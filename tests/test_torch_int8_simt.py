"""int8 at float32 and at every width: the SIMT instances of K10 and K11.

* ``int8_kernel_name`` keeps the Hopper instances (int8 ``wgmma``) where they
  take the operands, bf16 at their widths, and sends every other float32 or
  bf16 width of the float32 kernels to the SIMT instances (K10 ``__dp4a``,
  K11 int8 ``mma.sync``, ``csrc/*_q_simt.cu``); outside those it names the
  dtype or the width in a ValueError. Checked over every width the Hopper wrappers refuse, those of
  ``test_ln_ffn_q_cuda_wrapper_names_a_refused_width`` among them.
* The public int8 ops, handed tensors that say they are on the card, reach
  the wrapper of that instance (K11's two modes too), and launch nothing.
* The SIMT wrappers refuse CPU tensors, other dtypes and widths outside
  their range before any launch.
* Every C entry point's parameters, read from its source, agree in number
  and kind with the ctypes argtypes ``ops/cuda.py`` hands it.
* ``gpu``: each SIMT kernel and mode against its plain version on the card
  at TINY_CONFIG's widths and its tensor-parallel shard, the float32 r10
  widths and their shard, d 384 bf16 and ragged row counts (within 2^-6 of
  the largest output, and at most twice the share of outputs by which the
  plain version moves when LayerNorm sums in float64); the tiny int8 forward
  on the card through them against the frozen JAX int8 logits. This file
  imports no JAX, so the card's machine runs it.
"""

import os
import re

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import cuda as kernels
from herro_tpu_torch.ops import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "torch_data")
BF, F32 = torch.bfloat16, torch.float32


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _ln_params(rng, d):
    return ((1 + rng.normal(0, 0.1, size=(d,))).astype(np.float32),
            rng.normal(0, 0.1, size=(d,)).astype(np.float32))


def _qkv_q_args(seed, d, H, D, B=2, L=64, dtype=F32, dev="cpu"):
    """K10's operands: x [B, L, d] of ``dtype``, the qkv weight quantized
    after its cast to ``dtype`` (as the model does) and k-major, b of
    ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    s, b = _ln_params(rng, d)
    w = rng.normal(0, d ** -0.5, size=(d, 3 * H * D)).astype(np.float32)
    bias = rng.normal(0, 0.25, size=(3 * H * D,)).astype(np.float32)
    w_i8, s_col = fused.quantize_weight(_t(w, dtype).to(dev))
    return (_t(x, dtype).to(dev), _t(s).to(dev), _t(b).to(dev), fused.k_major(w_i8), s_col,
            _t(bias, dtype).to(dev), H)


def _ffn_q_args(seed, d, f, rows=64, dtype=F32, dev="cpu", zero_rows=False):
    """K11's operands: x [rows, d] of ``dtype``, both weights quantized from
    float32 and k-major, the biases float32. ``zero_rows``: every 7th row
    constant with LayerNorm's bias and b1 zero, so its y and hidden are zero
    (both scales clamp at 1e-12)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    s, b = _ln_params(rng, d)
    w1 = rng.normal(0, d ** -0.5, size=(d, f)).astype(np.float32)
    b1 = rng.normal(0, 0.1, size=(f,)).astype(np.float32)
    w2 = rng.normal(0, f ** -0.5, size=(f, d)).astype(np.float32)
    b2 = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    if zero_rows:
        x[::7] = 0.5
        b[:] = 0.0
        b1[:] = 0.0
    (q1, s1), (q2, s2) = (fused.quantize_weight(_t(w).to(dev)) for w in (w1, w2))
    return (_t(x, dtype).to(dev), _t(s).to(dev), _t(b).to(dev), fused.k_major(q1), s1,
            _t(b1).to(dev), fused.k_major(q2), s2, _t(b2).to(dev))


# ---------------------------------------------------------------------------
# the choice of instance
# ---------------------------------------------------------------------------

# every (d_model, d_ff) the Hopper K11 refuses that the SIMT one takes, the
# widths of test_ln_ffn_q_cuda_wrapper_names_a_refused_width first; then
# TINY_CONFIG, its shard, r10 in float32 and its shard, d384x5L
FFN_REFUSED = [(128, 512), (384, 1024), (512, 128), (512, 1536), (256, 384), (256, 1664),
               (512, 1088), (32, 64), (32, 32), (384, 1280), (384, 640), (512, 2048),
               (256, 2048), (96, 96), (256, 480)]
# (d_model, head dim) the Hopper K10 refuses: narrow heads, d 384 and others
QKV_REFUSED = [(32, 16), (64, 32), (256, 64), (512, 16), (384, 128), (128, 128), (480, 128),
               (512, 64)]


@pytest.mark.parametrize("d,f", FFN_REFUSED)
def test_ffn_widths_the_hopper_kernel_refuses_take_the_simt_instance(d, f):
    assert not fused._ffn_q_hopper_takes(d, f)
    with pytest.raises(ValueError, match=rf"\(d_model, d_ff\) = \({d}, {f}\)"):
        fused._ln_ffn_q_cuda(*_ffn_q_args(1, d, f, dtype=BF))
    for dtype in (BF, F32):
        assert fused.int8_kernel_name(dtype, d, f) == "ln_ffn_q_simt"


@pytest.mark.parametrize("d,D", QKV_REFUSED)
def test_qkv_widths_the_hopper_kernel_refuses_take_the_simt_instance(d, D):
    with pytest.raises(ValueError, match=rf"head dim {D}|d_model {d}"):
        fused._ln_qkv_rope_q_cuda(*_qkv_q_args(2, d, 1, D, dtype=BF))
    for dtype in (BF, F32):
        assert fused.int8_kernel_name(dtype, d, D=D) == "ln_qkv_rope_q_simt"


def test_the_hopper_instances_keep_their_bf16_widths():
    """bf16 at a width the Hopper kernel takes stays there; float32 at the
    same width goes to the SIMT instance."""
    for d, (lo, hi) in fused.FFN_Q_D_FF.items():
        for f in range(lo, hi + 1, 128):
            assert fused.int8_kernel_name(BF, d, f) == "ln_ffn_q"
            assert fused.int8_kernel_name(F32, d, f) == "ln_ffn_q_simt"
    for d in fused.QKV_Q_WIDTHS:
        assert fused.int8_kernel_name(BF, d, D=fused.HEAD_DIM) == "ln_qkv_rope_q"
        assert fused.int8_kernel_name(F32, d, D=fused.HEAD_DIM) == "ln_qkv_rope_q_simt"


@pytest.mark.parametrize(
    "dtype,d,f,D,match",
    [(F32, 48, 64, None, r"d_model 48: the int8 SIMT kernels take a multiple of 32 up to 512"),
     (BF, 544, 1024, None, r"d_model 544"), (F32, 1024, None, 128, r"d_model 1024"),
     (F32, 32, 48, None, r"d_ff 48: the int8 SIMT kernel takes a multiple of 32 up to 2048"),
     (BF, 512, 4096, None, r"d_ff 4096"), (BF, 256, 16, None, r"d_ff 16"),
     (F32, 32, None, 8, r"head dim 8: the int8 SIMT kernels take \(16, 32, 64, 128\)"),
     (BF, 512, None, 256, r"head dim 256"), (torch.float16, 512, 1024, None, r"float16"),
     # the widths the float32 and bf16 SIMT kernels take and int8 does not
     (F32, 768, 3072, None, r"d_model 768: the int8 SIMT kernels take a multiple of 32 up to 512"),
     (BF, 768, None, 96, r"d_model 768: the int8 SIMT kernels"),
     (F32, 512, None, 96, r"head dim 96: the int8 SIMT kernels take \(16, 32, 64, 128\)"),
     (BF, 512, 3072, None, r"d_ff 3072: the int8 SIMT kernel takes a multiple of 32 up to 2048"),
     (torch.float64, 32, None, 16, r"float64")],
)
def test_int8_kernel_name_names_what_no_instance_takes(dtype, d, f, D, match):
    with pytest.raises(ValueError, match=match):
        fused.int8_kernel_name(dtype, d, f, D)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what ``on_card`` reads."""

    is_cuda = property(lambda self: True)


def _on_card(args):
    return tuple(a.as_subclass(_OnCard) if isinstance(a, torch.Tensor) else a for a in args)


ROUTES = [  # (op, wrapper the Hopper instance takes, the SIMT one's)
    ("ln_ffn_q", "_ln_ffn_q_cuda", "_ln_ffn_q_simt_cuda"),
    ("ln_ffn_q_rowmax", "_ln_ffn_q_rowmax_cuda", "_ln_ffn_q_rowmax_simt_cuda"),
    ("ln_ffn_q_rowscale", "_ln_ffn_q_rowscale_cuda", "_ln_ffn_q_rowscale_simt_cuda"),
    ("ln_qkv_rope_q", "_ln_qkv_rope_q_cuda", "_ln_qkv_rope_q_simt_cuda"),
]


def _op_args(op, dtype, d, D, f, seed=3):
    """Operands of an int8 op or wrapper: K10's at head dim D (H 2), K11's
    modes at d_ff f (``rowscale``'s row maxima 1, res_scale 0.5)."""
    if "qkv" in op:
        return _qkv_q_args(seed, d, 2, D, L=16, dtype=dtype)
    args = _ffn_q_args(seed, d, f, rows=16, dtype=dtype)
    if "rowmax" in op:
        return args[:6]
    if "rowscale" in op:
        return (*args, torch.ones(16), 0.5)
    return args


# (dtype, d, D, d_ff, the instance): r10's widths in bf16 (d_ff 1024, or a
# shard's 512) and in float32, d384x5L in bf16, TINY_CONFIG
OP_WIDTHS = [(BF, 512, 128, 1024, "hopper"), (BF, 512, 128, 512, "hopper"),
             (F32, 512, 128, 1024, "simt"), (BF, 384, 128, 1280, "simt"),
             (F32, 32, 16, 64, "simt")]


@pytest.mark.parametrize("op,hopper,simt", ROUTES)
@pytest.mark.parametrize("dtype,d,D,f,want", OP_WIDTHS)
def test_public_int8_ops_reach_the_chosen_instance(op, hopper, simt, dtype, d, D, f, want,
                                                  monkeypatch):
    """On tensors that say they are on the card each public int8 op hands
    its operands to the wrapper ``int8_kernel_name`` names, and launches
    nothing itself."""
    called = []
    for name in (hopper, simt):
        monkeypatch.setattr(fused, name, lambda *a, name=name: called.append(name))
    before = kernels.launch_counts.snapshot()
    getattr(fused, op)(*_on_card(_op_args(op, dtype, d, D, f)))
    assert called == [hopper if want == "hopper" else simt]
    assert kernels.launch_counts.snapshot() == before


# ---------------------------------------------------------------------------
# the SIMT wrappers refuse before any launch
# ---------------------------------------------------------------------------

SIMT_WRAPPERS = [r[2] for r in ROUTES]


@pytest.mark.parametrize("wrapper", SIMT_WRAPPERS)
@pytest.mark.parametrize("dtype,d,D,f", [(F32, 32, 16, 64), (BF, 512, 128, 1024),
                                         (F32, 384, 32, 128), (BF, 32, 64, 2048)])
def test_simt_wrappers_never_run_on_cpu_tensors(wrapper, dtype, d, D, f):
    """At widths they take the SIMT wrappers get as far as the device, which
    they refuse: a CPU tensor never runs a kernel."""
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        getattr(fused, wrapper)(*_op_args(wrapper, dtype, d, D, f, seed=5))
    assert kernels.launch_counts.snapshot() == before


@pytest.mark.parametrize("wrapper", SIMT_WRAPPERS)
@pytest.mark.parametrize("case", ["d48", "d544", "narrow", "wide", "float16", "d768", "D96"])
def test_simt_wrappers_name_what_they_refuse(wrapper, case):
    """Outside their widths or dtypes the SIMT wrappers raise a ValueError
    that names it before they look at the device, and launch nothing."""
    qkv = "qkv" in wrapper
    d, D, f, match = {
        "d48": (48, 16, 64, r"d_model 48: the int8 SIMT kernels"),
        "d544": (544, 32, 64, r"d_model 544"),
        "narrow": (32, 8, 16, r"head dim 8" if qkv else r"d_ff 16"),
        "wide": (32, 256, 4096, r"head dim 256" if qkv else r"d_ff 4096"),
        "float16": (32, 16, 64, r"float16"),
        # taken by the float32 kernels, not by int8
        "d768": (768, 96, 3072, r"d_model 768: the int8 SIMT kernels"),
        "D96": (512, 96, 3072, r"head dim 96: the int8 SIMT kernels" if qkv
                else r"d_ff 3072: the int8 SIMT kernel"),
    }[case]
    args = _op_args(wrapper, F32, d, D, f, seed=6)
    if case == "float16":
        args = (args[0].half(), *args[1:])
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match=match):
        getattr(fused, wrapper)(*args)
    assert kernels.launch_counts.snapshot() == before


def test_simt_wrappers_want_k_major_weights():
    args = list(_qkv_q_args(7, 32, 2, 16, dtype=F32))
    args[3] = args[3].contiguous()  # the reference's [in, out] layout
    with pytest.raises(ValueError, match="k-major"):
        fused._ln_qkv_rope_q_simt_cuda(*args)
    args = list(_ffn_q_args(8, 32, 64, dtype=F32))
    args[6] = args[6].contiguous()
    with pytest.raises(ValueError, match="k-major"):
        fused._ln_ffn_q_simt_cuda(*args)


def test_simt_qkv_wrapper_wants_b_in_the_dtype_of_x():
    args = list(_qkv_q_args(9, 32, 2, 16, dtype=BF))
    args[5] = args[5].float()
    with pytest.raises(ValueError, match="b is torch.float32"):
        fused._ln_qkv_rope_q_simt_cuda(*args)


# ---------------------------------------------------------------------------
# the C entry points against the ctypes argtypes
# ---------------------------------------------------------------------------

_KIND = {kernels._P: "pointer", kernels._L: "long", kernels._I: "int", kernels._F: "float"}


def _c_parameters(source: str, fn: str) -> list[str]:
    """The kinds of fn's parameters as its source declares them."""
    m = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', source, re.S)
    assert m, f"{fn} not found"
    kinds = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        kinds.append("pointer" if "*" in p else p.rsplit(" ", 1)[0].replace("const ", ""))
    return kinds


ENTRIES = sorted([(n, n, *e) for n, e in kernels.KERNELS.items()]
                 + [(m, *e) for m, e in kernels.MODES.items()])


@pytest.mark.parametrize("name,kernel,fn,argtypes", ENTRIES, ids=[e[0] for e in ENTRIES])
def test_c_entry_point_parameters_match_their_argtypes(name, kernel, fn, argtypes):
    """ctypes passes each argument as its argtype says: a pointer cut to an
    int, or an int where the C function reads a long, would launch on
    garbage on the card, and nothing here compiles the C side. So each entry
    point's declared parameters are held against its argtypes, kind by
    kind."""
    with open(os.path.join(kernels.CSRC, f"{kernel}.cu")) as fh:
        declared = _c_parameters(fh.read(), fn)
    assert declared == [_KIND[a] for a in argtypes]


def test_registry_holds_the_simt_int8_kernels_and_modes():
    assert {"ln_qkv_rope_q_simt", "ln_ffn_q_simt"} <= set(kernels.KERNELS)
    assert kernels.MODES["ln_ffn_q_simt_rowmax"][0] == "ln_ffn_q_simt"
    assert kernels.MODES["ln_ffn_q_simt_rowscale"][0] == "ln_ffn_q_simt"
    counts = kernels.launch_counts.snapshot()
    assert all(n in counts for n in ("ln_qkv_rope_q_simt", "ln_ffn_q_simt",
                                     "ln_ffn_q_simt_rowmax", "ln_ffn_q_simt_rowscale"))


# ---------------------------------------------------------------------------
# the SIMT kernels against their plain versions, on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(fn):
    before = kernels.launch_counts.snapshot()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    return out, {n: after[n] - before[n] for n in after if after[n] != before[n]}


def _close(got, want):
    """Within 2^-6 of the largest output: an int8 step of one LayerNorm value
    moves its row by about that much at most."""
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= float(w.abs().max()) * 2.0 ** -6


def _within_twice_the_floor(plain, got, *args):
    """The share of outputs that differ from the plain version is at most
    twice the share by which the plain version moves when LayerNorm's sums
    run in float64 (chip_smoke.py's int8 bar)."""
    from chip_smoke import float64_layernorm_sums, share_differing

    want = plain(*args)
    floor = share_differing(float64_layernorm_sums(fused, plain, *args), want)
    share = share_differing(got, want)
    assert share <= 2 * floor, (share, floor)
    return share, floor


# (d, H, D, d_ff, dtype): TINY_CONFIG and its tp 2 shard, r10 in float32 and
# its tp 2 shard, d384x5L in bf16, head dims 32 and 64, r10 bf16 on SIMT
GPU_WIDTHS = [(32, 2, 16, 64, F32), (32, 1, 16, 32, F32), (512, 4, 128, 1024, F32),
              (512, 2, 128, 512, F32), (384, 3, 128, 1280, BF), (64, 2, 32, 128, F32),
              (256, 4, 64, 2048, BF), (512, 4, 128, 1024, BF)]
GPU_IDS = [f"d{w[0]}-H{w[1]}-D{w[2]}-f{w[3]}-{str(w[4])[6:]}" for w in GPU_WIDTHS]


@pytest.mark.gpu
@pytest.mark.parametrize("nb,gl", [(1, 37), (2, 1000), (3, 1024)])
@pytest.mark.parametrize("width", GPU_WIDTHS, ids=GPU_IDS)
def test_ln_qkv_rope_q_simt_matches_plain_on_card(width, nb, gl):
    dev = _card()
    d, H, D, _, dtype = width
    args = _qkv_q_args(10, d, H, D, B=nb, L=gl, dtype=dtype, dev=dev)
    got, launched = _launched(lambda: fused._ln_qkv_rope_q_simt_cuda(*args))
    assert launched == {"ln_qkv_rope_q_simt": 1}
    assert all(g.dtype == dtype and g.shape == (nb, H, gl, D) for g in got)
    _close(got, fused._ln_qkv_rope_q_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,zero_rows", [(37, False), (2000, False), (300, True)])
@pytest.mark.parametrize("width", GPU_WIDTHS, ids=GPU_IDS)
def test_ln_ffn_q_simt_and_its_modes_match_plain_on_card(width, rows, zero_rows):
    """The whole kernel, and a tp 2 shard's two passes (W1's first half of
    columns, W2's rows, b2 / 2, x / 2): ``rowmax`` with and without the tied
    counts (the same maxima); in bf16 equal to the plain maxima but where
    LayerNorm's sums move a row (1 row in 500, 2 at least), in float32 within
    2^-6 (there the row scale of y keeps LayerNorm's last bit, which moves h
    and its maximum by an ulp in most rows; the share is held to the int8
    bar in the test below); the tied counts in either, but in 1 row in 500;
    ``rowscale`` fed the plain maxima. ``zero_rows``' outputs are x + b2
    exactly."""
    dev = _card()
    d, _, _, f, dtype = width
    args = _ffn_q_args(11, d, f, rows=rows, dtype=dtype, dev=dev, zero_rows=zero_rows)
    got, launched = _launched(lambda: fused._ln_ffn_q_simt_cuda(*args))
    assert launched == {"ln_ffn_q_simt": 1}
    assert got.dtype == dtype and got.shape == args[0].shape
    want = fused._ln_ffn_q_plain(*args)
    _close(got, want)
    if zero_rows:
        zero = (args[0][::7].float() + args[-1]).to(dtype)
        assert torch.equal(got[::7], zero) and torch.equal(want[::7], zero)
    if f < 64:
        return  # a shard of d_ff 16 is below the kernels' widths
    x, s, b, w1, s1, b1, w2, s2, b2 = args
    fl = f // 2
    head = (x, s, b, fused.k_major(w1[:, :fl]), s1[:fl].contiguous(), b1[:fl].contiguous())
    (top, ties), launched = _launched(lambda: fused._ln_ffn_q_rowmax_simt_cuda(*head, ties=True))
    assert launched == {"ln_ffn_q_simt_rowmax": 1}
    top_alone, none = fused._ln_ffn_q_rowmax_simt_cuda(*head)
    want_top, want_ties = fused._ln_ffn_q_rowmax_plain(*head, ties=True)
    assert torch.equal(top, top_alone) and none is None
    if dtype == BF:
        assert int((top != want_top).sum()) <= max(2, rows // 500)
    else:  # float32 keeps LayerNorm's last bit in s_row, and so in h and its maxima
        _close(top, want_top)
    assert ties.dtype == torch.int32 and int(ties.min()) >= 1
    assert int((ties != want_ties).sum()) <= max(2, rows // 500)
    tail = (fused.k_major(w2[:fl]), s2, b2 / 2, want_top, 0.5)
    got, launched = _launched(lambda: fused._ln_ffn_q_rowscale_simt_cuda(*head, *tail))
    assert launched == {"ln_ffn_q_simt_rowscale": 1}
    _close(got, fused._ln_ffn_q_rowscale_plain(*head, *tail))


@pytest.mark.gpu
@pytest.mark.parametrize("width", GPU_WIDTHS[:5], ids=GPU_IDS[:5])
def test_simt_kernels_differ_at_most_twice_the_floor_on_card(width):
    """At B=8, L=4096 (32,768 LayerNorm rows, enough that the float64 sums
    move some), each SIMT kernel's share of differing outputs (K11's row
    maxima too) is at most twice the plain version's own under LayerNorm
    sums in float64."""
    dev = _card()
    d, H, D, f, dtype = width
    qkv = _qkv_q_args(12, d, H, D, B=8, L=4096, dtype=dtype, dev=dev)
    _within_twice_the_floor(fused._ln_qkv_rope_q_plain, fused._ln_qkv_rope_q_simt_cuda(*qkv),
                            *qkv)
    ffn = _ffn_q_args(13, d, f, rows=8 * 4096, dtype=dtype, dev=dev)
    _within_twice_the_floor(fused._ln_ffn_q_plain, fused._ln_ffn_q_simt_cuda(*ffn), *ffn)
    head = ffn[:6]
    _within_twice_the_floor(lambda *a: fused._ln_ffn_q_rowmax_plain(*a)[0],
                            fused._ln_ffn_q_rowmax_simt_cuda(*head)[0], *head)


@pytest.mark.gpu
def test_public_ops_take_the_simt_instances_on_card():
    """float32 at r10's widths and bf16 at d 384 launch the SIMT instances
    through the public ops; bf16 at r10's widths still launches the Hopper
    ones and no SIMT instance."""
    dev = _card()
    for dtype, d, H, f, qkv_name, ffn_name in (
            (F32, 512, 4, 1024, "ln_qkv_rope_q_simt", "ln_ffn_q_simt"),
            (BF, 384, 3, 1280, "ln_qkv_rope_q_simt", "ln_ffn_q_simt"),
            (BF, 512, 4, 1024, "ln_qkv_rope_q", "ln_ffn_q")):
        _, launched = _launched(
            lambda: fused.ln_qkv_rope_q(*_qkv_q_args(14, d, H, 128, dtype=dtype, dev=dev)))
        assert launched == {qkv_name: 1}
        _, launched = _launched(
            lambda: fused.ln_ffn_q(*_ffn_q_args(15, d, f, dtype=dtype, dev=dev)))
        assert launched == {ffn_name: 1}


@pytest.mark.gpu
def test_tiny_int8_forward_on_card_matches_the_frozen_jax_int8_logits():
    """The seeded tiny checkpoint's int8 forward on the card launches the
    SIMT K10 and K11 n_layers times each beside the float32 entry and
    attention, and lands within the int8 bars of
    ``tests/test_torch_int8_goldens.py`` of herro_tpu's frozen int8 logits."""
    dev = _card()
    from test_torch_int8_goldens import int8_forward_gap, within_bars

    gap = int8_forward_gap("tiny", dev)
    cfg = gap["cfg"]
    assert gap["launches"] == {"entry_embed_f32": 1, "ln_qkv_rope_q_simt": cfg.n_layers,
                               "flash_f32_full": cfg.n_layers, "ln_ffn_q_simt": cfg.n_layers}
    assert within_bars(gap), gap
