"""bf16 at every width and head dim: the bf16 SIMT instances of K4, K1/K8,
K2/K6/K7/K9 and K3 (``csrc/*_bf16.cu``).

* ``bf16_kernel_name`` keeps each Hopper instance (TMA and ``wgmma``) at
  every bf16 width it was built for, sends TINY_CONFIG in bf16 (d 32, H 2 x
  D 16, d_ff 64), its tensor-parallel shard, head dims 16, 32 and 64 and R
  1-63 to the SIMT instances, and names what neither takes (d 544, d 1024,
  d_ff 4096, D 96, D 256, R 64) in a ValueError.
* Each public op, handed bf16 tensors that say they are on the card, runs
  its wrapper's checks to the launch of the instance ``bf16_kernel_name``
  names (the launch itself recorded, not made); out of range it raises
  before any launch.
* The plain bf16 versions at TINY_CONFIG's widths against herro_tpu's
  Pallas kernels in interpret mode, in bf16: within 2^-6 of the largest
  output (4 bf16 ulps), as ``tests/test_torch_kernels.py`` holds bf16.
* The port's plain bf16 forward of ``tiny`` and of the flagship at head dim
  64 ("r10h64") against herro_tpu's bf16 logits frozen by
  ``tests/torch_data/make_bf16_golden.py`` (rebuilt here with the JAX
  package): the class on every supported column, and max |dlogit| and
  |dinfo| within twice the gap the file records; the same at ``--tp 2``
  (two shards of the CPU); ``tiny --int8`` in bf16 against herro_tpu's int8
  bf16 forward within ``chip_smoke.INT8_GOLDEN_BARS``.
* ``gpu``: each bf16 SIMT instance against its plain version on the card,
  at the bf16 bars of ``chip_smoke.compare``; the tiny and r10h64 forwards
  through them against the frozen goldens. These skip inside the test
  without a card and import no JAX.
"""

import contextlib
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import attention as tattn
from herro_tpu_torch.ops import cuda as kernels
from herro_tpu_torch.ops import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "torch_data")
BF = torch.bfloat16
R_ROWS, V = 31, 12


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_bf16_golden", os.path.join(DATA, "make_bf16_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a, dtype=None, dev="cpu"):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# the operands, made from a numpy seed
# ---------------------------------------------------------------------------


def _entry(seed, d, R=R_ROWS, B=2, L=64, dev="cpu"):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, size=(B, R, L)).astype(np.uint8)
    tok[:, :, L - 5 :] = 11
    quals = rng.uniform(-1, 1, size=(B, R, L)).astype(np.float32)
    w_embT = rng.normal(0, 0.2, size=(d, R * V)).astype(np.float32)
    w_qT = rng.normal(0, 0.2, size=(d, R)).astype(np.float32)
    cb = rng.normal(0, 0.25, size=(d,)).astype(np.float32)
    wc = fused.col_proj_table(_t(w_embT, BF, dev), _t(w_qT, BF, dev))
    return _t(tok, dev=dev), _t(quals, dev=dev), wc, _t(cb, dev=dev), BF


def _qkv(seed, d, H, D, B=2, L=64, dev="cpu"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, d))
    s, b = 1 + rng.normal(0, 0.1, size=(d,)), rng.normal(0, 0.1, size=(d,))
    w = rng.normal(0, d ** -0.5, size=(d, 3 * H * D))
    bias = rng.normal(0, 0.25, size=(3 * H * D,))
    f32 = lambda a: _t(a.astype(np.float32), dev=dev)
    return _t(x, BF, dev), f32(s), f32(b), _t(w, BF, dev), _t(bias, BF, dev), H


def _attn(seed, d, H, D, L=64, lengths=(64, 30), dev="cpu"):
    rng = np.random.default_rng(seed)
    q, k, v = (_t(rng.normal(size=(len(lengths), H, L, D)), BF, dev) for _ in range(3))
    x = _t(rng.normal(size=(len(lengths), L, d)), BF, dev)
    wo = _t(rng.normal(0, (H * D) ** -0.5, size=(H, D, d)), BF, dev)
    bo = _t(rng.normal(0, 0.25, size=(d,)), BF, dev)
    return q, k, v, x, wo, bo, _t(np.asarray(lengths, np.int32), dev=dev)


def _ffn(seed, d, f, rows=64, dev="cpu"):
    rng = np.random.default_rng(seed)
    f32 = lambda a: _t(a.astype(np.float32), dev=dev)
    return (_t(rng.normal(size=(rows, d)), BF, dev), f32(1 + rng.normal(0, 0.1, size=(d,))),
            f32(rng.normal(0, 0.1, size=(d,))),
            _t(rng.normal(0, d ** -0.5, size=(d, f)), BF, dev),
            _t(rng.normal(0, 0.25, size=(f,)), BF, dev),
            _t(rng.normal(0, f ** -0.5, size=(f, d)), BF, dev),
            _t(rng.normal(0, 0.25, size=(d,)), BF, dev))


# ---------------------------------------------------------------------------
# the choice of instance
# ---------------------------------------------------------------------------


def test_the_hopper_instances_keep_every_shipped_bf16_width(monkeypatch):
    """bf16 at a width a Hopper instance was built for stays there, under
    either rope route and at every band."""
    monkeypatch.delenv("HERRO_TPU_ROPE", raising=False)
    for d in fused.EMBED_WIDTHS:
        for R in range(29, 33):
            assert fused.bf16_kernel_name("entry_embed", d, R=R) == "entry_embed"
    for d in fused.QKV_WIDTHS:
        assert fused.bf16_kernel_name("ln_qkv_rope", d, D=128) == "ln_qkv_rope"
    for H, d in fused.ATTENTION_WIDTHS:
        for band in (None, 40, 384, 512):
            assert fused.bf16_kernel_name("flash_outproj", d, H=H, D=128, local_window=band) \
                == fused.flash_kernel_name(band)
    assert fused.bf16_kernel_name("flash_attention", D=128) == "flash_attention"
    for d in fused.FFN_WIDTHS:
        for f in (128, 256, 512, 1024, 1280, 1536, 2048):
            assert fused.bf16_kernel_name("ln_ffn", d, f) == "ln_ffn"
    monkeypatch.setenv("HERRO_TPU_ROPE", "split")
    assert fused.bf16_kernel_name("ln_qkv_rope", 512, D=128) == "ln_qkv_rope_split"


# (op, widths, the SIMT instance): TINY_CONFIG in bf16 and its tp 2 shard,
# r10h64 and its tp 2 shard, head dims 16 / 32 / 64, R 1-63 off the 512-row
# table, d_ff off the Hopper multiples of 128
SIMT_CASES = [
    ("entry_embed", dict(d=32, R=31), "entry_embed_bf16"),
    ("entry_embed", dict(d=512, R=1), "entry_embed_bf16"),
    ("entry_embed", dict(d=256, R=28), "entry_embed_bf16"),
    ("entry_embed", dict(d=384, R=63), "entry_embed_bf16"),
    ("ln_qkv_rope", dict(d=32, D=16), "ln_qkv_rope_bf16"),
    ("ln_qkv_rope", dict(d=64, D=32), "ln_qkv_rope_bf16"),
    ("ln_qkv_rope", dict(d=512, D=64), "ln_qkv_rope_bf16"),
    ("ln_qkv_rope", dict(d=128, D=128), "ln_qkv_rope_bf16"),
    ("flash_outproj", dict(d=32, H=2, D=16), "flash_bf16_full"),
    ("flash_outproj", dict(d=32, H=1, D=16, local_window=40), "flash_bf16"),
    ("flash_outproj", dict(d=512, H=8, D=64, local_window=512), "flash_bf16"),
    ("flash_outproj", dict(d=512, H=4, D=64, local_window=384), "flash_bf16"),
    ("flash_outproj", dict(d=256, H=4, D=128), "flash_bf16_full"),
    ("flash_attention", dict(D=16), "flash_bf16_attention"),
    ("flash_attention", dict(D=32), "flash_bf16_attention"),
    ("flash_attention", dict(D=64), "flash_bf16_attention"),
    ("ln_ffn", dict(d=32, f=64), "ln_ffn_bf16"),
    ("ln_ffn", dict(d=32, f=32), "ln_ffn_bf16"),
    ("ln_ffn", dict(d=512, f=2016), "ln_ffn_bf16"),
    ("ln_ffn", dict(d=128, f=512), "ln_ffn_bf16"),
]


@pytest.mark.parametrize("op,widths,name", SIMT_CASES)
def test_widths_no_hopper_instance_takes_go_to_the_simt_instance(op, widths, name, monkeypatch):
    monkeypatch.delenv("HERRO_TPU_ROPE", raising=False)
    assert fused.bf16_kernel_name(op, **widths) == name
    assert name in kernels.launch_counts.snapshot()
    if op == "ln_qkv_rope":
        monkeypatch.setenv("HERRO_TPU_ROPE", "split")
        assert fused.bf16_kernel_name(op, **widths) == "ln_qkv_rope_bf16_split"


# widths neither instance takes, and the ValueError that names them
REFUSED = [
    ("entry_embed", dict(d=544, R=31), r"d_model 544: the bf16 kernels take \(256, 384, 512\) "
     r"on the Hopper instance and a multiple of 32 up to 512 on the SIMT one"),
    ("entry_embed", dict(d=1024, R=31), r"d_model 1024"),
    ("entry_embed", dict(d=32, R=64), r"R 64 pileup rows: the bf16 kernels take 29 to 32"),
    ("ln_qkv_rope", dict(d=544, D=64), r"d_model 544"),
    ("ln_qkv_rope", dict(d=1024, D=128), r"d_model 1024"),
    ("ln_qkv_rope", dict(d=384, D=96), r"head dim 96: the bf16 kernels take 128 on the Hopper "
     r"instance and \(16, 32, 64, 128\) on the SIMT one"),
    ("ln_qkv_rope", dict(d=512, D=256), r"head dim 256"),
    ("flash_outproj", dict(d=1024, H=8, D=128), r"d_model 1024"),
    ("flash_outproj", dict(d=544, H=2, D=16, local_window=40), r"d_model 544"),
    ("flash_outproj", dict(d=384, H=4, D=96, local_window=512), r"head dim 96"),
    ("flash_outproj", dict(d=512, H=2, D=256), r"head dim 256"),
    ("flash_attention", dict(D=96), r"head dim 96"),
    ("flash_attention", dict(D=256), r"head dim 256"),
    ("ln_ffn", dict(d=544, f=1024), r"d_model 544"),
    ("ln_ffn", dict(d=1024, f=4096), r"d_model 1024"),
    # the Hopper K3 takes any multiple of 128 at its widths; d 32 is not one
    ("ln_ffn", dict(d=32, f=4096), r"d_ff 4096: the bf16 kernels take a multiple of 128"),
    ("ln_ffn", dict(d=32, f=48), r"d_ff 48"),
]


@pytest.mark.parametrize("op,widths,match", REFUSED)
def test_bf16_kernel_name_names_what_no_instance_takes(op, widths, match):
    with pytest.raises(ValueError, match=match):
        fused.bf16_kernel_name(op, **widths)


def test_bf16_kernel_name_knows_its_ops():
    with pytest.raises(ValueError, match="no bf16 op"):
        fused.bf16_kernel_name("ln_ffn_q", 32, 64)


# ---------------------------------------------------------------------------
# the public ops on tensors that say they are on the card
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what ``on_card`` reads."""

    is_cuda = property(lambda self: True)


def _on_card(args):
    return tuple(a.clone().as_subclass(_OnCard) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.fixture
def fake_launches(monkeypatch):
    """The wrappers run through every check to their launch on CPU tensors:
    the launch (``cuda.call``) records the kernel's name instead of running
    it; the stream, the device guard and the cached rope tables stand in
    for the card's."""
    launched = []
    monkeypatch.delenv("HERRO_TPU_ROPE", raising=False)
    monkeypatch.delenv("HERRO_TPU_PALLAS", raising=False)
    monkeypatch.setattr(kernels, "call", lambda name, *args: launched.append(name))
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fused, "_rope_tables_cached",
                        lambda L, D, dev: fused.rope_tables(L, D, "cpu"))
    return launched


# (tag, d, H, D, d_ff): TINY_CONFIG in bf16, its tp 2 shard, head dim 32,
# r10h64 and its tp 2 shard, r10 (the Hopper instances), d384x5L
OP_WIDTHS = [("tiny", 32, 2, 16, 64), ("tiny-tp2", 32, 1, 16, 32), ("d64", 64, 2, 32, 128),
             ("r10h64", 512, 8, 64, 1024), ("r10h64-tp2", 512, 4, 64, 512),
             ("r10", 512, 4, 128, 1024), ("d384", 384, 3, 128, 1280)]


@pytest.mark.parametrize("op", ["entry_embed", "ln_qkv_rope", "flash_outproj",
                                "attention", "ln_ffn"])
@pytest.mark.parametrize("tag,d,H,D,f", OP_WIDTHS, ids=[w[0] for w in OP_WIDTHS])
def test_public_ops_reach_the_instance_bf16_kernel_name_names(op, tag, d, H, D, f,
                                                              fake_launches):
    """Each public op on bf16 tensors that say they are on the card passes
    its wrapper's checks of shapes and dtypes and launches once, the
    instance ``bf16_kernel_name`` names for its widths; nothing else."""
    band = 512 if tag.startswith("r10") else None
    if op == "entry_embed":
        args, want = _entry(1, d), fused.bf16_kernel_name(op, d, R=R_ROWS)
        out = fused.entry_embed(*_on_card(args))
        assert out.dtype == BF and out.shape == (2, 64, d)
    elif op == "ln_qkv_rope":
        args, want = _qkv(2, d, H, D), fused.bf16_kernel_name(op, d, D=D)
        outs = fused.ln_qkv_rope(*_on_card(args))
        assert all(o.dtype == BF and o.shape == (2, H, 64, D) for o in outs)
    elif op == "flash_outproj":
        args = (*_attn(3, d, H, D), band)
        want = fused.bf16_kernel_name(op, d, H=H, D=D, local_window=band)
        out = fused.flash_outproj(*_on_card(args))
        assert out.dtype == BF and out.shape == (2, 64, d)
    elif op == "attention":
        q, k, v, *_, lengths = _attn(4, d, H, D)
        want = fused.bf16_kernel_name("flash_attention", D=D)
        out = tattn.attention(*_on_card((q, k, v, lengths)), band, impl="auto")
        assert out.dtype == BF and out.shape == q.shape
    else:
        args, want = _ffn(5, d, f), fused.bf16_kernel_name(op, d, f)
        out = fused.ln_ffn(*_on_card(args))
        assert out.dtype == BF and out.shape == (64, d)
    assert fake_launches == [want]
    hopper = tag in ("r10", "d384") or (tag.startswith("r10h64")
                                        and op in ("entry_embed", "ln_ffn"))
    assert hopper == ("bf16" not in want)


# (op, operands out of range, the width named)
def _refused_case(op, case):
    d, H, D, f = {"d544": (544, 2, 16, 64), "d1024": (1024, 8, 128, 1024),
                  "f4096": (32, 2, 16, 4096), "D96": (384, 4, 96, 512),
                  "D256": (512, 2, 256, 512)}[case]
    if op == "entry_embed":
        return fused.entry_embed, _entry(6, d)
    if op == "ln_qkv_rope":
        return fused.ln_qkv_rope, _qkv(7, d, H, D)
    if op == "flash_outproj":
        return fused.flash_outproj, (*_attn(8, d, H, D), 40)
    if op == "attention":
        q, k, v, *_, lengths = _attn(9, d, H, D)
        return (lambda q, k, v: tattn.attention(q, k, v, lengths, 40)), (q, k, v)
    return fused.ln_ffn, _ffn(10, d, f)


REFUSALS = [(op, case) for op, cases in (
    ("entry_embed", ("d544", "d1024")), ("ln_qkv_rope", ("d544", "d1024", "D96", "D256")),
    ("flash_outproj", ("d544", "d1024", "D96", "D256")), ("attention", ("D96", "D256")),
    ("ln_ffn", ("d544", "d1024", "f4096"))) for case in cases]


@pytest.mark.parametrize("op,case", REFUSALS)
def test_public_ops_name_a_width_no_instance_takes_before_any_launch(op, case, fake_launches):
    call, args = _refused_case(op, case)
    width = {"d544": "d_model 544", "d1024": "d_model 1024", "f4096": "d_ff 4096",
             "D96": "head dim 96", "D256": "head dim 256"}[case]
    with pytest.raises(ValueError, match=width):
        call(*_on_card(args))
    assert fake_launches == []


@pytest.mark.parametrize("op", ["entry_embed", "ln_qkv_rope", "flash_outproj", "ln_ffn"])
def test_bf16_simt_wrappers_refuse_the_cpu_and_other_dtypes(op):
    """At widths they take, the SIMT wrappers get as far as the device and
    refuse a CPU tensor; a float32 operand beside bf16 ones is named."""
    wrapper, args = {
        "entry_embed": (fused._entry_embed_simt_cuda, (*_entry(11, 32), "entry_embed_bf16")),
        "ln_qkv_rope": (fused._ln_qkv_rope_simt_cuda, (*_qkv(12, 32, 2, 16), "ln_qkv_rope_bf16")),
        "flash_outproj": (fused._flash_outproj_simt_cuda, (*_attn(13, 32, 2, 16), None,
                                                           "flash_bf16_full")),
        "ln_ffn": (fused._ln_ffn_simt_cuda, (*_ffn(14, 32, 64), "ln_ffn_bf16")),
    }[op]
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        wrapper(*args)
    bad = list(args)
    i = 2 if op == "entry_embed" else 3  # wc, w, x, w1: of the kernel's dtype
    bad[i] = bad[i].float()
    with pytest.raises(ValueError, match="torch.float32, the kernel takes torch.bfloat16"):
        wrapper(*bad)
    assert kernels.launch_counts.snapshot() == before


# ---------------------------------------------------------------------------
# the plain bf16 versions against herro_tpu's Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import attention as jattn
    from herro_tpu.ops import fused as jfused

    return dict(jnp=jnp, pltpu=pltpu, fused=jfused, attn=jattn)


def _close_bf16(got, want, lengths=None, row_axis=1):
    """Within 2^-6 of the largest output (4 bf16 ulps), on the rows below
    each length where ``lengths`` is given."""
    got, want = got.float().numpy(), np.asarray(want, dtype=np.float32)
    tol = np.abs(want).max() * 2.0 ** -6
    if lengths is None:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        return
    for b, n in enumerate(lengths):
        sl = (b, slice(None, n)) if row_axis == 1 else (b, slice(None), slice(None, n))
        np.testing.assert_allclose(got[sl], want[sl], atol=tol, rtol=0)


def _jax(ref, t):
    """A torch tensor as a jnp array of its dtype (bf16 through float32)."""
    jnp = ref["jnp"]
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == BF \
        else jnp.asarray(t.numpy())


@pytest.mark.parametrize("kind", ["entry", "qkv-tbl", "qkv-split", "ffn"])
def test_bf16_plain_versions_match_pallas_interpret_at_tiny_width(kind, ref, monkeypatch):
    """TINY_CONFIG's widths (d 32, H 2 x D 16, d_ff 64) in bf16, L=512: the
    entry, both rope routes and the FFN."""
    jf, jnp = ref["fused"], ref["jnp"]
    with ref["pltpu"].force_tpu_interpret_mode():
        if kind == "entry":  # the weights in bf16, as both models hand them over
            rng = np.random.default_rng(15)
            tok, quals, _, cb, _ = _entry(15, 32, L=512)
            w_embT, w_qT = (_t(rng.normal(0, 0.2, size=(32, n)), BF) for n in (R_ROWS * V, R_ROWS))
            want = jf._entry_embed_pallas(
                *(_jax(ref, a) for a in (tok, quals, w_embT, w_qT, cb)), jnp.bfloat16, blk_l=128)
            got = fused.entry_embed(tok, quals, fused.col_proj_table(w_embT, w_qT), cb, BF)
            _close_bf16(got, want)
        elif kind.startswith("qkv"):
            route = kind.split("-")[1]
            monkeypatch.setenv("HERRO_TPU_ROPE", route)
            args = _qkv(16, 32, 2, 16, L=512)
            want = jf._ln_qkv_rope_pallas(*(_jax(ref, a) for a in args[:5]), 2, blk_t=128,
                                          rope_tbl=route == "tbl")
            for g, w in zip(fused.ln_qkv_rope(*args), want):
                assert g.dtype == BF and g.shape == (2, 2, 512, 16)
                _close_bf16(g, w)
        else:
            args = _ffn(17, 32, 64, rows=1024)
            want = jf._ln_ffn_pallas(*(_jax(ref, a) for a in args), blk_t=256)
            _close_bf16(fused.ln_ffn(*args), want)


@pytest.mark.parametrize("local_window", [None, 512, 40])
def test_bf16_attention_plain_versions_match_pallas_interpret_at_tiny_width(local_window,
                                                                           ref):
    """The out projection's attention (K2, K6 or K7 by the band) and K9 at
    H 2 x D 16, d 32 in bf16, L=512, on the rows below each length; K9's
    length-0 example all zeros on both sides."""
    args = _attn(18, 32, 2, 16, L=512, lengths=(512, 442, 0))
    with ref["pltpu"].force_tpu_interpret_mode():
        want = ref["fused"]._flash_outproj_pallas(*(_jax(ref, a) for a in args), local_window)
        q, k, v, *_, lengths = args
        want9 = np.asarray(ref["attn"].flash_attention(
            *(_jax(ref, a) for a in (q, k, v, lengths)), local_window), dtype=np.float32)
    lens = lengths.numpy()
    _close_bf16(fused.flash_outproj(*args, local_window), want, lens[:2])
    got9 = tattn._flash_attention_plain(q, k, v, lengths, local_window)
    _close_bf16(got9, want9, lens[:2], row_axis=2)
    assert not got9[2].any() and not want9[2].any()


# ---------------------------------------------------------------------------
# the frozen bf16 goldens: tiny and r10h64
# ---------------------------------------------------------------------------

GOLDENS = {"tiny": "golden_tiny_bf16.npz", "r10h64": "golden_r10h64_bf16.npz"}


def _within_twice_the_recorded_gap(gap, frozen) -> bool:
    """The bar of the card's forwards (``chip_smoke.py``): the class on every
    supported column, max |dlogit| and |dinfo| at most twice the CPU plain
    route's gap the file records."""
    return (gap["finite"] and gap["flipped"] == 0
            and gap["max_dlogit"] <= 2 * float(frozen["cpu_max_dlogit"])
            and gap["max_dinfo"] <= 2 * float(frozen["cpu_max_dinfo"]))


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_plain_bf16_forward_matches_frozen_jax_logits(name, tp):
    """One device: the gap the file records, the class on every supported
    column. Two tensor-parallel shards (heads and d_ff halved: tiny H 1 x D
    16, d_ff 32; r10h64 H 4 x D 64, d_ff 512): the same bar as the card's,
    within twice that gap."""
    mk = _maker()
    frozen = np.load(os.path.join(DATA, GOLDENS[name]))
    gap = mk.port_gap(name, frozen, tp=tp)
    cfg = gap["cfg"]
    assert cfg.dtype == "bfloat16" and gap["n"] > 0 and gap["launches"] == {}
    assert (cfg.d_model // cfg.n_heads, cfg.d_model) == ((16, 32) if name == "tiny"
                                                          else (64, 512))
    if tp == 1:
        assert gap["flipped"] == int(frozen["cpu_flipped"]) == 0
        assert gap["max_dlogit"] <= float(frozen["cpu_max_dlogit"]) * (1 + 1e-6)
    assert _within_twice_the_recorded_gap(gap, frozen), gap


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_frozen_bf16_goldens_rebuild_from_herro_tpu(name):
    """The JAX package rebuilds what the files hold (its CPU build: bit for
    bit, checked to 1e-5 as the float32 goldens are)."""
    mk = _maker()
    got = mk.build_tiny() if name == "tiny" else mk.build_r10h64()
    frozen = np.load(os.path.join(DATA, GOLDENS[name]))
    for key in ("info", "logits"):
        np.testing.assert_allclose(got[key], frozen[key], atol=1e-5, rtol=0)


def test_r10h64_is_model_r10_sim_read_at_head_dim_64():
    """Both packages' r10h64 hold the checkpoint's bytes: the port's state
    dict equals the flagship's but for the out kernel's shape."""
    from herro_tpu_torch.models.checkpoint import load_model

    mk = _maker()
    cfg, sd = mk.port_r10h64()
    cfg0, sd0 = load_model(os.path.join(ROOT, "resources", "model_r10_sim"))
    assert dataclasses.replace(cfg0, n_heads=8) == cfg
    for k, v in sd0.items():
        assert torch.equal(sd[k].reshape(v.shape), v)
    assert sd["blocks.0.attn.out_kernel"].shape == (8, 64, 512)


def test_plain_int8_tiny_bf16_forward_matches_herro_tpu():
    """``--int8`` on tiny in bf16 (the SIMT int8 K10 and K11 on the card,
    beside this PR's bf16 K4 and K7) against herro_tpu's int8 bf16 forward,
    within ``chip_smoke.INT8_GOLDEN_BARS`` (0.05 on |dlogit| and |dinfo|, 1
    column in 40 whose class differs; the CPU reads 0.038 / 0.036 and 1 of
    417)."""
    from chip_smoke import INT8_GOLDEN_BARS as bars

    mk = _maker()
    f32 = mk._float32_golden()
    jcfg, params = f32.tiny_params()
    fx = np.load(f32.TINY_GOLDEN)
    want = f32.jax_forward(dataclasses.replace(jcfg, dtype="bfloat16", int8=True), params,
                           f32.model_inputs(fx))
    gap = mk.port_gap("tiny", want, int8=True)
    assert gap["cfg"].int8 and gap["cfg"].dtype == "bfloat16" and gap["finite"]
    assert gap["max_dlogit"] <= bars["max_dlogit"] and gap["max_dinfo"] <= bars["max_dinfo"]
    assert gap["flipped"] <= bars["flipped_share"] * gap["n"]


# ---------------------------------------------------------------------------
# the bf16 SIMT kernels against their plain versions, on the card
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


def _held(got, want, keep=None, residual=None):
    """``chip_smoke.compare``'s bf16 bars: 2^-6 of the largest output, and
    of the residual-free part where the output is residual + part."""
    from chip_smoke import compare

    err, tol, part_err, part_tol = compare(torch, got, want, keep, residual)
    assert err <= tol and (part_err is None or part_err <= part_tol), \
        (err, tol, part_err, part_tol)


# (d, H, D, d_ff): TINY_CONFIG, its tp 2 shard, head dim 32, r10h64 and its
# tp 2 shard (K3 and K4 at d 512 forced onto the SIMT instance by name)
GPU_WIDTHS = [(32, 2, 16, 64), (32, 1, 16, 32), (64, 2, 32, 128), (512, 8, 64, 1024),
              (512, 4, 64, 512)]
GPU_IDS = [f"d{w[0]}-H{w[1]}-D{w[2]}-f{w[3]}" for w in GPU_WIDTHS]


@pytest.mark.gpu
@pytest.mark.parametrize("gl,lengths", [(1024, (1024, 1000, 77, 0)), (1000, (1000, 937, 600, 1))])
@pytest.mark.parametrize("width", GPU_WIDTHS, ids=GPU_IDS)
def test_bf16_simt_kernels_match_plain_on_card(width, gl, lengths):
    dev = _card()
    d, H, D, f = width
    lens = _t(np.asarray(lengths, np.int32), dev=dev)
    keep = torch.arange(gl, device=dev)[None, :] < lens[:, None]
    entry = _entry(20, d, B=4, L=gl, dev=dev)
    got, launched = _launched(lambda: fused._entry_embed_cuda(*entry, kernel="entry_embed_bf16"))
    assert launched == {"entry_embed_bf16": 1}
    _held(got, fused._entry_embed_plain(*entry))
    qkv = _qkv(21, d, H, D, B=4, L=gl, dev=dev)
    outs = {}
    for route in ("ln_qkv_rope_bf16", "ln_qkv_rope_bf16_split"):
        outs[route], launched = _launched(lambda: fused._ln_qkv_rope_cuda(*qkv, kernel=route))
        assert launched == {route: 1}
        _held(outs[route], fused._ln_qkv_rope_plain(*qkv))
    assert all(torch.equal(a, b) for a, b in zip(*outs.values()))  # the same bits
    q, k, v = outs["ln_qkv_rope_bf16"]
    _, _, _, x, wo, bo, _ = _attn(22, d, H, D, L=gl, lengths=lengths, dev=dev)
    for band in (None, 0, 40, 512, 5000):
        name = "flash_bf16_full" if band is None else "flash_bf16"
        args = (q, k, v, x, wo, bo, lens, band)
        got, launched = _launched(lambda: fused._flash_outproj_cuda(*args, kernel=name))
        assert launched == {name: 1} and bool(torch.isfinite(got.float()).all())
        _held(got, fused._flash_outproj_plain(*args), keep, x)
        got, launched = _launched(lambda: tattn._flash_attention_cuda(
            q, k, v, lens, band, kernel="flash_bf16_attention"))
        assert launched == {"flash_bf16_attention": 1}
        _held(got, tattn._flash_attention_plain(q, k, v, lens, band),
              keep[:, None, :].expand(len(lengths), H, gl))
        for b, n in enumerate(lengths):
            assert n or not got[b].any()  # a length-0 example comes out 0
    ffn = _ffn(23, d, f, rows=len(lengths) * gl, dev=dev)
    got, launched = _launched(lambda: fused._ln_ffn_cuda(*ffn, kernel="ln_ffn_bf16"))
    assert launched == {"ln_ffn_bf16": 1}
    _held(got, fused._ln_ffn_plain(*ffn), residual=ffn[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_bf16_forward_on_card_matches_frozen_jax_logits(name):
    """tiny in bf16 launches only the bf16 SIMT instances; r10h64 its SIMT
    K1 and K2 beside the Hopper K3 and K4; both within twice the CPU's gap
    to the frozen JAX logits, the class on every supported column."""
    dev = _card()
    mk = _maker()
    frozen = np.load(os.path.join(DATA, GOLDENS[name]))
    gap = mk.port_gap(name, frozen, device=dev)
    n = gap["cfg"].n_layers
    want = {"entry_embed_bf16" if name == "tiny" else "entry_embed": 1,
            "ln_qkv_rope_bf16": n, "flash_bf16" if name == "r10h64" else "flash_bf16_full": n,
            "ln_ffn_bf16" if name == "tiny" else "ln_ffn": n}
    assert gap["launches"] == want
    assert _within_twice_the_recorded_gap(gap, frozen), gap


@pytest.mark.gpu
def test_bf16_rows_fail_when_the_kernel_misses_a_rounding():
    """``tools/bf16_rounding_faults.py`` at tiny, L=1024: a copy of the
    package with the bf16 SIMT device code unchanged holds every row of
    ``chip_smoke.simt_cases``; with one rounding of the bf16 plain version
    missed (or one added), the rows ``FAULTS`` names fail: every planted
    fault, K9's P too, since K9's rows take the plain version that rounds P
    per key tile against the running maximum as the kernel does."""
    _card()
    spec = importlib.util.spec_from_file_location(
        "bf16_rounding_faults", os.path.join(ROOT, "tools", "bf16_rounding_faults.py"))
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    rows = faults.run(list(faults.FAULTS), [("tiny", 1024)])
    got = faults.verdicts(rows)
    assert set(got) == set(faults.FAULTS)
    assert all(faults.as_expected(failed, want, f) for f, (failed, want) in got.items()), got
