"""The port's int8 path and its split-rope route held against herro_tpu.

On the same numpy inputs:

* ``quantize_weight``, ``_quant_rows`` and ``_int8_mm`` against the JAX
  functions of the same names, **bit-equal** (true division, round half to
  even, exact integer accumulation, the same order of the two scale
  multiplications);
* the plain versions of ``ln_qkv_rope_q`` (K10) and ``ln_ffn_q`` (K11) against
  the jnp twins and against the Pallas kernels in interpret mode, in float32
  and in bfloat16;
* the split-rope Pallas kernel (K8, ``rope_tbl=False``) against the port's
  plain ``ln_qkv_rope``;
* the int8 model against herro_tpu's int8 forward through ``params_from_jax``,
  and ``CorrectionRunner(int8=True, device="cpu")`` against herro_tpu's int8
  run, FASTA byte for byte.

Tolerances. The quantization is discontinuous: a value that rounds the other
way moves an output by one quantum, s_row * s_col * |w_i8| (up to ~1e-2 here),
so an absolute bound below that holds only while no rounding flips. In
float32 both sides compute LayerNorm, the quotient y / s and the rounding with
the same IEEE operations and the seeds here flip nothing: 1e-4 absolute, as
for the float kernels (summation order, exp/tanh/cos). In bfloat16 the
reference rounds inside gelu after each elementwise step where the port
rounds once, and a bf16 ulp of LayerNorm's output is about one quantum, so
the two sides may differ by 4 bf16 ulps at the largest magnitude
(max|ref| * 2^-6). Model logits in float32: 1e-3 (three layers of the above),
argmax equal.

The ``gpu`` tests hold the three CUDA kernels against their plain versions on
the card at the kernels' own widths (D = 128, bf16), K11's two modes and K10
at the widths of a tensor-parallel shard, and skip without a card.
"""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import cuda as kernels
from herro_tpu_torch.ops import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R10_CKPT = os.path.join(ROOT, "resources", "model_r10_sim")
B, L, d, H, D, F_FF = 2, 256, 64, 2, 32, 128
ATOL = 1e-4
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def ref():
    """herro_tpu's int8 functions, jnp twins and Pallas kernels."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import fused as jfused

    return SimpleNamespace(jax=jax, jnp=jnp, pltpu=pltpu, fused=jfused)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _j(ref, x, dtype=None):
    return ref.jnp.asarray(x) if dtype is None else ref.jnp.asarray(x, getattr(ref.jnp, dtype))


def _f32(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def _tol(want, dtype):
    return ATOL if dtype == "float32" else float(np.abs(want).max()) * 2.0 ** -6


def _ln_params(rng, d=d):
    return (
        (1 + rng.normal(0, 0.1, size=(d,))).astype(np.float32),
        rng.normal(0, 0.1, size=(d,)).astype(np.float32),
    )


def _qkv_inputs(seed, d=d, H=H, D=D, L=L):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    s, b = _ln_params(rng, d)
    w = rng.normal(0, d ** -0.5, size=(d, 3 * H * D)).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(3 * H * D,)).astype(np.float32)
    return x, s, b, w, bias


def _ffn_inputs(seed, d=d, f=F_FF, rows=B * L):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    s, b = _ln_params(rng, d)
    w1 = rng.normal(0, d ** -0.5, size=(d, f)).astype(np.float32)
    b1 = rng.normal(0, 0.1, size=(f,)).astype(np.float32)
    w2 = rng.normal(0, f ** -0.5, size=(f, d)).astype(np.float32)
    b2 = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    return x, s, b, w1, b1, w2, b2


# ---------------------------------------------------------------------------
# the quantization primitives, bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,dtype,seed",
    [((32, 48), "float32", 0), ((64, 96), "float32", 1), ((512, 1536), "bfloat16", 2),
     ((1536, 256), "float32", 3)],
)
def test_quantize_weight_bit_equal(shape, dtype, seed, ref):
    """w_i8 and s equal herro_tpu's bit for bit, also for a weight cast to
    bf16 first (the qkv kernel), an all-zero column (s clamps at 1e-12) and
    columns whose quotients land on .5 ties."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, size=shape).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = np.linspace(-1.27, 1.27, shape[0]).round(2)  # s = 0.01: ties at k + .5
    w[0, 5] = 1.27
    w[1:5, 5] = [0.005, 0.015, 0.025, -0.035]
    want_w, want_s = ref.fused.quantize_weight(_j(ref, w, dtype))
    got_w, got_s = fused.quantize_weight(_t(w, dtype))
    assert got_w.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[3] == np.float32(1e-12) and not got_w[:, 3].any()


@pytest.mark.parametrize("seed", [4, 5])
def test_quant_rows_bit_equal(seed, ref):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(64, 96)).astype(np.float32)
    y[2] = 0.0
    y[3] = np.arange(96, dtype=np.float32) * 0.5  # max 47.5: quotients on ties
    want_q, want_s = ref.fused._quant_rows(_j(ref, y))
    got_q, got_s = fused._quant_rows(_t(y))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q.dtype == torch.int8 and int(got_q.abs().max()) == 127


@pytest.mark.parametrize("K", [64, 1536])
def test_int8_mm_bit_equal(K, ref):
    """Exact integer accumulation (|acc| reaches 127 * 127 * K: past 2^24 at
    K = 1536), then the two scale multiplications in the reference's order."""
    rng = np.random.default_rng(6)
    a = rng.integers(-127, 128, size=(32, K)).astype(np.int8)
    w = rng.integers(-127, 128, size=(K, 48)).astype(np.int8)
    a[0], w[:, 0] = 127, 127
    s_row = rng.uniform(0.01, 0.05, size=(32, 1)).astype(np.float32)
    s_col = rng.uniform(0.001, 0.01, size=(48,)).astype(np.float32)
    want = ref.fused._int8_mm(*(_j(ref, v) for v in (a, s_row, w, s_col)))
    got = fused._int8_mm(*(_t(v) for v in (a, s_row, w, s_col)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k_major_is_the_same_weight_transposed_in_memory():
    w = torch.arange(-60, 60, dtype=torch.int8).reshape(8, 15)
    km = fused.k_major(w)
    assert km.shape == w.shape and torch.equal(km, w)
    assert km.t().is_contiguous() and not km.is_contiguous()


# ---------------------------------------------------------------------------
# K10, K11: the plain versions against the jnp twins and the Pallas kernels
# ---------------------------------------------------------------------------


def _qkv_q_both(ref, seed, dtype, width=d, heads=H, hd=D):
    x, s, b, w, bias = _qkv_inputs(seed, width, heads, hd)
    jw, js = ref.fused.quantize_weight(_j(ref, w, dtype))
    jargs = (_j(ref, x, dtype), _j(ref, s), _j(ref, b), jw, js, _j(ref, bias, dtype), heads)
    tw, ts = fused.quantize_weight(_t(w, dtype))
    got = fused.ln_qkv_rope_q(_t(x, dtype), _t(s), _t(b), tw, ts, _t(bias, dtype), heads)
    return jargs, got


@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_qkv_rope_q_plain_matches_jnp_twin(dtype, ref):
    jargs, got = _qkv_q_both(ref, 10, dtype)
    want = ref.fused._ln_qkv_rope_q_jnp(*jargs)
    for g, r in zip(got, want):
        assert g.shape == (B, H, L, D) and str(g.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(_f32(g), _f32(r), atol=_tol(_f32(r), dtype), rtol=0)


# (dtype, d_model, heads, head dim): the test widths, d384x5L's (H 3 x 128:
# K10's SIMT instance in bf16), TINY_CONFIG's head dim 16 and a head dim of
# 64, each in both dtypes
QKV_Q_PALLAS_WIDTHS = [(dt, d, H, D) for dt in DTYPES] + [
    (dt, *w) for w in ((384, 3, 128), (32, 2, 16), (128, 2, 64)) for dt in DTYPES]
QKV_Q_PALLAS_IDS = DTYPES + [f"{dt}-{tag}" for tag in ("d384", "hd16", "hd64")
                             for dt in DTYPES]


@pytest.mark.parametrize("dtype,width,heads,hd", QKV_Q_PALLAS_WIDTHS, ids=QKV_Q_PALLAS_IDS)
def test_ln_qkv_rope_q_plain_matches_pallas_interpret(dtype, width, heads, hd, ref):
    jargs, got = _qkv_q_both(ref, 11, dtype, width, heads, hd)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._ln_qkv_rope_q_pallas(*jargs, blk_t=64)
    for g, r in zip(got, want):
        assert g.shape == (B, heads, L, hd)
        np.testing.assert_allclose(_f32(g), _f32(r), atol=_tol(_f32(r), dtype), rtol=0)


def _ffn_q_both(ref, seed, dtype, width=d, f=F_FF):
    x, s, b, w1, b1, w2, b2 = _ffn_inputs(seed, width, f)
    j1, js1 = ref.fused.quantize_weight(_j(ref, w1))
    j2, js2 = ref.fused.quantize_weight(_j(ref, w2))
    jargs = (_j(ref, x, dtype), _j(ref, s), _j(ref, b), j1, js1, _j(ref, b1), j2, js2,
             _j(ref, b2))
    t1, ts1 = fused.quantize_weight(_t(w1))
    t2, ts2 = fused.quantize_weight(_t(w2))
    got = fused.ln_ffn_q(_t(x, dtype), _t(s), _t(b), t1, ts1, _t(b1), t2, ts2, _t(b2))
    return jargs, got


@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_ffn_q_plain_matches_jnp_twin(dtype, ref):
    jargs, got = _ffn_q_both(ref, 12, dtype)
    want = _f32(ref.fused._ln_ffn_q_jnp(*jargs))
    assert got.shape == (B * L, d) and str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(_f32(got), want, atol=_tol(want, dtype), rtol=0)


# (dtype, d_model, d_ff): the test widths, and d384x5L's (d 384, d_ff 1280:
# K11's SIMT instance in bf16, tools/variant_step_time_torch.py)
FFN_Q_PALLAS_WIDTHS = [(dt, d, F_FF) for dt in DTYPES] + [(dt, 384, 1280) for dt in DTYPES]


@pytest.mark.parametrize("dtype,width,f", FFN_Q_PALLAS_WIDTHS,
                         ids=DTYPES + [f"{dt}-d384" for dt in DTYPES])
def test_ln_ffn_q_plain_matches_pallas_interpret(dtype, width, f, ref):
    jargs, got = _ffn_q_both(ref, 13, dtype, width, f)
    with ref.pltpu.force_tpu_interpret_mode():
        want = _f32(ref.fused._ln_ffn_q_pallas(*jargs, blk_t=128))
    np.testing.assert_allclose(_f32(got), want, atol=_tol(want, dtype), rtol=0)


def test_ln_ffn_q_keeps_leading_dimensions(ref):
    """[B, L, d] in, [B, L, d] out, equal to the flattened call."""
    x, s, b, w1, b1, w2, b2 = _ffn_inputs(14)
    q1, q2 = fused.quantize_weight(_t(w1)), fused.quantize_weight(_t(w2))
    args = (_t(s), _t(b), *q1, _t(b1), *q2, _t(b2))
    flat = fused.ln_ffn_q(_t(x), *args)
    out = fused.ln_ffn_q(_t(x).reshape(B, L, d), *args)
    assert out.shape == (B, L, d) and torch.equal(out.reshape(-1, d), flat)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_block_q_matches_jax(dtype, ref):
    """The whole int8 attention block: the reference quantizes the qkv
    weight inside the call, the port takes it quantized."""
    rng = np.random.default_rng(15)
    x, s, b, w, bias = _qkv_inputs(16)
    wo = rng.normal(0, 0.1, size=(H, D, d)).astype(np.float32)
    bo = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    lengths = np.array([L, L - 70], dtype=np.int32)
    want = _f32(ref.fused.attention_block_q(
        _j(ref, x, dtype), _j(ref, s), _j(ref, b), _j(ref, w, dtype), _j(ref, bias, dtype),
        _j(ref, wo, dtype), _j(ref, bo, dtype), _j(ref, lengths), H, 64,
    ))
    got = _f32(fused.attention_block_q(
        _t(x, dtype), _t(s), _t(b), *fused.quantize_weight(_t(w, dtype)), _t(bias, dtype),
        _t(wo, dtype), _t(bo, dtype), _t(lengths), H, 64,
    ))
    tol = 2 * _tol(want, dtype)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# K8: the split-rope Pallas kernel against the port's plain ln_qkv_rope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_qkv_rope_plain_matches_split_rope_pallas_interpret(dtype, ref):
    x, s, b, w, bias = _qkv_inputs(20)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._ln_qkv_rope_pallas(
            _j(ref, x, dtype), _j(ref, s), _j(ref, b), _j(ref, w, dtype),
            _j(ref, bias, dtype), H, blk_t=64, rope_tbl=False,
        )
    got = fused.ln_qkv_rope(_t(x, dtype), _t(s), _t(b), _t(w, dtype), _t(bias, dtype), H)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(r), atol=_tol(_f32(r), dtype), rtol=0)


@pytest.mark.parametrize("gl", [1000, 9216])
def test_rope_tables_match_reference_block_tables(gl, ref):
    """The port's rope tables (K1's inputs; K8 and K10 build the same on the
    card) against herro_tpu's ``_rope_tables_blk``, which the split-rope and
    int8 TPU kernels build, at the R10 head dim (D 128) and positions 0..L-1.
    Both compute freq_i = exp(-ln(1e4) i / 64), ang = pos * freq_i and cos/sin
    in float32, each cos/sin within an ulp of the exact one; XLA's exp on the
    CPU is not correctly rounded (9 of the 64 frequencies differ from
    torch.exp's by one ulp), which moves the angle at position p by up to
    p * 2^-23 and the angle's own rounding by as much again: the bound is
    (p + 1) * 2^-22 per row, plus an ulp of the result."""
    want_c, want_s = (np.asarray(t) for t in ref.fused._rope_tables_blk(0, gl, 64))
    got_c, got_s = (t.numpy() for t in fused.rope_tables(gl, 128, "cpu"))
    assert got_c.shape == got_s.shape == (gl, 64)
    bound = (np.arange(gl, dtype=np.float64)[:, None] + 1) * 2.0 ** -22 + 2.0 ** -23
    for got, want in ((got_c, want_c), (got_s, want_s)):
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    # position 0: every angle is 0 on both sides
    assert (got_c[0] == 1).all() and (got_s[0] == 0).all()


@pytest.mark.parametrize(
    "value,name",
    [(None, "ln_qkv_rope"), ("tbl", "ln_qkv_rope"), ("split", "ln_qkv_rope_split"),
     ("anything", "ln_qkv_rope_split")],
)
def test_rope_env_picks_kernel_at_the_call(value, name, monkeypatch):
    """Read where the reference reads it: at every call, default ``tbl``,
    anything else the split route."""
    if value is None:
        monkeypatch.delenv("HERRO_TPU_ROPE", raising=False)
    else:
        monkeypatch.setenv("HERRO_TPU_ROPE", value)
    assert fused.rope_kernel_name() == name
    assert name in kernels.KERNELS


def test_rope_env_leaves_the_cpu_result_alone(monkeypatch):
    x, s, b, w, bias = map(_t, _qkv_inputs(21))
    monkeypatch.delenv("HERRO_TPU_ROPE", raising=False)
    want = fused.ln_qkv_rope(x, s, b, w, bias, H)
    monkeypatch.setenv("HERRO_TPU_ROPE", "split")
    for g, r in zip(fused.ln_qkv_rope(x, s, b, w, bias, H), want):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# the registry and the wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name", ["ln_qkv_rope_split", "ln_qkv_rope_q", "ln_ffn_q", "flash_attention"]
)
def test_kernel_has_its_own_entry_source_and_counter(name):
    entry, argtypes = kernels.KERNELS[name]
    assert entry == f"herro_{name}"
    assert [e for e, _ in kernels.KERNELS.values()].count(entry) == 1
    src = os.path.join(kernels.CSRC, f"{name}.cu")
    assert f'extern "C" int {entry}(' in open(src).read()
    assert kernels.launch_counts.snapshot()[name] >= 0 and len(argtypes) >= 11


def test_registry_holds_all_eleven_kernels():
    """The eleven Hopper kernels, one a pallas_call site of the reference,
    and beside them the four float32 kernels of the same functions, the two
    SIMT int8 ones (K10 and K11 at float32 and at every width) and the four
    bf16 SIMT ones (bf16 at the widths no Hopper instance takes)."""
    f32 = {"entry_embed_f32", "ln_qkv_rope_f32", "flash_f32", "ln_ffn_f32"}
    simt8 = {"ln_qkv_rope_q_simt", "ln_ffn_q_simt"}
    bf16 = {"entry_embed_bf16", "ln_qkv_rope_bf16", "flash_bf16", "ln_ffn_bf16"}
    assert len(set(kernels.KERNELS) - f32 - simt8 - bf16) == 11
    assert f32 | simt8 | bf16 <= set(kernels.KERNELS)
    sources = {f[:-3] for f in os.listdir(kernels.CSRC) if f.endswith(".cu")}
    assert sources == set(kernels.KERNELS)


def _bf16_qkv_q_args(seed, d=256, heads=2):
    """bf16 operands at a width the K10 kernel takes (d 256, H 2: r9's)."""
    x, s, b, w, bias = _qkv_inputs(seed, d=d, H=heads, D=128)
    w_i8, s_col = fused.quantize_weight(_t(w, "bfloat16"))
    return [_t(x, "bfloat16"), _t(s), _t(b), fused.k_major(w_i8), s_col,
            _t(bias, "bfloat16"), heads]


def _bf16_ffn_q_args(seed, d=256, f=512, rows=B * L):
    """bf16 operands at a width the K11 kernel takes."""
    x, s, b, w1, b1, w2, b2 = _ffn_inputs(seed, d=d, f=f, rows=rows)
    (q1, s1), (q2, s2) = fused.quantize_weight(_t(w1)), fused.quantize_weight(_t(w2))
    return [_t(x, "bfloat16"), _t(s), _t(b), fused.k_major(q1), s1, _t(b1),
            fused.k_major(q2), s2, _t(b2)]


@pytest.mark.parametrize(
    "wrapper,make_args",
    [("_ln_qkv_rope_q_cuda", _bf16_qkv_q_args), ("_ln_ffn_q_cuda", _bf16_ffn_q_args)],
)
def test_int8_cuda_wrappers_never_run_on_cpu_tensors(wrapper, make_args):
    """The card's wrapper raises on CPU tensors and launches nothing; only
    the public op, handed CPU tensors, takes the plain version."""
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        getattr(fused, wrapper)(*make_args(30))
    assert kernels.launch_counts.snapshot() == before


def test_split_rope_cuda_wrapper_never_runs_on_cpu_tensors(monkeypatch):
    monkeypatch.setenv("HERRO_TPU_ROPE", "split")
    x, s, b, w, bias = _qkv_inputs(31, d=256, H=2, D=128)  # a width K8 takes
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        fused._ln_qkv_rope_cuda(_t(x, "bfloat16"), _t(s), _t(b), _t(w, "bfloat16"),
                                _t(bias, "bfloat16"), 2)
    assert kernels.launch_counts.snapshot() == before


@pytest.mark.parametrize("d_model,d_ff", [(128, 512), (384, 1024), (512, 128), (512, 1536),
                                           (256, 384), (256, 1664), (512, 1088)])
def test_ln_ffn_q_cuda_wrapper_names_a_refused_width(d_model, d_ff):
    """K11 takes d_model 256 or 512 and a d_ff range for each (the hidden of
    a tile stays in shared memory): any other width raises a ValueError that
    names it, before the wrapper looks at the device (these are CPU
    tensors), and launches nothing."""
    lo, hi = fused.FFN_Q_D_FF.get(d_model, (1, 0))
    assert d_ff % 128 or not lo <= d_ff <= hi  # a width the kernel refuses
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match=rf"\(d_model, d_ff\) = \({d_model}, {d_ff}\)"):
        fused._ln_ffn_q_cuda(*_bf16_ffn_q_args(34, d=d_model, f=d_ff, rows=64))
    assert kernels.launch_counts.snapshot() == before


def test_ln_ffn_q_plain_noise_floor_of_the_layernorm_sums():
    """How often LayerNorm's summation order alone changes K11's output: the
    plain version at the R10 widths (d 512, d_ff 1024) on 4096 bf16 rows,
    against the same with LayerNorm's two sums taken in float64 (the helper
    chip_smoke.py runs on the card beside the kernel). A sum one ulp apart
    flips the bf16 rounding of a LayerNorm value now and then; one int8 value
    of a row moves every output of that row. Measured here: one row of 4096,
    1.25e-4 of the outputs; the share must be above 0 (the order matters) and
    below 1e-3, far below the 1.96% by which the earlier mma.sync kernel
    departed from the plain version on the card."""
    from chip_smoke import float64_layernorm_sums

    x, s, b, w1, b1, w2, b2 = _ffn_inputs(0, d=512, f=1024, rows=4096)
    (q1, s1), (q2, s2) = fused.quantize_weight(_t(w1)), fused.quantize_weight(_t(w2))
    args = (_t(x, "bfloat16"), _t(s), _t(b), q1, s1, _t(b1), q2, s2, _t(b2))
    want = fused._ln_ffn_q_plain(*args)
    other = float64_layernorm_sums(fused, fused._ln_ffn_q_plain, *args)
    differ = want != other
    share = float(differ.float().mean())
    assert 0 < share < 1e-3, share
    rows = differ.any(dim=-1)
    # where a row moves, about half its outputs change their last bf16 bit
    assert 0 < int(rows.sum()) <= 4 and float(differ[rows].float().mean()) > 0.2


def test_ln_qkv_rope_q_plain_noise_floor_of_the_layernorm_sums():
    """The same floor for K10's qkv path: the plain version at the R10 widths
    (d 512, H 4) on the 4096 LayerNorm rows of the K11 test above, against
    LayerNorm's two sums in float64. The one row whose bf16 LayerNorm value
    flips there moves its int8 row and so a share of its q, k and v: the
    share of each output is above 0 and below 1e-3. ``chip_smoke.py`` holds
    the kernel on the card to at most twice this floor (and the ``gpu`` test
    below)."""
    from chip_smoke import float64_layernorm_sums, share_differing

    x, s, b = _ffn_inputs(0, d=512, f=1024, rows=4096)[:3]
    w = np.random.default_rng(5).normal(0, 512 ** -0.5, size=(512, 3 * 4 * 128))
    w_i8, s_col = fused.quantize_weight(_t(w.astype(np.float32), "bfloat16"))
    bias = np.random.default_rng(6).normal(0, 0.25, size=(3 * 4 * 128,))
    args = (_t(x, "bfloat16").reshape(1, 4096, 512), _t(s), _t(b), w_i8, s_col,
            _t(bias.astype(np.float32), "bfloat16"), 4)
    want = fused._ln_qkv_rope_q_plain(*args)
    other = float64_layernorm_sums(fused, fused._ln_qkv_rope_q_plain, *args)
    share = share_differing(other, want)
    assert 0 < share < 1e-3, share
    rows = [(a != r).any(dim=-1) for a, r in zip(other, want)]  # [1, H, L] each
    assert 0 < int(rows[0].any(dim=1).sum()) <= 4  # the flipped LayerNorm rows


def test_int8_cuda_wrappers_want_k_major_weights():
    args = _bf16_qkv_q_args(32)
    args[3] = args[3].contiguous()  # the reference's [in, out] layout
    with pytest.raises(ValueError, match="k-major"):
        fused._ln_qkv_rope_q_cuda(*args)
    args = _bf16_ffn_q_args(33)
    args[6] = args[6].contiguous()
    with pytest.raises(ValueError, match="k-major"):
        fused._ln_ffn_q_cuda(*args)


# ---------------------------------------------------------------------------
# the int8 model and runner against herro_tpu's
# ---------------------------------------------------------------------------


def _model_inputs(seed, Bm=3, Lm=96, S=16):
    from herro_tpu_torch.constants import N_ROWS

    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 11, size=(Bm, N_ROWS, Lm)).astype(np.uint8)
    valid = min(70, Lm - 10)
    tok[1, :, valid:] = 11
    quals = rng.uniform(-1, 1, size=(Bm, N_ROWS, Lm)).astype(np.float32)
    sidx = np.sort(rng.integers(0, valid, size=(Bm, S)), axis=1).astype(np.int32)
    smask = np.ones((Bm, S), bool)
    smask[0, 12:] = False
    return tok, quals, sidx, smask


MODEL_CASES = {
    "tiny": {},
    "banded-3-layers": dict(local_window=24, n_layers=3),
    "wide-ffn": dict(d_ff=192, n_layers=1),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_int8_model_logits_match_jax_float32(case, ref):
    from herro_tpu.models import model as jmodel
    from herro_tpu_torch.models.checkpoint import params_from_jax
    from herro_tpu_torch.models.model import CorrectionModel, ModelConfig

    jcfg = dataclasses.replace(jmodel.TINY_CONFIG, int8=True, **MODEL_CASES[case])
    params = jmodel.init_params(jcfg, ref.jax.random.PRNGKey(9))
    inputs = _model_inputs(40)
    j_info, j_logits = jmodel.CorrectionModel(jcfg).apply(params, *map(ref.jnp.asarray, inputs))
    model = CorrectionModel(ModelConfig(**dataclasses.asdict(jcfg)))
    assert model.cfg.int8
    model.load_state_dict(params_from_jax(ref.jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        info, logits = model(*map(_t, inputs))
    mask = inputs[3]
    assert np.abs(logits.numpy() - np.asarray(j_logits))[mask].max() <= 1e-3
    assert np.abs(info.numpy() - np.asarray(j_info))[mask].max() <= 1e-3
    np.testing.assert_array_equal(
        logits.numpy().argmax(-1)[mask], np.asarray(j_logits).argmax(-1)[mask]
    )


def test_int8_model_tracks_the_float_model():
    """The reference's own bar (tests/test_model.py): the int8 forward decodes
    the same class as the float forward on >= 95% of the columns, with a
    logit gap that is quantization noise, not a broken path."""
    from herro_tpu_torch.models.model import CONFIGS, CorrectionModel

    cfg = CONFIGS["tiny"]
    model = CorrectionModel(cfg, generator=torch.Generator().manual_seed(3))
    model_q = CorrectionModel(dataclasses.replace(cfg, int8=True))
    model_q.load_state_dict(model.state_dict())
    inputs = [_t(a) for a in _model_inputs(41, Bm=4, Lm=64)]
    with torch.inference_mode():
        _, logits = model(*inputs)
        _, logits_q = model_q(*inputs)
    assert not torch.equal(logits, logits_q)  # the int8 branch did run
    agree = (logits.argmax(-1) == logits_q.argmax(-1)).float().mean()
    assert agree >= 0.95 and (logits - logits_q).abs().max() < 1.5


def test_int8_compute_weights_follow_the_reference(ref):
    """qkv is quantized after its cast to the compute dtype, the FFN kernels
    from the float32 parameters; b_qkv is in the compute dtype, the FFN biases
    float32; the out projection stays in the compute dtype. Built once per
    parameter state, k-major."""
    from herro_tpu_torch.models.model import CONFIGS, CorrectionModel

    cfg = dataclasses.replace(CONFIGS["tiny"], dtype="bfloat16", int8=True)
    model = CorrectionModel(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)  # biases start at 0
    with torch.inference_mode():
        w = model.compute_weights()
        assert model.compute_weights() is w
    blk, bw = model.blocks[1], w["blocks"][1]
    assert "w_qkv" not in bw and "w1" not in bw and "w2" not in bw
    bf = ref.jnp.bfloat16
    for key, skey, kernel in (
        ("wqkv_i8", "sqkv", ref.jnp.asarray(blk.attn.qkv_kernel.detach().numpy(), bf)),
        ("w1_i8", "s1", ref.jnp.asarray(blk.ff1.kernel.detach().numpy())),
        ("w2_i8", "s2", ref.jnp.asarray(blk.ff2.kernel.detach().numpy())),
    ):
        want_w, want_s = ref.fused.quantize_weight(kernel)
        np.testing.assert_array_equal(bw[key].numpy(), np.asarray(want_w))
        np.testing.assert_array_equal(bw[skey].numpy(), np.asarray(want_s))
        assert bw[key].t().is_contiguous()
    assert bw["b_qkv"].dtype == bw["wo"].dtype == bw["bo"].dtype == torch.bfloat16
    assert bw["b1"].dtype == bw["b2"].dtype == torch.float32
    assert torch.equal(bw["b1"], blk.ff1.bias) and torch.equal(bw["b2"], blk.ff2.bias)


@pytest.mark.parametrize(
    "in_config,flag,want",
    [(False, True, True), (True, False, False), (True, None, True), (False, None, False)],
)
def test_runner_int8_flag_overrides_the_config(in_config, flag, want):
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    cfg, params = load_or_init("tiny")
    cfg = dataclasses.replace(cfg, int8=in_config)
    runner = CorrectionRunner(cfg, params, int8=flag, device="cpu")
    assert runner.cfg.int8 is want and runner.model.cfg.int8 is want
    assert ("w1_i8" in runner.model.compute_weights()["blocks"][0]) is want


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from herro_tpu.training.simulate import paf_rows, simulate

    tmp = tmp_path_factory.mktemp("torch_int8")
    ds = simulate(genome_len=2500, n_reads=30, read_len=(900, 1600), sub_rate=0.01,
                  ins_rate=0.005, del_rate=0.005, seed=11)
    fastq = tmp / "reads.fastq"
    ds.write_fastq(str(fastq))
    return tmp, str(fastq), paf_rows(ds, min_overlap=200)


WINDOW = 256
SPEC = dict(lengths=(320, 512, 1024), sup_fractions=(0.25, 1.0))


def _fasta(pkg, fastq, rows, out, **runner_kw):
    """``run_correction`` of package ``pkg`` (herro_tpu or herro_tpu_torch) with
    the flagship weights in float32 and int8=True."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    cfg, params = mod("models.checkpoint").load_model(R10_CKPT)
    cfg = dataclasses.replace(cfg, dtype="float32")
    runner = mod("pipeline.infer").CorrectionRunner(cfg, params, int8=True, **runner_kw)
    assert runner.cfg.int8
    reads = mod("io.fastx").load_reads(fastq, min_length=WINDOW)
    grouped = mod("overlaps.paf").parse_paf(rows, reads.name_to_id)
    n = mod("pipeline.engine").run_correction(
        reads, iter(grouped.items()), runner, out, WINDOW, 4,
        bucket_spec=mod("pipeline.batching").BucketSpec(**SPEC),
    )
    return n, open(out, "rb").read()


def test_int8_fasta_identical_to_jax_float32(dataset):
    tmp, fastq, rows = dataset
    n_ref, want = _fasta("herro_tpu", fastq, rows, str(tmp / "jax.fasta"))
    n, got = _fasta("herro_tpu_torch", fastq, rows, str(tmp / "port.fasta"), device="cpu")
    assert n == n_ref > 0
    assert got == want


def test_cli_int8_on_cpu(dataset, monkeypatch):
    """``inference --int8`` through the CLI on the CPU writes what the runner
    with int8=True writes, and not what the float run writes; ``--no-int8``
    takes the float path."""
    from herro_tpu_torch import cli
    from herro_tpu_torch.overlaps.batches import BatchWriter

    tmp, fastq, rows = dataset
    aln_dir = str(tmp / "alns")
    with BatchWriter(aln_dir, 0, sorted({r.split(b"\t")[5] for r in rows})) as bw:
        for r in rows:
            bw.write(r)
    seen = []
    from herro_tpu_torch.pipeline import infer

    class Spy(infer.CorrectionRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self.cfg.int8)

    monkeypatch.setattr(infer, "CorrectionRunner", Spy)
    outs = {}
    for flag in ("--int8", "--no-int8"):
        outs[flag] = str(tmp / f"cli{flag}.fasta")
        cli.main(["inference", "--device", "cpu", "--read-alns", aln_dir, "-m", "tiny",
                  flag, "-w", str(WINDOW), "-b", "4", fastq, outs[flag]])
    assert seen == [True, False]
    assert open(outs["--int8"], "rb").read().count(b">") > 0


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions, on the card
# ---------------------------------------------------------------------------

GPU_D, GPU_H = 256, 2  # r10deep / r9 widths
GPU_LENGTHS = [1024, 1000]  # whole blocks, and a ragged tail block


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_close(got, want):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=np.abs(want).max() * 2.0 ** -6, rtol=0)


def _launched(before):
    after = kernels.launch_counts.snapshot()
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}


# the qkv kernels at both shipped widths, (H, d) 2/256 (r9, r10deep) and
# 4/512 (r10); rows B x L of 1 x 1, 1 x 37 (a ragged tile, fewer tiles than
# SMs), 2 x GPU_LENGTHS (whole tiles, and a tile that ends mid-example) and
# 32 x 1000 (many tiles per SM, each example's last tile ragged)
QKV_WIDTHS = [(2, 256), (4, 512)]
QKV_ROWS = [(1, 1), (1, 37), *((2, gl) for gl in GPU_LENGTHS), (32, 1000)]


def _qkv_card_args(seed, heads, width, nb, gl, dev):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, gl, width)).astype(np.float32)
    s, b = _ln_params(rng, width)
    w = rng.normal(0, width ** -0.5, size=(width, 3 * heads * 128)).astype(np.float32)
    bias = rng.normal(0, 0.25, size=(3 * heads * 128,)).astype(np.float32)
    return (_t(x, "bfloat16").to(dev), _t(s).to(dev), _t(b).to(dev),
            _t(w, "bfloat16").to(dev), _t(bias, "bfloat16").to(dev), heads)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", QKV_WIDTHS)
@pytest.mark.parametrize("nb,gl", QKV_ROWS)
def test_split_rope_kernel_matches_plain_and_table_kernel_on_card(heads, width, nb, gl):
    """K8 builds the tables K1 reads, bit for bit, and shares the rest of
    its code: the two kernels give the same bits."""
    dev = _card()
    args = _qkv_card_args(50, heads, width, nb, gl, dev)
    before = kernels.launch_counts.snapshot()
    got = fused._ln_qkv_rope_cuda(*args, kernel="ln_qkv_rope_split")
    torch.cuda.synchronize()
    assert _launched(before) == {"ln_qkv_rope_split": 1}
    tbl = fused._ln_qkv_rope_cuda(*args, kernel="ln_qkv_rope")
    for g, r, t in zip(got, fused._ln_qkv_rope_plain(*args), tbl):
        _bf16_close(g, r)
        assert torch.equal(g, t)


def _qkv_q_card_args(seed, heads, width, nb, gl, dev):
    x, s, b, w, bias, heads = _qkv_card_args(seed, heads, width, nb, gl, dev)
    w_i8, s_col = fused.quantize_weight(w)
    return x, s, b, fused.k_major(w_i8), s_col, bias, heads


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", QKV_WIDTHS)
@pytest.mark.parametrize("nb,gl", QKV_ROWS)
def test_ln_qkv_rope_q_kernel_matches_plain_on_card(heads, width, nb, gl):
    dev = _card()
    args = _qkv_q_card_args(51, heads, width, nb, gl, dev)
    before = kernels.launch_counts.snapshot()
    got = fused._ln_qkv_rope_q_cuda(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {"ln_qkv_rope_q": 1}
    for g, r in zip(got, fused._ln_qkv_rope_q_plain(*args)):
        _bf16_close(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", QKV_WIDTHS)
def test_ln_qkv_rope_q_kernel_differs_at_most_twice_the_floor_on_card(heads, width):
    """K10 follows the plain version's roundings but for the order of
    LayerNorm's two sums: the share of its outputs that differ from the plain
    version is at most twice the share by which the plain version moves when
    those sums run in float64 (``test_ln_qkv_rope_q_plain_noise_floor_of_the_
    layernorm_sums``'s floor, here on the card over 131,072 rows, tens of
    them flipped)."""
    from chip_smoke import float64_layernorm_sums, share_differing

    dev = _card()
    args = _qkv_q_card_args(53, heads, width, 32, 4096, dev)
    got = fused._ln_qkv_rope_q_cuda(*args)
    want = fused._ln_qkv_rope_q_plain(*args)
    floor = share_differing(float64_layernorm_sums(fused, fused._ln_qkv_rope_q_plain, *args),
                            want)
    share = share_differing(got, want)
    assert 0 < floor < 1e-3
    assert share <= 2 * floor, (share, floor)


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,f,rows,zero_rows", [
    pytest.param(GPU_D, 512, 2 * 1024, False, id="1024-512"),
    pytest.param(GPU_D, 512, 2 * 1000, False, id="1000-512"),
    pytest.param(GPU_D, 1536, 2 * 1000, False, id="1000-1536"),
    pytest.param(512, 1024, 2000, False, id="r10-ragged"),
    pytest.param(512, 1024, 50, False, id="r10-T50"),
    pytest.param(256, 1536, 40, False, id="r9-T40"),
    # three tiles: the second block of the second cluster runs past T
    pytest.param(512, 1024, 130, False, id="r10-cluster-tail"),
    pytest.param(256, 1536, 130, False, id="r9-cluster-tail"),
    pytest.param(512, 1024, 300, True, id="r10-zero-hidden"),
    pytest.param(256, 1536, 300, True, id="r9-zero-hidden"),
])
def test_ln_ffn_q_kernel_matches_plain_on_card(d_model, f, rows, zero_rows):
    """Both shipped widths, (512, 1024) and the r9 (256, 1536), whose hidden
    leaves a two-slot ring; T not a multiple of 64, below 64, and a
    cluster's last tile past T. ``zero_rows``: every 7th row constant, with
    LayerNorm's bias and b1 zero, so that its y and its hidden are all zero
    (both scales clamp at 1e-12) and its output is x + b2."""
    dev = _card()
    x, s, b, w1, b1, w2, b2 = _ffn_inputs(52, d=d_model, f=f, rows=rows)
    if zero_rows:
        x[::7] = 0.5
        b[:] = 0.0
        b1[:] = 0.0
    (q1, s1), (q2, s2) = (fused.quantize_weight(_t(w).to(dev)) for w in (w1, w2))
    args = (_t(x, "bfloat16").to(dev), _t(s).to(dev), _t(b).to(dev), fused.k_major(q1), s1,
            _t(b1).to(dev), fused.k_major(q2), s2, _t(b2).to(dev))
    before = kernels.launch_counts.snapshot()
    got = fused._ln_ffn_q_cuda(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {"ln_ffn_q": 1}
    want = fused._ln_ffn_q_plain(*args)
    _bf16_close(got, want)
    if zero_rows:
        zero = (args[0][::7].float() + args[-1].float()).to(torch.bfloat16)
        assert torch.equal(got[::7], zero) and torch.equal(want[::7], zero)


# K11's two modes at the widths of a tensor-parallel shard, K10 at a shard's
# head counts (parallel/tensor.py)
# (d_model, d_ff / tp, tp): r10 at tp 2 and 4, r9 at tp 2, r10deep at tp 2
FFN_SHARDS = [(512, 512, 2), (512, 256, 4), (256, 768, 2), (256, 512, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,f_loc,tp", FFN_SHARDS)
@pytest.mark.parametrize("rows", [2000, 130])
def test_ffn_q_modes_match_plain_on_card(d_model, f_loc, tp, rows):
    """Mode A's row maxima and tied counts (asked for, or the maxima alone:
    the same bits) equal the plain version's but where LayerNorm's
    summation order moves a row (at most 2, or 1 in 500 rows); mode B, fed
    the plain maxima, matches its plain version within 2^-6 of the largest
    output, and so does the whole kernel at these widths (below d_ff 2 x
    d_model at d 512: x in a buffer of its own)."""
    dev = _card()
    x, s, b, w1, b1, w2, b2 = _ffn_inputs(52, d=d_model, f=f_loc, rows=rows)
    (q1, s1), (q2, s2) = (fused.quantize_weight(torch.from_numpy(w).to(dev)) for w in (w1, w2))
    t = lambda a: torch.from_numpy(a).to(dev)
    xs = t(x).to(torch.bfloat16)
    head = (xs, t(s), t(b), fused.k_major(q1), s1, t(b1))
    before = kernels.launch_counts.snapshot()
    hmax, ties = fused._ln_ffn_q_rowmax_cuda(*head, ties=True)
    hmax_alone, no_ties = fused._ln_ffn_q_rowmax_cuda(*head)
    want_max, want_ties = fused._ln_ffn_q_rowmax_plain(*head, ties=True)
    got = fused._ln_ffn_q_rowscale_cuda(*head, fused.k_major(q2), s2, t(b2) / tp, want_max,
                                        1.0 / tp)
    whole = fused._ln_ffn_q_cuda(*head, fused.k_major(q2), s2, t(b2))
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "ln_ffn_q_rowmax": 2, "ln_ffn_q_rowscale": 1, "ln_ffn_q": 1}
    assert torch.equal(hmax, hmax_alone) and no_ties is None
    assert int((hmax != want_max).sum()) <= max(2, rows // 500)
    assert ties.dtype == torch.int32 and int(ties.min()) >= 1
    assert int((ties != want_ties).sum()) <= max(2, rows // 500)
    want = fused._ln_ffn_q_rowscale_plain(*head, fused.k_major(q2), s2, t(b2) / tp,
                                          want_max, 1.0 / tp)
    for a, r in ((got, want), (whole, fused._ln_ffn_q_plain(*head, fused.k_major(q2), s2,
                                                            t(b2)))):
        a, r = a.float(), r.float()
        assert bool(torch.isfinite(a).all())
        assert float((a - r).abs().max()) <= float(r.abs().max()) * 2.0 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", [(2, 512), (1, 512), (1, 256)])
def test_ln_qkv_rope_q_kernel_at_shard_heads_on_card(heads, width):
    """K10 at the head counts of a shard (r10 at tp 2 and 4, r10deep at tp 2)
    against its plain version, within 2^-6 of the largest output."""
    dev = _card()
    rng = np.random.default_rng(54)
    x = torch.from_numpy(rng.normal(size=(2, 1000, width)).astype(np.float32))
    s = torch.from_numpy((1 + rng.normal(0, 0.1, size=(width,))).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, size=(width,)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, width ** -0.5, size=(width, 3 * heads * 128))
                         .astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.25, size=(3 * heads * 128,)).astype(np.float32))
    w_i8, s_col = fused.quantize_weight(w.to(dev, torch.bfloat16))
    args = (x.to(dev, torch.bfloat16), s.to(dev), b.to(dev), fused.k_major(w_i8), s_col,
            bias.to(dev, torch.bfloat16), heads)
    for g, r in zip(fused._ln_qkv_rope_q_cuda(*args), fused._ln_qkv_rope_q_plain(*args)):
        g, r = g.float(), r.float()
        assert bool(torch.isfinite(g).all())
        assert float((g - r).abs().max()) <= float(r.abs().max()) * 2.0 ** -6
