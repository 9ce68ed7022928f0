"""The arithmetic of the tensor-core tile product (``csrc/gemm_tc.cuh``) on the CPU.

K1/K8 (``ln_qkv_rope_f32``, ``_bf16`` and their ``_split`` routes) and K3
(``ln_ffn_f32``, ``ln_ffn_bf16``) take their products on the tensor cores,
which read float32 as TF32. :func:`product` repeats the float32 arithmetic
in plain torch, step by step as the kernel takes it:

* each operand split into two TF32 parts on its float32 bits (hi: the 13
  low bits cleared; lo = x - hi, the same way), as ``split_tf32`` splits a
  fragment;
* three products, lo.hi + hi.lo + hi.hi, each exact in float32;
* k in stages of 32, each stage's sum from zero, added to the float32
  accumulator at round-to-nearest (the tensor cores round their own sums
  toward zero, so no sum is carried through them from stage to stage).

Products and sums inside a stage run in torch's order, not the tensor
cores'; the card's own check is ``chip_smoke.py`` (phases ``float32`` and
``bf16_any``). At r10's widths in float32 (d 512, H 4 x 128, d_ff 1024; B
x L = 2 x 256) the emulated K1 and K3, with LayerNorm, the bias, the rope,
gelu and the residual as the plain versions take them, hold herro_tpu's
Pallas kernels (``_ln_qkv_rope_pallas``, ``_ln_ffn_pallas``) in interpret
mode within 1e-4; one TF32 product (each operand rounded as
``cvt.rna.tf32.f32`` rounds it) misses that bar for both, so the kernel
takes three. ``tools/bf16_rounding_faults.py``'s anchors of the
tile product's roundings stand in the device code the tensor-core
instances run.

K2/K6/K7's out projection on the same tile product (``flash_tc.cuh:project``,
which bf16 takes; float32 keeps FFMA there, as the three TF32 products moved
the int8 r10 golden past its frozen bar on the card) is held the same way
in float32: herro_tpu's banded attention
and projection (``_banded_flash_outproj_rot_pallas``) in interpret mode at
r10's widths against the port's plain attention (P unrounded in float32)
then the emulated product, K = H D 512 and N = d 512, in
``kEpiResidualAfter``'s order ((x + o @ Wo) + bo), within 2e-4 on the rows
inside the length.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from herro_tpu_torch.ops import fused
from test_torch_flash_tc import split_tf32, tf32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "herro_tpu_torch", "csrc")
ATOL = 1e-4
ATOL_PROJ = 2e-4  # after the out projection's extra contraction (chip_smoke.F32_ATOL_PROJ)
KBK = 32  # k a stage (gemm_tc.cuh kBK)
B, L, d, H, D, F_FF = 2, 256, 512, 4, 128, 1024  # model_r10_sim's widths
WINDOW, BLK = 128, 64  # the band and the Pallas kernel's block (w % blk == 0)
LENGTHS = (L, L - 70)


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import fused as jfused

    return jnp, pltpu, jfused


def three(a, w):
    ah, al = split_tf32(a)
    wh, wl = split_tf32(w)
    return (al @ wh + ah @ wl) + ah @ wh


def one(a, w):
    return tf32(a) @ tf32(w)


def product(a, w, take=three):
    """a [T, K] @ w [K, N] in float32 as the kernel sums it: each stage of
    KBK k from zero, the stages added in order."""
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], KBK):
        acc = acc + take(a[:, k0:k0 + KBK], w[k0:k0 + KBK])
    return acc


def qkv(x, s, b, w, bias, take):
    y = fused.layernorm(x, s, b).reshape(-1, d)
    out = (product(y, w, take) + bias).reshape(B, L, 3, H, D)
    return fused._rope_split_heads(out)


def ffn(x, s, b, w1, b1, w2, b2, take):
    xf = x.reshape(-1, d)
    h = F.gelu(product(fused.layernorm(xf, s, b), w1, take) + b1, approximate="tanh")
    return (xf + (product(h, w2, take) + b2)).reshape(x.shape)


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, mean=0.0):
        return torch.from_numpy(rng.normal(mean, std, size=shape).astype(np.float32))

    x = t(B, L, d)
    s, b = t(d, std=0.1, mean=1.0), t(d, std=0.1)
    w, bias = t(d, 3 * H * D, std=d ** -0.5), t(3 * H * D, std=0.25)
    w1, b1 = t(d, F_FF, std=d ** -0.5), t(F_FF, std=0.25)
    w2, b2 = t(F_FF, d, std=F_FF ** -0.5), t(d, std=0.25)
    return x, s, b, w, bias, w1, b1, w2, b2


def _attn_inputs(seed):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy(rng.normal(0.0, std, size=shape).astype(np.float32))

    q, k, v = (t(B, H, L, D) for _ in range(3))
    x = t(B, L, d)
    wo, bo = t(H, D, d, std=(H * D) ** -0.5), t(d, std=0.25)
    return q, k, v, x, wo, bo, torch.tensor(LENGTHS, dtype=torch.int32)


def outproj(q, k, v, x, wo, bo, lengths, take):
    """K2's function with the projection as the tile product sums it: the
    attention's output o [T, H D] (the scratch's layout) against Wo [H D, d],
    then (x + o @ Wo) + bo."""
    from herro_tpu_torch.ops.attention import chunked_attention

    o = chunked_attention(q, k, v, lengths, WINDOW).permute(0, 2, 1, 3).reshape(-1, H * D)
    y = (x.reshape(-1, d) + product(o, wo.reshape(H * D, d), take)) + bo
    return y.reshape(B, L, d)


def _valid(y):
    """The rows inside each example's length (the rest are padding)."""
    y = np.asarray(y)
    return np.concatenate([y[b, :n] for b, n in enumerate(LENGTHS)])


def _gap(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float(np.abs(g.numpy() - np.asarray(r)).max()) for g, r in zip(got, want))


@pytest.fixture(scope="module")
def pallas(ref):
    """herro_tpu's K1 (the table route) and K3 on the inputs, in interpret mode."""
    jnp, pltpu, jfused = ref
    x, s, b, w, bias, w1, b1, w2, b2 = _inputs(7)
    j = jnp.asarray
    with pltpu.force_tpu_interpret_mode():
        k1 = jfused._ln_qkv_rope_pallas(*map(j, (x, s, b, w, bias)), H, blk_t=L, rope_tbl=True)
        k3 = jfused._ln_ffn_pallas(*map(j, (x.reshape(-1, d), s, b, w1, b1, w2, b2)), blk_t=256)
    a = _attn_inputs(9)
    k2 = jfused._banded_flash_outproj_rot_pallas(*map(j, a), WINDOW, blk=BLK, interpret=True)
    return {"ln_qkv_rope": k1, "ln_ffn": np.asarray(k3).reshape(B, L, d),
            "flash_outproj": _valid(k2)}


def _emulated(kernel, take):
    x, s, b, w, bias, w1, b1, w2, b2 = _inputs(7)
    if kernel == "ln_qkv_rope":
        return qkv(x, s, b, w, bias, take)
    if kernel == "flash_outproj":
        return torch.from_numpy(_valid(outproj(*_attn_inputs(9), take)))
    return ffn(x, s, b, w1, b1, w2, b2, take)


BARS = {"ln_qkv_rope": ATOL, "ln_ffn": ATOL, "flash_outproj": ATOL_PROJ}


@pytest.mark.parametrize("kernel", ["ln_qkv_rope", "ln_ffn", "flash_outproj"])
def test_three_tf32_products_hold_the_float32_bar_against_pallas(kernel, pallas):
    """Measured: K1 3.3e-5 (the plain version itself 3.3e-5: the rope
    tables' cos/sin), K3 4.1e-6 (plain 2.9e-6), K2's projection 7.2e-7 (plain
    7.2e-7; one TF32 product 2.4e-4)."""
    assert _gap(_emulated(kernel, three), pallas[kernel]) <= BARS[kernel]


@pytest.mark.parametrize("kernel", ["ln_qkv_rope", "ln_ffn"])
def test_one_tf32_product_misses_the_float32_bar_at_r10_widths(kernel, pallas):
    """Measured: K1 1.5e-3, K3 1.3e-3, over ten times the bar."""
    assert _gap(_emulated(kernel, one), pallas[kernel]) > 10 * ATOL


def test_stage_sums_match_one_float32_product_to_its_rounding():
    """The stages' sums from zero against one float32 product of the whole
    k: within float32's own error of a sum of 512 terms."""
    x, _, _, w, *_ = _inputs(8)
    a = x.reshape(-1, d)
    want = (a.double() @ w.double()).float()
    assert float((product(a, w) - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("fault", ["ln_output", "qkv_bias", "ffn_bias"])
def test_rounding_fault_anchors_stand_in_the_tensor_core_code(fault):
    """Each anchor is in its source once, in a helper that the tensor-core
    kernels (gemm_tc.cuh, the qkv kernel of ln_qkv_rope_simt.cuh) and the
    narrow ones at d 32 (narrow.cuh) both call: LayerNorm's output
    (ln_apply), qkv's bias (qkv_bias), the FFN's bias (epilogue)."""
    spec = importlib.util.spec_from_file_location(
        "bf16_rounding_faults", os.path.join(ROOT, "tools", "bf16_rounding_faults.py"))
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    src, old, _, _ = faults.FAULTS[fault]

    def text(name):
        with open(os.path.join(CSRC, name)) as fh:
            return fh.read()

    assert text(src).count(old) == 1
    helper = {"ln_output": ("f32.cuh", "ln_apply<E>("), "qkv_bias": ("ln_qkv_rope_simt.cuh",
              "qkv_bias<E>("), "ffn_bias": ("f32.cuh", "epilogue<E, kEpi")}[fault]
    assert src == helper[0]
    # the helper is called by the tensor-core code and by the narrow kernels
    qkv_src = text("ln_qkv_rope_simt.cuh")
    tc, narrow = text("gemm_tc.cuh") + qkv_src, text("narrow.cuh")
    assert tc.count(helper[1]) >= 1 and narrow.count(helper[1]) >= 1
    assert '#include "gemm_tc.cuh"' in qkv_src and '#include "ln_qkv_rope_simt.cuh"' in narrow
    assert all('#include "narrow.cuh"' in text(f"{k}_{s}.cu")
               for k in ("ln_ffn", "ln_qkv_rope") for s in ("f32", "bf16"))


def test_outproj_entry_refuses_what_its_kernel_does_not_take():
    """``fused._outproj_cuda`` (the out projection's own entry point, for its
    rows on the card) names an out projection mode, the instance's dtype
    and card tensors before any launch."""
    o, x = torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 32)
    wo, bo = torch.zeros(2, 16, 32), torch.zeros(32)
    with pytest.raises(ValueError, match="no out projection"):
        fused._outproj_cuda(o, x, wo, bo, "flash_f32")
    with pytest.raises(ValueError, match="takes torch.float32"):
        fused._outproj_cuda(o.bfloat16(), x.bfloat16(), wo.bfloat16(), bo.bfloat16(),
                            "flash_f32_outproj")
    with pytest.raises(ValueError, match="o/x/wo/bo shapes"):
        fused._outproj_cuda(o, x, wo[:, :8], bo, "flash_f32_outproj")
    with pytest.raises(ValueError, match="not on the card"):
        fused._outproj_cuda(o, x, wo, bo, "flash_f32_outproj")
    # the plain version: herro_tpu's projection order on o [B, L, H, D]
    o = torch.randn(1, 8, 2, 16)
    x, wo, bo = torch.randn(1, 8, 32), torch.randn(2, 16, 32), torch.randn(32)
    want = (x + torch.einsum("blhd,hdo->blo", o, wo) + bo)
    assert torch.allclose(fused._outproj_plain(o, x, wo, bo), want, atol=1e-6)
