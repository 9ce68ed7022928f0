"""The arithmetic of the tensor-core attention (``csrc/flash_tc.cuh``) on the CPU.

The kernel behind K2, K6, K7 and K9's float32 and bf16 instances
(``flash_f32.cu``, ``flash_bf16.cu``) runs S = Q.K^T and P.V on the tensor
cores, which read float32 as TF32. :func:`emulate` repeats its arithmetic in
plain torch, step by step as the kernel takes it:

* the split of a float32 operand into two TF32 parts as the kernel makes
  it on the float32 bits: hi = x with its 13 low bits cleared, lo = x - hi
  (exact) the same way, so hi + lo is x to 2^-20 of |x|;
* float32: Q scaled by 1/sqrt(D) in float32, each operand split so, three
  products lo.hi + hi.lo + hi.hi (each exact in float32), for S and P.V;
* bf16: S = Q.K^T of the bf16 operands as they are (exact products), the
  scale joined to log2(e) in the exponent; every mode packs P to bf16
  against V (the P-unrounded mode, two TF32 parts of P against V, is the
  one ``tools/bf16_rounding_faults.py`` plants as its ``outproj_p``);
* the key tiles of 64 (32 for float32 at D 128) from key 0, the running
  maximum, p = exp2(s c - m c), the row sum unrounded, O rescaled by
  exp2(m_old c - m c) at each tile, divided by the sum clamped at 1e-30;
* the out projection as ``f32.cuh`` makes it: o stored as E, then
  E((x + o @ Wo) + bo) in float32.

Products and sums run in torch's order and exp2 is the CPU's, not the
card's ex2.approx; the card's own check is ``chip_smoke.py`` (phases
``float32`` and ``bf16_any``) and the ``gpu`` tests. One TF32 product, the
yardstick the split is held against, takes each operand rounded as
``cvt.rna.tf32.f32`` rounds it (to nearest, ties away from zero).

Held against the port's plain versions (``fused._flash_outproj_plain``,
``attention._flash_attention_plain`` and, in bf16, the tiled ones the
card's rows take: ``attention._flash_attention_tiled``,
``fused._flash_outproj_tiled``), with q/k/v from ``_ln_qkv_rope_plain`` on inputs
from a numpy seed, for each head dim of ``F32_HEAD_DIMS`` at its width,
each dtype and each mode (band, full, K9): float32 within 1e-4 (2e-4 after
the out projection), bf16 within ``chip_smoke.compare``'s bars with at most
2^-6 of the outputs differing. At r10's widths (H 4 x D 128) one TF32
product for each of S and P.V misses the float32 bar in every mode: the
split is needed. Had the bf16 projection kept P unrounded, a split of P
into two TF32 parts would move no more outputs than one into two bf16
parts.
"""

import math

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import attention as tattn
from herro_tpu_torch.ops import fused

LOG2E = 1.4426950408889634
NEG = -1e30
ATOL = 1e-4  # float32, 2e-4 after the out projection
BF16_MAX_SHARE = 2.0 ** -6
L, LENGTHS = 320, (320, 250, 0)  # five 64-key tiles; a length-0 example
BAND = 100  # across tiles, inside none
# (d, H, D): TINY_CONFIG, head dim 32, the flagship at head dim 64 (r10h64),
# model_r10_sim (r10); head dims 48, 80 and 112, and w768h96 (d 768, H 8 x 96)
WIDTHS = {16: (32, 2, 16), 32: (64, 2, 32), 64: (512, 8, 64), 128: (512, 4, 128),
          48: (96, 2, 48), 80: (160, 2, 80), 96: (768, 8, 96), 112: (224, 2, 112)}
MODES = {"band": BAND, "full": None, "k9": None}


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """x with the 13 low bits of its float32 encoding cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x):
    """x as hi + lo, each TF32, as the kernel splits an operand."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def three_products(a, b):
    """a @ b as the kernel takes float32 operands: three TF32 products."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def one_product(a, b):
    return tf32(a) @ tf32(b)


def key_tile(dtype, D):
    return 32 if dtype == torch.float32 and D > 64 else 64


def emulate(q, k, v, lengths, window, round_p=False, product=three_products, p_split="tf32"):
    """The kernel's o [B, H, L, D] in float32, before its store: ``round_p``
    K9 in bf16; ``product`` float32's products; ``p_split`` the bf16
    projection's P ("tf32" as the kernel, "bf16" for comparison)."""
    B, H, Lq, D = q.shape
    f32 = q.dtype == torch.float32
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    if f32:
        qs, c = q * scale, log2e
    else:
        qs, c = q.float(), scale * log2e
    kf, vf = k.float(), v.float()
    m = torch.full((B, H, Lq, 1), NEG)
    l = torch.zeros(B, H, Lq, 1)
    o = torch.zeros(B, H, Lq, D)
    rows = torch.arange(Lq)[:, None]
    tile = key_tile(q.dtype, D)
    for k0 in range(0, Lq, tile):
        keys = torch.arange(k0, min(k0 + tile, Lq))[None, :]
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = product(qs, kt.transpose(-1, -2)) if f32 else qs @ kt.transpose(-1, -2)
        ok = keys[None, None] < lengths[:, None, None, None]
        if window is not None:
            ok = ok & ((rows - keys).abs() <= window)[None, None]
        s = torch.where(ok, s, torch.tensor(NEG))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        mc = mn * c
        alpha = torch.exp2(m * c - mc)
        # fmaf(s, c, -mc): one rounding
        p = torch.where(ok, torch.exp2((s.double() * c.double() - mc.double()).float()), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        if f32:
            pv = product(p, vt)
        elif round_p:
            pv = p.to(torch.bfloat16).float() @ vt
        elif p_split == "tf32":
            ph, pl = split_tf32(p)
            pv = pl @ vt + ph @ vt
        else:
            ph = p.to(torch.bfloat16).float()
            pv = (p - ph).to(torch.bfloat16).float() @ vt + ph @ vt
        o = o * alpha + pv
        m = mn
    return o / l.clamp_min(1e-30)


def project(o, x, wo, bo):
    """y = E((x + E(o) @ Wo) + bo), o [B, H, L, D] float32."""
    out = torch.einsum("bhld,hdo->blo", o.to(x.dtype).float(), wo.float())
    return (x.float() + out + bo.float()).to(x.dtype)


def _inputs(seed, D, dtype):
    d, H, _ = WIDTHS[D]
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt)

    x = t(rng.normal(size=(B, L, d)))
    ln_s = t(1 + rng.normal(0, 0.1, size=(d,)), torch.float32)
    ln_b = t(rng.normal(0, 0.1, size=(d,)), torch.float32)
    w = t(rng.normal(0, d ** -0.5, size=(d, 3 * H * D)))
    b = t(rng.normal(0, 0.25, size=(3 * H * D,)))
    q, k, v = fused._ln_qkv_rope_plain(x, ln_s, ln_b, w, b, H)
    wo = t(rng.normal(0, (H * D) ** -0.5, size=(H, D, d)))
    bo = t(rng.normal(0, 0.25, size=(d,)))
    return q, k, v, x, wo, bo, torch.tensor(LENGTHS, dtype=torch.int32)


def _keep(lengths, H=None):
    keep = torch.arange(L)[None, :] < lengths[:, None]
    return keep if H is None else keep[:, None, :].expand(len(lengths), H, L)


def _err(got, want, keep):
    return float((got.float() - want.float()).abs()[keep].max())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("D", sorted(WIDTHS))
def test_float32_three_tf32_products_hold_the_float32_bars(D, mode):
    q, k, v, x, wo, bo, lengths = _inputs(100 + D, D, torch.float32)
    window = MODES[mode]
    o = emulate(q, k, v, lengths, window)
    if mode == "k9":
        want = tattn._flash_attention_plain(q, k, v, lengths, window)
        assert _err(o, want, _keep(lengths, q.shape[1])) <= ATOL
        assert not o[2].any()  # a length-0 example comes out 0
        return
    got = project(o, x, wo, bo)
    want = fused._flash_outproj_plain(q, k, v, x, wo, bo, lengths, window)
    assert _err(got, want, _keep(lengths)) <= 2 * ATOL
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("D", sorted(WIDTHS))
def test_bf16_products_hold_the_bf16_bars(D, mode):
    from chip_smoke import compare, share_differing

    q, k, v, x, wo, bo, lengths = _inputs(200 + D, D, torch.bfloat16)
    window = MODES[mode]
    if mode == "k9":
        got = emulate(q, k, v, lengths, window, round_p=True).to(torch.bfloat16)
        want = tattn._flash_attention_tiled(q, k, v, lengths, window, tile=64)
        keep, residual = _keep(lengths, q.shape[1]), None
        assert not got[2].any()
    else:
        got = project(emulate(q, k, v, lengths, window, round_p=True), x, wo, bo)
        want = fused._flash_outproj_tiled(q, k, v, x, wo, bo, lengths, window, tile=64)
        keep, residual = _keep(lengths), x
    err, tol, part_err, part_tol = compare(torch, got, want, keep, residual)
    assert err <= tol and (part_err is None or part_err <= part_tol), \
        (err, tol, part_err, part_tol)
    assert share_differing(got, want, keep) <= BF16_MAX_SHARE


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_tf32_product_misses_the_float32_bar_at_r10_widths(mode):
    """The attention output itself (K9's, and the scratch the projection
    reads): one TF32 product for S and one for P.V land above 1e-4 of the
    plain float32 version, three below it by an order."""
    q, k, v, *_, lengths = _inputs(300, 128, torch.float32)
    window = MODES[mode] if mode != "k9" else 512
    want = tattn._flash_attention_plain(q, k, v, lengths, window)
    keep = _keep(lengths, q.shape[1])
    one = _err(emulate(q, k, v, lengths, window, product=one_product), want, keep)
    three = _err(emulate(q, k, v, lengths, window), want, keep)
    assert one > ATOL and three < ATOL / 10, (one, three)


def test_tf32_split_of_p_moves_no_more_bf16_outputs_than_a_bf16_split():
    """The bf16 out projection's P at float32 precision (the mode the
    kernel keeps for the planted fault, against the CPU forward's plain
    version): as two TF32 parts against as two bf16 parts, at r10h64's
    widths, band 40."""
    from chip_smoke import share_differing

    q, k, v, x, wo, bo, lengths = _inputs(400, 64, torch.bfloat16)
    want = fused._flash_outproj_plain(q, k, v, x, wo, bo, lengths, 40)
    keep = _keep(lengths)
    shares = {s: share_differing(project(emulate(q, k, v, lengths, 40, p_split=s), x, wo, bo),
                                 want, keep) for s in ("tf32", "bf16")}
    assert shares["tf32"] <= shares["bf16"] <= BF16_MAX_SHARE, shares


def test_tf32_rounds_to_nearest_ties_away_from_zero_and_the_split_truncates():
    one = 1.0 + 2.0 ** -10  # the TF32 step above 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, 1.0 + 2.0 ** -9]
    x = torch.tensor([math.pi], dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert tf32_trunc(hi) == hi and tf32_trunc(lo) == lo
    assert abs(float(hi + lo) - float(x)) <= float(x) * 2.0 ** -20


def test_the_clock_tool_finds_its_anchors_in_the_kernel():
    """``tools/flash_tc_clocks_torch.py`` edits a copy of ``flash_tc.cuh``
    at texts that must each stand in it once."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "flash_tc_clocks_torch", os.path.join(root, "tools", "flash_tc_clocks_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(root, "herro_tpu_torch", "csrc", "flash_tc.cuh")) as fh:
        text = fh.read()
    assert [text.count(old) for old, _ in tool.EDITS] == [1] * len(tool.EDITS)
