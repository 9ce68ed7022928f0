"""K2/K6/K7's bf16 P: rounded to bf16 before P.V, as herro_tpu's Pallas kernels round it.

herro_tpu's three attention + out projection kernels each take
``p.astype(v.dtype)`` before P.V (``herro_tpu/ops/fused.py``: K7
``_flash_outproj_kernel`` over key tiles of its ``blk_k`` 512 against the
running maximum; K6 ``_banded_flash_outproj_kernel`` and K2
``_banded_flash_outproj_rot_kernel`` against one maximum over the whole
band). The port's bf16 SIMT instance (``csrc/flash_tc.cuh``) rounds P the
same way over 64-key tiles; its yardstick on the card is
``fused._flash_outproj_tiled``. The CPU forward's plain version,
``fused._flash_outproj_plain``, keeps P at float32 precision as herro_tpu's
jnp twin does.

On the CPU, in bf16 at TINY_CONFIG's widths (H 2 x D 16, d 32), L=1536,
lengths 1536 / 1400 / 700, against the Pallas kernel herro_tpu takes at
each band (``_flash_outproj_pallas``: None -> K7, 512 -> K2, 40 -> K6) in
interpret mode, the share of outputs below each length that differ at all:

* under the port's projection (every head's part summed in float32, one
  rounding: K2's order), measured (seed 41): P unrounded 0.335 / 0.189 /
  0.351 (None / 512 / 40), P rounded per 64-key tile 0.309 / 0.139 / 0.307;
* under the reference kernel's own projection order (K6 and K7 round the
  sum to bf16 after each head, K2 as the port), which isolates P:
  unrounded 0.171 / 0.189 / 0.192, the 64-key tiles 0.096 / 0.139 / 0.063,
  and P rounded exactly as the reference kernel rounds it (512-key tiles
  for K7, the whole band for K2 and K6) 2.3e-4 / 1.8e-4 / 2.1e-4.

So the Pallas kernels round P, the rounded yardstick is the closer of the
two under either projection order, and what is left besides the tile
width is the order of the projection's sums (on K2 1.8e-4 of outputs).

``gpu``: ``tools/bf16_rounding_faults.py``'s fault ``outproj_p`` (the bf16
SIMT projection with P left unrounded) fails the ``flash_bf16`` and
``flash_bf16_full`` rows of ``chip_smoke.simt_cases`` at tiny (L=1024 and
9216), and the unchanged copy fails none.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import attention as tattn
from herro_tpu_torch.ops import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16
H, D, d, L = 2, 16, 32, 1536
LENGTHS = (1536, 1400, 700)
BLK_K = 512  # herro_tpu's _flash_outproj_full_pallas key tile
KERNEL_TILE = tattn.SIMT_KEY_TILE
# band -> (the reference kernel, its P tile: 512-key tiles for K7, one
# maximum over the band for K2 and K6; whether it rounds the projection's
# sum after each head)
PALLAS = {None: ("K7", BLK_K, True), 512: ("K2", L, False), 40: ("K6", L, True)}
MAX_SHARE = 2.0 ** -10  # P rounded as the reference rounds it, its projection order


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import fused as jfused

    return jnp, pltpu, jfused


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = len(LENGTHS)
    q, k, v = (torch.from_numpy(rng.normal(size=(n, H, L, D)) * s).to(BF)
               for s in (2.0, 2.0, 1.0))
    x = torch.from_numpy(rng.normal(size=(n, L, d))).to(BF)
    wo = torch.from_numpy(rng.normal(0, (H * D) ** -0.5, size=(H, D, d))).to(BF)
    bo = torch.from_numpy(rng.normal(0, 0.25, size=(d,))).to(BF)
    return q, k, v, x, wo, bo, torch.tensor(LENGTHS, dtype=torch.int32)


def _pallas(ref, args, band):
    jnp, pltpu, jfused = ref

    def j(t):
        a = jnp.asarray(t.float().numpy() if t.dtype == BF else t.numpy())
        return a.astype(jnp.bfloat16) if t.dtype == BF else a

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jfused._flash_outproj_pallas(*map(j, args), band), np.float32)


def _per_head(attn, x, wo, bo):
    """The projection as herro_tpu's K6 and K7 sum it: head 0's part added
    to x + bo and rounded to bf16, each later head's added to that and
    rounded again."""
    out = None
    for h in range(attn.shape[1]):
        part = torch.einsum("bld,do->blo", attn[:, h].float(), wo[h].float())
        out = (x.float() + bo.float() + part if h == 0 else out.float() + part).to(x.dtype)
    return out


def _share(got, want):
    keep = np.arange(L)[None, :, None] < np.asarray(LENGTHS)[:, None, None]
    keep = np.broadcast_to(keep, want.shape)
    return float((got.float().numpy() != want)[keep].mean())


@pytest.mark.parametrize("band", [None, 512, 40])
def test_rounded_p_is_closer_to_the_pallas_kernels_than_unrounded_p(band, ref):
    args = _inputs(41)
    want = _pallas(ref, args, band)
    shares = {"plain": _share(fused._flash_outproj_plain(*args, band), want),
              "tiled": _share(fused._flash_outproj_tiled(*args, band), want)}
    assert shares["tiled"] < shares["plain"], shares


@pytest.mark.parametrize("band", [None, 512, 40])
def test_p_rounded_as_the_reference_rounds_it_gives_its_outputs(band, ref):
    """Under the reference kernel's own projection order: P rounded as it
    rounds P leaves at most 2^-10 of the outputs apart; the kernel's 64-key
    tiles sit between that and P unrounded."""
    q, k, v, x, wo, bo, lengths = args = _inputs(41)
    want = _pallas(ref, args, band)
    _, tile, per_head = PALLAS[band]
    project = _per_head if per_head else fused._project

    def share(attn):
        return _share(project(attn, x, wo, bo), want)

    exact = share(tattn._flash_attention_tiled(q, k, v, lengths, band, tile))
    kernel = share(tattn._flash_attention_tiled(q, k, v, lengths, band, KERNEL_TILE))
    unrounded = share(tattn.chunked_attention(q, k, v, lengths, band))
    assert exact <= MAX_SHARE, (exact, kernel, unrounded)
    assert exact < kernel < unrounded, (exact, kernel, unrounded)


@pytest.mark.parametrize("band", [None, 512, 40])
def test_p_left_unrounded_moves_more_outputs_than_the_cards_share_bar(band):
    """The two yardsticks apart, on the rows below each length: more than
    ``chip_smoke.BF16_SIMT_MAX_SHARE`` of the outputs, so the card's rows,
    held against the rounded one, see the kernel that leaves P unrounded."""
    from chip_smoke import BF16_SIMT_MAX_SHARE, share_differing

    args = _inputs(42)
    keep = torch.arange(L)[None, :] < args[-1][:, None]
    rounded = fused._flash_outproj_tiled(*args, band)
    assert rounded.dtype == BF and bool(torch.isfinite(rounded.float()).all())
    share = share_differing(rounded, fused._flash_outproj_plain(*args, band), keep)
    assert share > 4 * BF16_SIMT_MAX_SHARE, share


@pytest.mark.gpu
def test_projection_rows_fail_when_the_kernel_leaves_p_unrounded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    spec = importlib.util.spec_from_file_location(
        "bf16_rounding_faults", os.path.join(ROOT, "tools", "bf16_rounding_faults.py"))
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    got = faults.verdicts(faults.run(["none", "outproj_p"], [("tiny", 1024), ("tiny", 9216)]))
    assert got["outproj_p"][1] == {"flash_bf16", "flash_bf16_full"}
    assert all(faults.as_expected(failed, want, f) for f, (failed, want) in got.items()), got
