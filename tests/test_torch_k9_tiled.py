"""K9's yardstick: the plain version that rounds P per key tile.

The flash kernel (``herro_tpu/ops/attention.py:_flash_kernel``, K9) walks the
keys in tiles of ``blk_k`` and rounds p = exp(s - m) to bf16 for P.V against
the running maximum m of the keys seen so far; the port's bf16 SIMT instance
(``csrc/flash_simt.cuh``) does the same over 64-key tiles.
``attention._flash_attention_tiled`` follows those steps at a tile width of
its parameter; ``attention._flash_attention_plain`` rounds P against the
whole row's maximum instead.

* On the CPU, in bf16 at TINY_CONFIG's widths (H 2 x D 16), L=1536 in three
  key tiles of the Pallas kernel's ``blk_k`` 512, bands None / 512 / 40: the
  tiled version against the Pallas kernel in interpret mode, on the rows
  below each length. Bar: at most 2^-10 of the outputs differ at all, by at
  most 2^-8 of the largest output (one bf16 ulp there: both sides compute
  the same roundings of p, and an ulp of float32 in exp or a sum moves one
  now and then). The whole-row version differs on a larger share (0.5-11%
  of the outputs on these inputs), so the tiled version is the tighter
  yardstick.
* A tile as wide as the row is the whole-row version; a length-0 example
  comes out 0, every row finite.
* ``gpu``: ``tools/bf16_rounding_faults.py``'s fault ``k9_p`` (the bf16
  SIMT K9 with P left unrounded) fails K9's rows of ``chip_smoke.simt_cases``
  at tiny, L=1024, and the unchanged copy fails none.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import attention as tattn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16
H, D, L = 2, 16, 1536
BLK_K = 512  # herro_tpu.ops.attention.flash_attention's default key tile
LENGTHS = (1536, 1400, 700)
MAX_SHARE = 2.0 ** -10  # of the outputs that may differ at all
MAX_ULPS = 2.0 ** -8  # of the largest output, for those that do


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import attention as jattn

    return jnp, pltpu, jattn


def _qkv(seed, lengths=LENGTHS, L=L):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(len(lengths), H, L, D)) * s).to(BF)
               for s in (2.0, 2.0, 1.0))
    return q, k, v, torch.from_numpy(np.asarray(lengths, np.int32))


def _valid(out, lengths):
    keep = np.arange(out.shape[2])[None, None, :, None] < np.asarray(lengths)[:, None, None, None]
    return np.broadcast_to(keep, out.shape)


def _gap(got, want, keep):
    """(share of the outputs that differ, max |difference|) on ``keep``."""
    diff = np.abs(got.float().numpy() - want)[keep]
    return float((diff > 0).mean()), float(diff.max())


@pytest.mark.parametrize("local_window", [None, 512, 40])
def test_tiled_plain_matches_pallas_interpret_closer_than_the_whole_row(local_window, ref):
    jnp, pltpu, jattn = ref
    q, k, v, lengths = _qkv(31)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn.flash_attention(
            *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
            jnp.asarray(lengths.numpy()), local_window, blk_k=BLK_K), dtype=np.float32)
    keep = _valid(want, LENGTHS)
    tiled = _gap(tattn._flash_attention_tiled(q, k, v, lengths, local_window, tile=BLK_K),
                 want, keep)
    whole = _gap(tattn._flash_attention_plain(q, k, v, lengths, local_window), want, keep)
    assert tiled[0] <= MAX_SHARE and tiled[1] <= MAX_ULPS * np.abs(want[keep]).max(), tiled
    assert whole[0] > tiled[0], (whole, tiled)


@pytest.mark.parametrize("local_window", [None, 100])
def test_a_tile_as_wide_as_the_row_is_the_whole_row_plain(local_window):
    q, k, v, lengths = _qkv(32, lengths=(512, 300), L=512)
    got = tattn._flash_attention_tiled(q, k, v, lengths, local_window, tile=512)
    want = tattn._flash_attention_plain(q, k, v, lengths, local_window)
    keep = _valid(want.float().numpy(), (512, 300))
    share, _ = _gap(got, want.float().numpy(), keep)
    assert share <= MAX_SHARE


@pytest.mark.parametrize("local_window", [None, 512, 40])
def test_tiled_plain_length_zero_gives_zeros(local_window):
    q, k, v, lengths = _qkv(33, lengths=(1536, 0, 65))
    out = tattn._flash_attention_tiled(q, k, v, lengths, local_window)
    assert out.dtype == BF and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all()) and not out[1].any()


@pytest.mark.gpu
def test_k9_rows_fail_when_the_kernel_leaves_p_unrounded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    spec = importlib.util.spec_from_file_location(
        "bf16_rounding_faults", os.path.join(ROOT, "tools", "bf16_rounding_faults.py"))
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    got = faults.verdicts(faults.run(["none", "k9_p"], [("tiny", 1024)]))
    assert got["k9_p"][1] == {"flash_bf16_attention"}
    assert all(faults.as_expected(failed, want, f) for f, (failed, want) in got.items()), got
