"""The port's attention + out-projection op under all three masks.

``flash_outproj`` takes ``local_window`` None (full attention, K7), a
multiple of 256 (K2) or any other band (K6). One plain PyTorch version serves
all three; here it is held, on the same numpy inputs, against

* the JAX package's jnp twin ``_flash_outproj_jnp``,
* the full-attention Pallas kernel ``_flash_outproj_full_pallas`` (K7) and
* the tiled banded Pallas kernel ``_banded_flash_outproj_pallas`` (K6), on
  its aligned branch (band == tile) and its general branch,

the Pallas kernels in interpret mode, at small shapes (d 64, H 2, D 32,
L 256, tiles of 64) for ``local_window`` in {None, 24, 64, 100}.

Tolerances. float32: both sides sum a few hundred products in different
orders and use different exp implementations, 2e-4 absolute. bfloat16: K6
and K7 round the output to bf16 after each head's contribution, while the
port (like K2 and the jnp twin) sums the heads in float32 and rounds once,
which is the closer answer; with two heads that is up to two extra roundings
on values of magnitude up to ~4, so the two sides may differ by 4 bf16 ulps
at the largest magnitude (max|ref| * 2^-6).

Rows at or past a batch element's length are padding: a band with no key
below the length averages other V rows in each formulation, and K7 leaves a
length-0 element at x + bo. No later stage reads them; they are compared
nowhere and only required to be finite.

The ``gpu`` tests hold the two CUDA kernels against the plain version on the
card at the kernels' own widths (D = 128, bf16) and skip without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import cuda as kernels
from herro_tpu_torch.ops import fused

B, H, L, D, d = 2, 2, 256, 32, 64
BLK = 64
ATOL = 2e-4
WINDOWS = [None, 24, 64, 100]


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import fused as jfused

    return SimpleNamespace(jnp=jnp, pltpu=pltpu, fused=jfused)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def _inputs(seed, lengths=(L, L - 70), L=L, H=H, D=D, d=d):
    rng = np.random.default_rng(seed)
    nb = len(lengths)
    q, k, v = (rng.normal(size=(nb, H, L, D)).astype(np.float32) for _ in range(3))
    x = rng.normal(size=(nb, L, d)).astype(np.float32)
    wo = rng.normal(0, 0.1, size=(H, D, d)).astype(np.float32)
    bo = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    return q, k, v, x, wo, bo, np.asarray(lengths, dtype=np.int32)


def _close_valid_rows(got, want, lengths, atol):
    assert np.isfinite(got).all()
    for b in range(got.shape[0]):
        np.testing.assert_allclose(
            got[b, : lengths[b]], want[b, : lengths[b]], atol=atol, rtol=0
        )


def _jax_args(ref, args, dtype):
    return [
        ref.jnp.asarray(a, dtype) if a.dtype == np.float32 else ref.jnp.asarray(a)
        for a in args
    ]


def _port(args, local_window, dtype=torch.float32):
    out = fused.flash_outproj(*(_t(a, dtype) for a in args), local_window)
    return out.float().numpy()


# ---------------------------------------------------------------------------
# the plain version against the JAX package, float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("local_window", WINDOWS)
def test_plain_matches_jnp_twin(local_window, ref):
    args = _inputs(30)
    want = ref.fused._flash_outproj_jnp(*_jax_args(ref, args, ref.jnp.float32), local_window)
    _close_valid_rows(_port(args, local_window), np.asarray(want), args[-1], ATOL)


@pytest.mark.parametrize("local_window", WINDOWS)
def test_plain_matches_full_pallas_interpret(local_window, ref):
    """K7: the online-softmax kernel over every key block below the length;
    its optional band covers the banded windows too."""
    args = _inputs(31)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._flash_outproj_full_pallas(
            *_jax_args(ref, args, ref.jnp.float32), local_window, BLK, BLK
        )
    _close_valid_rows(_port(args, local_window), np.asarray(want), args[-1], ATOL)


@pytest.mark.parametrize("local_window", [24, 64, 100])
def test_plain_matches_banded_pallas_interpret(local_window, ref):
    """K6: the aligned branch at band == tile (64) and the general branch
    below one tile (24) and across two (100, n_side 2)."""
    args = _inputs(32)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._banded_flash_outproj_pallas(
            *_jax_args(ref, args, ref.jnp.float32), local_window, blk=BLK
        )
    _close_valid_rows(_port(args, local_window), np.asarray(want), args[-1], ATOL)


# ---------------------------------------------------------------------------
# bfloat16: the Pallas kernels round after each head, the port once
# ---------------------------------------------------------------------------


def _bf16_tol(want):
    return float(np.abs(want).max()) * 2.0 ** -6


def test_plain_bf16_matches_full_pallas_interpret(ref):
    args = _inputs(33)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._flash_outproj_full_pallas(
            *_jax_args(ref, args, ref.jnp.bfloat16), None, BLK, BLK
        )
    want = np.asarray(want.astype(ref.jnp.float32))
    _close_valid_rows(_port(args, None, torch.bfloat16), want, args[-1], _bf16_tol(want))


@pytest.mark.parametrize("local_window", [64, 100])
def test_plain_bf16_matches_banded_pallas_interpret(local_window, ref):
    args = _inputs(34)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._banded_flash_outproj_pallas(
            *_jax_args(ref, args, ref.jnp.bfloat16), local_window, blk=BLK
        )
    want = np.asarray(want.astype(ref.jnp.float32))
    _close_valid_rows(
        _port(args, local_window, torch.bfloat16), want, args[-1], _bf16_tol(want)
    )


# ---------------------------------------------------------------------------
# rows with nothing to attend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("local_window", WINDOWS)
def test_plain_padding_rows_are_finite(local_window, ref):
    """A length-0 element and rows beyond length + band: finite on both
    sides; the element with keys still agrees on its valid rows."""
    args = _inputs(35, lengths=(0, 90))
    want = ref.fused._flash_outproj_jnp(*_jax_args(ref, args, ref.jnp.float32), local_window)
    got = _port(args, local_window)
    assert np.isfinite(np.asarray(want)).all()
    _close_valid_rows(got, np.asarray(want), args[-1], ATOL)


# ---------------------------------------------------------------------------
# which kernel a band takes on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "local_window,name",
    [
        (None, "flash_outproj_full"),
        (256, "flash_outproj"),
        (512, "flash_outproj"),
        (1024, "flash_outproj"),
        (1, "flash_outproj_band"),
        (24, "flash_outproj_band"),
        (40, "flash_outproj_band"),
        (100, "flash_outproj_band"),
        (384, "flash_outproj_band"),
        (9217, "flash_outproj_band"),
    ],
)
def test_dispatch_picks_kernel(local_window, name):
    assert fused.flash_kernel_name(local_window) == name
    assert name in kernels.KERNELS and name in kernels.launch_counts.snapshot()


def test_each_attention_kernel_has_its_own_entry_and_source():
    import os

    names = ["flash_outproj", "flash_outproj_band", "flash_outproj_full"]
    entries = {kernels.KERNELS[n][0] for n in names}
    assert len(entries) == 3
    for n in names:
        assert os.path.exists(os.path.join(kernels.CSRC, f"{n}.cu"))
    # the full kernel takes no window: one int fewer than the banded entries
    assert len(kernels.KERNELS["flash_outproj_full"][1]) == \
        len(kernels.KERNELS["flash_outproj_band"][1]) - 1


@pytest.mark.parametrize("local_window", [None, 384, 512])
def test_cuda_wrapper_never_runs_on_cpu_tensors(local_window):
    """The card's wrapper raises on CPU tensors; only the public op, handed
    CPU tensors, takes the plain version."""
    args = [_t(a, torch.bfloat16) for a in _inputs(36, D=128, d=128)]
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        fused._flash_outproj_cuda(*args, local_window)
    assert kernels.launch_counts.snapshot() == before


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain version, on the card
# ---------------------------------------------------------------------------

GPU_D, GPU_H, GPU_L = 256, 2, 1000  # r9 / r10deep widths, a ragged tail block


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on_card(local_window, lengths, name):
    dev = _card()
    args = _inputs(37, lengths=lengths, L=GPU_L, H=GPU_H, D=128, d=GPU_D)
    targs = [_t(a, torch.bfloat16).to(dev) for a in args]
    before = kernels.launch_counts.snapshot()
    got = fused._flash_outproj_cuda(*targs, local_window)
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {name: 1}
    want = fused._flash_outproj_plain(*targs, local_window).float().cpu().numpy()
    _close_valid_rows(got.float().cpu().numpy(), want, args[-1], _bf16_tol(want))


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [(GPU_L, GPU_L - 300), (0, 77)])
def test_full_kernel_matches_plain_on_card(lengths):
    _on_card(None, lengths, "flash_outproj_full")


@pytest.mark.gpu
@pytest.mark.parametrize("local_window", [1, 40, 100, 384, 5000])
def test_band_kernel_matches_plain_on_card(local_window):
    """Below one key tile (1, 40), across tiles (100, 384), wider than the
    sequence (5000)."""
    _on_card(local_window, (GPU_L, GPU_L - 300), "flash_outproj_band")
