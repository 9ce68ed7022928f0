"""The port's attention ops: ``flash_outproj`` under all three masks, and
the standalone ``attention()`` with its flash, chunked and naive routes.

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

``attention(q, k, v, lengths, local_window, impl)`` (a port of
``herro_tpu/ops/attention.py``) is held against the JAX functions of the same
names and against the Pallas ``flash_attention`` in interpret mode, forward
(2e-4 absolute in float32, as above) and gradients (1e-3 absolute, the
reference's own bound in tests/test_attention.py: the backward sums over L
keys). The flash route's plain version gives 0 for a row with no key to
attend, as the kernel does for an example of length 0.

The ``gpu`` tests hold the CUDA kernels against the plain versions on the
card at the kernels' own widths (D = 128, bf16) and skip without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import attention as tattn
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

    import jax

    from herro_tpu.ops import attention as jattn
    from herro_tpu.ops import fused as jfused

    return SimpleNamespace(jax=jax, jnp=jnp, pltpu=pltpu, fused=jfused, attn=jattn)


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
    CPU tensors, takes the plain version. (H, d) = (2, 256) is a width the
    kernels take, so the device is what it refuses."""
    args = [_t(a, torch.bfloat16) for a in _inputs(36, L=64, H=2, D=128, d=256)]
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        fused._flash_outproj_cuda(*args, local_window)
    assert kernels.launch_counts.snapshot() == before


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain version, on the card
# ---------------------------------------------------------------------------

GPU_D, GPU_H, GPU_L = 256, 2, 1000  # r9 / r10deep widths, a ragged tail block
# (H, d) of every shipped checkpoint: r9 / r10deep, and r10
GPU_WIDTHS = [(GPU_H, GPU_D), (4, 512)]


def _gpu_lengths(gl):
    """The full length, a cut, one not a multiple of a tile, one under a
    tile, one row and none."""
    return (gl, gl - 300, 937, 127, 1, 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on_card(local_window, gl, heads, width, name):
    """One launch of ``name``'s own counter and no other; every output row
    finite (the padding rows too); the rows below each length within
    4 bf16 ulps at the largest magnitude of the plain version's."""
    dev = _card()
    lengths = _gpu_lengths(gl)
    args = _inputs(37, lengths=lengths, L=gl, H=heads, D=128, d=width)
    targs = [_t(a, torch.bfloat16).to(dev) for a in args]
    before = kernels.launch_counts.snapshot()
    got = fused._flash_outproj_cuda(*targs, local_window)
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {name: 1}
    want = fused._flash_outproj_plain(*targs, local_window).float().cpu().numpy()
    _close_valid_rows(got.float().cpu().numpy(), want, args[-1], _bf16_tol(want))
    return got, targs


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", GPU_WIDTHS)
@pytest.mark.parametrize("gl", [1024, GPU_L])
def test_full_kernel_matches_plain_on_card(gl, heads, width):
    """Lengths L, L - 300, 937, 127, 1 and 0 in one batch: query tiles past
    a length do no attention, and a length of 0 leaves exactly bf16(x + bo)."""
    got, (_, _, _, x, _, bo, _) = _on_card(None, gl, heads, width, "flash_outproj_full")
    empty = _gpu_lengths(gl).index(0)
    assert torch.equal(got[empty], (x[empty].float() + bo.float()).to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", GPU_WIDTHS)
@pytest.mark.parametrize("local_window", [1, 40, 100, 384, 5000])
def test_band_kernel_matches_plain_on_card(local_window, heads, width):
    """Below one key tile (1, 40), across tiles (100, 384), wider than the
    sequence (5000)."""
    _on_card(local_window, GPU_L, heads, width, "flash_outproj_band")


# ---------------------------------------------------------------------------
# attention(): the flash, chunked and naive routes against herro_tpu's
# ---------------------------------------------------------------------------


def _qkv(seed, lengths=(L, L - 70), L=L, H=H, D=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(len(lengths), H, L, D)).astype(np.float32) for _ in range(3))
    return q, k, v, np.asarray(lengths, dtype=np.int32)


def _valid_rows_close(got, want, lengths, atol):
    """[B, H, L, D] outputs on the query rows below each length."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :, :n], want[b, :, :n], atol=atol, rtol=0)


@pytest.mark.parametrize("local_window", [None, 32])
def test_naive_attention_matches_jax(local_window, ref):
    args = _qkv(40)
    want = ref.attn.naive_attention(*map(ref.jnp.asarray, args), local_window)
    got = tattn.naive_attention(*map(_t, args), local_window)
    assert got.shape == (B, H, L, D)
    _valid_rows_close(got.numpy(), want, args[-1], ATOL)


@pytest.mark.parametrize("impl", ["auto", "flash", "chunked", "naive"])
@pytest.mark.parametrize("local_window", [None, 32, 100])
def test_attention_impl_matches_jax(impl, local_window, ref):
    """Every route of the port against the reference's chunked and naive
    routes (on the CPU the reference's auto is chunked, the port's too, and
    the port's flash is the kernel's plain version)."""
    args = _qkv(41)
    got = tattn.attention(*map(_t, args), local_window, impl=impl).numpy()
    for jimpl in ("chunked", "naive"):
        want = ref.attn.attention(*map(ref.jnp.asarray, args), local_window, impl=jimpl)
        _valid_rows_close(got, want, args[-1], ATOL)


@pytest.mark.parametrize("impl", ["flash", "chunked", "naive"])
@pytest.mark.parametrize("local_window", [None, 32, 0, 300])
def test_attention_impl_matches_flash_pallas_interpret(impl, local_window, ref):
    """Bands up to the diagonal alone (0) and wider than L (300 > 256)."""
    args = _qkv(42)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.attn.flash_attention(
            *map(ref.jnp.asarray, args), local_window, blk_q=BLK, blk_k=BLK
        )
    got = tattn.attention(*map(_t, args), local_window, impl=impl).numpy()
    _valid_rows_close(got, want, args[-1], ATOL)


def test_flash_plain_bf16_matches_flash_pallas_interpret(ref):
    """bf16: P is rounded to bf16 before P.V on both sides, the output once."""
    args = _qkv(43)
    bf = ref.jnp.bfloat16
    jargs = [ref.jnp.asarray(a, bf) for a in args[:3]] + [ref.jnp.asarray(args[3])]
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.attn.flash_attention(*jargs, 32, blk_q=BLK, blk_k=BLK)
    want = np.asarray(want.astype(ref.jnp.float32))
    got = tattn.flash_attention(*(_t(a, torch.bfloat16) for a in args), 32)
    assert got.dtype == torch.bfloat16
    _valid_rows_close(got.float().numpy(), want, args[-1], _bf16_tol(want))


@pytest.mark.parametrize("local_window", [0, 192, 500])
def test_flash_plain_bf16_matches_flash_pallas_interpret_at_band_edges(local_window, ref):
    """The band's edges as the kernel takes them: the diagonal alone (0), a
    band of exactly L and one wider (clamped to L), at L = 192, which is not
    a multiple of the kernel's 128-row tiles (the Pallas kernel takes one
    block of 192). bf16, P rounded before P.V on both sides: 4 bf16 ulps at
    the largest magnitude."""
    args = _qkv(54, lengths=(192, 150), L=192)
    bf = ref.jnp.bfloat16
    jargs = [ref.jnp.asarray(a, bf) for a in args[:3]] + [ref.jnp.asarray(args[3])]
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.attn.flash_attention(*jargs, local_window)
    want = np.asarray(want.astype(ref.jnp.float32))
    got = tattn.flash_attention(*(_t(a, torch.bfloat16) for a in args), local_window)
    assert got.dtype == torch.bfloat16 and got.shape == (2, H, 192, D)
    _valid_rows_close(got.float().numpy(), want, args[-1], _bf16_tol(want))
    if local_window == 0:  # each row attends itself alone: v, exactly
        v = _t(args[2], torch.bfloat16).float().numpy()
        for b, n in enumerate(args[-1]):
            np.testing.assert_array_equal(got[b, :, :n].float().numpy(), v[b, :, :n])


@pytest.mark.parametrize("local_window", [None, 32])
def test_flash_plain_length_zero_gives_zeros(local_window, ref):
    """An example of length 0 walks no key block: the kernel and its plain
    version give 0 there, where naive and chunked give the mean of v. The
    Pallas kernel in interpret mode gives 0 too."""
    args = _qkv(44, lengths=(0, 90))
    got = tattn.flash_attention(*map(_t, args), local_window)
    assert not got[0].any() and got[1].any()
    assert tattn.naive_attention(*map(_t, args), local_window)[0].any()
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.attn.flash_attention(
            *map(ref.jnp.asarray, args), local_window, blk_q=BLK, blk_k=BLK
        )
    assert not np.asarray(want)[0].any()
    _valid_rows_close(got.numpy(), want, args[-1], ATOL)


def _port_grads(args, local_window, impl, row_ok):
    q, k, v = (_t(a).requires_grad_(True) for a in args[:3])
    out = tattn.attention(q, k, v, _t(args[3]), local_window, impl=impl)
    (torch.where(_t(row_ok), out, torch.zeros(())) ** 2).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("impl", ["flash", "chunked", "naive"])
@pytest.mark.parametrize("local_window", [None, 32])
def test_attention_gradients_match_jax(impl, local_window, ref):
    """dq, dk, dv of sum(out^2) over the valid query rows: the flash route
    (forward the kernel's plain version, backward recomputed through
    chunked) and the two differentiable routes against jax.grad through the
    reference's naive attention."""
    args = _qkv(45)
    lengths = args[3]
    row_ok = (np.arange(L)[None, :] < lengths[:, None])[:, None, :, None]

    def loss(q, k, v):
        out = ref.attn.naive_attention(q, k, v, ref.jnp.asarray(lengths), local_window)
        return ref.jnp.sum(ref.jnp.where(row_ok, out, 0.0) ** 2)

    want = ref.jax.grad(loss, argnums=(0, 1, 2))(*map(ref.jnp.asarray, args[:3]))
    for g, w in zip(_port_grads(args, local_window, impl, row_ok), want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3, rtol=0)


def test_flash_route_backward_matches_jax_custom_vjp(ref):
    """The reference's own pairing: flash forward (interpret mode), chunked
    recompute backward (``_flash_with_vjp``)."""
    args = _qkv(46)
    lengths = args[3]
    row_ok = (np.arange(L)[None, :] < lengths[:, None])[:, None, :, None]

    def loss(q, k, v):
        out = ref.attn._flash_with_vjp(q, k, v, ref.jnp.asarray(lengths), 32)
        return ref.jnp.sum(ref.jnp.where(row_ok, out, 0.0) ** 2)

    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.jax.grad(loss, argnums=(0, 1, 2))(*map(ref.jnp.asarray, args[:3]))
    for g, w in zip(_port_grads(args, 32, "flash", row_ok), want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3, rtol=0)


def test_chunked_attention_rematerialises_under_autograd():
    """Blocks are checkpointed only when a gradient is wanted; the values are
    the same either way."""
    args = [_t(a) for a in _qkv(47, L=1024, lengths=(1024, 900))]
    plain = tattn.chunked_attention(*args, 32)
    q = args[0].clone().requires_grad_(True)
    out = tattn.chunked_attention(q, *args[1:], 32)
    assert out.requires_grad and torch.equal(out.detach(), plain)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_attention_rejects_unknown_impl():
    args = [_t(a) for a in _qkv(48, L=64, lengths=(64,))]
    with pytest.raises(ValueError, match="impl"):
        tattn.attention(*args, impl="pallas")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the dispatch reads."""

    is_cuda = property(lambda self: True)


@pytest.mark.parametrize(
    "dtype,D,message",
    [(torch.float32, 128, "not on the card"), (torch.float32, 8, "head dim"),
     (torch.float16, 128, "bfloat16"), (torch.bfloat16, 24, "head dim"),
     (torch.bfloat16, 128, "not on the card"), (torch.bfloat16, 32, "not on the card"),
     (torch.bfloat16, 96, "not on the card")],
)
def test_attention_auto_never_gives_way_to_plain_on_the_card(dtype, D, message):
    """``auto`` on tensors that say they are CUDA tensors goes to the kernel's
    wrapper (bf16: the Hopper kernel at head dim 128 and the bf16 SIMT one
    at 16-112, multiples of 16, float32: the float32 one), which raises on
    what no kernel takes (and here, for the shapes they take, on the
    lengths that are plainly on the CPU); it never runs ``chunked`` there and launches
    nothing."""
    # copies in torch's own (aligned) memory: the kernels take 32-byte aligned operands
    q, k, v, lengths = (_t(a, dtype).clone() for a in _qkv(53, L=64, lengths=(64, 50), D=D))
    q, k, v = (t.as_subclass(_OnCard) for t in (q, k, v))
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match=message):
        tattn.attention(q, k, v, lengths.int(), 32, impl="auto")
    assert kernels.launch_counts.snapshot() == before
    assert tattn.attention(q, k, v, lengths.int(), 32, impl="chunked").shape == q.shape


@pytest.mark.parametrize("heads", [1, 3, 5])
def test_flash_cuda_wrapper_takes_any_heads(heads):
    """The kernel runs one head a tile, so its wrapper refuses no H: on CPU
    tensors of any H it gets as far as the device and refuses that."""
    args = [_t(a, torch.bfloat16) for a in _qkv(55, L=64, lengths=(64, 10), H=heads, D=128)]
    args[3] = args[3].int()
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        tattn._flash_attention_cuda(*args, 40)
    assert kernels.launch_counts.snapshot() == before


def test_flash_cuda_wrapper_never_runs_on_cpu_tensors():
    args = [_t(a, torch.bfloat16) for a in _qkv(49, D=128)]
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        tattn._flash_attention_cuda(*args, 32)
    with pytest.raises(ValueError, match="head dim"):  # the Hopper instance at D 32
        tattn._flash_attention_cuda(*(_t(a, torch.bfloat16) for a in _qkv(49)), 32,
                                    kernel="flash_attention")
    assert kernels.launch_counts.snapshot() == before


# ---------------------------------------------------------------------------
# the flash attention kernel (K9) on the card
# ---------------------------------------------------------------------------


def _flash_on_card(local_window, lengths, heads=GPU_H, gl=GPU_L):
    dev = _card()
    args = _qkv(50, lengths=lengths, L=gl, H=heads, D=128)
    targs = [_t(a, torch.bfloat16).to(dev) for a in args]
    before = kernels.launch_counts.snapshot()
    got = tattn.attention(*targs, local_window)  # auto: the kernel
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == \
        {"flash_attention": 1}
    want = tattn._flash_attention_plain(*targs, local_window).float().cpu().numpy()
    _valid_rows_close(got.float().cpu().numpy(), want, args[-1], _bf16_tol(want))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("gl", [1024, GPU_L])
@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("local_window", [None, 0, 1, 40, 100, 384, 512, 5000])
def test_flash_attention_kernel_matches_plain_on_card(local_window, heads, gl):
    """One head a tile, so any H; the diagonal alone (0), bands below one
    128-key tile (1, 40), across tiles (100, 384, 512) and wider than the
    sequence (5000); L a multiple of 128 and not (1000); lengths L, L - 300,
    one not a multiple of 128 and one under a tile."""
    _flash_on_card(local_window, (gl, gl - 300, 937, 77), heads, gl)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("local_window", [None, 0, 40])
def test_flash_attention_kernel_length_zero_gives_zeros_on_card(local_window, heads):
    got = _flash_on_card(local_window, (0, 77), heads)
    assert not got[0].any()


@pytest.mark.gpu
def test_flash_attention_gradient_on_card():
    """Forward the kernel, backward the chunked recompute, against autograd
    through naive attention (bf16 inputs: 4 bf16 ulps of the largest
    gradient)."""
    dev = _card()
    args = _qkv(51, lengths=(256, 200), L=256, H=GPU_H, D=128)
    lengths = _t(args[3]).to(dev)
    row_ok = (torch.arange(256, device=dev)[None, :] < lengths[:, None])[:, None, :, None]
    grads = {}
    for impl in ("flash", "naive"):
        q, k, v = (_t(a, torch.bfloat16).to(dev).requires_grad_(True) for a in args[:3])
        out = tattn.attention(q, k, v, lengths, 40, impl=impl)
        (torch.where(row_ok, out.float(), torch.zeros((), device=dev)) ** 2).sum().backward()
        grads[impl] = [t.grad.float().cpu().numpy() for t in (q, k, v)]
    for g, w in zip(grads["flash"], grads["naive"]):
        np.testing.assert_allclose(g, w, atol=np.abs(w).max() * 2.0 ** -6, rtol=0)


@pytest.mark.gpu
def test_attention_flash_raises_on_what_the_kernel_does_not_take():
    """float16 is neither the Hopper kernel's bf16 nor the float32 kernel's
    float32: both ``flash`` and ``auto`` raise on the card."""
    dev = _card()
    args = [_t(a).to(dev) for a in _qkv(52, L=64, lengths=(64, 64), D=128)]
    args[:3] = [a.half() for a in args[:3]]
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.attention(*args, impl="flash")
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.attention(*args, impl="auto")  # on the card auto is the kernel
    out = tattn.attention(*args, impl="chunked")  # plain only when asked by name
    assert out.dtype == torch.float16 and kernels.launch_counts.snapshot() == before
