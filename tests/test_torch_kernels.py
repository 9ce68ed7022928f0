"""The port's kernels (K1-K5) held against herro_tpu.

Each CUDA kernel's plain PyTorch version (what the port runs on the CPU) is
compared, on the same numpy inputs, with

* the JAX package's jnp twin of the Pallas kernel, and
* the Pallas kernel itself in interpret mode,

at small shapes (d 64, H 2, D 32, L 256) in float32. The ``gpu`` tests hold
each CUDA kernel against its plain version on the card at the kernels' own
widths (D = 128) in bf16, and skip without a card.

Tolerances, float32: both sides sum up to a few hundred products in
different orders and use different exp/cos/tanh implementations, a few f32
ulps on values of order 1-10, so 1e-4 absolute (2e-4 after the out
projection's extra contraction). The counting rule is integer logic: exact.

JAX is imported inside the fixture that needs it, so the ``gpu`` tests also
run where only PyTorch is installed (``pytest --noconftest -m gpu``).
"""

import functools
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import consensus, fused

B, L, d, H, D, F_FF, R, V = 2, 256, 64, 2, 32, 128, 31, 12
ATOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """herro_tpu's jnp twins and Pallas kernels, and the interpret mode."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import consensus as jcons
    from herro_tpu.ops import fused as jfused

    return SimpleNamespace(jnp=jnp, pltpu=pltpu, cons=jcons, fused=jfused)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pileup(seed, B=B, L=L):
    """Tokens [B, R, L] (pad suffix, pad rows past n_alns), f32 quals,
    lengths and n_alns, as the batcher lays them out."""
    rng = np.random.default_rng(seed)
    lengths = np.array([L, L - 70][:B], dtype=np.int32)
    n_alns = rng.integers(1, R, size=B).astype(np.int32)
    tok = rng.integers(0, 11, size=(B, R, L)).astype(np.uint8)
    tok[:, 0] = rng.integers(0, 5, size=(B, L))
    for b in range(B):
        tok[b, n_alns[b] + 1 :] = 11
        tok[b, :, lengths[b] :] = 11
    quals = rng.uniform(-1, 1, size=(B, R, L)).astype(np.float32)
    return tok, quals, lengths, n_alns


def _garbage_past_n_alns(seed, rows=R, L=L, n_alns=(0, 1, 15, 30, 31, 40)):
    """Tokens [len(n_alns), rows, L] with every token a base (< 10), rows
    past n_alns included, and runs of one token so that columns reach the
    counting rule's ties and plurality; n_alns as given."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 10, size=(len(n_alns), rows, L)).astype(np.uint8)
    same = rng.random(size=tok.shape) < 0.4
    tok[same] = np.broadcast_to(tok[:, :1], tok.shape)[same]
    tok[:, :, L // 2 :][rng.random(size=(len(n_alns), rows, L - L // 2)) < 0.05] = 11
    return tok, np.asarray(n_alns, dtype=np.int32)


def _embed_weights(seed, d=d):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(0, 0.2, size=(d, R * V)).astype(np.float32),
        rng.normal(0, 0.2, size=(d, R)).astype(np.float32),
        rng.normal(0, 0.1, size=(d,)).astype(np.float32),
    )


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


def _attn_inputs(seed, d=d, H=H, D=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32) for _ in range(3))
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    wo = rng.normal(0, 0.1, size=(H, D, d)).astype(np.float32)
    bo = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    lengths = np.array([L, L - 70], dtype=np.int32)
    return q, k, v, x, wo, bo, lengths


def _ffn_inputs(seed, d=d, f=F_FF, rows=B * L):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    s, b = _ln_params(rng, d)
    w1 = rng.normal(0, d ** -0.5, size=(d, f)).astype(np.float32)
    b1 = rng.normal(0, 0.1, size=(f,)).astype(np.float32)
    w2 = rng.normal(0, f ** -0.5, size=(f, d)).astype(np.float32)
    b2 = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    return x, s, b, w1, b1, w2, b2


def _close_valid_rows(got, ref, lengths, atol):
    # rows at or past a window's length are never read downstream, and an
    # all-masked band averages different key sets in each formulation
    for b in range(got.shape[0]):
        np.testing.assert_allclose(got[b, : lengths[b]], ref[b, : lengths[b]], atol=atol)


# ---------------------------------------------------------------------------
# plain versions against the jnp twins
# ---------------------------------------------------------------------------


def test_entry_embed_plain_matches_jnp_twin(ref):
    tok, quals, _, _ = _pileup(0)
    w_embT, w_qT, cb = _embed_weights(1)
    want = ref.fused._entry_embed_jnp(
        ref.jnp.asarray(tok), ref.jnp.asarray(quals), ref.jnp.asarray(w_embT),
        ref.jnp.asarray(w_qT), ref.jnp.asarray(cb), ref.jnp.float32,
    )
    wc = fused.col_proj_table(_t(w_embT), _t(w_qT))
    got = fused.entry_embed(_t(tok), _t(quals), wc, _t(cb), torch.float32)
    assert got.shape == (B, L, d)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_ln_qkv_rope_plain_matches_jnp_twin(ref):
    x, s, b, w, bias = _qkv_inputs(2)
    want = ref.fused._ln_qkv_rope_jnp(*map(ref.jnp.asarray, (x, s, b, w, bias)), H)
    got = fused.ln_qkv_rope(*map(_t, (x, s, b, w, bias)), H)
    for g, r in zip(got, want):
        assert g.shape == (B, H, L, D)
        np.testing.assert_allclose(g.numpy(), _np(r), atol=ATOL)


@pytest.mark.parametrize("local_window", [64, 96, None])
def test_flash_outproj_plain_matches_jnp_twin(local_window, ref):
    q, k, v, x, wo, bo, lengths = _attn_inputs(3)
    want = ref.fused._flash_outproj_jnp(
        *map(ref.jnp.asarray, (q, k, v, x, wo, bo, lengths)), local_window
    )
    got = fused.flash_outproj(*map(_t, (q, k, v, x, wo, bo, lengths)), local_window)
    _close_valid_rows(got.numpy(), _np(want), lengths, 2 * ATOL)


def test_ln_ffn_plain_matches_jnp_twin(ref):
    args = _ffn_inputs(4)
    want = ref.fused._ln_ffn_jnp(*map(ref.jnp.asarray, args))
    got = fused.ln_ffn(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_count_decisions_plain_matches_jnp_twin(ref):
    tok, _, _, n_alns = _pileup(5)
    want = ref.cons.count_decisions_jnp(ref.jnp.asarray(tok), ref.jnp.asarray(n_alns))
    got = consensus.count_decisions(_t(tok), _t(n_alns))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("gl", [1000, 37])
def test_count_decisions_plain_matches_jnp_twin_at_ragged_length(gl, ref):
    """L not a multiple of the kernel's 16 columns a thread (its byte path),
    every row a base past n_alns."""
    tok, n_alns = _garbage_past_n_alns(16, L=gl)
    want = ref.cons.count_decisions_jnp(ref.jnp.asarray(tok), ref.jnp.asarray(n_alns))
    got = consensus.count_decisions(_t(tok), _t(n_alns))
    assert got.shape == (len(n_alns), gl)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_layernorm_matches_jax(ref):
    rng = np.random.default_rng(6)
    x = (3 + 2 * rng.normal(size=(64, d))).astype(np.float32)
    s, b = _ln_params(rng)
    want = ref.fused.layernorm(*map(ref.jnp.asarray, (x, s, b)))
    got = fused.layernorm(*map(_t, (x, s, b)))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


# R10's own widths (d 512, R 31, V 12, H 4 x D 128): the col_proj table's
# slot layout, which the CUDA kernel's one-hot tile shares, and K1's plain
# path, whose weight the kernel reads as it is stored
R10_D, R10_H = 512, 4


def test_col_proj_table_slot_layout():
    """Pileup row r owns rows 16r..16r+15: its V one-hot rows, its qual row,
    zeros; zero rows up to 512."""
    w_embT, w_qT, _ = _embed_weights(30, d=R10_D)
    wc = fused.col_proj_table(_t(w_embT), _t(w_qT)).numpy()
    assert wc.shape == (512, R10_D)
    for r in range(R):
        np.testing.assert_array_equal(wc[16 * r : 16 * r + V], w_embT[:, r * V : (r + 1) * V].T)
        np.testing.assert_array_equal(wc[16 * r + V], w_qT[:, r])
        assert not wc[16 * r + V + 1 : 16 * (r + 1)].any()
    assert not wc[16 * R :].any()


def test_entry_embed_plain_matches_jnp_twin_at_r10_width(ref):
    tok, quals, _, _ = _pileup(31)
    w_embT, w_qT, cb = _embed_weights(32, d=R10_D)
    want = ref.fused._entry_embed_jnp(
        ref.jnp.asarray(tok), ref.jnp.asarray(quals), ref.jnp.asarray(w_embT),
        ref.jnp.asarray(w_qT), ref.jnp.asarray(cb), ref.jnp.float32,
    )
    wc = fused.col_proj_table(_t(w_embT), _t(w_qT))
    got = fused.entry_embed(_t(tok), _t(quals), wc, _t(cb), torch.float32)
    assert got.shape == (B, L, R10_D)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_ln_qkv_rope_plain_matches_jnp_twin_at_r10_width(ref):
    x, s, b, w, bias = _qkv_inputs(33, d=R10_D, H=R10_H, D=128, L=128)
    want = ref.fused._ln_qkv_rope_jnp(*map(ref.jnp.asarray, (x, s, b, w, bias)), R10_H)
    got = fused.ln_qkv_rope(*map(_t, (x, s, b, w, bias)), R10_H)
    for g, r in zip(got, want):
        assert g.shape == (B, R10_H, 128, 128)
        np.testing.assert_allclose(g.numpy(), _np(r), atol=ATOL)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def test_entry_embed_plain_matches_pallas_interpret(ref):
    tok, quals, _, _ = _pileup(10)
    w_embT, w_qT, cb = _embed_weights(11)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._entry_embed_pallas(
            ref.jnp.asarray(tok), ref.jnp.asarray(quals), ref.jnp.asarray(w_embT),
            ref.jnp.asarray(w_qT), ref.jnp.asarray(cb), ref.jnp.float32, blk_l=128,
        )
    wc = fused.col_proj_table(_t(w_embT), _t(w_qT))
    got = fused.entry_embed(_t(tok), _t(quals), wc, _t(cb), torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_ln_qkv_rope_plain_matches_pallas_interpret(ref):
    x, s, b, w, bias = _qkv_inputs(12)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._ln_qkv_rope_pallas(
            *map(ref.jnp.asarray, (x, s, b, w, bias)), H, blk_t=64, rope_tbl=True
        )
    got = fused.ln_qkv_rope(*map(_t, (x, s, b, w, bias)), H)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=ATOL)


@pytest.mark.parametrize("local_window", [64, 128])
def test_flash_outproj_plain_matches_pallas_interpret(local_window, ref):
    """The rotation-slot banded kernel (the production choice) at blk 64:
    n_side 1 and 2, with edge query blocks and a suffix length."""
    q, k, v, x, wo, bo, lengths = _attn_inputs(13)
    want = ref.fused._banded_flash_outproj_rot_pallas(
        *map(ref.jnp.asarray, (q, k, v, x, wo, bo, lengths)), local_window,
        blk=64, interpret=True,
    )
    got = fused.flash_outproj(*map(_t, (q, k, v, x, wo, bo, lengths)), local_window)
    _close_valid_rows(got.numpy(), _np(want), lengths, 2 * ATOL)


def test_ln_ffn_plain_matches_pallas_interpret(ref):
    args = _ffn_inputs(14)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._ln_ffn_pallas(*map(ref.jnp.asarray, args), blk_t=128)
    got = fused.ln_ffn(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_count_decisions_plain_matches_pallas_interpret(ref):
    tok, _, _, n_alns = _pileup(15)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused.count_decisions_pallas(
            ref.jnp.asarray(tok), ref.jnp.asarray(n_alns), blk_l=128
        )
    got = consensus.count_decisions(_t(tok), _t(n_alns))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("n_alns", [0, 1, 15, 30, 31, 40])
def test_count_decisions_plain_matches_pallas_interpret_past_n_alns(n_alns, ref):
    """R = 31 as on the main path, every token past n_alns a base (< 10): the
    rows the kernel does not read would change the answer if counted, which
    the plain version with every row counted shows."""
    tok, na = _garbage_past_n_alns(17, L=512, n_alns=(n_alns, n_alns))
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused.count_decisions_pallas(ref.jnp.asarray(tok), ref.jnp.asarray(na))
    got = consensus.count_decisions(_t(tok), _t(na))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    if n_alns < R - 1:
        every_row = consensus.count_decisions(_t(tok), _t(np.full_like(na, R - 1)))
        assert not torch.equal(got, every_row)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions, on the card
# ---------------------------------------------------------------------------

# d 256 / H 2 / D 128 as r10deep and r9; a length that fills whole blocks and
# one that leaves a ragged tail block in every kernel
GPU_D, GPU_H = 256, 2
GPU_LENGTHS = [1024, 1000]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_close(got, ref, rows=None):
    """bf16 outputs: within 4 ulps of the largest magnitude (the two sides
    differ in f32 summation order before the one bf16 rounding)."""
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    tol = np.abs(ref).max() * 2.0 ** -6
    if rows is None:
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    else:
        _close_valid_rows(got, ref, rows, tol)


def _cuda(x, dev, dtype=None):
    t = _t(x).to(dev)
    return t.to(dtype) if dtype is not None else t


@pytest.mark.gpu
@pytest.mark.parametrize("gl", GPU_LENGTHS)
def test_entry_embed_kernel_matches_plain_on_card(gl):
    dev = _card()
    tok, quals, _, _ = _pileup(20, L=gl)
    w_embT, w_qT, cb = _embed_weights(21, d=GPU_D)
    wc = fused.col_proj_table(_cuda(w_embT, dev, torch.bfloat16),
                              _cuda(w_qT, dev, torch.bfloat16))
    args = (_cuda(tok, dev), _cuda(quals, dev), wc, _cuda(cb, dev), torch.bfloat16)
    _bf16_close(fused._entry_embed_cuda(*args), fused._entry_embed_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("gl", GPU_LENGTHS)
def test_ln_qkv_rope_kernel_matches_plain_on_card(gl):
    dev = _card()
    x, s, b, w, bias = _qkv_inputs(22, d=GPU_D, H=GPU_H, D=128, L=gl)
    bf = torch.bfloat16
    args = (_cuda(x, dev, bf), _cuda(s, dev), _cuda(b, dev), _cuda(w, dev, bf),
            _cuda(bias, dev, bf), GPU_H)
    for g, r in zip(fused._ln_qkv_rope_cuda(*args), fused._ln_qkv_rope_plain(*args)):
        _bf16_close(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("gl", GPU_LENGTHS)
def test_flash_outproj_kernel_matches_plain_on_card(gl):
    dev = _card()
    rng = np.random.default_rng(23)
    bf = torch.bfloat16
    q, k, v = (_cuda(rng.normal(size=(B, GPU_H, gl, 128)), dev, bf) for _ in range(3))
    x = _cuda(rng.normal(size=(B, gl, GPU_D)), dev, bf)
    wo = _cuda(rng.normal(0, 0.05, size=(GPU_H, 128, GPU_D)), dev, bf)
    bo = _cuda(rng.normal(0, 0.1, size=(GPU_D,)), dev, bf)
    lengths = np.array([gl, gl - 300], dtype=np.int32)
    args = (q, k, v, x, wo, bo, _cuda(lengths, dev), 128)
    _bf16_close(fused._flash_outproj_cuda(*args), fused._flash_outproj_plain(*args),
                rows=lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("gl,f", [(1024, 512), (1000, 512), (1000, 1536)])
def test_ln_ffn_kernel_matches_plain_on_card(gl, f):
    """d_ff 512 (four hidden chunks) and 1536 (r9, twelve), at d 256."""
    dev = _card()
    x, s, b, w1, b1, w2, b2 = _ffn_inputs(24, d=GPU_D, f=f, rows=B * gl)
    bf = torch.bfloat16
    args = (_cuda(x, dev, bf), _cuda(s, dev), _cuda(b, dev), _cuda(w1, dev, bf),
            _cuda(b1, dev, bf), _cuda(w2, dev, bf), _cuda(b2, dev, bf))
    _bf16_close(fused._ln_ffn_cuda(*args), fused._ln_ffn_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("gl", GPU_LENGTHS)
def test_count_decisions_kernel_matches_plain_on_card(gl):
    dev = _card()
    tok, _, _, n_alns = _pileup(25, L=gl)
    t, n = _cuda(tok, dev), _cuda(n_alns, dev)
    assert torch.equal(
        consensus._count_decisions_cuda(t, n), consensus._count_decisions_plain(t, n)
    )


@pytest.mark.gpu
@pytest.mark.parametrize("rows,gl", [(31, 9216), (31, 1024), (31, 1000), (31, 7), (1, 1024),
                                     (1, 1000), (63, 1000)])
def test_count_decisions_kernel_reads_no_row_past_n_alns_on_card(rows, gl):
    """Tokens < 10 in every row, so a row past n_alns that were counted would
    change the answer; n_alns from 0 to past R; L a multiple of 16 (16-byte
    loads) or not (bytes, masked at L); R = 1 counts the target row alone."""
    dev = _card()
    tok, n_alns = _garbage_past_n_alns(26, rows, gl)
    t, n = _cuda(tok, dev), _cuda(n_alns, dev)
    got = consensus._count_decisions_cuda(t, n)
    assert torch.equal(got, consensus._count_decisions_plain(t, n))


# K2 and K3 at every width a shipped checkpoint takes: (H, d) 2/256 (r9,
# r10deep) and 4/512 (r10); (d, f) 512/1024, 256/1024 and 256/1536; at
# the tensor-parallel shards of r10 (tp 2: H 2, d_ff 512; tp 4: H 1, d_ff
# 256) and r10deep (tp 2: H 1, d 256, d_ff 512); and at the d384x5L shape of
# tools/variant_step_time_torch.py (H 3, d 384, d_ff 1280)
K2_SHARD_WIDTHS = [(2, 512), (1, 512), (1, 256), (3, 384)]
K2_WIDTHS = [(2, 256), (4, 512), *K2_SHARD_WIDTHS]
K3_WIDTHS = [(512, 1024), (256, 1024), (256, 1536), (512, 512), (512, 256), (384, 1280)]


def _launches(name):
    from herro_tpu_torch.ops import cuda as kernels

    return kernels.launch_counts.snapshot()[name]


@pytest.mark.parametrize(
    "op,mask,heads,width,f",
    [("flash_outproj", mask, heads, width, None)
     for mask in (None, 384, 512) for heads, width in [(3, 640), (4, 256), (8, 512)]]
    + [("ln_ffn", None, None, width, f) for width, f in [(640, 1024), (128, 512), (256, 64)]]
    + [(op, None, heads, width, None)
       for op in ("ln_qkv_rope", "ln_qkv_rope_split", "ln_qkv_rope_q")
       for heads, width in [(1, 128), (3, 768), (4, 640), (2, 192)]]
    + [("ln_qkv_rope_q", None, 3, 384, None)]
    + [("count_decisions", None, None, rows, None) for rows in (0, 64, 100)],
)
def test_cuda_wrappers_refuse_widths_the_kernels_lack(op, mask, heads, width, f):
    """The Hopper kernels are built for (H, d) = (4, 512), (2, 256), the
    tensor-parallel shards (2, 512), (1, 512), (1, 256) and (3, 384)
    (attention, all three masks), d 256, 384 or 512 with d_ff a multiple of
    128 (ln_ffn), d 256, 384 or 512 with any H (K1 and K8; K10 256 or 512),
    and 1 to 63 pileup rows (count_decisions, ``width`` here: 6-bit counts);
    the wrapper, asked for the Hopper instance by name (bf16 at other widths
    takes the bf16 SIMT one, ``tests/test_torch_bf16_widths.py``), names any
    other width in a ValueError before it looks at the device (these are CPU
    tensors) and launches nothing."""
    rng = np.random.default_rng(30)
    bf = torch.bfloat16
    if op == "count_decisions":
        args = (_t(rng.integers(0, 10, size=(2, width, 64)).astype(np.uint8)),
                _t(np.array([5, 70], np.int32)))
        call, match = consensus._count_decisions_cuda, rf"R {width}: the kernel counts"
    elif op.startswith("ln_qkv_rope"):
        x, s, b, w, bias = _qkv_inputs(30, d=width, H=heads, D=128, L=64)
        if op == "ln_qkv_rope_q":
            w_i8, s_col = fused.quantize_weight(_t(w).to(bf))
            args = (_t(x).to(bf), _t(s), _t(b), fused.k_major(w_i8), s_col, _t(bias).to(bf),
                    heads)
            call, widths = fused._ln_qkv_rope_q_cuda, fused.QKV_Q_WIDTHS
        else:
            args = (_t(x).to(bf), _t(s), _t(b), _t(w).to(bf), _t(bias).to(bf), heads)
            call = functools.partial(fused._ln_qkv_rope_cuda, kernel=op)
            widths = fused.QKV_WIDTHS
        match = rf"d_model {width}: the kernel takes " + re.escape(str(widths))
    elif op == "flash_outproj":
        gl = 64
        q, k, v = (_t(rng.normal(size=(1, heads, gl, 128))).to(bf) for _ in range(3))
        args = (q, k, v, _t(rng.normal(size=(1, gl, width))).to(bf),
                _t(rng.normal(size=(heads, 128, width))).to(bf),
                _t(rng.normal(size=(width,))).to(bf), _t(np.array([gl], np.int32)), mask)
        call = functools.partial(fused._flash_outproj_cuda, kernel=fused.flash_kernel_name(mask))
        match = "n_heads, d_model"
    else:
        x, s, b, w1, b1, w2, b2 = _ffn_inputs(30, d=width, f=f, rows=64)
        args = (_t(x).to(bf), _t(s), _t(b), _t(w1).to(bf), _t(b1).to(bf), _t(w2).to(bf),
                _t(b2).to(bf))
        call = functools.partial(fused._ln_ffn_cuda, kernel="ln_ffn")
        match = "d_model" if width not in fused.FFN_WIDTHS else "d_ff"
    from herro_tpu_torch.ops import cuda as kernels

    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match=match):
        call(*args)
    assert kernels.launch_counts.snapshot() == before


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", K2_WIDTHS)
@pytest.mark.parametrize("band", [256, 512])
def test_flash_outproj_k2_kernel_matches_plain_on_card(heads, width, band):
    """A band that is a multiple of 256 takes K2; lengths L, L - 300, one
    below the band, one not a multiple of 64, and 0."""
    dev = _card()
    assert fused.flash_kernel_name(band) == "flash_outproj"
    gl = 1024
    rng = np.random.default_rng(26)
    bf = torch.bfloat16
    lengths = np.array([gl, gl - 300, band - 1, 937, 0], dtype=np.int32)
    nb = len(lengths)
    q, k, v = (_cuda(rng.normal(size=(nb, heads, gl, 128)), dev, bf) for _ in range(3))
    x = _cuda(rng.normal(size=(nb, gl, width)), dev, bf)
    wo = _cuda(rng.normal(0, (heads * 128) ** -0.5, size=(heads, 128, width)), dev, bf)
    bo = _cuda(rng.normal(0, 0.25, size=(width,)), dev, bf)
    args = (q, k, v, x, wo, bo, _cuda(lengths, dev), band)
    before = _launches("flash_outproj")
    got = fused._flash_outproj_cuda(*args)
    torch.cuda.synchronize()
    assert _launches("flash_outproj") == before + 1
    assert bool(torch.isfinite(got.float()).all())  # padding rows too
    _bf16_close(got, fused._flash_outproj_plain(*args), rows=lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", K2_SHARD_WIDTHS)
@pytest.mark.parametrize("band", [None, 384])
def test_flash_outproj_k6_k7_shard_widths_match_plain_on_card(heads, width, band):
    """K7 (no band) and K6 (band 384) share K2's device code and its
    instantiations: the tensor-parallel shard widths, lengths as K2's test."""
    dev = _card()
    name = fused.flash_kernel_name(band)
    gl = 1024
    rng = np.random.default_rng(31)
    bf = torch.bfloat16
    lengths = np.array([gl, gl - 300, 383, 937, 0], dtype=np.int32)
    nb = len(lengths)
    q, k, v = (_cuda(rng.normal(size=(nb, heads, gl, 128)), dev, bf) for _ in range(3))
    x = _cuda(rng.normal(size=(nb, gl, width)), dev, bf)
    wo = _cuda(rng.normal(0, (heads * 128) ** -0.5, size=(heads, 128, width)), dev, bf)
    bo = _cuda(rng.normal(0, 0.25, size=(width,)), dev, bf)
    args = (q, k, v, x, wo, bo, _cuda(lengths, dev), band)
    before = _launches(name)
    got = fused._flash_outproj_cuda(*args)
    torch.cuda.synchronize()
    assert _launches(name) == before + 1
    assert bool(torch.isfinite(got.float()).all())
    _bf16_close(got, fused._flash_outproj_plain(*args), rows=lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,f", K3_WIDTHS)
@pytest.mark.parametrize("rows", [1, 37, 32 * 1000, 32 * 1024])
def test_ln_ffn_k3_widths_match_plain_on_card(d_model, f, rows):
    """Ragged row tiles, fewer tiles than SMs, and many tiles per SM."""
    dev = _card()
    x, s, b, w1, b1, w2, b2 = _ffn_inputs(27, d=d_model, f=f, rows=rows)
    bf = torch.bfloat16
    args = (_cuda(x, dev, bf), _cuda(s, dev), _cuda(b, dev), _cuda(w1, dev, bf),
            _cuda(b1, dev, bf), _cuda(w2, dev, bf), _cuda(b2, dev, bf))
    before = _launches("ln_ffn")
    got = fused._ln_ffn_cuda(*args)
    torch.cuda.synchronize()
    assert _launches("ln_ffn") == before + 1
    _bf16_close(got, fused._ln_ffn_plain(*args))


# K1 and K4 at every width a shipped checkpoint takes: (H, d) 2/256 and
# 4/512, K1 also at the tensor-parallel shards (N = 3 * H * 128 of 768 and
# 384 columns, fewer head blocks than the cluster's W multicast sees at 4/512);
# rows B * L of 1 x 1, 1 x 37 (a ragged tile, fewer tiles than SMs),
# 32 x 1000 (L not a multiple of the tile) and 32 x 1024 (many tiles per SM)
K1_WIDTHS = [(2, 256), (4, 512), *K2_SHARD_WIDTHS]
ROW_SHAPES = [(1, 1), (1, 37), (32, 1000), (32, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("heads,width", K1_WIDTHS)
@pytest.mark.parametrize("nb,gl", ROW_SHAPES)
def test_ln_qkv_rope_k1_widths_match_plain_on_card(heads, width, nb, gl):
    dev = _card()
    rng = np.random.default_rng(28)
    bf = torch.bfloat16
    x = _cuda(rng.normal(size=(nb, gl, width)), dev, bf)
    s, b = (_cuda(p, dev) for p in _ln_params(rng, width))
    w = _cuda(rng.normal(0, width ** -0.5, size=(width, 3 * heads * 128)), dev, bf)
    bias = _cuda(rng.normal(0, 0.25, size=(3 * heads * 128,)), dev, bf)
    args = (x, s, b, w, bias, heads)
    before = _launches("ln_qkv_rope")
    got = fused._ln_qkv_rope_cuda(*args, kernel="ln_qkv_rope")
    torch.cuda.synchronize()
    assert _launches("ln_qkv_rope") == before + 1
    for g, r in zip(got, fused._ln_qkv_rope_plain(*args)):
        _bf16_close(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 384, 512])
@pytest.mark.parametrize("nb,gl", ROW_SHAPES)
def test_entry_embed_k4_widths_match_plain_on_card(width, nb, gl):
    dev = _card()
    rng = np.random.default_rng(29)
    tok = rng.integers(0, 14, size=(nb, R, gl)).astype(np.uint8)  # 12, 13: outside the vocab
    quals = rng.uniform(-1, 1, size=(nb, R, gl)).astype(np.float32)
    w_embT, w_qT, cb = _embed_weights(29, d=width)
    wc = fused.col_proj_table(_cuda(w_embT, dev, torch.bfloat16),
                              _cuda(w_qT, dev, torch.bfloat16))
    args = (_cuda(tok, dev), _cuda(quals, dev), wc, _cuda(cb, dev), torch.bfloat16)
    before = _launches("entry_embed")
    got = fused._entry_embed_cuda(*args)
    torch.cuda.synchronize()
    assert _launches("entry_embed") == before + 1
    _bf16_close(got, fused._entry_embed_plain(*args))
