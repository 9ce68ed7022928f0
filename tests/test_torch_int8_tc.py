"""The arithmetic of K10's and K11's SIMT instances on the int8 tensor cores on the CPU.

``csrc/ln_qkv_rope_q_simt.cu`` (K10) and ``csrc/ln_ffn_q_simt.cu`` (K11)
take their int8 products on ``mma.sync`` m16n8k32 (s8 x s8 -> s32,
``csrc/mma.cuh:mma_s8``) through ``csrc/int8_simt.cuh``'s ``stage_mma``: a
block of 8 warps over 128 token rows, a warp 32 rows x BN/2 columns (in
spans of S, 2S apart: ``span_col``), k in stages of 64 bytes, the fragments
read by ``ldmatrix`` from row-major int8 tiles (A by token rows, W k-major).
Nothing here compiles that code, so :func:`fragment_walk` repeats its walk
lane by lane: ``ldmatrix.x4`` as the PTX ISA defines it (lane l names row l
% 8 of matrix l / 8; thread i receives bytes 4 (i % 4) .. 4 (i % 4) + 3 of
row i / 4 of each matrix), the addresses each lane hands it in the kernel,
m16n8k32's fragment layouts (A: a0 row g, k 4t..4t+3, a1 row g + 8, a2 and
a3 k + 16; B: b0 column g, k 4t..4t+3, b1 k + 16; C: c0, c1 row g, columns
2t, 2t + 1, c2, c3 row g + 8; g = lane / 4, t = lane % 4), and the
epilogue's reading of the C fragments. The reassembled product must equal
the int64 product exactly at d 32 / 384 / 512 with d_ff 64 / 1280 / 1024
(the hidden pass, y_i8 @ W1, and the output pass, h_i8 @ W2) on a ragged
row count.

:func:`qkv_epilogue` repeats K10's epilogue on those C fragments lane by
lane: dequantize, add the bias, round, and rope each value with its partner
D/2 columns away, which the warp's spans put in the same thread's fragment
nt ^ P (at D 128 two spans of 32, 64 apart). From the plain version's int8
LayerNorm rows it must give ``fused._ln_qkv_rope_q_plain``'s q, k, v bit for
bit at the widths of TINY_CONFIG, its shard, r10, its shard, d384x5L and
head dims 32 and 64, in float32 and bf16; a partner one fragment off must
fail.

:func:`row_maxima` repeats the hidden pass's (max |h|, tied count) merge in
the kernel's order (a thread's fragments column tile by column tile, then
its quad by ``__shfl_xor`` 1 and 2, then the two warps of a row by
``atomicMax`` and the counts of those that hold it) over h from the plain
version, on inputs with ties planted in every place the merge meets them;
it must equal ``_ln_ffn_q_rowmax_plain(..., ties=True)`` exactly.

``gpu``: on the card, ``_rowscale`` fed ``_rowmax``'s maxima with
res_scale 1 is the whole function bit for bit (r10 in float32, TINY_CONFIG).
This file imports no JAX; the plain K11 against herro_tpu's Pallas kernel at
d 384 is ``tests/test_torch_int8.py``'s.
"""

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import fused
from test_torch_int8_simt import _card, _ffn_q_args, _launched, _qkv_q_args

KB, BM, WARP_ROWS, WARPS = 64, 128, 32, 8  # int8_simt.cuh kKB, kBM, kWarpRows; 8 warps
LANES = np.arange(32)
G, T4 = LANES // 4, LANES % 4
# (d, d_ff): TINY_CONFIG, d384x5L, r10
WIDTHS = [(32, 64), (384, 1280), (512, 1024)]
ROWS = 200  # two row tiles, the second ragged


def tile_width(n: int) -> int:
    """BN for a product n columns wide (f32.cuh tile_width)."""
    return 64 if n <= 64 else 128


def ldmatrix_x4(tile, rows, cols):
    """``ldmatrix.sync.aligned.m8n8.x4.b16`` on an int8 tile: lane l names
    the row (``rows[l]``) and first byte (``cols[l]``) of row l % 8 of
    matrix l / 8; thread i receives of each matrix j the bytes 4 (i % 4) ..
    4 (i % 4) + 3 of its row i / 4. Returns [32 lanes, 4 registers, 4
    bytes]."""
    src = 8 * np.arange(4)[None, :] + (LANES // 4)[:, None]  # [thread, matrix] -> lane
    r = rows[src]
    c = cols[src] + 4 * (LANES % 4)[:, None]
    return tile[r[..., None], c[..., None] + np.arange(4)]


def mma_s8(acc, a, b0, b1):
    """acc [32, 4] += m16n8k32 of the fragments a [32, 4, 4], b0 / b1 [32, 4]
    (bytes), by the PTX ISA's layouts."""
    A = np.zeros((16, 32), np.int64)
    Bm = np.zeros((32, 8), np.int64)
    for j in range(4):
        A[(G + 8 * (j % 2))[:, None], (4 * T4 + 16 * (j // 2))[:, None] + np.arange(4)] = a[:, j]
    Bm[(4 * T4)[:, None] + np.arange(4), G[:, None]] = b0
    Bm[(4 * T4 + 16)[:, None] + np.arange(4), G[:, None]] = b1
    C = A @ Bm
    for e in range(4):
        acc[:, e] += C[G + 8 * (e // 2), 2 * T4 + e % 2]


def frag_col(nt, warp, BN, S=None):
    """The tile's first column of a warp's fragment nt (int8_simt.cuh: the
    warp column's first span, warp % 2 * S, plus span_col<S>(nt)): its
    columns in spans of S (BN/2 by default), 2S apart, the second warp
    column's S after the first's."""
    S = BN // 2 if S is None else S
    return 8 * nt % S + 8 * nt // S * 2 * S + warp % 2 * S


def fragment_walk(a, wt, S=None):
    """a [T, K] int8 @ wt [N, K] (k-major) int8 as the kernel walks it: row
    tiles of BM, column tiles of BN, k stages of KB (rows past T, columns
    past N and k past K read 0), stage_mma's ldmatrix addresses with the
    warp's columns in spans of S. Yields (r0, n0, warp, BN, acc) after each
    column tile, acc [2 mt, BN/16 nt, 32 lanes, 4] the warp's C fragments."""
    T, K = a.shape
    N = wt.shape[0]
    BN = tile_width(N)
    nk = -(-K // KB)
    for r0 in range(0, T, BM):
        A = np.zeros((BM, nk * KB), np.int64)
        rows = a[r0:r0 + BM]
        A[:len(rows), :K] = rows
        for n0 in range(0, N, BN):
            Wt = np.zeros((BN, nk * KB), np.int64)
            cols = wt[n0:n0 + BN]
            Wt[:len(cols), :K] = cols
            for warp in range(WARPS):
                wr = warp // 2 * WARP_ROWS
                acc = np.zeros((2, BN // 16, 32, 4), np.int64)
                for kt in range(nk):
                    stage = Wt[:, kt * KB:(kt + 1) * KB]
                    for ks in range(KB // 32):
                        af = [ldmatrix_x4(A, wr + 16 * mt + (LANES & 15),
                                          kt * KB + 32 * ks + (LANES >> 4) * 16)
                              for mt in range(2)]
                        for np_ in range(BN // 32):
                            b = ldmatrix_x4(stage, frag_col(2 * np_, warp, BN, S) + (LANES & 7)
                                            + (LANES >> 4) * 8,
                                            32 * ks + ((LANES >> 3) & 1) * 16)
                            for mt in range(2):
                                mma_s8(acc[mt, 2 * np_], af[mt], b[:, 0], b[:, 1])
                                mma_s8(acc[mt, 2 * np_ + 1], af[mt], b[:, 2], b[:, 3])
                yield r0, n0, warp, BN, acc


def tile_product(a, wt, S=None):
    """The product reassembled from :func:`fragment_walk`'s C fragments at
    the epilogue's rows wr + 16 mt + g + 8 hf and columns n0 + frag_col(nt) +
    2t + e."""
    T, N = a.shape[0], wt.shape[0]
    out = np.zeros((T, N), np.int64)
    for r0, n0, warp, BN, acc in fragment_walk(a, wt, S):
        wr = warp // 2 * WARP_ROWS
        for mt in range(2):
            for hf in range(2):
                row = r0 + wr + 16 * mt + G + 8 * hf
                for nt in range(BN // 16):
                    for e in range(2):
                        col = n0 + frag_col(nt, warp, BN, S) + 2 * T4 + e
                        ok = (row < T) & (col < N)
                        out[row[ok], col[ok]] = acc[mt, nt][ok, 2 * hf + e]
    return out


def _i8(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int64)


@pytest.mark.parametrize("d,f", WIDTHS, ids=[f"d{d}-f{f}" for d, f in WIDTHS])
def test_fragment_walk_reassembles_both_products_exactly(d, f):
    """The hidden pass's y_i8 [T, d] @ W1 (k-major [f, d]) and the output
    pass's h_i8 [T, f] @ W2 (k-major [d, f]), int8 values over the whole
    range, against the int64 product."""
    rng = np.random.default_rng(d + f)
    y, w1t = _i8(rng, ROWS, d), _i8(rng, f, d)
    h, w2t = _i8(rng, ROWS, f), _i8(rng, d, f)
    np.testing.assert_array_equal(tile_product(y, w1t), y @ w1t.T)
    np.testing.assert_array_equal(tile_product(h, w2t), h @ w2t.T)


def test_fragment_walk_sees_a_misread_lane():
    """The emulation is not blind to the addressing: W's two k halves read
    the other way round (lanes 8-15 and 16-23 swapped) break the product."""
    rng = np.random.default_rng(3)
    a, wt = _i8(rng, 40, 64), _i8(rng, 64, 64)
    swap = np.where((LANES >> 3) == 1, LANES + 8, np.where((LANES >> 3) == 2, LANES - 8, LANES))
    kept = ldmatrix_x4
    try:
        globals()["ldmatrix_x4"] = lambda tile, rows, cols: kept(tile, rows[swap], cols[swap])
        assert not np.array_equal(tile_product(a, wt), a @ wt.T)
    finally:
        globals()["ldmatrix_x4"] = kept


# K10: (d, H, D) of TINY_CONFIG and its tp 2 shard (D 16: BN 128 and 64), r10
# and its shard, d384x5L (D 128: spans of 32), a head-dim-64 and a
# head-dim-32 width
QKV_WIDTHS = [(32, 2, 16), (32, 1, 16), (512, 4, 128), (512, 2, 128), (384, 3, 128),
              (256, 4, 64), (64, 2, 32)]
QKV_IDS = ["tiny", "tiny-shard", "r10", "r10-shard", "d384", "hd64", "hd32"]


def qkv_span(D, BN):
    """K10's span S and partner offset P (ln_qkv_rope_q_simt.cu Tile): at D
    128 a warp's columns are two spans of 32, 64 apart, so that both halves
    of each head it touches are its own."""
    return (32, 4) if D == 128 else (BN // 2, D // 16)


def qkv_epilogue(x, scale, bias, w_i8, s_col, b, H, partner=None):
    """K10's SIMT instance on the CPU: the plain version's int8 LayerNorm
    rows (the kernel's differ from them only in LayerNorm's sum order) times
    W through :func:`fragment_walk` with the kernel's spans, then its
    epilogue lane by lane on the C fragments, in float32 with the kernel's
    roundings: for each pair of fragments (lo in the first half of its
    heads, hi = lo | P), dequantize ((acc * s_row) * s_col + b), round to
    x's dtype, rope (x1 c - x2 s, x2 c + x1 s, rounded) on q and k, store v
    as it is. ``partner`` replaces hi (a planted fault). Returns q, k, v [B,
    H, L, D] of x's dtype."""
    Bn, L, d = x.shape
    N = w_i8.shape[1]
    D = N // (3 * H)
    HD, half = H * D, D // 2
    dt = x.dtype
    T = Bn * L

    def rnd(v):
        return torch.from_numpy(v).to(dt).float().numpy()

    y = fused.layernorm(x, scale, bias).float().reshape(-1, d)
    y_i8, s_row = fused._quant_rows(y)
    s_row, sc = s_row[:, 0].numpy(), s_col.numpy()
    bf = b.float().numpy()
    cos, sin = (t.numpy() for t in fused.rope_tables(L, D, "cpu"))
    out = np.zeros((3, Bn, H, L, D), np.float32)
    S, P = qkv_span(D, tile_width(N))
    for r0, n0, warp, BN, acc in fragment_walk(y_i8.numpy().astype(np.int64),
                                               w_i8.t().numpy().astype(np.int64), S):
        wr = warp // 2 * WARP_ROWS
        for lo in range(BN // 16):
            if lo & P:
                continue
            hi = lo | P if partner is None else partner(lo, P)
            n = n0 + frag_col(lo, warp, BN, S) + 2 * T4
            if n[0] >= N:  # the fragment's 8 columns are in or out together
                continue
            assert (n0 + frag_col(lo | P, warp, BN, S) + 2 * T4 == n + half).all()
            which, h, dd = n // HD, n % HD // D, n % D
            assert (dd < half).all() and (which == which[0]).all()
            for mt in range(2):
                for hf in range(2):
                    row = r0 + wr + 16 * mt + G + 8 * hf
                    ok = row < T
                    rw = np.minimum(row, T - 1)
                    bb, l = rw // L, rw % L
                    for e in range(2):
                        sr = s_row[rw]
                        a = rnd((acc[mt, lo][:, 2 * hf + e].astype(np.float32) * sr) * sc[n + e]
                                + bf[n + e])
                        z = rnd((acc[mt, hi][:, 2 * hf + e].astype(np.float32) * sr)
                                * sc[n + half + e] + bf[n + half + e])
                        if which[0] < 2:
                            c, sn = cos[l, dd + e], sin[l, dd + e]
                            a, z = rnd(a * c - z * sn), rnd(z * c + a * sn)
                        out[which[ok], bb[ok], h[ok], l[ok], (dd + e)[ok]] = a[ok]
                        out[which[ok], bb[ok], h[ok], l[ok], (dd + half + e)[ok]] = z[ok]
    return tuple(torch.from_numpy(o).to(dt) for o in out)


def _qkv_case(width, dtype):
    """K10's operands at ``width`` (B 2 x L 60: one row tile, ragged, the
    second sequence starting inside it)."""
    d, H, D = width
    return _qkv_q_args(23 + d + H + D, d, H, D, B=2, L=60, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", QKV_WIDTHS, ids=QKV_IDS)
def test_qkv_epilogue_on_the_fragments_is_the_plain_version_bit_for_bit(width, dtype):
    args = _qkv_case(width, dtype)
    want = fused._ln_qkv_rope_q_plain(*args)
    got = qkv_epilogue(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("width", [QKV_WIDTHS[0], QKV_WIDTHS[2], QKV_WIDTHS[5]],
                         ids=["tiny", "r10", "hd64"])
def test_qkv_epilogue_sees_a_partner_one_fragment_off(width):
    """The rope partner taken from the fragment beside the one that holds it
    breaks q and k, and leaves v as it was."""
    args = _qkv_case(width, "float32")
    want = fused._ln_qkv_rope_q_plain(*args)
    q, k, v = qkv_epilogue(*args, partner=lambda lo, P: (lo | P) ^ 1)
    assert not torch.equal(q, want[0]) and not torch.equal(k, want[1])


def row_maxima(h):
    """The hidden pass's (max |h|, count of columns reaching it) per row, h
    [T, f] float32, merged as the kernel merges: each thread over its C
    fragments in column-tile, nt, (mt, hf), e order; its quad by xor 1 then
    2 (equal maxima add their counts, the larger takes its own); the two
    warps of a row by atomicMax, then atomicAdd of the counts of those that
    hold the maximum."""
    T, f = h.shape
    BN = tile_width(f)
    a = np.abs(h)
    top = np.zeros(T, np.float32)
    count = np.zeros(T, np.int64)

    def merge(m, c, m2, c2):
        bigger = m2 > m
        same = m2 == m
        return np.where(bigger, m2, m), np.where(bigger, c2, np.where(same, c + c2, c))

    for r0 in range(0, T, BM):
        smax = np.zeros(BM, np.float32)
        held = []
        for warp in range(WARPS):
            wr = warp // 2 * WARP_ROWS
            m = np.zeros((2, 2, 32), np.float32)
            c = np.zeros((2, 2, 32), np.int64)
            for n0 in range(0, f, BN):
                for nt in range(BN // 16):
                    n = n0 + frag_col(nt, warp, BN) + 2 * T4
                    for mt in range(2):
                        for hf in range(2):
                            row = r0 + wr + 16 * mt + G + 8 * hf
                            ok = (n < f) & (row < T)
                            for e in range(2):
                                v = np.where(ok, a[np.minimum(row, T - 1), np.minimum(n + e, f - 1)],
                                             -1.0)
                                m[mt, hf], c[mt, hf] = merge(m[mt, hf], c[mt, hf], v,
                                                             np.where(ok, 1, 0))
            for o in (1, 2):
                m, c = merge(m, c, m[..., LANES ^ o], c[..., LANES ^ o])
            for mt in range(2):
                for hf in range(2):
                    rl = wr + 16 * mt + G + 8 * hf
                    lead = (T4 == 0) & (r0 + rl < T)
                    np.maximum.at(smax, rl[lead], m[mt, hf][lead])
                    held.append((rl[lead], m[mt, hf][lead], c[mt, hf][lead]))
        scnt = np.zeros(BM, np.int64)
        for rl, mv, cv in held:
            hit = mv == smax[rl]
            np.add.at(scnt, rl[hit], cv[hit])
        n_rows = min(BM, T - r0)
        top[r0:r0 + n_rows], count[r0:r0 + n_rows] = smax[:n_rows], scnt[:n_rows]
    return top, count


def _tied_inputs(seed, d=64, f=512, rows=200):
    """K11's first pass operands with column j0 of W1 and b1 copied into
    the same thread's next column, the next thread of its quad, the next 8
    columns, the other warp, the next column tile; its bias large, so that
    it holds the row maximum of most rows, five times over."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
    s = torch.from_numpy((1 + rng.normal(0, 0.1, size=d)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, size=d).astype(np.float32))
    w1 = rng.normal(0, d ** -0.5, size=(d, f)).astype(np.float32)
    b1 = rng.normal(0, 0.1, size=f).astype(np.float32)
    j0 = 4
    b1[j0] = 2.5
    for j in (j0 + 1, j0 + 2, j0 + 8, j0 + 64, j0 + 128):
        w1[:, j], b1[j] = w1[:, j0], b1[j0]
    q1, s1 = fused.quantize_weight(torch.from_numpy(w1))
    return x, s, b, q1, s1, torch.from_numpy(b1)


def test_row_maxima_merge_equals_the_plain_maxima_and_ties():
    head = _tied_inputs(5)
    want_top, want_ties = fused._ln_ffn_q_rowmax_plain(*head, ties=True)
    assert int(want_ties.max()) >= 5  # the planted ties hold the maximum
    h = fused._ffn_q_hidden(*head).numpy()
    top, count = row_maxima(h)
    assert torch.equal(torch.from_numpy(top), want_top)
    assert torch.equal(torch.from_numpy(count).to(torch.int32), want_ties)


def test_row_maxima_merge_on_random_rows_matches_at_every_width():
    for d, f in WIDTHS:
        rng = np.random.default_rng(d)
        h = rng.normal(size=(ROWS, f)).astype(np.float32)
        h[:, ::3] = np.round(h[:, ::3])  # many ties, some at the maximum
        top, count = row_maxima(h)
        a = np.abs(h)
        np.testing.assert_array_equal(top, a.max(axis=1))
        np.testing.assert_array_equal(count, (a == a.max(axis=1, keepdims=True)).sum(axis=1))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [(512, 1024), (32, 64)], ids=["r10-float32", "tiny"])
def test_rowscale_on_rowmax_maxima_is_the_whole_function_on_card(width):
    """``_rowscale`` quantizes h by the maxima it is given in its epilogue;
    the whole function finds them and quantizes h where it lies. Fed
    ``_rowmax``'s maxima and res_scale 1, the first is the second bit for
    bit (float32, on a ragged row count)."""
    dev = _card()
    d, f = width
    args = _ffn_q_args(21, d, f, rows=3001, dtype=torch.float32, dev=dev)
    whole, launched = _launched(lambda: fused._ln_ffn_q_simt_cuda(*args))
    assert launched == {"ln_ffn_q_simt": 1}
    hmax, _ = fused._ln_ffn_q_rowmax_simt_cuda(*args[:6])
    parts, launched = _launched(lambda: fused._ln_ffn_q_rowscale_simt_cuda(*args, hmax, 1.0))
    assert launched == {"ln_ffn_q_simt_rowscale": 1}
    assert torch.equal(parts, whole)


def test_clock_tool_plants_its_laps_in_a_copy_of_the_sources(tmp_path):
    """``tools/ffn_q_simt_clocks_torch.py`` (K11's hidden pass) and
    ``tools/qkv_q_simt_clocks_torch.py`` (K10) edit a copy of
    ``int8_simt.cuh`` and their kernel's source at anchors that must each
    stand once in the sources; the repository's files are left as they
    are."""
    import importlib.util
    import os
    import shutil
    import sys

    from herro_tpu_torch.ops import cuda

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tools = os.path.join(root, "tools")
    sys.path.insert(0, tools)
    try:
        for name, source, reader, laps in (
                ("ffn_q_simt_clocks_torch", "ln_ffn_q_simt.cu", "herro_ffn_clocks", "clk_[6] +="),
                ("qkv_q_simt_clocks_torch", "ln_qkv_rope_q_simt.cu", "herro_qkv_clocks",
                 "clk_[5] +=")):
            spec = importlib.util.spec_from_file_location(name, os.path.join(tools, f"{name}.py"))
            tool = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(tool)
            csrc = tmp_path / name / "csrc"
            shutil.copytree(cuda.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
            tool.patched(str(csrc))
            text = (csrc / source).read_text()
            assert reader in text and text.count(laps) == 1
            assert "simt8_clocks[" in (csrc / "int8_simt.cuh").read_text()
            for kept in ("int8_simt.cuh", source):
                text = open(os.path.join(cuda.CSRC, kept)).read()
                assert "simt8_clocks" not in text and reader not in text
    finally:
        sys.path.remove(tools)
