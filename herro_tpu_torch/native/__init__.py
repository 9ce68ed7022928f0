"""ctypes bindings for the native host kernels.

The library builds on first import (g++, ~1s) and is cached next to the
source (several processes may import at once: see ``_build``); set
``HERRO_TPU_NATIVE=0`` to force the pure-numpy fallbacks. Every binding has
an identical-semantics numpy twin in cigar/ and features/ — parity is
enforced by tests/test_native.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libherro_native.so")
_SRC_PATH = os.path.join(_DIR, "haec_native.cpp")

_lib = None


def _stale() -> bool:
    return not os.path.exists(_LIB_PATH) or os.path.getmtime(
        _LIB_PATH
    ) < os.path.getmtime(_SRC_PATH)


def _build() -> bool:
    """Build the library so that concurrent importers never see a partial
    file: one process builds at a time (an exclusive lock on a lock file beside
    the source), compiling to a temporary name in the same directory and
    renaming it into place. An importer that waited for the lock finds the
    finished library and builds nothing."""
    import fcntl

    tmp = f"libherro_native.{os.getpid()}.tmp.so"
    try:
        with open(_LIB_PATH + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _stale():
                return True
            try:
                subprocess.run(
                    ["make", "-C", _DIR, f"TARGET={tmp}"],
                    check=True,
                    capture_output=True,
                )
                os.replace(os.path.join(_DIR, tmp), _LIB_PATH)
            finally:
                if os.path.exists(os.path.join(_DIR, tmp)):
                    os.unlink(os.path.join(_DIR, tmp))
        return True
    except (subprocess.CalledProcessError, OSError) as e:
        print(f"[herro-tpu] native build failed ({e}); using numpy fallbacks",
              file=sys.stderr)
        return False


def _load():
    global _lib
    if os.environ.get("HERRO_TPU_NATIVE", "1") == "0":
        return None
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        print(f"[herro-tpu] cannot load native lib ({e})", file=sys.stderr)
        return None

    # Pointers are passed as raw addresses (arr.ctypes.data) via c_void_p:
    # building ctypes POINTER casts per call costs more than some kernels.
    i64, ptr, dbl = ctypes.c_int64, ctypes.c_void_p, ctypes.c_double
    lib.ht_decode_2bit.argtypes = [ptr, i64, i64, ctypes.c_int, ptr]
    lib.ht_encode_2bit.argtypes = [ptr, i64, ptr]
    lib.ht_extract_windows.argtypes = [
        ptr, ptr, i64, i64, i64, i64, i64, i64, i64, ptr, i64,
    ]
    lib.ht_extract_windows.restype = i64
    lib.ht_max_ins.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.ht_fill_query_row.argtypes = [
        ptr, ptr, i64, i64, ptr, ptr, i64, i64, i64, i64, i64,
        ctypes.c_int, ptr, ptr, ptr, ptr,
    ]
    lib.ht_window_accuracy.argtypes = [
        ptr, ptr, i64, i64, i64, i64, ptr, ptr,
    ]
    lib.ht_window_accuracy.restype = dbl
    lib.ht_supported_mask.argtypes = [ptr, i64, i64, i64, ptr]
    lib.ht_parse_cigar.argtypes = [ptr, i64, ptr, ptr, ptr]
    lib.ht_parse_cigar.restype = i64
    lib.ht_max_ins_batch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr]
    lib.ht_fill_rows.argtypes = [
        ptr, ptr, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr, ptr, i64, i64,
    ]
    lib.ht_window_accuracies.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr,
    ]
    lib.ht_fit_align.argtypes = [
        ptr, i64, ptr, i64, i64, i64, ptr, ptr, ptr, ptr,
    ]
    lib.ht_fit_align.restype = i64
    lib.ht_read_build.argtypes = [
        i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i64, ptr, ptr, i64, i64, i64, i64, i64, ptr, ptr, ptr,
    ]
    lib.ht_read_build.restype = ptr
    lib.ht_read_emit.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64]
    lib.ht_read_emit_tensors.argtypes = [ptr, ptr, i64, ptr, ptr, ptr, ptr, i64]
    lib.ht_read_free.argtypes = [ptr]
    lib.ht_prof_dump.argtypes = [ptr]
    lib.ht_prof_reset.argtypes = []
    return lib


_lib = _load()


def available() -> bool:
    return _lib is not None


def decode_2bit(words: np.ndarray, start: int, end: int, rc: bool) -> np.ndarray:
    out = np.empty(max(end - start, 0), dtype=np.uint8)
    if end > start:
        _lib.ht_decode_2bit(
            words.ctypes.data, start, end, int(rc), out.ctypes.data
        )
    return out


def encode_2bit(seq: np.ndarray) -> np.ndarray:
    n = seq.shape[0]
    out = np.zeros((n + 31) // 32, dtype=np.uint64)
    if n:
        _lib.ht_encode_2bit(
            seq.ctypes.data, n, out.ctypes.data
        )
    return out


def extract_windows_rows(
    codes: np.ndarray,
    lens: np.ndarray,
    tstart: int,
    tend: int,
    tlen: int,
    qstart: int,
    qend: int,
    window_size: int,
) -> np.ndarray:
    """Emitted window rows [n, 8]: win_idx, t_ws, q_ws, q_end, op_s, off_s,
    op_e, off_e."""
    max_rows = (tend - tstart) // window_size + 3
    out = np.empty((max_rows, 8), dtype=np.int64)
    n = _lib.ht_extract_windows(
        codes.ctypes.data,
        lens.ctypes.data,
        codes.shape[0],
        tstart,
        tend,
        tlen,
        qstart,
        qend,
        window_size,
        out.ctypes.data,
        max_rows,
    )
    assert n >= 0, "native window buffer overflow"
    return out[:n]


def max_ins_accumulate(
    codes: np.ndarray,
    lens: np.ndarray,
    op_s: int,
    off_s: int,
    op_e: int,
    off_e: int,
    t_base: int,
    max_ins: np.ndarray,
) -> None:
    _lib.ht_max_ins(
        codes.ctypes.data,
        lens.ctypes.data,
        op_s,
        off_s,
        op_e,
        off_e,
        t_base,
        max_ins.ctypes.data,
    )


def fill_query_row(
    bases_row: np.ndarray,
    quals_row: np.ndarray,
    codes: np.ndarray,
    lens: np.ndarray,
    op_s: int,
    off_s: int,
    op_e: int,
    off_e: int,
    t_base: int,
    strand_rev: bool,
    qseq: np.ndarray,
    qqual: np.ndarray,
    anchor: np.ndarray,
    max_ins: np.ndarray,
) -> None:
    stride = bases_row.strides[0]
    assert quals_row.strides[0] == stride
    _lib.ht_fill_query_row(
        bases_row.ctypes.data,
        quals_row.ctypes.data,
        stride,
        bases_row.shape[0],
        codes.ctypes.data,
        lens.ctypes.data,
        op_s,
        off_s,
        op_e,
        off_e,
        t_base,
        int(strand_rev),
        qseq.ctypes.data,
        qqual.ctypes.data,
        anchor.ctypes.data,
        max_ins.ctypes.data,
    )


def parse_cigar_arrays(cigar: bytes) -> tuple[np.ndarray, np.ndarray, bool] | None:
    """(codes, lens, has_eqx) of an ASCII CIGAR, or None if malformed."""
    n = len(cigar)
    max_ops = n // 2 + 1
    codes = np.empty(max_ops, dtype=np.uint8)
    lens = np.empty(max_ops, dtype=np.int32)
    flags = np.zeros(1, dtype=np.int32)
    buf = np.frombuffer(cigar, dtype=np.uint8)
    cnt = _lib.ht_parse_cigar(
        buf.ctypes.data, n, codes.ctypes.data, lens.ctypes.data,
        flags.ctypes.data,
    )
    if cnt < 0:
        return None
    # copy: slices of the ~2x over-allocated parse buffers would pin the
    # whole allocation for the lifetime of the Cigar (hundreds of MB across
    # a 50k-read alignment batch)
    return codes[:cnt].copy(), lens[:cnt].copy(), bool(flags[0] & 1)


class WindowBatch:
    """Per-window pointer-array staging for the batched native entry points.

    Holds references to every per-overlap array so the addresses stay valid
    for the duration of the calls.
    """

    def __init__(self, cigars_codes, cigars_lens, ows, t_bases):
        n = len(ows)
        self.n = n
        self._keep = (cigars_codes, cigars_lens)
        self.codes_p = np.fromiter(
            (a.ctypes.data for a in cigars_codes), dtype=np.uint64, count=n
        )
        self.lens_p = np.fromiter(
            (a.ctypes.data for a in cigars_lens), dtype=np.uint64, count=n
        )
        self.op_s = np.fromiter((ow.op_start for ow in ows), dtype=np.int64, count=n)
        self.off_s = np.fromiter((ow.start_off for ow in ows), dtype=np.int64, count=n)
        self.op_e = np.fromiter((ow.op_end for ow in ows), dtype=np.int64, count=n)
        self.off_e = np.fromiter((ow.end_off for ow in ows), dtype=np.int64, count=n)
        self.t_base = np.asarray(t_bases, dtype=np.int64)

    def permute(self, order: list[int]) -> "WindowBatch":
        b = object.__new__(WindowBatch)
        b.n = self.n
        b._keep = self._keep
        idx = np.asarray(order, dtype=np.int64)
        b.codes_p = self.codes_p[idx]
        b.lens_p = self.lens_p[idx]
        b.op_s = self.op_s[idx]
        b.off_s = self.off_s[idx]
        b.op_e = self.op_e[idx]
        b.off_e = self.off_e[idx]
        b.t_base = self.t_base[idx]
        return b


def window_accuracies(wb: WindowBatch, tseqs: list, qseqs: list) -> np.ndarray:
    out = np.empty(wb.n, dtype=np.float64)
    tp = np.fromiter((a.ctypes.data for a in tseqs), dtype=np.uint64, count=wb.n)
    qp = np.fromiter((a.ctypes.data for a in qseqs), dtype=np.uint64, count=wb.n)
    _lib.ht_window_accuracies(
        wb.codes_p.ctypes.data, wb.lens_p.ctypes.data,
        wb.op_s.ctypes.data, wb.off_s.ctypes.data,
        wb.op_e.ctypes.data, wb.off_e.ctypes.data,
        tp.ctypes.data, qp.ctypes.data, wb.n, out.ctypes.data,
    )
    return out


def max_ins_batch(wb: WindowBatch, win_len: int) -> np.ndarray:
    max_ins = np.zeros(win_len, dtype=np.int32)
    _lib.ht_max_ins_batch(
        wb.codes_p.ctypes.data, wb.lens_p.ctypes.data,
        wb.op_s.ctypes.data, wb.off_s.ctypes.data,
        wb.op_e.ctypes.data, wb.off_e.ctypes.data,
        wb.t_base.ctypes.data, wb.n, max_ins.ctypes.data,
    )
    return max_ins


def fill_rows(
    bases: np.ndarray,
    quals: np.ndarray,
    wb: WindowBatch,
    strands_rev,
    qseqs: list,
    qquals: list,
    anchor: np.ndarray,
    max_ins: np.ndarray,
    no_aln_qual: int,
) -> None:
    """Fill pileup rows 1..n of the (L, C) matrices in one native call."""
    length, n_cols = bases.shape
    sr = np.asarray(strands_rev, dtype=np.uint8)
    qp = np.fromiter((a.ctypes.data for a in qseqs), dtype=np.uint64, count=wb.n)
    qq = np.fromiter((a.ctypes.data for a in qquals), dtype=np.uint64, count=wb.n)
    _lib.ht_fill_rows(
        bases.ctypes.data, quals.ctypes.data, n_cols, length,
        wb.codes_p.ctypes.data, wb.lens_p.ctypes.data,
        wb.op_s.ctypes.data, wb.off_s.ctypes.data,
        wb.op_e.ctypes.data, wb.off_e.ctypes.data,
        wb.t_base.ctypes.data, sr.ctypes.data,
        qp.ctypes.data, qq.ctypes.data,
        anchor.ctypes.data, max_ins.ctypes.data, wb.n, no_aln_qual,
    )


def _read_build(
    codes_list, lens_list, tstart, tend, tlen, qstart, qend, strand_rev,
    qseqs, qquals, qid_local, n_qid, tseq, tqual, read_len, window_size,
    top_k, max_indel, no_aln_qual,
):
    """Shared ht_read_build call: returns (handle, per-window dims)."""
    n_alns = len(codes_list)
    n_windows = -(-read_len // window_size)
    codes_p = np.fromiter(
        (a.ctypes.data for a in codes_list), dtype=np.uint64, count=n_alns
    )
    lens_p = np.fromiter(
        (a.ctypes.data for a in lens_list), dtype=np.uint64, count=n_alns
    )
    n_ops = np.fromiter(
        (a.shape[0] for a in codes_list), dtype=np.int64, count=n_alns
    )
    qseq_p = np.fromiter(
        (a.ctypes.data for a in qseqs), dtype=np.uint64, count=n_alns
    )
    qqual_p = np.fromiter(
        (a.ctypes.data for a in qquals), dtype=np.uint64, count=n_alns
    )
    out_len = np.empty(n_windows, dtype=np.int64)
    out_nsup = np.empty(n_windows, dtype=np.int64)
    out_nrows = np.empty(n_windows, dtype=np.int64)
    handle = _lib.ht_read_build(
        n_alns, codes_p.ctypes.data, lens_p.ctypes.data, n_ops.ctypes.data,
        tstart.ctypes.data, tend.ctypes.data, tlen.ctypes.data,
        qstart.ctypes.data, qend.ctypes.data, strand_rev.ctypes.data,
        qseq_p.ctypes.data, qqual_p.ctypes.data, qid_local.ctypes.data,
        n_qid, tseq.ctypes.data, tqual.ctypes.data, read_len, window_size,
        top_k, max_indel, no_aln_qual,
        out_len.ctypes.data, out_nsup.ctypes.data, out_nrows.ctypes.data,
    )
    return handle, out_len, out_nsup, out_nrows, n_windows


def read_featurize(
    codes_list,
    lens_list,
    tstart: np.ndarray,
    tend: np.ndarray,
    tlen: np.ndarray,
    qstart: np.ndarray,
    qend: np.ndarray,
    strand_rev: np.ndarray,
    qseqs,
    qquals,
    qid_local: np.ndarray,
    n_qid: int,
    tseq: np.ndarray,
    tqual: np.ndarray,
    read_len: int,
    window_size: int,
    top_k: int,
    max_indel: int,
    no_aln_qual: int,
):
    """Whole-read featurization in one native build + one emit call.

    Returns ``(bases, quals, supported, row_aln, nrows)`` lists, one entry
    per window, or ``None`` when the native build bails (caller falls back
    to the per-window path). ``row_aln[w]`` maps each re-ranked pileup row
    to its index in the caller's alignment arrays.
    """
    handle, out_len, out_nsup, out_nrows, n_windows = _read_build(
        codes_list, lens_list, tstart, tend, tlen, qstart, qend, strand_rev,
        qseqs, qquals, qid_local, n_qid, tseq, tqual, read_len, window_size,
        top_k, max_indel, no_aln_qual,
    )
    if not handle:
        return None
    try:
        C = top_k + 1
        bases = [np.empty((int(l), C), dtype=np.uint8) for l in out_len]
        quals = [np.empty((int(l), C), dtype=np.uint8) for l in out_len]
        supported = [
            np.empty(int(k), dtype=[("pos", np.uint16), ("ins", np.uint8)])
            for k in out_nsup
        ]
        # structured (u16, u8) fields are interleaved; emit into flat planes
        sup_pos = [np.empty(int(k), dtype=np.uint16) for k in out_nsup]
        sup_ins = [np.empty(int(k), dtype=np.uint8) for k in out_nsup]
        row_aln = [np.empty(int(r), dtype=np.int32) for r in out_nrows]

        def pp(arrs):
            return np.fromiter(
                (a.ctypes.data for a in arrs), dtype=np.uint64, count=n_windows
            )

        bp, qp, spp, sip, rp = pp(bases), pp(quals), pp(sup_pos), pp(sup_ins), pp(row_aln)
        _lib.ht_read_emit(
            handle, bp.ctypes.data, qp.ctypes.data, spp.ctypes.data,
            sip.ctypes.data, rp.ctypes.data, top_k,
        )
    finally:
        _lib.ht_read_free(handle)
    for s, p, i in zip(supported, sup_pos, sup_ins):
        s["pos"] = p
        s["ins"] = i
    return bases, quals, supported, row_aln, out_nrows


def read_featurize_tensors(
    codes_list,
    lens_list,
    tstart: np.ndarray,
    tend: np.ndarray,
    tlen: np.ndarray,
    qstart: np.ndarray,
    qend: np.ndarray,
    strand_rev: np.ndarray,
    qseqs,
    qquals,
    qid_local: np.ndarray,
    n_qid: int,
    tseq: np.ndarray,
    tqual: np.ndarray,
    read_len: int,
    window_size: int,
    top_k: int,
    max_indel: int,
    no_aln_qual: int,
    vocab_lut: np.ndarray,
    token_pad: int,
):
    """Whole-read featurization emitting device-ready window tensors.

    Same build as :func:`read_featurize`, but the emit produces what the
    inference batcher ships (batching.collate): per window, vocab-mapped
    token nibble rows packed ``[P, L]`` (P = (top_k+2)//2), quals transposed
    row-major ``[C, L]``, flat supported column indices (int32) and the
    re-ranked row -> alignment map. Returns ``(tok_packed, quals_rm,
    support_flat, row_aln, nrows)`` lists or ``None`` on build failure.
    """
    handle, out_len, out_nsup, out_nrows, n_windows = _read_build(
        codes_list, lens_list, tstart, tend, tlen, qstart, qend, strand_rev,
        qseqs, qquals, qid_local, n_qid, tseq, tqual, read_len, window_size,
        top_k, max_indel, no_aln_qual,
    )
    if not handle:
        return None
    try:
        C = top_k + 1
        P = (C + 1) // 2
        tokp = [np.empty((P, int(l)), dtype=np.uint8) for l in out_len]
        quals = [np.empty((C, int(l)), dtype=np.uint8) for l in out_len]
        supflat = [np.empty(int(k), dtype=np.int32) for k in out_nsup]
        row_aln = [np.empty(int(r), dtype=np.int32) for r in out_nrows]

        def pp(arrs):
            return np.fromiter(
                (a.ctypes.data for a in arrs), dtype=np.uint64, count=n_windows
            )

        tp, qp, sp, rp = pp(tokp), pp(quals), pp(supflat), pp(row_aln)
        assert vocab_lut.dtype == np.uint8
        if vocab_lut.shape[0] < 256:  # pileup bytes are ASCII (< 128), but
            # the kernel indexes blindly — present a full 256-entry table
            vocab_lut = np.pad(vocab_lut, (0, 256 - vocab_lut.shape[0]))
        vocab_lut = np.ascontiguousarray(vocab_lut)
        _lib.ht_read_emit_tensors(
            handle, vocab_lut.ctypes.data, int(token_pad), tp.ctypes.data,
            qp.ctypes.data, sp.ctypes.data, rp.ctypes.data, top_k,
        )
    finally:
        _lib.ht_read_free(handle)
    return tokp, quals, supflat, row_aln, out_nrows


PROF_PHASES = (
    "extract+filter", "anchfill+acc+sort", "maxins+anchors", "fill_topk",
    "supported+phase", "rerank+compact", "final_supported", "total_build",
    "emit_tensors",
)


def prof_dump(reset: bool = False) -> dict[str, float]:
    """Seconds per ht_read_build phase accumulated since load/reset.

    Only populated when the library runs with HT_PROF=1 in the environment
    (the flag is read once at first build call); all-zero otherwise."""
    out = np.zeros(len(PROF_PHASES), dtype=np.int64)
    _lib.ht_prof_dump(out.ctypes.data)
    if reset:
        _lib.ht_prof_reset()
    return {k: v * 1e-9 for k, v in zip(PROF_PHASES, out.tolist())}


def supported_mask(bases: np.ndarray, thresh: int) -> np.ndarray:
    """Per-pileup-column supported flags for a row-major (L, C) byte matrix."""
    assert bases.flags.c_contiguous
    L, C = bases.shape
    out = np.empty(L, dtype=np.uint8)
    _lib.ht_supported_mask(bases.ctypes.data, L, C, thresh, out.ctypes.data)
    return out.view(bool)


def window_accuracy(
    codes: np.ndarray,
    lens: np.ndarray,
    op_s: int,
    off_s: int,
    op_e: int,
    off_e: int,
    tseq: np.ndarray,
    qseq: np.ndarray,
) -> float:
    return _lib.ht_window_accuracy(
        codes.ctypes.data,
        lens.ctypes.data,
        op_s,
        off_s,
        op_e,
        off_e,
        tseq.ctypes.data,
        qseq.ctypes.data,
    )


def fit_align(
    a: np.ndarray, b: np.ndarray, diag0: int, band: int
) -> "tuple[int, np.ndarray, np.ndarray, tuple[int, int], np.ndarray] | None":
    """Banded fitting alignment of ``a`` against ``b`` with traceback.

    Returns (distance, b2a[m], ins_after[m+1], (j0, j1), counts[4]) or None
    when the optimum leaves the band (caller should widen and retry).
    """
    n, m = a.shape[0], b.shape[0]
    b2a = np.empty(m, dtype=np.uint8)
    ins_after = np.empty(m + 1, dtype=np.int32)
    span = np.empty(2, dtype=np.int64)
    counts = np.empty(4, dtype=np.int64)
    dist = _lib.ht_fit_align(
        np.ascontiguousarray(a).ctypes.data, n,
        np.ascontiguousarray(b).ctypes.data, m,
        diag0, band,
        b2a.ctypes.data, ins_after.ctypes.data,
        span.ctypes.data, counts.ctypes.data,
    )
    if dist < 0:
        return None
    return int(dist), b2a, ins_after, (int(span[0]), int(span[1])), counts
