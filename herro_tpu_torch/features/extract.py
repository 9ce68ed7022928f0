"""Per-target-read feature extraction.

Orchestrates the reference's `extract_features` (src/features.rs:326-583):

1. split every alignment's CIGAR into target windows;
2. drop overlap-windows containing an indel > 50 bp;
3. sort each window's overlaps by window-local alignment accuracy;
4. build the pileup matrices + first-pass supported positions;
5. haplotype re-rank: score each query read by its match ratio against the
   target at supported columns across *all* windows, keep the top-30 rows,
   drop pileup columns that became all-gap, recompute supported positions;
6. hand the finished windows to a sink (npy dump for training, or the
   inference batcher).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..cigar.ops import window_accuracy
from ..cigar.windowing import OverlapWindow, extract_windows
from ..constants import (
    GAP_FWD, GAP_REV, MAX_INDEL_LEN, NO_ALN, NO_ALN_QUAL, TOP_K,
)
from ..io.fastx import ReadSet
from ..overlaps.paf import Alignment, STRAND_REV
from .pileup import fill_window_pileup, get_supported, window_max_ins

# Uppercase fold that leaves '#' and '*' untouched — the ratio comparison of
# the reference uses char::to_ascii_uppercase (src/features.rs:486-487).
_UPPER = np.arange(256, dtype=np.uint8)
for _l, _u in zip(b"acgt", b"ACGT"):
    _UPPER[_l] = _u


@dataclass
class WindowFeatures:
    """One finished window example handed to a sink."""

    rid: int
    wid: int
    n_alns: int  # min(#overlap rows, TOP_K)
    n_total_wins: int
    bases: np.ndarray  # uint8 [L, 31] ascii pileup bytes
    quals: np.ndarray  # uint8 [L, 31] phred+33
    supported: np.ndarray  # structured (pos u16, ins u8)
    qids: list[int]  # query read ids, ranked


class _QueryArena:
    """Per-alignment oriented query decode, done once.

    A query read participates in every window its overlap spans; decoding the
    full oriented span (RC'd + qual-reversed for reverse strands) once makes
    each window's slice a free contiguous view. Mirrors the oriented-slice
    semantics of the reference (src/features.rs:97-153)."""

    def __init__(self, reads: ReadSet, alignments: list, rid: int):
        self._reads = reads
        self._alns = alignments
        self._rid = rid
        self._cache: dict[int, tuple[np.ndarray, np.ndarray, bool]] = {}

    def full(self, aln_idx: int) -> tuple[np.ndarray, np.ndarray, bool]:
        hit = self._cache.get(aln_idx)
        if hit is not None:
            return hit
        aln = self._alns[aln_idx]
        if aln.tid == self._rid:
            qid, q0, q1 = aln.qid, aln.qstart, aln.qend
        else:
            qid, q0, q1 = aln.tid, aln.tstart, aln.tend
        rev = aln.strand == STRAND_REV
        if rev:
            seq = self._reads.seq(qid, q0, q1, rc=True)
            qual = np.ascontiguousarray(self._reads.qual(qid, q0, q1)[::-1])
        else:
            seq = self._reads.seq(qid, q0, q1)
            qual = self._reads.qual(qid, q0, q1)
        out = (seq, qual, rev)
        self._cache[aln_idx] = out
        return out

    def window(self, ow: OverlapWindow) -> tuple[np.ndarray, np.ndarray, bool]:
        seq, qual, rev = self.full(ow.aln_idx)
        return seq[ow.qstart : ow.qend], qual[ow.qstart : ow.qend], rev


# Escape hatch for parity tests: force the per-window orchestration even when
# the read-level native kernel is available.
_READ_LEVEL = True


def _native_call_args(
    rid: int,
    reads: ReadSet,
    alignments: list[Alignment],
    window_size: int,
):
    """Shared prep for the read-level native kernels: per-alignment spans
    (windowing guard pre-applied), oriented query decodes, local qid table.
    Returns ``(args, qids, n_windows)`` — ``args`` is the positional prefix
    both ht_read_build entry points take."""
    read_len = reads.length(rid)
    tseq = reads.seq(rid)
    tqual = reads.qual(rid)
    n_windows = (read_len + window_size - 1) // window_size

    # Per-alignment spans with the read as target; drop alignments that the
    # windowing guard would reject anyway (span < W) so their oriented decode
    # is never materialised.
    kept: list[int] = []
    spans = []
    for idx, aln in enumerate(alignments):
        if aln.tid == rid:
            t0, t1, tl = aln.tstart, aln.tend, aln.tlen
            q0, q1 = aln.qstart, aln.qend
        else:
            t0, t1, tl = aln.qstart, aln.qend, aln.qlen
            q0, q1 = aln.tstart, aln.tend
        if t1 - t0 < window_size or q1 - q0 < window_size:
            continue
        kept.append(idx)
        spans.append((t0, t1, tl, q0, q1))
    n = len(kept)

    arena = _QueryArena(reads, alignments, rid)
    qseqs, qquals, revs = [], [], np.empty(n, dtype=np.uint8)
    for k, idx in enumerate(kept):
        seq, qual, rev = arena.full(idx)
        qseqs.append(seq)
        qquals.append(qual)
        revs[k] = rev

    sp = np.asarray(spans, dtype=np.int64).reshape(n, 5)
    qids = np.asarray(
        [alignments[idx].other_id(rid) for idx in kept], dtype=np.int64
    )
    uq, qid_local = (
        np.unique(qids, return_inverse=True) if n else (qids, qids)
    )

    args = (
        [alignments[idx].cigar.codes for idx in kept],
        [alignments[idx].cigar.lens for idx in kept],
        np.ascontiguousarray(sp[:, 0]), np.ascontiguousarray(sp[:, 1]),
        np.ascontiguousarray(sp[:, 2]), np.ascontiguousarray(sp[:, 3]),
        np.ascontiguousarray(sp[:, 4]), revs,
        qseqs, qquals, qid_local.astype(np.int64), len(uq),
        tseq, tqual, read_len, window_size, TOP_K, MAX_INDEL_LEN,
        int(NO_ALN_QUAL),
    )
    return args, qids, n_windows


def _extract_read_features_native(
    rid: int,
    reads: ReadSet,
    alignments: list[Alignment],
    window_size: int,
) -> "list[WindowFeatures] | None":
    """Whole-read featurization in one native call (ht_read_build/emit).

    Covers the same pipeline as the Python orchestration below — window
    grouping, long-indel filter, accuracy sort, pileup fill, supported
    columns, haplotype re-rank (src/features.rs:326-583) — with the
    per-window Python glue (~30-50% of featgen wall time) hoisted into C++.
    Byte-parity with the fallback path is enforced by
    tests/test_extract_parity.py.
    """
    from .. import native

    args, qids, n_windows = _native_call_args(
        rid, reads, alignments, window_size
    )
    res = native.read_featurize(*args)
    if res is None:
        return None
    bases, quals, supported, row_aln, nrows = res
    qids_l = qids.tolist()
    return [
        WindowFeatures(
            rid=rid,
            wid=wid,
            n_alns=min(int(nrows[wid]), TOP_K),
            n_total_wins=n_windows,
            bases=bases[wid],
            quals=quals[wid],
            supported=supported[wid],
            qids=[qids_l[a] for a in row_aln[wid]],
        )
        for wid in range(n_windows)
    ]


def extract_read_tensors(
    rid: int,
    reads: ReadSet,
    alignments: list[Alignment],
    window_size: int,
) -> "list":
    """Whole-read featurization straight to device-layout window tensors.

    The inference engine's hot path: one native build + one tensor emit per
    read (ht_read_emit_tensors) producing exactly the bytes
    ``batching.collate`` ships — packed token nibble rows [16, L], row-major
    quals [31, L] and flat supported indices — so the Python tensorize /
    pack / transpose passes never run. Falls back to
    :func:`extract_read_features` + :func:`~..pipeline.batching.tensorize`
    (converted to the same layout, keeping batches homogeneous) when the
    native library is unavailable or bails. Byte parity with the fallback is
    enforced by tests/test_extract_parity.py.
    """
    from .. import native
    from ..constants import BASES_MAP, TOKEN_PAD
    from ..pipeline.batching import WindowTensors, pack_tokens, tensorize

    res = None
    if _READ_LEVEL and native.available():
        args, _, n_windows = _native_call_args(
            rid, reads, alignments, window_size
        )
        res = native.read_featurize_tensors(
            *args, vocab_lut=BASES_MAP, token_pad=int(TOKEN_PAD)
        )
    if res is None:
        out = []
        for wf in extract_read_features(rid, reads, alignments, window_size):
            wt = tensorize(wf)
            wt.tokens_packed = np.ascontiguousarray(pack_tokens(wt.tokens).T)
            wt.quals_rm = np.ascontiguousarray(wt.quals.T)
            wt.tokens = None
            wt.quals = None
            wt.supported = None
            out.append(wt)
        return out
    tokp, quals_rm, supflat, row_aln, nrows = res
    return [
        WindowTensors(
            rid=rid,
            wid=wid,
            n_alns=min(int(nrows[wid]), TOP_K),
            n_total_wins=n_windows,
            tokens=None,
            quals=None,
            support_flat=supflat[wid],
            supported=None,
            tokens_packed=tokp[wid],
            quals_rm=quals_rm[wid],
        )
        for wid in range(n_windows)
    ]


def extract_read_features(
    rid: int,
    reads: ReadSet,
    alignments: list[Alignment],
    window_size: int,
) -> list[WindowFeatures]:
    """All window features of one target read, fully ranked and re-ranked."""
    from .. import native

    if _READ_LEVEL and native.available():
        out = _extract_read_features_native(rid, reads, alignments, window_size)
        if out is not None:
            return out

    read_len = reads.length(rid)
    tseq = reads.seq(rid)
    tqual = reads.qual(rid)
    n_windows = (read_len + window_size - 1) // window_size

    windows: list[list[OverlapWindow]] = [[] for _ in range(n_windows)]
    cigars = [aln.cigar for aln in alignments]
    for aln_idx, aln in enumerate(alignments):
        # The live path always sees the read as the target (src/features.rs:349).
        if aln.tid == rid:
            t0, t1, tl = aln.tstart, aln.tend, aln.tlen
            q0, q1 = aln.qstart, aln.qend
        else:
            t0, t1, tl = aln.qstart, aln.qend, aln.qlen
            q0, q1 = aln.tstart, aln.tend
        extract_windows(
            windows, aln_idx, aln.cigar, t0, t1, tl, q0, q1, window_size
        )

    arena = _QueryArena(reads, alignments, rid)
    staged = []
    for wid in range(n_windows):
        win_start = wid * window_size
        win_len = (
            read_len - win_start if wid == n_windows - 1 else window_size
        )

        # Long-indel filter (src/features.rs:376-383); O(1) per window via
        # per-alignment prefix counts of >MAX_INDEL_LEN indel ops.
        ows = [
            ow
            for ow in windows[wid]
            if (pre := cigars[ow.aln_idx].long_indel_prefix(MAX_INDEL_LEN))[
                ow.op_end
            ]
            == pre[ow.op_start]
        ]

        # Window slices are views into the per-alignment oriented decode.
        qdata = [arena.window(ow) for ow in ows]

        # One pointer-array batch per window drives the native kernels
        # (accuracy, max_ins, row fill) with one ctypes call each.
        from .. import native

        wb = None
        if native.available() and ows:
            wb = native.WindowBatch(
                [cigars[ow.aln_idx].codes for ow in ows],
                [cigars[ow.aln_idx].lens for ow in ows],
                ows,
                [ow.tstart - win_start for ow in ows],
            )

        # Stable sort by window-local accuracy, descending
        # (src/features.rs:386-409).
        if wb is not None:
            tslices = [tseq[ow.tstart : win_start + win_len] for ow in ows]
            accs = native.window_accuracies(wb, tslices, [q[0] for q in qdata])
        else:
            accs = [
                window_accuracy(
                    cigars[ow.aln_idx],
                    ow.op_start,
                    ow.start_off,
                    ow.op_end,
                    ow.end_off,
                    tseq[ow.tstart : win_start + win_len],
                    qdata[k][0],
                )
                for k, ow in enumerate(ows)
            ]
        order = sorted(range(len(ows)), key=lambda k: -accs[k])
        ows = [ows[k] for k in order]
        qdata = [qdata[k] for k in order]
        if wb is not None:
            wb = wb.permute(order)

        max_ins = window_max_ins(ows, cigars, win_start, win_len, wb=wb)
        bases, quals = fill_window_pileup(
            ows,
            cigars,
            [q[2] for q in qdata],
            [q[0] for q in qdata],
            [q[1] for q in qdata],
            tseq,
            tqual,
            win_start,
            win_len,
            max_ins,
            TOP_K,
            wb=wb,
        )
        supported = get_supported(bases)
        qids = [alignments[ow.aln_idx].other_id(rid) for ow in ows]
        staged.append((wid, bases, quals, supported, qids))

    # -- Haplotype phase scoring across all windows (src/features.rs:461-509).
    num = {}
    den = {}
    for wid, bases, quals, supported, qids in staged:
        if len(supported) == 0 or not qids:
            continue
        tgt = bases[:, 0]
        anchors = np.nonzero(tgt != GAP_FWD)[0]
        flat = anchors[supported["pos"].astype(np.int64)] + supported["ins"]
        # Only columns where the target has a real base participate.
        keep = tgt[flat] != GAP_FWD
        flat = flat[keep]
        if flat.size == 0:
            continue
        t_up = _UPPER[tgt[flat]]
        for row, qid in enumerate(qids, start=1):
            q_up = _UPPER[bases[flat, row]]
            n = int(np.count_nonzero(q_up == t_up))
            num[qid] = num.get(qid, 0) + n
            den[qid] = den.get(qid, 0) + (flat.size - n)

    def score(qid: int) -> float:
        n = num.get(qid, 0)
        d = den.get(qid, 0)
        t = n + d
        return (n / t) * math.log(t + 1.0) if t else 0.0

    # -- Re-rank rows, keep top-30 queries + target (src/features.rs:502-579).
    out: list[WindowFeatures] = []
    for wid, bases, quals, supported, qids in staged:
        scores = [math.inf] + [score(q) for q in qids]
        sr = sorted(range(len(scores)), key=lambda i: -scores[i])
        n_cols = bases.shape[1]
        col_order = sr[: TOP_K + 1] + list(range(len(sr), TOP_K + 1))
        new_bases = bases[:, col_order]
        new_quals = quals[:, col_order]

        # Drop pileup columns that hold no real base among kept rows.
        non_dot = new_bases != NO_ALN
        gapish = (new_bases == GAP_FWD) | (new_bases == GAP_REV)
        all_gap = ~np.any(non_dot & ~gapish, axis=1)
        retain = ~all_gap
        new_bases = np.ascontiguousarray(new_bases[retain])
        new_quals = np.ascontiguousarray(new_quals[retain])

        new_supported = get_supported(new_bases)
        new_qids = [qids[i - 1] for i in sr[1:]]

        out.append(
            WindowFeatures(
                rid=rid,
                wid=wid,
                n_alns=min(len(new_qids), TOP_K),
                n_total_wins=n_windows,
                bases=new_bases,
                quals=new_quals,
                supported=new_supported,
                qids=new_qids,
            )
        )
    return out
