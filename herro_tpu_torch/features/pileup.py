"""Window pileup tensorization.

Builds, per target window, the ``(L, 1 + max(n_overlaps, 30))`` bases/quals
byte matrices of the reference (src/features.rs:44-313), but as vectorised
numpy scatters instead of per-base byte loops:

* column 0 is the target; its bases sit at *anchor* flat positions
  ``anchor[t] = t + sum(max_ins[:t])`` with ``'*'`` in reserved insertion
  columns;
* query rows carry ``'*'`` gaps (forward strand) or ``'#'`` gaps
  (reverse-complemented, lowercased rows), ``'.'`` for unaligned flanks, and
  insertion bases written into the reserved columns after their anchor.

The byte alphabet and layout are identical to the reference so model inputs
and consensus decisions stay comparable.
"""

from __future__ import annotations

import numpy as np

from ..cigar.ops import Cigar, D, I, M, slice_lengths
from ..cigar.windowing import OverlapWindow
from ..constants import BASE_FORWARD, BASE_LOWER, GAP_FWD, GAP_REV, NO_ALN, NO_ALN_QUAL


def window_slice_arrays(
    cig: Cigar, ow: OverlapWindow
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Effective (codes, lens, t_rel_starts, q_rel_starts) of a window slice.

    ``t_rel`` is relative to the *overlap window's own* target start;
    ``q_rel`` is relative to the window's query slice start.
    """
    codes = cig.codes[ow.op_start : ow.op_end]
    lens = slice_lengths(cig, ow.op_start, ow.start_off, ow.op_end, ow.end_off)
    t_adv = np.where(codes != I, lens, 0)
    q_adv = np.where(codes != D, lens, 0)
    t_starts = np.concatenate([[0], np.cumsum(t_adv)[:-1]]) if len(lens) else lens
    q_starts = np.concatenate([[0], np.cumsum(q_adv)[:-1]]) if len(lens) else lens
    return codes, lens, t_starts, q_starts


def window_max_ins(
    ows: list[OverlapWindow],
    cigars: list[Cigar],
    win_start: int,
    win_len: int,
    wb=None,
) -> np.ndarray:
    """Per-target-column maximum insertion length (src/features.rs:44-95).

    An insertion whose anchor is target-relative position ``t`` reserves
    columns after anchor ``t-1``; the reference indexes ``max_ins[tpos-1]``.
    ``wb`` is an optional prebuilt ``native.WindowBatch`` (one call for all
    rows).
    """
    from .. import native

    if wb is not None:
        return native.max_ins_batch(wb, win_len)
    max_ins = np.zeros(win_len, dtype=np.int32)
    if native.available():
        for ow in ows:
            cig = cigars[ow.aln_idx]
            native.max_ins_accumulate(
                cig.codes,
                cig.lens,
                ow.op_start,
                ow.start_off,
                ow.op_end,
                ow.end_off,
                ow.tstart - win_start,
                max_ins,
            )
        return max_ins
    for ow in ows:
        cig = cigars[ow.aln_idx]
        codes, lens, t_starts, _ = window_slice_arrays(cig, ow)
        ins = codes == I
        if not ins.any():
            continue
        base = ow.tstart - win_start
        pos = base + t_starts[ins]  # anchor position of each insertion
        # pos == 0 has no preceding column to reserve into (native kernel
        # guards tpos > 0 identically); without the mask -1 wraps around.
        keep = pos > 0
        np.maximum.at(max_ins, pos[keep] - 1, lens[ins][keep])
    return max_ins


def _expand_runs(starts: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-base (run-relative offsets, expanded starts) for variable runs."""
    total = int(lens.sum())
    rep_starts = np.repeat(starts, lens)
    offsets = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    return rep_starts + offsets, offsets


def fill_query_row(
    bases_row: np.ndarray,
    quals_row: np.ndarray,
    ow: OverlapWindow,
    cig: Cigar,
    strand_rev: bool,
    qseq: np.ndarray,
    qqual: np.ndarray,
    anchor: np.ndarray,
    max_ins: np.ndarray,
    win_start: int,
) -> None:
    """Scatter one query's window slice into its pileup row
    (reference: src/features.rs:110-237).

    ``qseq`` / ``qqual`` are the window's oriented query bytes: already
    reverse-complemented for reverse-strand overlaps. ``anchor[t]`` is the
    flat column of target-relative position ``t``.
    """
    from .. import native

    if native.available():
        native.fill_query_row(
            bases_row,
            quals_row,
            cig.codes,
            cig.lens,
            ow.op_start,
            ow.start_off,
            ow.op_end,
            ow.end_off,
            ow.tstart - win_start,
            strand_rev,
            np.ascontiguousarray(qseq),
            np.ascontiguousarray(qqual),
            anchor,
            max_ins,
        )
        return

    gap = GAP_REV if strand_rev else GAP_FWD
    bases_row.fill(gap)

    t_base = ow.tstart - win_start
    idx0 = int(anchor[t_base])
    if idx0 > 0:
        bases_row[:idx0] = NO_ALN

    codes, lens, t_starts, q_starts = window_slice_arrays(cig, ow)
    if strand_rev:
        qseq = BASE_LOWER[qseq]

    t_starts = t_starts + t_base

    is_m = codes == M
    if is_m.any():
        tpos, _ = _expand_runs(t_starts[is_m], lens[is_m])
        qpos, _ = _expand_runs(q_starts[is_m], lens[is_m])
        flat = anchor[tpos]
        bases_row[flat] = qseq[qpos]
        quals_row[flat] = qqual[qpos]

    is_i = codes == I
    if is_i.any():
        # Insertion bases occupy the reserved columns right after anchor t-1.
        # A window-leading insertion (t == 0) has no preceding column and
        # window_max_ins reserved nothing for it — skip it (the native fill
        # guards tpos > 0 identically); without the mask -1 wraps around.
        ti = t_starts[is_i]
        qi = q_starts[is_i]
        li = lens[is_i]
        keep = ti > 0
        ti, qi, li = ti[keep], qi[keep], li[keep]
        if li.size:
            qpos, off = _expand_runs(qi, li)
            flat = np.repeat(anchor[ti - 1] + 1, li) + off
            bases_row[flat] = qseq[qpos]
            quals_row[flat] = qqual[qpos]

    t_end = t_base + int(np.sum(np.where(codes != I, lens, 0)))
    idx_end = int(anchor[t_end])
    if idx_end < bases_row.shape[0]:
        bases_row[idx_end:] = NO_ALN


def fill_window_pileup(
    ows: list[OverlapWindow],
    cigars: list[Cigar],
    strands_rev: list[bool],
    qseqs: list[np.ndarray],
    qquals: list[np.ndarray],
    tseq: np.ndarray,
    tqual: np.ndarray,
    win_start: int,
    win_len: int,
    max_ins: np.ndarray,
    min_rows: int,
    wb=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Assemble the full ``(L, 1 + max(n, min_rows))`` window pileup
    (reference: src/features.rs:268-313). Row data is stored column-major in
    the reference sense: axis 1 indexes reads, axis 0 pileup columns.
    ``wb`` is an optional prebuilt ``native.WindowBatch`` matching ``ows``."""
    length = win_len + int(max_ins.sum())
    n_cols = 1 + max(len(ows), min_rows)
    bases = np.full((length, n_cols), NO_ALN, dtype=np.uint8)
    quals = np.full((length, n_cols), NO_ALN_QUAL, dtype=np.uint8)

    anchor = np.zeros(win_len + 1, dtype=np.int64)
    np.cumsum(1 + max_ins, out=anchor[1:])

    # Target row (src/features.rs:239-266): gaps in insertion columns.
    bases[:, 0] = GAP_FWD
    bases[anchor[:win_len], 0] = tseq[win_start : win_start + win_len]
    quals[anchor[:win_len], 0] = tqual[win_start : win_start + win_len]

    if wb is not None and len(ows):
        from .. import native

        native.fill_rows(
            bases, quals, wb, strands_rev, qseqs, qquals, anchor, max_ins,
            NO_ALN_QUAL,
        )
        return bases, quals

    for i, ow in enumerate(ows):
        fill_query_row(
            bases[:, i + 1],
            quals[:, i + 1],
            ow,
            cigars[ow.aln_idx],
            strands_rev[i],
            qseqs[i],
            qquals[i],
            anchor,
            max_ins,
            win_start,
        )

    return bases, quals


def get_supported(bases: np.ndarray) -> np.ndarray:
    """Supported pileup positions as a structured array of (pos, ins).

    A column is supported when at least two of {A,C,G,T,*} (case-folded,
    '#'-folded) reach 10% of the row count (reference: src/features.rs:681-722).
    """
    from .. import native

    L, n_cols = bases.shape
    thresh = int(n_cols * 0.1)

    if native.available() and bases.flags.c_contiguous:
        mask = native.supported_mask(bases, thresh)
    else:
        folded = BASE_FORWARD[bases]
        counts = np.empty((L, 5), dtype=np.int32)
        for k, sym in enumerate(b"ACGT*"):
            counts[:, k] = (folded == sym).sum(axis=1)
        n_reaching = (counts >= thresh).sum(axis=1)
        mask = n_reaching >= 2

    tgt = bases[:, 0]
    is_anchor = tgt != GAP_FWD
    pos = np.cumsum(is_anchor) - 1
    col_idx = np.arange(L, dtype=np.int64)
    last_anchor = np.maximum.accumulate(np.where(is_anchor, col_idx, -1))
    ins = col_idx - last_anchor
    ins[is_anchor] = 0

    out = np.empty(int(mask.sum()), dtype=[("pos", np.uint16), ("ins", np.uint8)])
    out["pos"] = pos[mask].astype(np.uint16)
    out["ins"] = ins[mask].astype(np.uint8)
    return out
