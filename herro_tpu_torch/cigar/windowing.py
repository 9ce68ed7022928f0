"""Split an overlap's CIGAR walk into fixed-size target windows.

Re-expresses the per-op state machine of the reference
(src/windowing.rs:44-273) as a per-*boundary* walk: every window boundary
``k*W`` inside the overlap's target span is located with a binary search over
the cumulative op positions, so the cost is O(#windows · log #ops) instead of
O(#ops). The emitted windows are semantically identical, including:

* the ``0.1*W`` end thresholds that let overlaps almost reaching a read end
  claim the partial first / last window;
* an insertion sitting exactly on a boundary being absorbed into the left
  window;
* q-coordinates counted relative to the overlap's query range.

Windows reference op-index ranges ``[op_start, op_end)`` with per-end base
offsets, mirroring the byte-offset scheme of the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ops import Cigar, I, M


@dataclass
class OverlapWindow:
    """One overlap's contribution to one target window
    (reference: src/windowing.rs:6-16)."""

    aln_idx: int  # index into the target read's alignment list
    tstart: int  # first covered target position (absolute)
    qstart: int  # query window start, relative to the overlap's query span
    qend: int  # query window end, exclusive
    op_start: int  # first op index of the CIGAR slice
    start_off: int  # bases of op_start already consumed before the window
    op_end: int  # one-past-last op index
    end_off: int  # bases of the last op consumed inside the window


def extract_windows(
    windows: list[list[OverlapWindow]],
    aln_idx: int,
    cig: Cigar,
    tstart: int,
    tend: int,
    tlen: int,
    qstart: int,
    qend: int,
    window_size: int,
) -> None:
    """Append ``aln_idx``'s windows to ``windows`` (one list per target window).

    Coordinates are target-read coordinates; the caller guarantees the read is
    the alignment's *target* (the live reference path always has
    ``is_target == true``, see src/features.rs:346-358 — PAF rows are grouped
    by target id and minimap2 ``--dual=yes`` emits both orientations).
    """
    from .. import native

    if native.available():
        rows = native.extract_windows_rows(
            cig.codes, cig.lens, tstart, tend, tlen, qstart, qend, window_size
        )
        for w, t_ws, q_ws, q_end, op_s, off_s, op_e, off_e in rows:
            windows[w].append(
                OverlapWindow(
                    aln_idx,
                    int(t_ws),
                    int(q_ws),
                    int(q_end),
                    int(op_s),
                    int(off_s),
                    int(op_e),
                    int(off_e),
                )
            )
        return

    W = window_size
    if (tend - tstart) < W or (qend - qstart) < W:
        return

    zeroth_thresh = int(0.1 * W)
    nth_thresh = tlen - zeroth_thresh

    first_window = 0 if tstart < zeroth_thresh else (tstart + W - 1) // W
    if tend > nth_thresh:
        last_window = (tend - 1) // W + 1
    else:
        last_window = tend // W
    if last_window - first_window < 1:
        return

    codes = cig.codes
    lens = cig.lens
    n_ops = codes.shape[0]
    # Absolute target position after each op; op i spans (t_ends[i-1], t_ends[i]].
    t_ends = tstart + cig.t_cum[1:]
    q_cum = cig.q_cum  # query bases consumed before op i (relative)

    # Walk state: the pending window start, if known.
    state_set = tstart % W == 0 or tstart < zeroth_thresh
    t_ws = tstart
    q_ws = 0
    op_s = 0
    off_s = 0

    b_first = (tstart // W + 1) * W
    boundaries = range(b_first, tend + 1, W)
    if boundaries:
        # Crossing op of each boundary: first op whose end reaches it. Only
        # M/D ops advance t, so the found op is never an insertion.
        xs = np.searchsorted(t_ends, np.arange(b_first, tend + 1, W), side="left")

        for b, i in zip(boundaries, xs):
            i = int(i)
            op_t_start = int(t_ends[i]) - (int(lens[i]) if codes[i] != I else 0)
            offset = b - op_t_start
            q_at_b = int(q_cum[i]) + (offset if codes[i] == M else 0)

            if int(t_ends[i]) == b:
                # Boundary exactly at op end: absorb a following insertion
                # into this (left) window (src/windowing.rs:210-223).
                if i + 1 < n_ops and codes[i + 1] == I:
                    q_end_w = q_at_b + int(lens[i + 1])
                    op_e, off_e = i + 2, int(lens[i + 1])
                    nxt = (i + 2, 0)
                else:
                    q_end_w = q_at_b
                    op_e, off_e = i + 1, int(lens[i])
                    nxt = (i + 1, 0)
            else:
                q_end_w = q_at_b
                op_e, off_e = i + 1, offset
                nxt = (i, offset)

            if state_set:
                windows[b // W - 1].append(
                    OverlapWindow(aln_idx, t_ws, q_ws, q_end_w, op_s, off_s, op_e, off_e)
                )
            t_ws = b
            q_ws = q_end_w
            op_s, off_s = nxt
            state_set = True

    # Partial trailing window near the read end (src/windowing.rs:261-272).
    if tend > nth_thresh and tend % W != 0 and state_set:
        windows[last_window - 1].append(
            OverlapWindow(
                aln_idx,
                t_ws,
                q_ws,
                int(q_cum[n_ops]),
                op_s,
                off_s,
                n_ops,
                int(lens[n_ops - 1]),
            )
        )
