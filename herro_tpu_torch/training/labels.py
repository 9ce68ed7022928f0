"""Ground-truth labels for window features.

The reference repo ships no training code (SURVEY.md §2 — the model is an
opaque TorchScript blob), so this framework defines its own supervision:

* 5-way class per supported column: the base a perfect corrector would emit
  there ({A,C,G,T} = 0-3) or '*' (4) when the column should collapse
  (read-insertion errors, or query-noise insertion slots);
* a binary "informative" flag per supported column: 1 when the truth differs
  from the target read's current symbol — the analogue of the reference's
  (computed-but-unused) info head.

Labels are derived from the simulator's per-read edit scripts; for real data
the same interface can be fed from truth alignments of reads to a curated
assembly.
"""

from __future__ import annotations

import numpy as np

from ..constants import GAP_FWD
from ..features.extract import WindowFeatures
from ..training.simulate import SimDataset, SimRead, read_truth_arrays

_CLS_OF_BYTE = np.full(256, 255, dtype=np.uint8)
for _k, _c in enumerate(b"ACGT*"):
    _CLS_OF_BYTE[_c] = _k
for _k, _c in enumerate(b"acgt#"):
    _CLS_OF_BYTE[_c] = _k


def window_labels(
    wf: WindowFeatures,
    window_size: int,
    anchor_truth: np.ndarray,
    ins_truth: dict[int, bytes],
) -> tuple[np.ndarray, np.ndarray]:
    """(labels [n_sup] uint8 in 0..4, info [n_sup] uint8 in 0/1)."""
    win_start = wf.wid * window_size
    labels = np.empty(len(wf.supported), dtype=np.uint8)
    info = np.empty(len(wf.supported), dtype=np.uint8)

    # current target symbol per supported column, for the info flag
    anchors = np.nonzero(wf.bases[:, 0] != GAP_FWD)[0]

    for k, (pos, ins) in enumerate(zip(wf.supported["pos"], wf.supported["ins"])):
        p = win_start + int(pos)
        if ins == 0:
            labels[k] = anchor_truth[p]
            cur = wf.bases[anchors[int(pos)], 0]
        else:
            run = ins_truth.get(p, b"")
            labels[k] = (
                _CLS_OF_BYTE[run[int(ins) - 1]] if int(ins) <= len(run) else 4
            )
            cur = GAP_FWD  # insertion slots hold '*' in the target row
        info[k] = 1 if labels[k] != _CLS_OF_BYTE[cur] else 0
    return labels, info


def read_labels(
    ds: SimDataset, read: SimRead, feats: list[WindowFeatures], window_size: int
) -> list[tuple[np.ndarray, np.ndarray]]:
    anchor_truth, ins_truth = read_truth_arrays(ds, read)
    return [window_labels(wf, window_size, anchor_truth, ins_truth) for wf in feats]
