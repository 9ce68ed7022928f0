"""Training-feature dump sink (`features` subcommand).

Produces the same per-read directory layout as the reference's FeatsGenOutput
(src/features.rs:724-839):

    {out}/{read_id}/{wid}.features.npy   uint8 [2, L, 31]  (bases, quals)
    {out}/{read_id}/{wid}.supported.npy  structured (pos u16, ins u8)
    {out}/{read_id}/{wid}.ids.txt        ranked query read ids
"""

from __future__ import annotations

import os

import numpy as np

from ..io.fastx import ReadSet
from .extract import WindowFeatures


def write_window_features(
    base_path: str, reads: ReadSet, feats: list[WindowFeatures]
) -> None:
    if not feats:
        return
    rname = reads.ids[feats[0].rid].decode()
    out_dir = os.path.join(base_path, rname)
    os.makedirs(out_dir, exist_ok=True)
    for wf in feats:
        stacked = np.stack([wf.bases, wf.quals], axis=0)
        np.save(os.path.join(out_dir, f"{wf.wid}.features.npy"), stacked)
        np.save(os.path.join(out_dir, f"{wf.wid}.supported.npy"), wf.supported)
        with open(os.path.join(out_dir, f"{wf.wid}.ids.txt"), "w") as fh:
            for qid in wf.qids:
                fh.write(reads.ids[qid].decode() + "\n")


def load_window_features(path: str, wid: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    feats = np.load(os.path.join(path, f"{wid}.features.npy"))
    supported = np.load(os.path.join(path, f"{wid}.supported.npy"))
    return feats[0], feats[1], supported
