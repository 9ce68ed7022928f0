"""Training data generation.

Builds labelled TrainBatches either from the simulator (synthetic
pretraining / smoke tests) or from `features`-subcommand npy dumps plus a
labels source. Windows are padded to fixed (L, S) like inference batches.
All numpy: a copy of ``herro_tpu/training/data.py`` over the port's own
featgen, readers and simulator. A pickled window list holds this module's
``LabelledWindow``, so it does not load as the reference's, nor the other
way round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..constants import QUAL_PAD, TOKEN_PAD
from ..features.extract import extract_read_features
from ..io.fastx import load_reads
from ..overlaps.paf import parse_paf
from ..pipeline.batching import tensorize
from .labels import read_labels
from .simulate import SimDataset, paf_rows, simulate
from .train import TrainBatch


@dataclass
class LabelledWindow:
    tokens: np.ndarray  # uint8 [L, 31]
    quals: np.ndarray  # uint8 [L, 31]
    support_flat: np.ndarray  # int32 [n_sup]
    labels: np.ndarray  # uint8 [n_sup]
    info: np.ndarray  # uint8 [n_sup]


def simulated_windows(
    ds: SimDataset,
    fastq_path: str,
    window_size: int,
    min_overlap: int = 500,
) -> list[LabelledWindow]:
    """All labelled windows of a simulated dataset."""
    ds.write_fastq(fastq_path)
    reads = load_reads(fastq_path, min_length=window_size)
    grouped = parse_paf(paf_rows(ds, min_overlap), reads.name_to_id)

    out: list[LabelledWindow] = []
    for rid, alns in grouped.items():
        sim_read = next(r for r in ds.reads if r.name == reads.ids[rid])
        feats = extract_read_features(rid, reads, alns, window_size)
        labels = read_labels(ds, sim_read, feats, window_size)
        for wf, (lab, info) in zip(feats, labels):
            if len(lab) == 0:
                continue
            wt = tensorize(wf)
            out.append(
                LabelledWindow(wt.tokens, wt.quals, wt.support_flat, lab, info)
            )
    return out


@dataclass(frozen=True)
class SimProfile:
    """One simulated training shard: an error/coverage/ploidy regime."""

    name: str
    sub_rate: float
    ins_rate: float
    del_rate: float
    het_rate: float
    n_reads: int
    genome_len: int = 200_000
    seed: int = 0
    # extra simulate() kwargs as (key, value) pairs — kept a tuple so the
    # frozen profile stays hashable (systematic-error shards use this)
    extra: tuple = ()


# Pooled multi-regime curriculum. Coverage spans what real runs see after
# the TOP_K=30 row cap (evals sit at ~20-25x; UL data ranges 15-90x);
# error rates span R10.4.1-like (2-4%) to R9.4.1-like (8-10%); het on by
# default with haploid and high-het shards so neither regime is baked in.
# Reads average ~8 windows, so each shard yields ~#reads*6-8 windows.
CURRICULUM: tuple[SimProfile, ...] = (
    SimProfile("r10-low15x", 0.02, 0.02, 0.02, 0.005, 95, seed=101),
    SimProfile("r10-mid28x", 0.02, 0.02, 0.02, 0.005, 175, seed=102),
    SimProfile("r10-high60x", 0.02, 0.02, 0.02, 0.005, 280, 150_000, seed=103),
    SimProfile("r10-clean30x", 0.01, 0.015, 0.015, 0.005, 190, seed=104),
    SimProfile("r9-noisy30x", 0.05, 0.03, 0.03, 0.005, 190, seed=105),
    SimProfile("r9-mid45x", 0.04, 0.025, 0.025, 0.005, 280, seed=106),
    SimProfile("haploid30x", 0.02, 0.02, 0.02, 0.0, 190, seed=107),
    SimProfile("het1pct30x", 0.02, 0.02, 0.02, 0.01, 190, seed=108),
    # Ultra-low-coverage shards: at >=15x the supported-column task is
    # saturated (the round-2 flagship scores 100% on every such shard), so
    # these are where residual learning happens — votes split and the
    # informative qual plane (v3, AUC ~0.8) is the tiebreaker. Round-3
    # probe: flagship hard-column acc 0.97/0.97/0.98 here vs 1.0 elsewhere.
    SimProfile("r9-low10x", 0.05, 0.03, 0.03, 0.005, 65, seed=109),
    SimProfile("r10-low9x", 0.02, 0.02, 0.02, 0.005, 60, seed=110),
    SimProfile("r9-low14x", 0.06, 0.035, 0.035, 0.005, 90, seed=111),
    # Systematic-error shards (round 4): locus-correlated confident
    # miscalls — the same wrong base across covering reads, half
    # strand-biased — plus chimeric junction reads and coverage dropouts.
    # Per-read-independent errors are separable by voting alone; these are
    # the regimes where the pileup's *structure* (strand case, phase
    # disagreement) is the only signal, i.e. where real-data robustness is
    # earned (the reference trains on real minimap2 pileups full of them).
    SimProfile(
        "sys30x", 0.02, 0.02, 0.02, 0.005, 190, seed=112,
        extra=(
            ("sys_rate", 0.002),
            ("sys_strength", (0.3, 0.8)),
            ("sys_strand_frac", 0.5),
        ),
    ),
    SimProfile(
        "sys-noisy22x", 0.04, 0.025, 0.025, 0.005, 140, seed=113,
        extra=(
            ("sys_rate", 0.003),
            ("sys_strength", (0.4, 0.9)),
            ("sys_strand_frac", 0.7),
        ),
    ),
    SimProfile(
        "sys-rough18x", 0.02, 0.02, 0.02, 0.005, 115, seed=114,
        extra=(
            ("sys_rate", 0.002),
            ("sys_strand_frac", 0.5),
            ("chimera_rate", 0.06),
            ("n_dropouts", 3),
            ("dropout_keep", 0.25),
        ),
    ),
)


def profile_windows(
    p: SimProfile, window_size: int, cache_dir: str | None = None
) -> list[LabelledWindow]:
    """Labelled windows of one profile, cached per-profile when a cache dir
    is given (featgen is the expensive part; each shard regenerates
    independently so interrupted builds resume)."""
    import os
    import pickle
    import tempfile

    # v3: qual realism recalibrated to ~0.8 AUC (the v2 parameterisation was
    # near-oracle — see _informative_quals — and collapsed training); v1 was
    # constant Q40. Stale versions must never be reused: the qual plane is a
    # real model input.
    cache = (
        os.path.join(cache_dir, f"{p.name}-w{window_size}-v3.pkl")
        if cache_dir
        else None
    )
    if cache and os.path.exists(cache):
        with open(cache, "rb") as fh:
            return pickle.load(fh)
    ds = simulate(
        genome_len=p.genome_len,
        n_reads=p.n_reads,
        read_len=(4 * window_size, 12 * window_size),
        sub_rate=p.sub_rate,
        ins_rate=p.ins_rate,
        del_rate=p.del_rate,
        het_rate=p.het_rate,
        seed=p.seed,
        **dict(p.extra),
    )
    with tempfile.TemporaryDirectory() as tmp:
        windows = simulated_windows(ds, f"{tmp}/reads.fastq", window_size)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        tmp_path = cache + ".tmp"
        with open(tmp_path, "wb") as fh:
            pickle.dump(windows, fh)
        os.replace(tmp_path, cache)
    return windows


def curriculum_windows(
    window_size: int,
    cache_dir: str | None = None,
    profiles: tuple[SimProfile, ...] = CURRICULUM,
    verbose: bool = True,
) -> list[LabelledWindow]:
    import sys

    out: list[LabelledWindow] = []
    for p in profiles:
        ws = profile_windows(p, window_size, cache_dir)
        if verbose:
            print(f"[data] {p.name}: {len(ws)} windows", file=sys.stderr)
        out.extend(ws)
    return out


def collate_train(
    windows: list[LabelledWindow], L: int, S: int
) -> TrainBatch:
    B = len(windows)
    R = windows[0].tokens.shape[1]
    # Row-major device layout [B, R, L] — column axis on the 128-lane minor
    # dim (same as inference batches, pipeline/batching.collate).
    tokens = np.full((B, R, L), TOKEN_PAD, dtype=np.uint8)
    quals = np.full((B, R, L), QUAL_PAD, dtype=np.uint8)
    sidx = np.zeros((B, S), dtype=np.int32)
    smask = np.zeros((B, S), dtype=bool)
    labels = np.zeros((B, S), dtype=np.int32)
    info = np.zeros((B, S), dtype=np.float32)
    for i, w in enumerate(windows):
        l = min(w.tokens.shape[0], L)
        s = min(w.support_flat.shape[0], S)
        tokens[i, :, :l] = w.tokens[:l].T
        quals[i, :, :l] = w.quals[:l].T
        keep = w.support_flat[:s] < L
        sidx[i, :s][keep] = w.support_flat[:s][keep]
        smask[i, :s] = keep
        labels[i, :s][keep] = w.labels[:s][keep]
        info[i, :s][keep] = w.info[:s][keep]
    return TrainBatch(tokens, quals, sidx, smask, labels, info)


def batch_iterator(
    windows: list[LabelledWindow],
    batch_size: int,
    L: int,
    S: int,
    n_epochs: int,
    seed: int = 0,
) -> Iterator[TrainBatch]:
    rng = np.random.default_rng(seed)
    for _ in range(n_epochs):
        order = rng.permutation(len(windows))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            batch = [windows[j] for j in order[i : i + batch_size]]
            yield collate_train(batch, L, S)


# Training-time (L, S) shape ladder. Production windows are W=4096 target
# bases plus reserved insertion columns — ~7-10k pileup columns at realistic
# coverage/error profiles — so training must cover the FULL width (a single
# 5120 pad silently truncated half of every window and ~45% of its supported
# columns; the model then saw untrained distributions at inference). Three
# buckets keep XLA at three compiled programs while not padding short
# windows to the worst case.
TRAIN_BUCKETS: tuple[tuple[int, int], ...] = (
    (5120, 768),
    (8192, 1024),
    (9216, 1152),
    (10240, 1536),
)


def bucketed_batch_iterator(
    windows: list[LabelledWindow],
    batch_size: int,
    n_epochs: int,
    seed: int = 0,
    buckets: tuple[tuple[int, int], ...] = TRAIN_BUCKETS,
) -> Iterator[TrainBatch]:
    """Shuffle windows into per-(L, S) bucket batches each epoch.

    A window lands in the smallest bucket that fits both its length and its
    supported count; windows exceeding the top bucket are truncated there
    (a handful of pathological outliers at most).
    """
    rng = np.random.default_rng(seed)
    assign: dict[tuple[int, int], list[int]] = {b: [] for b in buckets}
    top = buckets[-1]
    for j, w in enumerate(windows):
        for L, S in buckets:
            if w.tokens.shape[0] <= L and w.support_flat.shape[0] <= S:
                assign[(L, S)].append(j)
                break
        else:
            assign[top].append(j)

    for _ in range(n_epochs):
        batches: list[tuple[tuple[int, int], np.ndarray]] = []
        for key, idxs in assign.items():
            if len(idxs) < batch_size:
                continue
            order = rng.permutation(len(idxs))
            for i in range(0, len(order) - batch_size + 1, batch_size):
                batches.append((key, order[i : i + batch_size]))
        rng.shuffle(batches)
        for (L, S), rows in batches:
            idxs = assign[(L, S)]
            yield collate_train([windows[idxs[r]] for r in rows], L, S)
