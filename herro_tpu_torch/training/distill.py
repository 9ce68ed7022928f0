"""Knowledge distillation: label `features` npy dumps with a teacher
checkpoint and train a student on them.

This is the training path for data that has no simulator truth: the
`features` subcommand dumps window pileups (the reference's FeatsGenOutput
layout, src/features.rs:724-839), a teacher model supplies per-supported-
column labels, and the normal Trainer fits a (typically smaller/faster)
student. Public precedent: "Knowledge distillation for fast and accurate DNA
sequence correction" (arXiv:2211.09862).

The port of ``herro_tpu/training/distill.py``: the teacher runs the inference
step (the card's kernels, the counting rule's included), the student trains
through :class:`Trainer`, on one device or, given a mesh, both over it.
"""

from __future__ import annotations

import os

import numpy as np

from ..pipeline.batching import BucketSpec, encode_window
from .data import LabelledWindow


def windows_from_dump(dump_dir: str) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(bases, quals, supported) triples from a `features` output tree."""
    out = []
    for read_dir in sorted(os.listdir(dump_dir)):
        d = os.path.join(dump_dir, read_dir)
        if not os.path.isdir(d):
            continue
        wids = sorted(
            int(f.split(".")[0])
            for f in os.listdir(d)
            if f.endswith(".features.npy")
        )
        for wid in wids:
            feats = np.load(os.path.join(d, f"{wid}.features.npy"))
            supported = np.load(os.path.join(d, f"{wid}.supported.npy"))
            out.append((feats[0], feats[1], supported))
    return out


def _tensorize_dump(bases: np.ndarray, quals: np.ndarray, supported: np.ndarray):
    tokens, support_flat = encode_window(bases, supported)
    return tokens, quals, support_flat


def teacher_label_windows(
    teacher_cfg,
    teacher_params,
    dumped: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    batch_size: int = 16,
    device=None,
    mesh=None,
) -> list[LabelledWindow]:
    """Run the teacher over dumped windows; emit hard labels + info flags.

    Uses the production CorrectionRunner machinery (bucketed static shapes,
    pipelined dispatch) with ``collect_info`` on, on ``device`` (the card
    unless the caller asks for the CPU) or over ``mesh`` (whose data axis
    must divide ``batch_size``).
    """
    from ..pipeline.batching import BucketBatcher
    from ..pipeline.infer import CorrectionRunner
    from ..pipeline.batching import WindowTensors

    runner = CorrectionRunner(
        teacher_cfg, teacher_params, collect_info=True, device=device, mesh=mesh
    )
    batcher = BucketBatcher(BucketSpec(), batch_size)

    staged: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    labelled: list[LabelledWindow] = []

    def emit(results):
        for res in results:
            tokens, quals, support_flat = staged.pop(res.rid)
            labels = res.decisions[support_flat].astype(np.uint8)
            info = (res.info > 0).astype(np.uint8) if res.info is not None else (
                np.zeros(len(support_flat), dtype=np.uint8)
            )
            labelled.append(
                LabelledWindow(tokens, quals, support_flat, labels, info)
            )

    pending = []
    for i, (bases, quals, supported) in enumerate(dumped):
        tokens, quals_u8, support_flat = _tensorize_dump(bases, quals, supported)
        if len(support_flat) == 0:
            continue
        staged[i] = (tokens, quals_u8, support_flat)
        wt = WindowTensors(
            rid=i,
            wid=0,
            n_alns=30,
            n_total_wins=1,
            tokens=tokens,
            quals=quals_u8,
            support_flat=support_flat,
            supported=supported,
        )
        batch = batcher.add(wt)
        if batch is not None:
            pending.append(runner.dispatch(batch))
            if len(pending) >= 3:
                emit(runner.finalize(pending.pop(0)))
    for batch in batcher.flush():
        pending.append(runner.dispatch(batch))
    while pending:
        emit(runner.finalize(pending.pop(0)))
    return labelled


def distill_from_dump(
    dump_dir: str,
    teacher: str,
    student_cfg_name: str,
    out_dir: str,
    steps: int = 500,
    batch_size: int = 16,
    lr: float = 3e-4,
    max_len: int = 5120,
    max_sup: int = 640,
    seed: int = 0,
    device=None,
    mesh=None,
) -> dict:
    """features-dump -> teacher labels -> student training -> checkpoint,
    on ``device`` or over ``mesh`` (``Trainer(mesh=...)``)."""
    from ..models.checkpoint import load_or_init, save_model
    from .data import batch_iterator
    from .train import Trainer

    if device is not None and mesh is not None:
        raise ValueError("distill_from_dump takes a device or a mesh, not both")
    tcfg, tparams = load_or_init(teacher)
    dumped = windows_from_dump(dump_dir)
    labelled = teacher_label_windows(
        tcfg, tparams, dumped, batch_size=batch_size, device=device, mesh=mesh
    )
    if not labelled:
        raise ValueError(f"no labelled windows produced from {dump_dir}")

    scfg, sparams = load_or_init(student_cfg_name)
    trainer = Trainer(scfg, sparams, lr=lr, total_steps=steps, device=device, mesh=mesh)
    it = batch_iterator(
        labelled, batch_size, L=max_len, S=max_sup, n_epochs=10_000, seed=seed
    )
    last = {}
    for batch in it:
        last = trainer.train_step(batch)
        if trainer.state.step >= steps:
            break
    save_model(out_dir, scfg, trainer.state.params)
    return {"n_windows": len(labelled), "final": last}
