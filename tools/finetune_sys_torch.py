"""Systematic-robustness fine-tune of the flagship checkpoint, trained by the
PyTorch/CUDA port.

The counterpart of tools/finetune_sys.py: the same ten-shard mix of the
curriculum (the three systematic-error shards and seven anchors of the gated
regimes), ``Trainer(..., hard_weight=3.0)`` on the bucket ladder, a
checkpoint every 250 steps and at the end. Trains on the card unless
``--device cpu`` is given.

The curriculum cache holds pickles of each package's own ``LabelledWindow``
under the same file names, so a cache that herro_tpu wrote cannot be read
here: the tool refuses it by name and asks for a cache directory of the
port's own.

Usage: python tools/finetune_sys_torch.py OUT_DIR [--steps 600] [--lr 1e-4]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickletools
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WINDOW = 4096

# tools/finetune_sys.py:44-59, by CURRICULUM name
MIX = (
    # systematic-error shards: the fine-tune target
    "sys30x",
    "sys-noisy22x",
    "sys-rough18x",
    # anchors: keep the gated regimes in the gradient
    "r10-low15x",
    "r10-mid28x",
    "r10-high60x",
    "r10-clean30x",
    "r9-noisy30x",
    "r9-mid45x",
    "r9-low10x",
)


def mix_profiles() -> tuple:
    from herro_tpu_torch.training.data import CURRICULUM

    by_name = {p.name: p for p in CURRICULUM}
    return tuple(by_name[n] for n in MIX)


def pickled_module(path: str) -> str:
    """The module of the first class a pickle names (its windows' class),
    read from the opcode stream without unpickling anything."""
    strings: list[str] = []
    with open(path, "rb") as fh:
        for op, arg, _ in pickletools.genops(fh):
            if op.name == "GLOBAL":
                return arg.split(" ")[0]
            if op.name == "STACK_GLOBAL":
                return strings[-2]
            if isinstance(arg, str):
                strings.append(arg)
    return ""


def foreign_caches(cache_dir: str, profiles, window_size: int = WINDOW) -> list[str]:
    """The cache files of ``profiles`` in ``cache_dir`` that another package
    than herro_tpu_torch wrote (profile_windows' file names)."""
    out = []
    for p in profiles:
        path = os.path.join(cache_dir, f"{p.name}-w{window_size}-v3.pkl")
        if os.path.exists(path) and not pickled_module(path).startswith("herro_tpu_torch."):
            out.append(path)
    return out


def finetune(windows, cfg, params, output: str, steps: int, lr: float, batch_size: int,
             seed: int = 0, device=None, log_every: int = 50, save_every: int = 250):
    """``steps`` steps of the fine-tune on ``windows``; saves to ``output``
    every ``save_every`` steps and at the end. Returns the trainer."""
    from herro_tpu_torch.models.checkpoint import save_model
    from herro_tpu_torch.training.data import bucketed_batch_iterator
    from herro_tpu_torch.training.train import Trainer

    trainer = Trainer(cfg, params, lr=lr, total_steps=steps, hard_weight=3.0, device=device)
    it = bucketed_batch_iterator(windows, batch_size, n_epochs=10_000, seed=seed)
    for batch in it:
        metrics = trainer.train_step(batch)
        if trainer.state.step % log_every == 0:
            print(
                f"step {trainer.state.step}: "
                + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
                file=sys.stderr, flush=True,
            )
        if trainer.state.step % save_every == 0:
            trainer.save(output)
        if trainer.state.step >= steps:
            break
    save_model(output, cfg, trainer.state.params)
    return trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("--base", default="resources/model_r10_sim")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--cache", default="/tmp/currcache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = ap.parse_args()

    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.training.data import curriculum_windows

    mix = mix_profiles()
    foreign = foreign_caches(args.cache, mix)
    if foreign:
        ap.error(f"{len(foreign)} cache files in {args.cache} were not written by "
                 f"herro_tpu_torch (e.g. {foreign[0]}): give the port a --cache of its own")
    windows = curriculum_windows(WINDOW, cache_dir=args.cache, profiles=mix)
    print(f"[finetune] {len(windows)} windows from {len(mix)} shards", file=sys.stderr)

    cfg, params = load_or_init(args.base)
    finetune(windows, cfg, params, args.output, args.steps, args.lr, args.batch_size,
             seed=args.seed, device=args.device)
    print(f"[finetune] saved {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
