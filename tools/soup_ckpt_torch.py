"""Interpolate two checkpoints of the same topology (model soup), with the
PyTorch/CUDA port's checkpoint reader and writer.

The counterpart of tools/soup_ckpt.py: theta = (1-alpha) * base + alpha *
other for every parameter leaf, in float32 on the host, written through
``herro_tpu_torch.models.checkpoint.save_model`` (a checkpoint both packages
load). Refuses two checkpoints whose configs differ.

Usage: python tools/soup_ckpt_torch.py BASE OTHER OUT --alpha 0.5
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def soup(base: str, other: str, output: str, alpha: float) -> None:
    """Write the soup of ``base`` and ``other`` at ``alpha`` (the weight on
    ``other``) to ``output``."""
    from herro_tpu_torch.models.checkpoint import load_model, save_model

    cfg_b, pb = load_model(base)
    cfg_o, po = load_model(other)
    if cfg_b != cfg_o:
        raise ValueError(f"topology mismatch: {cfg_b} vs {cfg_o}")
    mixed = {k: (1.0 - alpha) * v + alpha * po[k] for k, v in pb.items()}
    save_model(output, cfg_b, mixed)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("base")
    ap.add_argument("other")
    ap.add_argument("output")
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="weight on OTHER (0 = pure base, 1 = pure other)")
    args = ap.parse_args()
    try:
        soup(args.base, args.other, args.output, args.alpha)
    except ValueError as e:
        ap.error(str(e))
    print(f"[soup] wrote {args.output} (alpha={args.alpha} on {args.other})",
          file=sys.stderr)


if __name__ == "__main__":
    main()
