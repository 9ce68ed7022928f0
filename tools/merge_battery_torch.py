"""Merge a candidate checkpoint's matched-seed battery, run by the PyTorch/CUDA
port, into an eval-battery artifact and print the promotion-gate comparison.

The counterpart of tools/merge_battery.py: the gate (``gate_table``: the
``standard`` regime within 0.2 dB of the incumbent, het accuracy >= 99%) and
the merge are that tool's; ``--run`` runs the candidate's battery through
tools/eval_battery_torch.py (skipping the oracle, as the reference's does),
on the card unless ``--device cpu`` is given.

Usage:
    python tools/merge_battery_torch.py BATTERY.json CANDIDATE_CKPT [--run]
        [--promote-as resources/model_r10_sim] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from merge_battery import gate_table  # noqa: E402  (imports neither package)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("battery")
    ap.add_argument("candidate")
    ap.add_argument("--incumbent", default="resources/model_r10_sim")
    ap.add_argument("--run", action="store_true",
                    help="run the candidate's battery (card) before merging")
    ap.add_argument("--promote-as", default="")
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = ap.parse_args()

    with open(args.battery) as f:
        bat = json.load(f)

    if args.run:
        from eval_battery_torch import REGIMES, run_battery

        fresh = run_battery([args.candidate], list(REGIMES), with_oracle=False,
                            device=args.device)
        for reg, entry in fresh["regimes"].items():
            bat["regimes"][reg][args.candidate] = entry[args.candidate]

    for line in gate_table(bat, args.incumbent, args.candidate):
        print(line)

    if args.promote_as:
        for entry in bat["regimes"].values():
            if args.candidate in entry:
                entry[args.promote_as] = entry[args.candidate]

    with open(args.battery, "w") as f:
        json.dump(bat, f, indent=1)
    print(f"[merge] wrote {args.battery}", file=sys.stderr)


if __name__ == "__main__":
    main()
