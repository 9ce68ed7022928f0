"""Matched-seed eval battery of the PyTorch/CUDA port: regimes x checkpoints
-> one JSON artifact.

The counterpart of tools/eval_battery.py over ``herro_tpu_torch``: the same
regimes, defaults, seeds and JSON shape, so tools/quality_table.py renders
its output unchanged and tools/merge_battery.py's gate reads it; the file
also names where it ran (``device``: the card's name and power limit). Every run
in a regime shares the seed, so floors (counting), candidates and ceilings
(oracle) are scored on byte-identical features. Runs on the card unless
``--device cpu`` is given.

Usage:
    python tools/eval_battery_torch.py OUT.json CKPT [CKPT ...]
        [--regimes standard,r9,lowcov10x] [--skip-oracle] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the reference's regimes and defaults (tools/eval_battery.py:28-46; that
# module imports neither package until its run_battery runs)
from eval_battery import DEFAULTS, REGIMES  # noqa: E402


def run_battery(
    ckpts: list[str],
    regimes: list[str],
    with_oracle: bool = True,
    device=None,
) -> dict:
    """The battery over ``ckpts`` on ``device`` (the card by default)."""
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.training.eval import SIM_PROFILES, evaluate

    out: dict = {"defaults": DEFAULTS, "regimes": {}}
    loaded = [(c, *load_or_init(c)) for c in ckpts]
    for reg in regimes:
        kw = {**DEFAULTS, **REGIMES[reg]}
        if "profile" in kw:
            kw["sim_extra"] = SIM_PROFILES[kw.pop("profile")]
        entry: dict = {"params": {k: v for k, v in kw.items() if k != "batch_size"}}
        if with_oracle:
            t0 = time.time()
            res = evaluate(loaded[0][1], loaded[0][2], mode="oracle", device=device, **kw)
            entry["oracle"] = res.as_dict()
            print(
                f"[battery] {reg}/oracle: infix Q"
                f"{res.corrected_infix_q:.2f} ({time.time() - t0:.0f}s)",
                file=sys.stderr,
            )
        for name, cfg, params in loaded:
            t0 = time.time()
            res = evaluate(cfg, params, with_baseline=True, device=device, **kw)
            d = res.as_dict()
            entry[name] = d
            het = d.get("het", {}).get("accuracy")
            print(
                f"[battery] {reg}/{name}: infix Q{res.corrected_infix_q:.2f}"
                f" het={het if het is None else f'{het:.3f}'}"
                f" gain={d.get('model_gain_db'):.2f}dB"
                f" ({time.time() - t0:.0f}s)",
                file=sys.stderr,
            )
        out["regimes"][reg] = entry
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("ckpts", nargs="+")
    ap.add_argument("--regimes", default=",".join(REGIMES))
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = ap.parse_args()

    regimes = [r for r in args.regimes.split(",") if r]
    unknown = set(regimes) - set(REGIMES)
    if unknown:
        ap.error(f"unknown regimes: {sorted(unknown)}")
    result = run_battery(args.ckpts, regimes, with_oracle=not args.skip_oracle,
                         device=args.device)
    # where the numbers were taken: the card's name and power limit, or the CPU
    from herro_tpu_torch.pipeline.infer import resolve_device
    from herro_tpu_torch.pipeline.steptime import card

    result["device"] = card() if resolve_device(args.device).type == "cuda" else "cpu"
    with open(args.output, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[battery] wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
