#!/usr/bin/env python
"""End-to-end demo / acceptance test of the PyTorch/CUDA port.

The counterpart of demo/run_demo.py: simulates an R10-like dataset with known
ground truth (150 kb genome, 160 reads, 2 % sub / 2 % ins / 2 % del, 0.5 % het,
seed 777), corrects it end to end through ``herro_tpu_torch``'s pipeline, and
reports per-base identity / Q before and after. Runs on the card unless
``--device cpu`` is given.

Usage:
    python demo/run_demo_torch.py [checkpoint-or-config] [--big] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("model", nargs="?", default="resources/model_r10_sim")
    ap.add_argument("--big", action="store_true", help="~40x 1Mb genome")
    ap.add_argument("-w", "--window-size", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args()

    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.models.model import CONFIGS
    from herro_tpu_torch.training.eval import evaluate

    model = args.model
    if not os.path.isdir(model) and model not in CONFIGS:
        print(f"checkpoint {model} not found; using random-weight r10", file=sys.stderr)
        model = "r10"
    cfg, params = load_or_init(model)

    kw = dict(genome_len=1_000_000, n_reads=1300) if args.big else dict(
        genome_len=150_000, n_reads=160
    )
    t0 = time.time()
    res = evaluate(
        cfg,
        params,
        window_size=args.window_size,
        sub_rate=0.02,
        ins_rate=0.02,
        del_rate=0.02,
        het_rate=0.005,
        seed=777,
        device=args.device,
        **kw,
    )
    out = res.as_dict()
    out["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(out, indent=1))

    ok = res.corrected_identity > res.raw_identity
    print(
        ("PASS" if ok else "FAIL")
        + f": raw Q{res.raw_q:.1f} -> corrected Q{res.corrected_q:.1f}",
        file=sys.stderr,
    )
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
