"""Locate the systematic-regime quality gap: hotspot-resolved error audit,
corrected by the PyTorch/CUDA port.

The counterpart of tools/diag_systematic.py over ``herro_tpu_torch``: the
same simulation, window, buckets and report, the correction on the card
unless ``--device cpu`` is given. The reference's account of the audit:

The eval battery shows the flagship plateauing ~7.5 dB under the oracle on
the `systematic` regime while a focused fine-tune on systematic-error shards
transferred nothing (round 5: every regime regressed, systematic itself
-0.26 dB). This tool answers WHERE the residual errors live, by scoring the
corrected output per truth position against the simulator's hotspot maps
(SimDataset.sys_wrong/sys_p/sys_gate):

* error rate at non-hotspot columns vs hotspot columns, bucketed by the
  per-hotspot miscall probability (minority-truth columns with strength
  > 0.5 are majority-wrong pileups — counting CANNOT fix them and a voting
  model must actively overrule the pileup);
* at erroneous hotspot columns, whether the output IS the systematic wrong
  base (the model kept the correlated miscall) or a third base;
* the same split for the matched-features counting decode, so the model's
  contribution at hotspots is separated from its inheritance.

Usage: python tools/diag_systematic_torch.py [CKPT] [--out JSON] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the reference's simulation, window and buckets, and its FASTA reader
# (tools/diag_systematic.py:35-60; that module imports neither package until
# its _audit or main runs)
from diag_systematic import BUCKETS, SIM_KW, WINDOW, _read_fasta  # noqa: E402


def _audit(ds, reads, fasta_path: str) -> dict:
    """Per-truth-position error audit of ``fasta_path`` against the hotspot
    maps. Returns covered/error counts per column class."""
    from herro_tpu_torch.training.eval import _truth_context
    from herro_tpu_torch.training.simulate import _COMP
    from herro_tpu_torch.utils.align import align_to_truth

    by_name = _read_fasta(fasta_path)
    sys_p = ds.sys_p
    sys_wrong = ds.sys_wrong

    stats = {
        "normal": {"covered": 0, "errors": 0},
        "het": {"covered": 0, "errors": 0},
        "buckets": [
            {"lo": lo, "hi": hi, "covered": 0, "errors": 0,
             "kept_miscall": 0, "strand_gated_covered": 0,
             "strand_gated_errors": 0}
            for lo, hi in BUCKETS
        ],
    }

    for r in ds.reads:
        frags = by_name.get(r.name)
        if not frags:
            continue
        truth, other, het, _hp = _truth_context(ds, r)
        n = truth.shape[0]
        covered = np.zeros(n, dtype=bool)
        b2a_all = np.full(n, 254, dtype=np.uint8)
        for frag in frags:
            if len(frag) < 64:
                continue
            ta = align_to_truth(frag, truth)
            if ta is None:
                continue
            sl = slice(ta.j0, ta.j1)
            covered[sl] = True
            b2a_all[sl] = ta.b2a[sl]

        # genome position and orientation per truth index (chimera parts
        # concatenate their stored-orientation spans, eval.py:_truth_context)
        parts = r.parts if r.parts is not None else [r]
        gpos_chunks = []
        rc_chunks = []
        for p in parts:
            span = p.end - p.start
            if p.rc:
                g = np.arange(p.end - 1, p.start - 1, -1, dtype=np.int64)
            else:
                g = np.arange(p.start, p.end, dtype=np.int64)
            gpos_chunks.append(g)
            rc_chunks.append(np.full(span, p.rc, dtype=bool))
        gpos = np.concatenate(gpos_chunks)
        rcm = np.concatenate(rc_chunks)
        assert gpos.shape[0] == n, (gpos.shape, n, r.name)

        err = covered & (b2a_all != truth)
        p_here = sys_p[gpos]
        wrong_here = sys_wrong[gpos]
        # the stored-orientation wrong base (what the corrected fragment
        # would show if the miscall survived)
        wrong_stored = np.where(rcm, _COMP[wrong_here], wrong_here)
        gate_here = ds.sys_gate[gpos]
        hot = p_here > 0
        hetm = het if het is not None else np.zeros(n, dtype=bool)

        norm = covered & ~hot & ~hetm
        stats["normal"]["covered"] += int(norm.sum())
        stats["normal"]["errors"] += int(err[norm].sum())
        hc = covered & hetm & ~hot
        stats["het"]["covered"] += int(hc.sum())
        stats["het"]["errors"] += int(err[hc].sum())

        for b, (lo, hi) in zip(stats["buckets"], BUCKETS):
            m = covered & hot & (p_here >= lo) & (p_here < hi)
            b["covered"] += int(m.sum())
            b["errors"] += int(err[m].sum())
            b["kept_miscall"] += int((err & m & (b2a_all == wrong_stored)).sum())
            sg = m & (gate_here > 0)
            b["strand_gated_covered"] += int(sg.sum())
            b["strand_gated_errors"] += int(err[sg].sum())

    def _q(e, c):
        if c == 0:
            return None
        rate = max(e / c, 1e-9)
        return round(-10.0 * np.log10(rate), 2)

    stats["normal"]["q"] = _q(stats["normal"]["errors"], stats["normal"]["covered"])
    stats["het"]["q"] = _q(stats["het"]["errors"], stats["het"]["covered"])
    for b in stats["buckets"]:
        b["q"] = _q(b["errors"], b["covered"])
    return stats


def diagnose(ckpt: str, device=None, sim_kw: dict = SIM_KW) -> dict:
    """The audit of ``ckpt``'s correction and of the matched counting decode
    on the systematic simulation ``sim_kw``."""
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.pipeline.engine import run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner
    from herro_tpu_torch.training.eval import SIM_PROFILES
    from herro_tpu_torch.training.simulate import paf_rows, simulate

    ds = simulate(
        read_len=(3 * WINDOW, 8 * WINDOW),
        **sim_kw, **SIM_PROFILES["systematic"],
    )
    n_hot = int((ds.sys_p > 0).sum())
    print(f"[diag] {n_hot} hotspots over {sim_kw['genome_len']} bp",
          file=sys.stderr)

    cfg, params = load_or_init(ckpt)
    with tempfile.TemporaryDirectory() as tmp:
        fastq = os.path.join(tmp, "reads.fastq")
        ds.write_fastq(fastq)
        reads = load_reads(fastq, min_length=WINDOW)
        grouped = parse_paf(paf_rows(ds, min_overlap=WINDOW), reads.name_to_id)

        out = os.path.join(tmp, "corrected.fasta")
        cnt = os.path.join(tmp, "counting.fasta")
        runner = CorrectionRunner(cfg, params, collect_counting=True, device=device)
        run_correction(reads, iter(grouped.items()), runner, out, WINDOW, 16,
                       counting_output_path=cnt)

        return {
            "n_hotspots": n_hot,
            "model": _audit(ds, reads, out),
            "counting": _audit(ds, reads, cnt),
        }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", nargs="?", default="resources/model_r10_sim")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = ap.parse_args()

    report = diagnose(args.ckpt, args.device)
    for mode in ("model", "counting"):
        s = report[mode]
        print(f"--- {mode} ---")
        print(f"  normal cols: {s['normal']['errors']}/{s['normal']['covered']}"
              f" (Q{s['normal']['q']})")
        print(f"  het cols:    {s['het']['errors']}/{s['het']['covered']}"
              f" (Q{s['het']['q']})")
        for b in s["buckets"]:
            print(
                f"  hotspot p[{b['lo']:.2f},{b['hi']:.2f}): "
                f"{b['errors']}/{b['covered']} (Q{b['q']}), "
                f"kept-miscall {b['kept_miscall']}, "
                f"strand-gated {b['strand_gated_errors']}/{b['strand_gated_covered']}"
            )
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"[diag] wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
