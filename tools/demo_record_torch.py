"""The demo run through the PyTorch/CUDA port, held record by record against
the reference's record.

Corrects demo/run_demo.py's simulation (150 kb genome, 160 reads, seed 777,
window 4096, batch 16) with ``herro_tpu_torch`` (on the card unless
``--device cpu`` is given) and compares every corrected FASTA record, by its
name and the sha256 of its sequence, with the record tools/demo_record.py
made through herro_tpu (``tests/torch_data/demo_seed777_herro_tpu.json``):
prints the share of byte-identical records and both runs' raw and corrected
identity and Q as one JSON object.

Usage: python tools/demo_record_torch.py [CKPT] [--reference JSON] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from demo_record import record  # noqa: E402  (imports neither package)

REFERENCE = os.path.join(os.path.dirname(HERE), "tests", "torch_data",
                         "demo_seed777_herro_tpu.json")
SCORES = ("raw_identity", "raw_q", "corrected_identity", "corrected_q",
          "corrected_infix_identity", "corrected_infix_q")


def compare(ckpt: str = "resources/model_r10_sim", reference: str = REFERENCE,
            device=None) -> dict:
    """The port's demo record against the reference's: counts, the share of
    byte-identical records (over the names either run wrote) and the scores
    of both."""
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.pipeline.engine import run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner
    from herro_tpu_torch.training.eval import ScoreAccumulator, score_fragments
    from herro_tpu_torch.training.simulate import paf_rows, simulate

    with open(reference) as fh:
        ref = json.load(fh)
    got = record(dict(
        simulate=simulate, load_model=load_model, load_reads=load_reads,
        parse_paf=parse_paf, paf_rows=paf_rows, CorrectionRunner=CorrectionRunner,
        run_correction=run_correction, ScoreAccumulator=ScoreAccumulator,
        score_fragments=score_fragments,
    ), ckpt, device=device)
    names = set(got["records"]) | set(ref["records"])
    same = sum(got["records"].get(n) == ref["records"].get(n) for n in names)
    return dict(
        records=len(got["records"]), reference_records=len(ref["records"]),
        identical=same, share_identical=same / max(len(names), 1),
        **{k: got[k] for k in SCORES},
        **{f"reference_{k}": ref[k] for k in SCORES},
        corrected_q_gap_db=got["corrected_q"] - ref["corrected_q"],
        wall_s=got["wall_s"], reference_implementation=ref["implementation"],
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", nargs="?", default="resources/model_r10_sim")
    ap.add_argument("--reference", default=REFERENCE)
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = ap.parse_args()
    print(json.dumps(compare(args.ckpt, args.reference, args.device)))


if __name__ == "__main__":
    main()
