"""The demo run's corrected records, one name and sha256 each, with the
run's raw and corrected identity and Q.

The demo simulation of demo/run_demo.py (150 kb genome, 160 reads, 2% sub /
2% ins / 2% del, 0.5% het, seed 777, window 4096, batch 16) is corrected
through herro_tpu (JAX) and every corrected FASTA record is recorded by its
name and the sha256 of its sequence, so that another implementation can be
held against it record by record (tools/demo_record_torch.py, the port's
side, compares with this file).

Usage:
    JAX_PLATFORMS=cpu python tools/demo_record.py OUT.json [CKPT]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# demo/run_demo.py's simulation and evaluate()'s defaults for it
DEMO = dict(genome_len=150_000, n_reads=160, sub_rate=0.02, ins_rate=0.02,
            del_rate=0.02, het_rate=0.005, seed=777)
WINDOW = 4096
BATCH = 16


def fasta_digests(path: str) -> dict[str, str]:
    """{record name: sha256 hex of its sequence} of a corrected FASTA."""
    out: dict[str, str] = {}
    name, seq = None, []
    with open(path, "rb") as fh:
        for line in list(fh) + [b">"]:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    if name in out:
                        raise ValueError(f"record {name} twice in {path}")
                    out[name] = hashlib.sha256(b"".join(seq)).hexdigest()
                name, seq = line[1:].split(b" ")[0].decode(), []
            elif line:
                seq.append(line)
    return out


def record(pkg, ckpt: str, **runner_kw) -> dict:
    """The demo run through package ``pkg`` (a dict of its functions: see
    main), its records and scores."""
    t0 = time.time()
    ds = pkg["simulate"](read_len=(3 * WINDOW, 8 * WINDOW), **DEMO)
    cfg, params = pkg["load_model"](ckpt)
    with tempfile.TemporaryDirectory() as tmp:
        fastq = os.path.join(tmp, "reads.fastq")
        ds.write_fastq(fastq)
        reads = pkg["load_reads"](fastq, min_length=WINDOW)
        grouped = pkg["parse_paf"](pkg["paf_rows"](ds, min_overlap=WINDOW),
                                   reads.name_to_id)
        out = os.path.join(tmp, "corrected.fasta")
        runner = pkg["CorrectionRunner"](cfg, params, **runner_kw)
        pkg["run_correction"](reads, iter(grouped.items()), runner, out, WINDOW, BATCH)
        acc = pkg["ScoreAccumulator"]()
        pkg["score_fragments"](ds, reads, out, acc)
        records = fasta_digests(out)
    scores = acc.as_dict()
    return dict(
        simulation=dict(DEMO, window_size=WINDOW, batch_size=BATCH),
        checkpoint=os.path.relpath(os.path.abspath(ckpt)),
        n_records=len(records),
        **{k: scores[k] for k in ("raw_identity", "raw_q", "corrected_identity",
                                  "corrected_q", "corrected_infix_identity",
                                  "corrected_infix_q")},
        wall_s=time.time() - t0,
        records=records,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("ckpt", nargs="?", default="resources/model_r10_sim")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from herro_tpu.io.fastx import load_reads
    from herro_tpu.models.checkpoint import load_model
    from herro_tpu.overlaps.paf import parse_paf
    from herro_tpu.pipeline.engine import run_correction
    from herro_tpu.pipeline.infer import CorrectionRunner
    from herro_tpu.training.eval import ScoreAccumulator, score_fragments
    from herro_tpu.training.simulate import paf_rows, simulate

    rec = record(dict(
        simulate=simulate, load_model=load_model, load_reads=load_reads,
        parse_paf=parse_paf, paf_rows=paf_rows, CorrectionRunner=CorrectionRunner,
        run_correction=run_correction, ScoreAccumulator=ScoreAccumulator,
        score_fragments=score_fragments,
    ), args.ckpt)
    wall_s = rec.pop("wall_s")  # this host's, not a property of the record
    rec["implementation"] = f"herro_tpu (JAX {jax.__version__}, {jax.default_backend()})"
    with open(args.output, "w") as fh:
        json.dump(rec, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"[demo_record] {rec['n_records']} records, raw Q{rec['raw_q']:.2f} -> "
          f"corrected Q{rec['corrected_q']:.2f} ({wall_s:.0f}s); wrote "
          f"{args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
