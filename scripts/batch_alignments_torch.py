#!/usr/bin/env python
"""Route a PAF stream into 50k-read .oec.zst alignment batches, with the
PyTorch port alone (``herro_tpu_torch``; no JAX, no herro_tpu).

The counterpart of ``scripts/batch_alignments.py``, with the same arguments
and the same output, and the equivalent of the reference's scripts/batch.py
+ create_batched_alignments.sh:
reads a list of read ids and a PAF stream (file or stdin), routes each row by
its target id (column 6) into per-batch zstd files whose header is the batch's
read count + ids — byte-compatible with `herro inference --read-alns` in both
frameworks (``python -m herro_tpu_torch.cli inference --read-alns``).

Usage:
    minimap2 -t T -K8g -cx ava-ont -k25 -w17 -e200 -r150 -m2500 -f0.005 \
        -z200 --dual=yes reads.fastq reads.fastq \
      | python scripts/batch_alignments_torch.py rids.txt - outdir/
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from herro_tpu_torch.constants import READS_BATCH_SIZE  # noqa: E402
from herro_tpu_torch.overlaps.batches import BatchWriter  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("rids", help="file with one read id per line")
    ap.add_argument("alignments", help="PAF path, or - for stdin")
    ap.add_argument("outdir")
    ap.add_argument("--batch-size", type=int, default=READS_BATCH_SIZE)
    args = ap.parse_args()

    with open(args.rids, "rb") as fh:
        rids = [l.strip() for l in fh if l.strip()]
    batches = [
        rids[i : i + args.batch_size]
        for i in range(0, len(rids), args.batch_size)
    ]

    writers = [
        BatchWriter(args.outdir, i, batch) for i, batch in enumerate(batches)
    ]
    rid_to_batch = {}
    for i, batch in enumerate(batches):
        for rid in batch:
            rid_to_batch[rid] = i

    src = sys.stdin.buffer if args.alignments == "-" else open(args.alignments, "rb")
    n = 0
    for line in src:
        if not line.rstrip():
            continue
        tname = line.split(b"\t", 6)[5]
        idx = rid_to_batch.get(tname)
        if idx is not None:
            writers[idx].write(line)
            n += 1
    for w in writers:
        w.close()
    print(f"Routed {n} PAF rows into {len(writers)} batches.", file=sys.stderr)


if __name__ == "__main__":
    main()
