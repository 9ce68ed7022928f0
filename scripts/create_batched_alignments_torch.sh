#!/bin/bash
# All-vs-all overlap + durable alignment batching (offline, preferred for big
# runs), with the PyTorch port alone: create_batched_alignments.sh piping
# into batch_alignments_torch.py (herro_tpu_torch; no JAX, no herro_tpu).
# Equivalent of the reference's scripts/create_batched_alignments.sh:
# minimap2 ava-ont with the exact in-process flag set, piped into the batch
# router.
#
# Usage: create_batched_alignments_torch.sh <reads.fastq[.gz]> <rids.txt> <threads> <outdir>
set -e

script_dir=$(dirname "$0")
minimap2=${MINIMAP2:-minimap2}

reads=$1
rids=$2
threads=$3
outdir=$4

mkdir -p "$outdir"

$minimap2 -t "$threads" -K8g -cx ava-ont -k25 -w17 -e200 -r150 -m2500 \
    -f0.005 -z200 --dual=yes "$reads" "$reads" \
  | python "${script_dir}/batch_alignments_torch.py" "$rids" - "$outdir"
