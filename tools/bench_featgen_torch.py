"""Featgen-only microbenchmark: extract_read_features windows/s on one core,
with the PyTorch port alone (``herro_tpu_torch``; no JAX, no herro_tpu).

The counterpart of ``tools/bench_featgen.py``: the same simulations, the same
output. Featgen runs on the host only, so the numbers are the host's:

    python tools/bench_featgen_torch.py

Profiles match the round-2/3 measurement points (README perf table): ~30x
R10-like (2% ins) and ~90x heavy coverage. Run with HERRO_TPU_NATIVE=0 for
the numpy-fallback number.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from herro_tpu_torch.features.extract import extract_read_features  # noqa: E402
from herro_tpu_torch.io.fastx import load_reads  # noqa: E402
from herro_tpu_torch.overlaps.paf import parse_paf  # noqa: E402
from herro_tpu_torch.training.simulate import paf_rows, simulate  # noqa: E402

W = 4096


def bench(name: str, n_reads: int, genome_len: int, reps: int = 2) -> float:
    ds = simulate(
        genome_len=genome_len,
        n_reads=n_reads,
        read_len=(3 * W, 8 * W),
        sub_rate=0.02,
        ins_rate=0.02,
        del_rate=0.02,
        het_rate=0.005,
        seed=97,
    )
    rows = paf_rows(ds, min_overlap=W)
    with tempfile.TemporaryDirectory() as tmp:
        fastq = os.path.join(tmp, "r.fastq")
        ds.write_fastq(fastq)
        reads = load_reads(fastq, min_length=W)
    grouped = parse_paf(rows, reads.name_to_id)

    n_windows = 0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        n_windows = 0
        for rid, alns in grouped.items():
            n_windows += len(extract_read_features(rid, reads, alns, W))
        best = min(best, time.perf_counter() - t0)
    ws = n_windows / best
    print(f"{name}: {n_windows} windows in {best:.2f}s -> {ws:.0f} windows/s/core")
    return ws


if __name__ == "__main__":
    bench("~30x", n_reads=200, genome_len=150_000)
    bench("~90x", n_reads=264, genome_len=66_000)
