"""minimap2 all-vs-all overlap driver.

Spawns ``minimap2 -cx ava-ont`` with the exact flag set of the reference
(src/mm2.rs:15-37) and streams a batch of target reads as FASTA to its stdin
while the full read file is the query; yields raw PAF rows from stdout.
"""

from __future__ import annotations

import shutil
import subprocess
import threading
from typing import IO, Iterator

from ..constants import MM2_ARGS
from ..io.fastx import ReadSet


def minimap2_available() -> bool:
    return shutil.which("minimap2") is not None


def run_minimap2(
    reads: ReadSet,
    batch_rids: range,
    reads_path: str,
    threads: int,
) -> tuple[subprocess.Popen, IO[bytes]]:
    """Start minimap2 with the batch streamed to stdin; returns (proc, stdout)."""
    proc = subprocess.Popen(
        ["minimap2", "-t", str(threads), *MM2_ARGS, "-", reads_path],
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
    )

    def feed() -> None:
        stdin = proc.stdin
        assert stdin is not None
        try:
            for rid in batch_rids:
                stdin.write(b">")
                stdin.write(reads.ids[rid])
                stdin.write(b"\n")
                stdin.write(reads.seq(rid).tobytes())
                stdin.write(b"\n")
        except BrokenPipeError:
            pass
        finally:
            try:
                stdin.close()
            except BrokenPipeError:
                pass

    threading.Thread(target=feed, daemon=True).start()
    assert proc.stdout is not None
    return proc, proc.stdout


def overlap_batches(
    reads: ReadSet,
    reads_path: str,
    threads: int,
    batch_size: int,
    stride: tuple[int, int] = (0, 1),
) -> Iterator[tuple[int, range, Iterator[bytes]]]:
    """Yield (batch_idx, target rid range, PAF line iterator) per 50k-read batch
    (reference: src/overlaps.rs:248-286). ``stride=(i, n)`` runs minimap2 only
    for every n-th batch (multi-host split)."""
    n = len(reads)
    for batch_idx, start in enumerate(range(0, n, batch_size)):
        if batch_idx % stride[1] != stride[0]:
            continue
        rids = range(start, min(start + batch_size, n))
        proc, stdout = run_minimap2(reads, rids, reads_path, threads)

        def lines(p=proc, out=stdout) -> Iterator[bytes]:
            with out:
                for line in out:
                    yield line
            p.wait()

        yield batch_idx, rids, lines()
