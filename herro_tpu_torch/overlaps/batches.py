"""Durable ``.oec.zst`` alignment batch files.

Byte-compatible with the reference's batch format (src/overlaps.rs:248-323 and
scripts/batch.py): a zstd stream whose first line is the number of target
reads in the batch, followed by one target id per line, followed by raw PAF
rows routed to this batch by target id.
"""

from __future__ import annotations

import glob
import io
import os
from typing import IO, Iterator


class BatchWriter:
    """Write one ``{idx}.oec.zst`` batch: header then raw PAF lines."""

    def __init__(self, dir_path: str, batch_idx: int, target_ids: list[bytes]):
        import zstandard as zstd

        os.makedirs(dir_path, exist_ok=True)
        path = os.path.join(dir_path, f"{batch_idx}.oec.zst")
        self._fh = open(path, "wb")
        self._stream: IO[bytes] = zstd.ZstdCompressor().stream_writer(self._fh)
        self._stream.write(b"%d\n" % len(target_ids))
        for rid in target_ids:
            self._stream.write(rid + b"\n")

    def write(self, line: bytes) -> None:
        self._stream.write(line)

    def close(self) -> None:
        self._stream.close()

    def __enter__(self) -> "BatchWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def list_batches(dir_path: str) -> list[str]:
    return sorted(glob.glob(os.path.join(dir_path, "*.oec.zst")))


def read_batch(path: str) -> tuple[list[bytes], Iterator[bytes]]:
    """Return (header target ids, iterator over raw PAF lines)."""
    import zstandard as zstd

    fh = open(path, "rb")
    reader = io.BufferedReader(
        zstd.ZstdDecompressor().stream_reader(fh), buffer_size=1 << 20
    )
    n_targets = int(reader.readline())
    ids = [reader.readline().rstrip(b"\n") for _ in range(n_targets)]

    def lines() -> Iterator[bytes]:
        with reader:
            for line in reader:
                yield line
        fh.close()

    return ids, lines()
