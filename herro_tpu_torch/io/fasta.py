"""Corrected-read FASTA output.

Matches the reference writer byte-for-byte (src/lib.rs:267-317): a read whose
correction was split into multiple fragments gets ``:{i}`` suffixes on its id;
the original description (if any) is carried over after a space.
"""

from __future__ import annotations

import io
from typing import Sequence


def write_corrected(
    writer: io.BufferedIOBase,
    read_id: bytes,
    description: bytes | None,
    seqs: Sequence[bytes],
) -> None:
    if len(seqs) == 1:
        _write_one(writer, read_id, description, None, seqs[0])
    else:
        for i, seq in enumerate(seqs):
            _write_one(writer, read_id, description, i, seq)


def _write_one(
    writer: io.BufferedIOBase,
    read_id: bytes,
    description: bytes | None,
    idx: int | None,
    seq: bytes,
) -> None:
    writer.write(b">")
    writer.write(read_id)
    if idx is not None:
        writer.write(b":%d " % idx)
    else:
        writer.write(b" ")
    if description is not None:
        writer.write(description)
    writer.write(b"\n")
    writer.write(seq)
    writer.write(b"\n")
