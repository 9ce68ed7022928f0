"""FASTQ(.gz) reading into a shared, packed read set.

Mirrors the reference read-ingest semantics (src/haec_io.rs:37-75 and
src/lib.rs:241-265):

* reads shorter than the window size are dropped;
* the read id is everything before the first space/tab, the remainder is kept
  as the description;
* quality strings are required;
* an optional cluster membership filter (core + neighbour id sets) is applied;
* a path may be a single fastq(.gz) file or a directory whose ``*.fastq`` /
  ``*.fastq.gz`` members are concatenated.
"""

from __future__ import annotations

import glob
import gzip
import io
import os
from dataclasses import dataclass, field

import numpy as np

from .seqstore import PackedSeqs


@dataclass
class ReadSet:
    """All reads of one correction shard.

    Sequences live 2-bit packed in one arena (``seqs``); qualities live as raw
    phred+33 bytes in a second arena so every worker indexes the same buffers.
    """

    ids: list[bytes]
    descriptions: list[bytes | None]
    seqs: PackedSeqs
    quals: np.ndarray  # uint8 arena of phred+33 bytes
    qual_offsets: np.ndarray  # int64, len n_reads+1
    name_to_id: dict[bytes, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.name_to_id:
            self.name_to_id = {name: i for i, name in enumerate(self.ids)}

    def __len__(self) -> int:
        return len(self.ids)

    def length(self, rid: int) -> int:
        return self.seqs.length(rid)

    def seq(self, rid: int, start: int = 0, end: int | None = None, rc: bool = False) -> np.ndarray:
        return self.seqs.get(rid, start, end, rc=rc)

    def qual(self, rid: int, start: int = 0, end: int | None = None) -> np.ndarray:
        base = int(self.qual_offsets[rid])
        stop = int(self.qual_offsets[rid + 1])
        if end is None:
            end = stop - base
        return self.quals[base + start : base + end]

    @property
    def max_length(self) -> int:
        return int(self.seqs.lengths.max()) if len(self.ids) else 0


def _open_maybe_gz(path: str) -> io.BufferedReader:
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb")


def _iter_fastx(path: str):
    """Yield (id_line_bytes, seq, qual_or_None) records from fasta/fastq."""
    with _open_maybe_gz(path) as fh:
        first = fh.peek(1)[:1] if hasattr(fh, "peek") else b""
        if not first:
            line = fh.readline()
            if not line:
                return
            first = line[:1]
            records = _parse_stream(fh, first, line)
        else:
            records = _parse_stream(fh, first, None)
        yield from records


def _parse_stream(fh, first: bytes, pushback: bytes | None):
    if first == b"@":
        # FASTQ
        line = pushback if pushback is not None else fh.readline()
        while line:
            header = line.rstrip(b"\r\n")
            seq = fh.readline().rstrip(b"\r\n")
            fh.readline()  # '+'
            qual = fh.readline().rstrip(b"\r\n")
            if not header.startswith(b"@"):
                raise ValueError(f"Malformed FASTQ record header: {header[:50]!r}")
            yield header[1:], seq, qual
            line = fh.readline()
    elif first == b">":
        # FASTA (no qualities)
        header = None
        chunks: list[bytes] = []
        line = pushback if pushback is not None else fh.readline()
        while line:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if header is not None:
                    yield header, b"".join(chunks), None
                header = line[1:]
                chunks = []
            elif line:
                chunks.append(line)
            line = fh.readline()
        if header is not None:
            yield header, b"".join(chunks), None
    else:
        raise ValueError(f"Unrecognised fastx leader byte: {first!r}")


def _split_header(header: bytes) -> tuple[bytes, bytes | None]:
    for sep in (b" ", b"\t"):
        pos = header.find(sep)
        if pos != -1:
            return header[:pos], header[pos + 1 :]
    return header, None


def list_read_files(path: str) -> list[str]:
    """A file path as-is, or a directory's *.fastq / *.fastq.gz members."""
    if os.path.isfile(path):
        return [path]
    members = sorted(glob.glob(os.path.join(path, "*")))
    return [m for m in members if m.endswith(".fastq") or m.endswith(".fastq.gz")]


def load_reads(
    path: str,
    min_length: int,
    core: set[str] | None = None,
    neighbour: set[str] | None = None,
    require_quals: bool = True,
) -> ReadSet:
    """Load every read of ``path`` (file or directory) into a ReadSet.

    ``min_length`` is the window size: shorter reads can never produce a full
    window and are dropped up front (reference: src/haec_io.rs:48-50).
    When both ``core`` and ``neighbour`` are given, only members of their union
    are kept (reference: src/haec_io.rs:62-68).
    """
    ids: list[bytes] = []
    descriptions: list[bytes | None] = []
    seq_list: list[bytes] = []
    qual_chunks: list[np.ndarray] = []
    qual_offsets = [0]

    keep: set[bytes] | None = None
    if core is not None and neighbour is not None:
        keep = {s.encode() for s in core} | {s.encode() for s in neighbour}

    for fpath in list_read_files(path):
        for header, seq, qual in _iter_fastx(fpath):
            if len(seq) < min_length:
                continue
            rid, desc = _split_header(header)
            if keep is not None and rid not in keep:
                continue
            if qual is None:
                if require_quals:
                    raise ValueError(f"Read {rid!r} has no quality string.")
                qual = b"~" * len(seq)
            ids.append(rid)
            descriptions.append(desc)
            seq_list.append(seq)
            qual_chunks.append(np.frombuffer(qual, dtype=np.uint8))
            qual_offsets.append(qual_offsets[-1] + len(qual))

    quals = (
        np.concatenate(qual_chunks) if qual_chunks else np.empty(0, dtype=np.uint8)
    )
    return ReadSet(
        ids=ids,
        descriptions=descriptions,
        seqs=PackedSeqs.from_sequences(seq_list),
        quals=quals,
        qual_offsets=np.asarray(qual_offsets, dtype=np.int64),
    )


def read_cluster(path: str) -> tuple[set[str] | None, set[str] | None]:
    """Parse a cluster .part file of ``0\\tid`` (core) / ``1\\tid`` (neighbour)
    lines (reference: src/lib.rs:208-239). Empty path means no clustering."""
    if not path:
        return None, None
    core: set[str] = set()
    neighbour: set[str] = set()
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            tag, _, rid = line.partition("\t")
            if tag == "0":
                core.add(rid)
            elif tag == "1":
                neighbour.add(rid)
            else:
                raise ValueError(f"Invalid cluster line: {line[:50]!r}")
    return core, neighbour
