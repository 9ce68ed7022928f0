"""PAF alignment ingest.

Parsing semantics match the reference exactly (src/overlaps.rs:117-202):

* rows whose query or target id is unknown are dropped;
* with a core-cluster filter, rows whose *target* is outside the core are
  dropped (neighbour reads still contribute as queries);
* self-overlaps are dropped;
* only the *first* row per (qid, tid) pair is kept — minimap2 reports the best
  overlap first;
* the CIGAR is taken from the ``cg:Z:`` tag (searched from the last field
  backwards — minimap2 emits it last);
* surviving rows are grouped by target id.

Unlike the reference (which indexes ``[5..]`` into whatever the last field
happens to be, overlaps.rs:172, and would panic on a malformed row), rows
with missing/malformed fields, absent ``cg:Z:`` tags, or unparseable CIGARs
(S/H/N ops, corrupt run lengths) are *skipped and counted* — one odd row
from a real minimap2 run must not abort a whole correction."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO, Iterable

from ..cigar.ops import Cigar, parse_cigar

STRAND_FWD = 0
STRAND_REV = 1


@dataclass
class ParseStats:
    """Skip-and-count accounting for one or more parse_paf calls."""

    n_rows: int = 0
    n_kept: int = 0
    n_unknown_id: int = 0
    n_filtered: int = 0  # core filter / self-overlap / duplicate pair
    n_malformed: int = 0  # too few fields or non-integer coordinates
    n_no_cigar: int = 0  # no cg:Z: tag among the tag fields
    n_bad_cigar: int = 0  # cg:Z: tag present but unparseable

    @property
    def n_skipped(self) -> int:
        return self.n_malformed + self.n_no_cigar + self.n_bad_cigar

    def summary(self) -> str:
        return (
            f"{self.n_kept}/{self.n_rows} rows kept"
            + (
                f"; skipped {self.n_malformed} malformed, "
                f"{self.n_no_cigar} without cg:Z:, "
                f"{self.n_bad_cigar} bad CIGARs"
                if self.n_skipped
                else ""
            )
        )


@dataclass
class Alignment:
    """One overlap row (reference: src/overlaps.rs:44-101)."""

    qid: int
    qlen: int
    qstart: int
    qend: int
    strand: int  # STRAND_FWD / STRAND_REV
    tid: int
    tlen: int
    tstart: int
    tend: int
    cigar: Cigar

    def other_id(self, rid: int) -> int:
        return self.tid if self.qid == rid else self.qid


def parse_paf(
    lines: Iterable[bytes],
    name_to_id: dict[bytes, int],
    core: set[str] | None = None,
    raw_writer: IO[bytes] | None = None,
    stats: ParseStats | None = None,
) -> dict[int, list[Alignment]]:
    """Parse PAF rows into a target-id -> alignments map.

    ``stats`` (optional) accumulates kept/skipped row counts so callers can
    surface a corruption summary instead of silently dropping rows."""
    core_b = {c.encode() for c in core} if core is not None else None
    processed: set[tuple[int, int]] = set()
    tid_to_alns: dict[int, list[Alignment]] = {}
    st = stats if stats is not None else ParseStats()

    for line in lines:
        row = line.rstrip(b"\r\n").split(b"\t")
        if len(row) == 1 and not row[0]:
            continue  # blank line
        st.n_rows += 1
        if len(row) < 10:
            st.n_malformed += 1
            continue
        qid = name_to_id.get(row[0])
        if qid is None:
            st.n_unknown_id += 1
            continue
        if core_b is not None and row[5] not in core_b:
            st.n_filtered += 1
            continue
        tid = name_to_id.get(row[5])
        if tid is None:
            st.n_unknown_id += 1
            continue
        if tid == qid:
            st.n_filtered += 1
            continue
        key = (qid, tid)
        if key in processed:
            st.n_filtered += 1
            continue
        # The pair is consumed by its FIRST row even when that row turns out
        # malformed below: minimap2 orders rows best-first, so accepting a
        # later (inferior) row for the same pair would silently deviate from
        # the reference's first-row-per-pair rule (src/overlaps.rs:181-185) —
        # skip-and-count drops the pair entirely instead.
        processed.add(key)

        # the cg:Z: tag is normally the last field, but don't assume
        cigar_field = None
        for f in reversed(row[12:] or row[-1:]):
            if f.startswith(b"cg:Z:"):
                cigar_field = f
                break
        if cigar_field is None:
            st.n_no_cigar += 1
            continue

        try:
            qlen, qstart, qend = int(row[1]), int(row[2]), int(row[3])
            tlen, tstart, tend = int(row[6]), int(row[7]), int(row[8])
        except ValueError:
            st.n_malformed += 1
            continue
        try:
            cigar = parse_cigar(cigar_field[5:])
        except ValueError:
            st.n_bad_cigar += 1
            continue
        aln = Alignment(
            qid=qid,
            qlen=qlen,
            qstart=qstart,
            qend=qend,
            strand=STRAND_FWD if row[4] == b"+" else STRAND_REV,
            tid=tid,
            tlen=tlen,
            tstart=tstart,
            tend=tend,
            cigar=cigar,
        )

        st.n_kept += 1
        tid_to_alns.setdefault(tid, []).append(aln)

        if raw_writer is not None:
            raw_writer.write(line if line.endswith(b"\n") else line + b"\n")

    return tid_to_alns
