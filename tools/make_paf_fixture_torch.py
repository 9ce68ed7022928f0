"""Generate the committed "real-like" PAF fixture (tests/data/) with the
PyTorch port alone (``herro_tpu_torch``; no JAX, no herro_tpu).

The counterpart of ``tools/make_paf_fixture.py``: the same fixture, byte for
byte once decompressed, into ``--out-dir`` (default ``tests/data``). The
notes below are the reference tool's.

minimap2 is not installed in this build environment, so a captured ava-ont
PAF cannot be produced here. This generator is the next-best thing: it takes
exact simulator overlaps (herro_tpu_torch/training/simulate.py) and re-formats
them the way a real ``minimap2 -x ava-ont -c --eqx --dual=yes`` run looks on
disk (src/mm2.rs:15-37) — full tag columns in minimap2's order and
formats, mapq 255, M-form CIGARs on a subset (a run without --eqx), plus
the pathologies real all-vs-all PAFs contain and the reference's fragile
parser would panic on (src/overlaps.rs:172):

* rows whose query is absent from the read set (minimap2 run on a superset);
* self-overlap rows;
* duplicate (q, t) rows — secondary alignments after the best row;
* rows without a ``cg:Z:`` tag (minimap2 invoked without -c);
* corrupt rows: non-integer coordinates, too few fields, an unparseable
  CIGAR, CRLF endings, a blank line, and a final line truncated mid-field
  (a crashed writer).

The fixture is FROZEN: tests/test_real_paf.py pins exact row/skip counts and
drives parse -> window -> featurize -> consensus over it. Regenerate only
with a deliberate fixture bump (and update the pinned counts):

    python tools/make_paf_fixture_torch.py [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from herro_tpu_torch.training.simulate import paf_rows, simulate  # noqa: E402

SEED = 20260817
OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data"
)


def _to_m_form(cg: bytes) -> bytes:
    """Fold =/X runs into M runs (a minimap2 run without --eqx)."""
    from herro_tpu_torch.cigar.ops import parse_cigar

    c = parse_cigar(cg)
    out = []
    OPS = b"MIDNSHP=X"
    run_len = 0
    for code, ln in zip(c.codes, c.lens):
        op = OPS[code : code + 1]
        if op in (b"=", b"X", b"M"):
            run_len += int(ln)
            continue
        if run_len:
            out.append(b"%dM" % run_len)
            run_len = 0
        out.append(b"%d%s" % (int(ln), op))
    if run_len:
        out.append(b"%dM" % run_len)
    return b"".join(out)


def _minimapify(row: bytes, rng: np.random.Generator, m_form: bool) -> bytes:
    """Re-emit a simulator PAF row with minimap2 ava-ont field dressing."""
    cols = row.rstrip(b"\r\n").split(b"\t")
    cg = next(c for c in cols[9:] if c.startswith(b"cg:Z:"))[5:]
    if m_form:
        cg = _to_m_form(cg)

    from herro_tpu_torch.cigar.ops import parse_cigar

    c = parse_cigar(cg)
    OPS = b"MIDNSHP=X"
    n_match = sum(int(l) for k, l in zip(c.codes, c.lens) if OPS[k : k + 1] in (b"=", b"M"))
    aln_len = int(c.lens.sum())
    nm = aln_len - n_match
    dv = nm / max(aln_len, 1)

    out = cols[:9] + [
        b"%d" % n_match,
        b"%d" % aln_len,
        b"255",
        b"NM:i:%d" % nm,
        b"ms:i:%d" % max(n_match * 2 - nm, 0),
        b"AS:i:%d" % max(n_match * 2 - nm, 0),
        b"nn:i:0",
        b"tp:A:P",
        b"cm:i:%d" % max(n_match // 19, 1),
        b"s1:i:%d" % max(n_match - nm // 2, 1),
        b"s2:i:0",
        b"de:f:%.4f" % dv,
        b"rl:i:%d" % int(rng.integers(0, 2000)),
        b"cg:Z:" + cg,
    ]
    return b"\t".join(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help=f"where the fixture's three files go (default {OUT_DIR})")
    out_dir = ap.parse_args(argv).out_dir
    import zstandard as zstd

    ds = simulate(
        genome_len=14_000,
        n_reads=26,
        read_len=(2200, 4200),
        sub_rate=0.03,
        ins_rate=0.02,
        del_rate=0.02,
        het_rate=0.006,
        seed=SEED,
    )
    rng = np.random.default_rng(SEED)
    clean = paf_rows(ds, min_overlap=800)

    lines: list[bytes] = []
    for i, row in enumerate(clean):
        lines.append(_minimapify(row, rng, m_form=(i % 3 == 0)))

    # -- pathologies ------------------------------------------------------
    # Each pathology derives from a DISTINCT clean row so its (q, t) pair is
    # judged on its own merits. Rows that are skipped-and-counted still
    # consume their pair (first-row-per-pair, even when the first row is
    # bad), so pathologies inserted immediately BEFORE their template drop
    # the template as a duplicate — both rules get exercised.

    def variant(k: int, **kw) -> bytes:
        cols = lines[k].split(b"\t")
        for idx, val in kw.items():
            cols[int(idx[1:])] = val
        return b"\t".join(cols)

    body = list(lines)

    def before(k: int, row: bytes) -> None:
        body.insert(body.index(lines[k]), row)

    # unknown query name (minimap2 was run on a superset fastq): unique pair
    before(7, variant(0, c0=b"read_not_in_fastq"))
    # self overlap: q == t
    before(11, variant(1, c0=lines[1].split(b"\t")[5]))
    # duplicate (q, t): a worse secondary row strictly AFTER the best one —
    # first-wins must keep the original (src/overlaps.rs:181-185)
    body.insert(
        body.index(lines[0]) + 1, variant(0, c12=b"NM:i:999", c16=b"tp:A:S")
    )
    # no cg:Z: tag (run without -c): the skipped row consumes the pair, the
    # original right after it is then dropped as a duplicate
    before(10, b"\t".join(lines[10].split(b"\t")[:-1]))
    # corrupt coordinate — same consume-the-pair dance
    before(20, variant(20, c7=b"12x34"))
    # too few fields: malformed before the pair is even parsed (the original
    # right after it survives)
    before(30, b"\t".join(lines[30].split(b"\t")[:6]))
    # soft-clip op in the CIGAR (never valid in ava overlaps)
    before(40, variant(40, c22=b"cg:Z:50S100M2I"))
    # CRLF-terminated row (Windows-transferred file) — parser must strip it
    # and keep the row
    body[body.index(lines[3])] = lines[3] + b"\r"
    # blank line somewhere in the middle
    body.insert(len(body) // 2, b"")

    data = b"\n".join(body) + b"\n"
    # final line truncated mid-field (a crashed writer): 9 fields, cut
    # mid-integer -> malformed, and its pair appears earlier so nothing leaks
    data += b"\t".join(lines[50].split(b"\t")[:9])[:-3]

    os.makedirs(out_dir, exist_ok=True)
    paf_path = os.path.join(out_dir, "real_like.paf.zst")
    with open(paf_path, "wb") as fh:
        fh.write(zstd.ZstdCompressor(level=19).compress(data))

    fastq_path = os.path.join(out_dir, "real_like.fastq.gz")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "r.fastq")
        ds.write_fastq(raw)
        with open(raw, "rb") as src, gzip.GzipFile(
            fastq_path, "wb", compresslevel=9, mtime=0
        ) as dst:
            dst.write(src.read())

    truth_path = os.path.join(out_dir, "real_like.truth.txt")
    n_rows = sum(1 for ln in data.split(b"\n") if ln.strip())
    with open(truth_path, "w") as fh:
        fh.write(f"clean_rows={len(clean)}\n")
        fh.write(f"physical_rows={n_rows}\n")
    print(
        f"wrote {paf_path} ({os.path.getsize(paf_path)} B compressed, "
        f"{len(data)} B raw, {len(clean)} clean rows + pathologies), "
        f"{fastq_path}"
    )


if __name__ == "__main__":
    main()
