"""Resume journal and crash recovery with the port's engine and runner
(tests/test_resume.py with ``herro_tpu_torch``'s ``CorrectionRunner`` on the
CPU), the crash recovery also with ``int8=True``; the journal helpers held
equal to herro_tpu's on the same files."""

import pytest

from herro_tpu_torch.pipeline.engine import (
    _fold_resume_ids,
    corrected_read_ids,
    truncate_partial_tail,
)

JOURNAL = b">r1 desc\nACGT\n>r2:0 \nAC\n>r2:1 \nGT\n>we:ird\nAA\n"
NAME_TO_ID = {b"r1": 0, b"r2": 1, b"we:ird": 2, b"r3": 3}


def test_resume_journal_roundtrip(tmp_path):
    out = tmp_path / "c.fasta"
    out.write_bytes(JOURNAL)
    names = corrected_read_ids(str(out))
    assert names == {b"r1", b"r2:0", b"r2:1", b"we:ird"}
    assert _fold_resume_ids(names, NAME_TO_ID) == {0, 1, 2}


def test_resume_journal_equals_reference(tmp_path):
    from herro_tpu.pipeline import engine as jengine

    out = tmp_path / "c.fasta"
    out.write_bytes(JOURNAL)
    names = corrected_read_ids(str(out))
    assert names == jengine.corrected_read_ids(str(out))
    assert _fold_resume_ids(names, NAME_TO_ID) == jengine._fold_resume_ids(names, NAME_TO_ID)


def test_resume_missing_file(tmp_path):
    assert corrected_read_ids(str(tmp_path / "nope.fasta")) == set()


FULL = b">r1 \nACGT\n>r2 \nGGTT\n"


@pytest.mark.parametrize("cut", range(len(FULL) + 1))
def test_truncate_partial_tail(cut, tmp_path):
    """Cut at every byte offset: the journal keeps exactly the records whose
    final newline survived the cut, and the file equals what herro_tpu's
    truncation leaves."""
    from herro_tpu.pipeline import engine as jengine

    p, pj = tmp_path / "c.fasta", tmp_path / "j.fasta"
    p.write_bytes(FULL[:cut])
    pj.write_bytes(FULL[:cut])
    truncate_partial_tail(str(p))
    jengine.truncate_partial_tail(str(pj))
    assert p.read_bytes() == pj.read_bytes()
    names = corrected_read_ids(str(p))
    if cut >= len(FULL):
        assert names == {b"r1", b"r2"}
    elif cut >= len(b">r1 \nACGT\n"):
        assert names == {b"r1"}
    else:
        assert names == set()


def _setup(tmp_path, **sim):
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.training.simulate import simulate

    ds = simulate(**sim)
    fastq = tmp_path / "r.fastq"
    ds.write_fastq(str(fastq))
    return ds, load_reads(str(fastq), min_length=512)


@pytest.mark.parametrize("int8", [False, True])
def test_resume_after_midwrite_crash_matches_clean_run(int8, tmp_path):
    """Kill the output mid-record, resume, and get a byte-identical FASTA
    (up to record order) vs an uninterrupted run."""
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.pipeline.engine import run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner
    from herro_tpu_torch.training.simulate import paf_rows

    W = 512
    ds, reads = _setup(tmp_path, genome_len=6000, n_reads=12, read_len=(1200, 2500), seed=21)
    grouped = parse_paf(paf_rows(ds, min_overlap=W), reads.name_to_id)
    cfg, params = load_or_init("tiny")
    runner = CorrectionRunner(cfg, params, int8=int8, device="cpu")
    assert runner.cfg.int8 is int8

    clean = tmp_path / "clean.fasta"
    run_correction(reads, iter(grouped.items()), runner, str(clean), W, 4)

    # simulate a crash: keep a prefix of the clean output cut mid-record
    crashed = tmp_path / "crashed.fasta"
    blob = clean.read_bytes()
    cut = blob.index(b"\n", blob.index(b">", 10)) + 3  # mid 2nd record's seq
    crashed.write_bytes(blob[:cut])
    run_correction(reads, iter(grouped.items()), runner, str(crashed), W, 4, resume=True)

    def records(p):
        recs = {}
        for chunk in p.read_bytes().decode().split(">")[1:]:
            head, _, seq = chunk.partition("\n")
            recs[head.split(" ")[0]] = seq.replace("\n", "")
        return recs

    assert records(crashed) == records(clean) and len(records(clean)) > 1


def test_resume_rejects_counting_output(tmp_path):
    """--resume + a counting output would desync the two FASTAs (append vs
    truncate); the engine rejects the combination up front. A runner without
    collect_counting is rejected too (the baseline file would silently get
    the model decode)."""
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.pipeline.engine import run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    _, reads = _setup(tmp_path, genome_len=3000, n_reads=4, read_len=(800, 1200), seed=5)
    cfg, params = load_or_init("tiny")
    runner = CorrectionRunner(cfg, params, collect_counting=True, device="cpu")
    with pytest.raises(ValueError, match="resume"):
        run_correction(
            reads, iter([]), runner, str(tmp_path / "o.fa"), 512, 4,
            resume=True, counting_output_path=str(tmp_path / "c.fa"),
        )
    runner2 = CorrectionRunner(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="collect_counting"):
        run_correction(
            reads, iter([]), runner2, str(tmp_path / "o.fa"), 512, 4,
            counting_output_path=str(tmp_path / "c.fa"),
        )
