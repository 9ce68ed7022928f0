"""The port's pipeline with its own runner: bucketing, collation, threaded
featgen parity, bounded staging (tests/test_pipeline.py with
``herro_tpu_torch``'s ``CorrectionRunner(device="cpu")``), one run of each
engine test with ``int8=True``, and the host-side pieces held equal to
herro_tpu's on the same inputs."""

import numpy as np
import pytest
import torch

from herro_tpu_torch.constants import QUAL_PAD, TOKEN_PAD
from herro_tpu_torch.io.fastx import load_reads
from herro_tpu_torch.models.checkpoint import load_or_init
from herro_tpu_torch.overlaps.paf import parse_paf
from herro_tpu_torch.pipeline.batching import (
    BucketBatcher,
    BucketSpec,
    WindowTensors,
    collate,
    pack_tokens,
    unpack_tokens_np,
    unpack_tokens_torch,
)
from herro_tpu_torch.pipeline.engine import _parallel_featgen, run_correction
from herro_tpu_torch.pipeline.infer import CorrectionRunner
from herro_tpu_torch.training.simulate import paf_rows, simulate

LADDER = [(900, 10), (1024, 200), (1025, 10), (5000, 10), (64, 64), (9216, 300)]


def _records(data: bytes) -> dict:
    recs = {}
    name = None
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            name = line
            recs[name] = b""
        elif line and name:
            recs[name] += line
    return recs


def _runner(int8: bool) -> CorrectionRunner:
    cfg, params = load_or_init("tiny")
    runner = CorrectionRunner(cfg, params, int8=int8, device="cpu")
    assert runner.cfg.int8 is int8
    return runner


def test_bucket_spec_ladder():
    spec = BucketSpec(lengths=(1024, 2048), sup_fractions=(0.125, 1.0))
    assert spec.bucket_for(900, 10) == (1024, 128)
    assert spec.bucket_for(1024, 200) == (1024, 1024)
    assert spec.bucket_for(1025, 10) == (2048, 256)
    # beyond the ladder: next multiple of 1024
    assert spec.bucket_for(5000, 10)[0] == 5120


@pytest.mark.parametrize("length,n_sup", LADDER)
def test_bucket_spec_equals_reference(length, n_sup):
    from herro_tpu.pipeline.batching import BucketSpec as JaxBucketSpec

    assert BucketSpec().bucket_for(length, n_sup) == JaxBucketSpec().bucket_for(length, n_sup)


def _window(rid, wid, length, n_sup, n_total_wins=1, cls=WindowTensors):
    sup = np.zeros(n_sup, dtype=[("pos", np.uint16), ("ins", np.uint8)])
    return cls(
        rid=rid, wid=wid, n_alns=3, n_total_wins=n_total_wins,
        tokens=np.zeros((length, 31), dtype=np.uint8),
        quals=np.full((length, 31), 40, dtype=np.uint8),
        support_flat=np.arange(n_sup, dtype=np.int32), supported=sup,
    )


def test_collate_padding():
    b = collate([_window(0, 0, 10, 2)], L=16, S=4, batch_size=2)
    packed_pad = TOKEN_PAD | (TOKEN_PAD << 4)
    # row-major device layout: [B, 16 packed rows, L] / [B, 31, L]
    assert b.tokens_packed.shape == (2, 16, 16)
    assert (b.tokens_packed[0, :, 10:] == packed_pad).all()
    assert (b.tokens_packed[1] == packed_pad).all()
    assert (b.quals[0, :, 10:] == QUAL_PAD).all()
    assert b.support_mask[0].tolist() == [True, True, False, False]
    assert b.n_alns.tolist() == [3, 0]


def test_collate_equals_reference():
    from herro_tpu.pipeline import batching as jbatching

    rng = np.random.default_rng(2)
    mine, theirs = [], []
    for wid, (length, n_sup) in enumerate([(10, 2), (16, 4), (7, 0)]):
        tok = rng.integers(0, 12, size=(length, 31)).astype(np.uint8)
        qual = rng.integers(33, 90, size=(length, 31)).astype(np.uint8)
        for cls, acc in ((WindowTensors, mine), (jbatching.WindowTensors, theirs)):
            w = _window(0, wid, length, n_sup, cls=cls)
            w.tokens, w.quals = tok, qual
            acc.append(w)
    got = collate(mine, L=16, S=4, batch_size=4)
    want = jbatching.collate(theirs, L=16, S=4, batch_size=4)
    for field in ("tokens_packed", "quals", "support_idx", "support_mask", "n_alns"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    ds = simulate(genome_len=1500, n_reads=18, read_len=(500, 900), sub_rate=0.01,
                  ins_rate=0.005, del_rate=0.005, seed=3)
    fastq = tmp / "r.fastq"
    ds.write_fastq(str(fastq))
    reads = load_reads(str(fastq), min_length=128)
    grouped = parse_paf(paf_rows(ds, min_overlap=150), reads.name_to_id)
    return tmp, reads, grouped


@pytest.mark.parametrize("int8", [False, True])
def test_threaded_featgen_matches_serial(int8, small_run):
    tmp, reads, grouped = small_run
    runner = _runner(int8)
    spec = BucketSpec(lengths=(192, 256, 512), sup_fractions=(1.0,))
    outs = []
    for threads in (1, 3):
        out = tmp / f"c{threads}-{int8}.fasta"
        n = run_correction(
            reads, iter(sorted(grouped.items())), runner, str(out), window_size=128,
            batch_size=4, bucket_spec=spec, feat_threads=threads,
        )
        assert n > 0
        outs.append(out.read_bytes())
    # same set of corrected records regardless of threading
    assert _records(outs[0]) == _records(outs[1])


def test_parallel_featgen_propagates_worker_errors():
    """A failing feature worker must surface its exception, not hang."""

    class BoomReads:
        def length(self, rid):
            raise ValueError("boom")

    with pytest.raises(RuntimeError, match="feature worker failed"):
        _parallel_featgen(BoomReads(), [(0, [])], 256, 2, lambda wt: None)


def test_bucket_batcher_bounded_staging():
    """An adversarial length distribution (every bucket kept one short of a
    full batch) must not stage unboundedly: the oldest partial bucket is
    flushed padded once the bound is crossed, and every window comes out
    exactly once."""
    spec = BucketSpec(lengths=(64, 128, 192, 256, 320, 384), sup_fractions=(1.0,))
    bs = 4
    batcher = BucketBatcher(spec, bs, max_staged=6)
    seen = []
    peak = wid = 0
    # round-robin the buckets, never completing a full batch naturally
    for _round in range(bs - 1):
        for length in (64, 128, 192, 256, 320, 384):
            b = batcher.add(_window(0, wid, length, 2))
            wid += 1
            peak = max(peak, batcher.n_staged)
            if b is not None:
                seen.extend(w.wid for w in b.windows)
    for b in batcher.flush():
        seen.extend(w.wid for w in b.windows)
    assert peak <= 6, peak
    assert batcher.n_partial_flushes > 0
    assert sorted(seen) == list(range(wid))


def test_bucket_batcher_oldest_evicted_first():
    spec = BucketSpec(lengths=(64, 128), sup_fractions=(1.0,))
    batcher = BucketBatcher(spec, batch_size=8, max_staged=8)
    # bucket 64 born first (tick 0), bucket 128 born at tick 4
    for i in range(4):
        assert batcher.add(_window(0, i, 60, 2)) is None
    for i in range(4):
        assert batcher.add(_window(0, 4 + i, 120, 2)) is None
    b = batcher.add(_window(0, 8, 120, 2))  # 9 staged > 8
    assert b is not None
    assert b.shape_key[1] == 64  # the older (64-length) bucket was evicted
    assert {w.wid for w in b.windows} == {0, 1, 2, 3}
    assert batcher.n_staged == 5


@pytest.mark.parametrize("int8", [False, True])
def test_engine_partial_flush_output_identical(int8, tmp_path, monkeypatch):
    """run_correction with a tight staging bound produces byte-identical
    records while keeping peak staged windows bounded."""
    import herro_tpu_torch.pipeline.engine as engine_mod

    # noisy enough that most windows carry supported columns and reach the
    # batcher (clean windows bypass it through the host counting path)
    ds = simulate(genome_len=2000, n_reads=24, read_len=(600, 1100), sub_rate=0.05,
                  ins_rate=0.02, del_rate=0.02, het_rate=0.01, seed=3)
    fastq = tmp_path / "r.fastq"
    ds.write_fastq(str(fastq))
    reads = load_reads(str(fastq), min_length=128)
    grouped = parse_paf(paf_rows(ds, min_overlap=150), reads.name_to_id)
    runner = _runner(int8)
    # fine-grained ladder => many distinct buckets => adversarial staging
    spec = BucketSpec(lengths=(160, 192, 224, 256, 320, 384, 512), sup_fractions=(0.125, 1.0))
    peaks = {}

    class PeakBatcher(BucketBatcher):
        def add(self, w):
            out = super().add(w)
            peaks[self.max_staged] = max(peaks.get(self.max_staged, 0), self.n_staged)
            return out

    monkeypatch.setattr(engine_mod, "BucketBatcher", PeakBatcher)
    outs = []
    for bound in (None, 8):
        out = tmp_path / f"c{bound}.fasta"
        run_correction(
            reads, iter(sorted(grouped.items())), runner, str(out), window_size=128,
            batch_size=8, bucket_spec=spec, max_staged_windows=bound,
        )
        outs.append(out.read_bytes())
    # identical corrected records (completion *order* may legally permute:
    # partial flushes decide some windows earlier)
    assert _records(outs[0]) == _records(outs[1]) and len(_records(outs[0])) > 0
    assert peaks[8] <= 8


def test_token_pack_roundtrip():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 12, size=(3, 20, 31)).astype(np.uint8)
    packed = np.ascontiguousarray(pack_tokens(tokens).transpose(0, 2, 1))
    assert packed.shape == (3, 16, 20)
    out = unpack_tokens_torch(torch.from_numpy(packed), 31).numpy()
    assert np.array_equal(out, tokens.transpose(0, 2, 1))
    assert np.array_equal(unpack_tokens_np(packed, 31), tokens.transpose(0, 2, 1))


def test_token_pack_equals_reference():
    from herro_tpu.pipeline.batching import pack_tokens as jax_pack_tokens

    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 12, size=(2, 33, 31)).astype(np.uint8)
    np.testing.assert_array_equal(pack_tokens(tokens), jax_pack_tokens(tokens))
