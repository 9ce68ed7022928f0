"""The port's process-based featgen: byte parity with the serial path, error
propagation, pool reuse, a vanished worker, and the CLI wiring, all with the
torch runner on ``device="cpu"``.

Every test runs under a time limit of its own (``SIGALRM``), so a hung worker
fails its test instead of stalling the whole run.
"""

import functools
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from herro_tpu_torch.io.fastx import load_reads
from herro_tpu_torch.overlaps.paf import parse_paf
from herro_tpu_torch.pipeline.procpool import FeatgenPool, can_fork, parallel_featgen_procs
from herro_tpu_torch.training.simulate import paf_rows, simulate

W = 512
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_limit(seconds: int):
    """Fail the test with TimeoutError after ``seconds`` (main thread only)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def on_alarm(signum, frame):
                raise TimeoutError(f"{fn.__name__} exceeded {seconds}s")

            old = signal.signal(signal.SIGALRM, on_alarm)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)

        return wrapper

    return deco


def _need_fork():
    if not can_fork():
        pytest.skip("fork unavailable")


def _simulate():
    return simulate(genome_len=9000, n_reads=16, read_len=(1500, 3000), seed=33)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tproc")
    ds = _simulate()
    fastq = tmp / "r.fastq"
    ds.write_fastq(str(fastq))
    reads = load_reads(str(fastq), min_length=W)
    grouped = parse_paf(paf_rows(ds, min_overlap=W), reads.name_to_id)
    return reads, grouped


def _collect_serial(reads, grouped):
    from herro_tpu_torch.features.extract import extract_read_features
    from herro_tpu_torch.pipeline.batching import tensorize

    out = {}
    for rid, alns in grouped.items():
        for wt in map(tensorize, extract_read_features(rid, reads, alns, W)):
            out[(wt.rid, wt.wid)] = wt
    return out


def _records(path):
    recs, name = {}, None
    for line in path.read_bytes().splitlines():
        if line.startswith(b">"):
            name = line
            recs[name] = b""
        else:
            recs[name] += line
    return recs


def _tree(root):
    return {
        os.path.relpath(os.path.join(r, f), root): open(os.path.join(r, f), "rb").read()
        for r, _, fs in os.walk(root) for f in fs
    }


@time_limit(120)
def test_proc_featgen_byte_parity(dataset):
    _need_fork()
    from herro_tpu_torch.pipeline.batching import pack_tokens

    reads, grouped = dataset
    serial = _collect_serial(reads, grouped)
    got = {}
    parallel_featgen_procs(
        reads, iter(grouped.items()), W, 2,
        lambda wt: got.__setitem__((wt.rid, wt.wid), wt),
    )
    assert set(got) == set(serial)
    for key, wt in got.items():
        ref = serial[key]
        # pool workers emit device-layout windows (packed nibble rows +
        # row-major quals): compare against the tensorize equivalent
        assert wt.tokens is None and wt.tokens_packed is not None
        assert (
            wt.tokens_packed.tobytes()
            == np.ascontiguousarray(pack_tokens(ref.tokens).T).tobytes()
        )
        assert wt.quals_rm.tobytes() == ref.quals.T.tobytes()
        assert wt.tokens_lc().tobytes() == ref.tokens.tobytes()
        assert np.array_equal(wt.support_flat, ref.support_flat)
        assert wt.n_alns == ref.n_alns and wt.n_total_wins == ref.n_total_wins


@time_limit(120)
def test_proc_featgen_error_propagates(dataset):
    _need_fork()
    reads, grouped = dataset
    bad = [(10**9, alns) for _, alns in list(grouped.items())[:1]]
    with pytest.raises(RuntimeError, match="feature worker process"):
        parallel_featgen_procs(reads, iter(bad), W, 2, lambda wt: None)


@time_limit(300)
def test_run_correction_with_procs_matches_serial(dataset, tmp_path):
    """``feat_procs`` and an already-forked pool both give the serial FASTA."""
    _need_fork()
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.pipeline.engine import run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    reads, grouped = dataset
    cfg, params = load_or_init("tiny")
    with FeatgenPool(reads, W, 2) as pool:  # forked before the runner exists
        runner = CorrectionRunner(cfg, params, device="cpu")
        serial_out = tmp_path / "serial.fasta"
        run_correction(reads, iter(grouped.items()), runner, str(serial_out), W, 4)
        proc_out = tmp_path / "proc.fasta"
        run_correction(
            reads, iter(grouped.items()), runner, str(proc_out), W, 4, feat_procs=2
        )
        pool_out = tmp_path / "pool.fasta"
        run_correction(
            reads, iter(grouped.items()), runner, str(pool_out), W, 4, featgen_pool=pool
        )
    assert _records(serial_out) and _records(serial_out) == _records(proc_out)
    assert _records(serial_out) == _records(pool_out)


def _cli_inputs(tmp_path):
    from herro_tpu_torch.overlaps.batches import BatchWriter

    ds = _simulate()
    fastq = tmp_path / "r.fastq"
    ds.write_fastq(str(fastq))
    with BatchWriter(str(tmp_path / "batches"), 0, [r.name for r in ds.reads]) as w:
        for line in paf_rows(ds, min_overlap=W):
            w.write(line)
    return str(fastq), str(tmp_path / "batches")


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run(
        [sys.executable, "-m", "herro_tpu_torch.cli", *args],
        check=True, env=env, cwd=ROOT, timeout=300,
    )


@time_limit(400)
@pytest.mark.parametrize("extra", [["--feat-gen-procs", "2"], ["-t", "2"]],
                         ids=["procs", "threads"])
def test_features_subcommand_parallel_matches_serial(extra, tmp_path):
    """--feat-gen-procs and -t on the features subcommand write the npy tree
    of the serial run."""
    if extra[0] == "--feat-gen-procs":
        _need_fork()
    fastq, batches = _cli_inputs(tmp_path)
    for name, flags in (("serial", []), ("par", extra)):
        _run_cli("features", "--read-alns", batches, "-w", str(W), fastq,
                 str(tmp_path / name), *flags)
    serial, par = _tree(tmp_path / "serial"), _tree(tmp_path / "par")
    assert serial and sorted(serial) == sorted(par)
    for rel, data in serial.items():
        assert data == par[rel], rel


@time_limit(400)
def test_inference_subcommand_procs_matches_serial(tmp_path):
    """``inference --feat-gen-procs 2`` (the pool forked before the model is
    built) writes the records of the serial run."""
    _need_fork()
    fastq, batches = _cli_inputs(tmp_path)
    for name, flags in (("serial", []), ("procs", ["--feat-gen-procs", "2"])):
        _run_cli("inference", "--device", "cpu", "-m", "tiny", "--read-alns", batches,
                 "-w", str(W), "-b", "4", fastq, str(tmp_path / f"{name}.fasta"), *flags)
    serial = _records(tmp_path / "serial.fasta")
    assert serial and serial == _records(tmp_path / "procs.fasta")


@time_limit(120)
def test_pool_reuse_across_runs(dataset):
    """One FeatgenPool serves several runs (warmup + timed passes)."""
    _need_fork()
    reads, grouped = dataset
    serial = _collect_serial(reads, grouped)
    with FeatgenPool(reads, W, 2) as pool:
        for _ in range(3):
            got = {}
            pool.run(
                iter(grouped.items()),
                lambda wt: got.__setitem__((wt.rid, wt.wid), wt),
            )
            assert set(got) == set(serial)
            for key, wt in got.items():
                assert wt.tokens_lc().tobytes() == serial[key].tokens.tobytes()
    assert all(not w.is_alive() for w in pool._workers)
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(iter(()), lambda wt: None)


@time_limit(120)
def test_pool_detects_vanished_worker(dataset):
    """A worker killed without running its except handler (stand-in for a
    segfault or an OOM kill) is detected instead of hanging the run."""
    _need_fork()
    reads, grouped = dataset
    pool = FeatgenPool(reads, W, 2)

    def killer():
        for w in pool._workers:
            os.kill(w.pid, signal.SIGKILL)

    timer = threading.Timer(0.5, killer)
    timer.start()

    def slow_source():
        yield from iter(grouped.items())
        time.sleep(2.0)  # keep the run alive past the kill
        yield from iter(grouped.items())

    try:
        with pytest.raises(RuntimeError, match="died"):
            pool.run(slow_source(), lambda wt: None)
    finally:
        timer.join(timeout=5)
        pool.close(terminate=True)
    assert all(not w.is_alive() for w in pool._workers)


@time_limit(60)
def test_more_workers_than_cores_keep_every_window(dataset):
    """More workers than cores, two passes: no window lost or duplicated."""
    _need_fork()
    reads, grouped = dataset
    n = (os.cpu_count() or 2) + 2
    serial = _collect_serial(reads, grouped)
    with FeatgenPool(reads, W, min(n, 12)) as pool:
        for _ in range(2):
            seen = []
            pool.run(iter(grouped.items()), lambda wt: seen.append((wt.rid, wt.wid)))
            assert sorted(seen) == sorted(serial)
