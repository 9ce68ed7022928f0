"""End-to-end correction pipeline.

Mirrors the reference dataflow (src/lib.rs:113-206): an alignment source
streams (target rid, alignments); feature workers build window pileups; the
bucketed batcher feeds the device; consensus results accumulate per read and
are written as FASTA the moment a read completes. Stages communicate through
bounded queues for backpressure, like the reference's crossbeam channels.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

import numpy as np

from ..constants import (
    ALN_CHANNEL_CAPACITY,
    INFER_CHANNEL_CAP_FACTOR,
    READS_BATCH_SIZE,
)
from ..features.extract import extract_read_features
from ..io.fasta import write_corrected
from ..io.fastx import ReadSet
from ..overlaps.batches import BatchWriter, list_batches, read_batch
from ..overlaps.mm2 import overlap_batches
from ..overlaps.paf import Alignment, ParseStats, parse_paf
from ..ops.consensus import count_decisions_np, stitch_read
from ..pipeline.batching import BucketBatcher, BucketSpec, tensorize
from ..pipeline.infer import CorrectionRunner, WindowResult


@dataclass
class AlnMode:
    """None / read / write durable alignment batches (src/main.rs:25-36)."""

    read_path: str | None = None
    write_path: str | None = None


def alignment_stream(
    reads: ReadSet,
    reads_path: str,
    aln_mode: AlnMode,
    threads: int,
    core: set[str] | None = None,
    on_batch: Callable[[int], None] | None = None,
    stride: tuple[int, int] = (0, 1),
    stats: ParseStats | None = None,
) -> Iterator[tuple[int, list[Alignment]]]:
    """Stream (target rid, alignments) per read (src/overlaps.rs:325-375).

    ``stride=(i, n)`` takes every n-th alignment batch starting at i — the
    multi-host work split: batches are target-partitioned, so each process
    owns a disjoint set of target reads and no cross-host exchange is needed
    beyond the (replicated) read set.

    ``stats`` accumulates PAF skip-and-count totals across all batches.
    """
    p_idx, p_cnt = stride
    if aln_mode.read_path is not None:
        for k, path in enumerate(list_batches(aln_mode.read_path)):
            if k % p_cnt != p_idx:
                continue
            _, lines = read_batch(path)
            grouped = parse_paf(lines, reads.name_to_id, core=core, stats=stats)
            if on_batch:
                on_batch(len(grouped))
            yield from grouped.items()
    else:
        for batch_idx, rids, lines in overlap_batches(
            reads, reads_path, threads, READS_BATCH_SIZE, stride=stride
        ):
            writer = None
            if aln_mode.write_path is not None:
                writer = BatchWriter(
                    aln_mode.write_path,
                    batch_idx,
                    [reads.ids[r] for r in rids],
                )
            grouped = parse_paf(
                lines,
                reads.name_to_id,
                core=core,
                raw_writer=writer,
                stats=stats,
            )
            if writer is not None:
                writer.close()
            if on_batch:
                on_batch(len(grouped))
            yield from grouped.items()


class ConsensusAccumulator:
    """Collects per-read window results; emits corrected fragments when a
    read's window set completes (src/consensus.rs:229-263)."""

    def __init__(self, on_read: Callable[[int, list[bytes]], None]):
        self._pending: dict[int, list[WindowResult]] = {}
        self._on_read = on_read

    def add(self, result: WindowResult) -> None:
        entry = self._pending.setdefault(result.rid, [])
        entry.append(result)
        if len(entry) == result.n_total_wins:
            del self._pending[result.rid]
            entry.sort(key=lambda r: r.wid)
            frags = stitch_read([(r.n_alns, r.decisions) for r in entry])
            if frags is not None:
                self._on_read(result.rid, frags)

    @property
    def n_pending(self) -> int:
        return len(self._pending)


def truncate_partial_tail(output_path: str) -> int:
    """Drop a partially-written trailing FASTA record before resuming.

    A crash mid-append can cut the output anywhere; trusting the tail would
    mark a read "done" with a truncated sequence. A record is complete iff a
    ``>`` header line and its single sequence line both end in a newline — a
    byte-level cut cannot fabricate a newline, so truncating to the last
    complete record is sound. Returns the number of bytes removed.
    """
    import os

    try:
        size = os.path.getsize(output_path)
    except OSError:
        return 0
    good_end = 0
    with open(output_path, "rb") as fh:
        offset = 0
        expect_seq = False
        for line in fh:
            offset += len(line)
            if not line.endswith(b"\n"):
                break  # cut mid-line
            if not expect_seq:
                if not line.startswith(b">"):
                    break  # corrupt interleaving: keep only up to here
                expect_seq = True
            else:
                expect_seq = False
                good_end = offset
    removed = size - good_end
    if removed:
        with open(output_path, "r+b") as fh:
            fh.truncate(good_end)
    return removed


def corrected_read_ids(output_path: str) -> set[bytes]:
    """FASTA header names already present in a (partial) corrected output —
    the resume journal (split fragments keep their ``:i`` suffix here)."""
    done: set[bytes] = set()
    try:
        with open(output_path, "rb") as fh:
            for line in fh:
                if line.startswith(b">"):
                    done.add(line[1:].split(b" ", 1)[0].rstrip(b"\r\n"))
    except FileNotFoundError:
        pass
    return done


def _fold_resume_ids(done: set[bytes], name_to_id: dict[bytes, int]) -> set[int]:
    """Map journal names to read ids, stripping split ``:i`` suffixes."""
    skip: set[int] = set()
    for name in done:
        rid = name_to_id.get(name)
        if rid is None and b":" in name:
            stem, _, tail = name.rpartition(b":")
            if tail.isdigit():
                rid = name_to_id.get(stem)
        if rid is not None:
            skip.add(rid)
    return skip


@dataclass
class StageTimers:
    featgen_s: float = 0.0
    device_s: float = 0.0
    n_batches: int = 0
    n_windows: int = 0  # every window featgen produced, model or counting-only
    # seconds into the last run at which the alignment source gave its first
    # and its last (target, alignments) item: before the first, the run waits
    # for the aligner and the PAF parser, not for featgen or the device
    first_alns_s: float | None = None
    last_alns_s: float | None = None

    def summary(self) -> str:
        alns = ""
        if self.first_alns_s is not None and self.last_alns_s is not None:
            alns = f", alignments {self.first_alns_s:.3f}s-{self.last_alns_s:.3f}s"
        return (
            f"featgen {self.featgen_s:.3f}s, device {self.device_s:.3f}s{alns} "
            f"({self.n_batches} batches, {self.n_windows} windows)"
        )


def run_correction(
    reads: ReadSet,
    aln_source: Iterable[tuple[int, list[Alignment]]],
    runner: CorrectionRunner,
    output_path: str,
    window_size: int,
    batch_size: int,
    bucket_spec: BucketSpec | None = None,
    feat_threads: int = 1,
    on_read_done: Callable[[int], None] | None = None,
    resume: bool = False,
    timers: StageTimers | None = None,
    pipeline_depth: int = 8,
    counting_output_path: str | None = None,
    feat_procs: int = 0,
    featgen_pool=None,
    max_staged_windows: int | None = None,
) -> int:
    """Correct every read of ``aln_source``; returns #reads written.

    ``pipeline_depth`` is the number of device batches kept in flight:
    dispatch is async, so up to that many batches overlap with host featgen
    and with each other on the device queue.

    ``counting_output_path`` additionally writes the pure counting-rule
    decode of the *same* features to a second FASTA (requires a runner with
    ``collect_counting=True``) — the matched-seed baseline for quantifying
    the model's contribution without a second featgen pass.

    ``featgen_pool`` is an already-forked :class:`~.procpool.FeatgenPool`
    (preferred over ``feat_procs``: the CLI forks it before the first CUDA call).
    """
    import time as _time

    import collections

    from concurrent.futures import ThreadPoolExecutor

    if counting_output_path is not None:
        # Guard both misuse modes up front: without collect_counting the
        # "counting baseline" file would silently receive the model decode
        # (corrupting any model_gain comparison), and with --resume the main
        # output appends while this one restarts from scratch, desyncing the
        # two FASTAs.
        if not runner.collect_counting:
            raise ValueError(
                "counting_output_path requires a CorrectionRunner built "
                "with collect_counting=True"
            )
        if resume:
            raise ValueError(
                "--resume cannot be combined with a counting output: the "
                "main FASTA would resume (append) while the counting FASTA "
                "restarts, desynchronizing the two decodes"
            )

    spec = bucket_spec or BucketSpec()
    # max_staged_windows bounds pipeline memory: see BucketBatcher — a
    # partial (L, S) bucket is flushed (padded) once the staged-window total
    # crosses the bound, oldest bucket first, keeping both the staged
    # WindowTensors and the consensus accumulator's pending reads bounded
    # for the whole run instead of growing until the end-of-run flush.
    batcher = BucketBatcher(spec, batch_size, max_staged=max_staged_windows)
    n_written = 0
    write_lock = threading.Lock()
    timers = timers if timers is not None else StageTimers()
    depth = max(1, pipeline_depth)
    pending: collections.deque = collections.deque()
    # Dispatch (which includes the host->device batch upload) runs on
    # dedicated threads so transfers overlap with featgen — on slow links the
    # synchronous upload was a third of end-to-end wall time. TWO uploader
    # workers let one batch's host-side serialization CPU overlap the other
    # batch's network transfer (upload-bound heavy profiles: ~70 ms
    # serialize + ~150 ms link per batch; a single worker paid their sum).
    # Batches are independent and device-side execution order is
    # irrelevant — result ORDER is enforced by the single-worker fetcher,
    # which runs runner.finalize (pure, no shared state) in submission
    # order; blocking the featgen thread on the device round-trip used to
    # serialise the stages (round-3 bench: featgen 10.7s + device 8.6s of a
    # 22.9s run). Only add_result (consensus/batching state) stays
    # consumer-thread-only.
    # Two fetch workers likewise: each finalize is one RTT-bound device
    # fetch (~50-100 ms here) and the results feed a keyed accumulator —
    # window decisions are order-independent, the consumer still drains the
    # `pending` deque FIFO, and add_result stays consumer-thread-only.
    uploader = ThreadPoolExecutor(max_workers=2)
    fetcher = ThreadPoolExecutor(max_workers=2)

    skip: set[int] = set()
    if resume:
        removed = truncate_partial_tail(output_path)
        if removed:
            print(
                f"[herro-tpu] resume: dropped a partial trailing record "
                f"({removed} bytes)",
                flush=True,
            )
        skip = _fold_resume_ids(corrected_read_ids(output_path), reads.name_to_id)
        if skip:
            print(
                f"[herro-tpu] resume: skipping {len(skip)} corrected reads",
                flush=True,
            )
    out = open(output_path, "ab" if resume else "wb")
    cnt_out = (
        open(counting_output_path, "wb") if counting_output_path else None
    )

    def on_read(rid: int, frags: list[bytes]) -> None:
        nonlocal n_written
        with write_lock:
            write_corrected(out, reads.ids[rid], reads.descriptions[rid], frags)
            n_written += 1
        if on_read_done:
            on_read_done(rid)

    acc = ConsensusAccumulator(on_read)
    cnt_acc = None
    if cnt_out is not None:

        def on_read_counting(rid: int, frags: list[bytes]) -> None:
            with write_lock:
                write_corrected(
                    cnt_out, reads.ids[rid], reads.descriptions[rid], frags
                )

        cnt_acc = ConsensusAccumulator(on_read_counting)

    def add_result(res: WindowResult) -> None:
        if cnt_acc is not None:
            # collect_counting is guaranteed by the guard above, so every
            # window carries its counting decode.
            cnt_acc.add(
                WindowResult(
                    rid=res.rid,
                    wid=res.wid,
                    n_alns=res.n_alns,
                    n_total_wins=res.n_total_wins,
                    decisions=res.counting,
                )
            )
        acc.add(res)

    def handle_window(wt) -> None:
        timers.n_windows += 1
        if wt.n_supported == 0:
            # No model columns: pure counting decode, host side
            # (src/inference.rs:241-250 — such windows never reach the model).
            dec = count_decisions_np(wt.tokens_lc(), wt.n_alns)
            add_result(
                WindowResult(
                    rid=wt.rid,
                    wid=wt.wid,
                    n_alns=wt.n_alns,
                    n_total_wins=wt.n_total_wins,
                    decisions=dec,
                    counting=dec,
                )
            )
        else:
            batch = batcher.add(wt)
            if batch is not None:
                submit(batch)

    def submit(batch) -> None:
        dispatched = uploader.submit(runner.dispatch, batch)
        pending.append(
            fetcher.submit(lambda d=dispatched: runner.finalize(d.result()))
        )
        # Collect whatever already finished without blocking featgen; block
        # only when the in-flight window is full (device is the bottleneck).
        while pending and pending[0].done():
            drain_one()
        if len(pending) >= depth:
            drain_one()

    def drain_one() -> None:
        # device_s counts what the device stage costs the *pipeline*: the
        # time the consumer thread spends stalled on an unfinished batch
        # (fetch + unpack themselves run on the fetcher thread).
        t0 = _time.perf_counter()
        results = pending.popleft().result()
        timers.device_s += _time.perf_counter() - t0
        timers.n_batches += 1
        for res in results:
            add_result(res)

    t_run = _time.perf_counter()
    timers.first_alns_s = timers.last_alns_s = None

    def timed_source():
        for rid, alns in aln_source:
            timers.last_alns_s = _time.perf_counter() - t_run
            if timers.first_alns_s is None:
                timers.first_alns_s = timers.last_alns_s
            if rid not in skip:
                yield rid, alns

    source = timed_source()
    try:
        if featgen_pool is not None:
            featgen_pool.run(source, handle_window, timers=timers)
        elif feat_procs > 1:
            # GIL-free worker processes over the fork-shared read arenas
            # (reference: -t featgen threads per device, src/lib.rs:159-187).
            from .procpool import parallel_featgen_procs

            parallel_featgen_procs(
                reads, source, window_size, feat_procs, handle_window, timers
            )
        elif feat_threads <= 1:
            # Native tensor emit: windows arrive in device layout (packed
            # nibble rows + row-major quals), so tensorize/pack/transpose
            # never run on the consumer thread.
            from ..features.extract import extract_read_tensors

            for rid, alns in source:
                t0 = _time.perf_counter()
                wts = extract_read_tensors(rid, reads, alns, window_size)
                timers.featgen_s += _time.perf_counter() - t0
                for wt in wts:
                    handle_window(wt)
        else:
            _parallel_featgen(
                reads, source, window_size, feat_threads, handle_window, timers
            )

        for batch in batcher.flush():
            submit(batch)
        while pending:
            drain_one()
    finally:
        # On a worker/device failure the completed reads are already on disk;
        # closing flushes them so the run is resumable. In-flight device
        # batches are abandoned (their reads re-run on resume).
        pending.clear()
        uploader.shutdown(wait=False, cancel_futures=True)
        fetcher.shutdown(wait=False, cancel_futures=True)
        out.close()
        if cnt_out is not None:
            cnt_out.close()
    return n_written


def _parallel_featgen(
    reads: ReadSet,
    aln_source: Iterable[tuple[int, list[Alignment]]],
    window_size: int,
    n_threads: int,
    handle_window,
    timers: StageTimers | None = None,
    tensorized: bool = True,
) -> None:
    """Feature workers on threads (numpy releases the GIL on bulk ops);
    window handling stays on the consumer thread so batching/consensus state
    needs no locks — mirrors the reference's featgen-thread fan-in
    (src/lib.rs:159-187). ``timers.featgen_s`` accumulates summed worker
    CPU-side wall time (can exceed elapsed time with >1 thread)."""
    import time as _time

    in_q: queue.Queue = queue.Queue(maxsize=ALN_CHANNEL_CAPACITY)
    # Bounded fan-in, capacity proportional to the worker count — the
    # reference's infer-channel backpressure (src/lib.rs:42,155).
    out_q: queue.Queue = queue.Queue(
        maxsize=max(2 * INFER_CHANNEL_CAP_FACTOR * n_threads, 4)
    )
    t_lock = threading.Lock()

    def worker():
        while True:
            item = in_q.get()
            if item is None:
                out_q.put(None)
                return
            rid, alns = item
            try:
                t0 = _time.perf_counter()
                feats = extract_read_features(rid, reads, alns, window_size)
                wts = [tensorize(wf) for wf in feats] if tensorized else feats
                if timers is not None:
                    dt = _time.perf_counter() - t0
                    with t_lock:
                        timers.featgen_s += dt
            except BaseException as exc:  # propagate to the consumer
                out_q.put(("error", rid, exc))
                out_q.put(None)
                return
            out_q.put(wts)

    workers = [threading.Thread(target=worker, daemon=True) for _ in range(n_threads)]
    for w in workers:
        w.start()

    def feeder():
        for item in aln_source:
            in_q.put(item)
        for _ in workers:
            in_q.put(None)

    threading.Thread(target=feeder, daemon=True).start()

    done = 0
    while done < len(workers):
        item = out_q.get()
        if item is None:
            done += 1
            continue
        if isinstance(item, tuple) and len(item) == 3 and item[0] == "error":
            _, rid, exc = item
            raise RuntimeError(f"feature worker failed on read {rid}") from exc
        for wt in item:
            handle_window(wt)
