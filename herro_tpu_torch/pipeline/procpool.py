"""Process-based feature-generation workers.

The reference dedicates ``-t`` OS threads per device to feature generation
(src/lib.rs:159-187; 8 per GPU needed to keep a V100 fed, README.md:96) —
real parallelism because Rust. Python threads only overlap inside the
GIL-releasing native kernels; the numpy glue between them serialises at
higher thread counts. Worker *processes* sidestep the GIL entirely: the
read set's 2-bit sequence arena and qual arena are inherited **zero-copy
through fork** (copy-on-write pages that are never written), which is
exactly what the single-arena layout was designed for (io/seqstore.py).

Fork ordering: a child forked from a process that already initialised CUDA
inherits a CUDA context it cannot use, and any CUDA call in it fails or
hangs. The CLI therefore constructs :class:`FeatgenPool` *before* the first
CUDA call of the process (before the runner is built and before the weights
move to the card); the pool forks its workers eagerly at construction and is
reused across runs (warmup + timed, resume passes, ...). Workers run featgen
only (numpy and the native library) and never touch CUDA.

Dataflow mirrors the reference's featgen fan-in: a bounded task queue of
(rid, alignments) items, N workers running extract_read_features (+
tensorize), and one bounded result queue draining into the consumer thread,
which keeps batching/consensus state lock-free.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import queue as queue_mod
import sys
import threading
import traceback
import weakref
from typing import Callable, Iterable

from ..constants import INFER_CHANNEL_CAP_FACTOR
from ..features.extract import extract_read_features
from ..io.fastx import ReadSet

# Fork-inherited worker state: set in the parent immediately before the
# workers are forked, read by the children. Fork gives every child the same
# arenas without copying or pickling them.
_WORKER_STATE: dict = {}


def _worker_loop(task_q, result_q, window_size: int, do_tensorize: bool):
    import os
    import time as _time

    pid = os.getpid()
    reads: ReadSet = _WORKER_STATE["reads"]
    if do_tensorize:
        # Device-layout windows straight from the native emit: besides
        # skipping tensorize/pack, the packed token rows halve the pickled
        # bytes a window costs on the result queue.
        from ..features.extract import extract_read_tensors

    while True:
        item = task_q.get()
        if item is None:
            return
        rid, alns = item
        # Exactly ONE result message per task — the consumer's accounting
        # (results received == tasks fed) is what ends a run, so there is no
        # end-of-run sentinel for a racing worker to steal.
        try:
            t0 = _time.perf_counter()
            if do_tensorize:
                out = extract_read_tensors(rid, reads, alns, window_size)
            else:
                out = extract_read_features(rid, reads, alns, window_size)
            dt = _time.perf_counter() - t0
        except BaseException:
            result_q.put(("error", rid, traceback.format_exc()))
            continue
        result_q.put((out, dt, pid))


def can_fork() -> bool:
    return "fork" in mp.get_all_start_methods()


# Safety net for pools leaked without close(): tear them down before the
# interpreter's multiprocessing finalizers try to *join* their queue feeder
# threads (a feeder blocked on a full pipe would hang shutdown).
_LIVE_POOLS: "weakref.WeakSet[FeatgenPool]" = weakref.WeakSet()


@atexit.register
def _close_leaked_pools() -> None:
    for pool in list(_LIVE_POOLS):
        pool.close(terminate=True)


class FeatgenPool:
    """A reusable pool of forked feature-generation workers.

    Construct BEFORE the first CUDA call (fork safety, see module docstring).
    ``run()`` may be called repeatedly; ``close()`` (or the context manager)
    terminates the workers.
    """

    def __init__(
        self,
        reads: ReadSet,
        window_size: int,
        n_procs: int,
        tensorized: bool = True,
    ):
        if not can_fork():
            raise RuntimeError("process featgen needs the fork start method (POSIX)")
        ctx = mp.get_context("fork")
        self.n_procs = n_procs
        self._task_q = ctx.Queue(maxsize=4 * n_procs)
        self._result_q = ctx.Queue(
            maxsize=max(2 * INFER_CHANNEL_CAP_FACTOR * n_procs, 4)
        )
        _WORKER_STATE["reads"] = reads
        self._workers = [
            ctx.Process(
                target=_worker_loop,
                args=(self._task_q, self._result_q, window_size, tensorized),
                daemon=True,
            )
            for _ in range(n_procs)
        ]
        for w in self._workers:
            w.start()
        _WORKER_STATE.clear()  # children hold their fork-time copy
        self._closed = False
        # reads each worker has featurized, by pid, over the pool's lifetime
        self.reads_by_worker: dict[int, int] = {}
        _LIVE_POOLS.add(self)

    def run(
        self,
        aln_source: Iterable,
        handle_window: Callable,
        timers=None,
    ) -> None:
        """Fan (rid, alignments) items over the workers for one pass.

        ``handle_window`` runs on the calling thread for every produced
        window, so downstream batching/consensus state needs no locks.
        """
        if self._closed:
            raise RuntimeError("pool already closed")

        fed = 0
        feeder_done = threading.Event()

        def feeder():
            # Feeding can block on the bounded task queue; run it on a thread
            # so the consumer below keeps draining results (no deadlock).
            nonlocal fed
            try:
                for item in aln_source:
                    self._task_q.put(item)
                    fed += 1
            finally:
                feeder_done.set()

        feeder_t = threading.Thread(target=feeder, daemon=True)
        feeder_t.start()

        received = 0
        failure: tuple | None = None
        while True:
            # `fed` is only compared once the feeder finished, so it is final.
            if feeder_done.is_set() and received == fed:
                break
            try:
                # Poll with a timeout: a worker that dies without reaching
                # its except handler (segfault in a native kernel, OOM-kill)
                # never sends its task's result; detect the vanished process
                # instead of hanging forever.
                item = self._result_q.get(timeout=5.0)
            except queue_mod.Empty:
                dead = [w for w in self._workers if not w.is_alive()]
                if dead:
                    w = dead[0]
                    self.close(terminate=True)
                    raise RuntimeError(
                        f"feature worker pid={w.pid} died "
                        f"(exitcode {w.exitcode}) without reporting an error"
                    )
                continue
            received += 1
            if isinstance(item[0], str) and item[0] == "error":
                _, rid, tb = item
                failure = (rid, tb)
                break
            out, dt, pid = item
            self.reads_by_worker[pid] = self.reads_by_worker.get(pid, 0) + 1
            if timers is not None:
                timers.featgen_s += dt
            for w in out:
                handle_window(w)
        if failure is not None:
            rid, tb = failure
            self.close(terminate=True)
            print(tb, file=sys.stderr)
            raise RuntimeError(f"feature worker process failed on read {rid}")

    def close(self, terminate: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        _LIVE_POOLS.discard(self)
        for w in self._workers:
            if terminate:
                w.terminate()
            else:
                self._task_q.put(None)
        for w in self._workers:
            w.join(timeout=30)
        for w in self._workers:
            if w.is_alive():  # terminate lost the race / worker wedged
                w.kill()
                w.join(timeout=5)
        # Deterministic queue teardown. Each mp.Queue owns a feeder thread
        # that, at interpreter exit, is *joined* by a multiprocessing
        # finalizer — and a feeder blocked writing to a full pipe nobody
        # reads anymore (workers are gone) hangs that join forever, wedging
        # pytest after "N passed". Drain what we can, detach the exit-time
        # join, and close the pipes now.
        for q in (self._task_q, self._result_q):
            try:
                while True:
                    q.get_nowait()
            except Exception:
                pass
            q.cancel_join_thread()
            q.close()

    def __enter__(self) -> "FeatgenPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(terminate=exc[0] is not None)


def parallel_featgen_procs(
    reads: ReadSet,
    aln_source: Iterable,
    window_size: int,
    n_procs: int,
    handle_window: Callable,
    timers=None,
    tensorized: bool = True,
) -> None:
    """One-shot convenience wrapper: fork a pool, run, close.

    Prefer constructing :class:`FeatgenPool` before the first CUDA call and
    passing it to ``run_correction(featgen_pool=...)`` — this wrapper forks
    at call time, which in the inference path is after the card is open. It
    suits the ``features`` subcommand, which never opens the card.
    """
    with FeatgenPool(reads, window_size, n_procs, tensorized=tensorized) as pool:
        pool.run(aln_source, handle_window, timers=timers)
