"""Account for every host CPU second of the heavy-coverage e2e run of the
PyTorch/CUDA port.

The counterpart of tools/profile_e2e.py over ``herro_tpu_torch``: the same
30x and 90x profiles (bench.py's light and heavy e2e sets), one warm-up pass
over a quarter of the targets, then one timed run with per-stage wall and
per-thread CPU accounting:

* native featgen build phases (HT_PROF=1, ``native.prof_dump``);
* tensorize (vocab map + supported flatten, consumer thread);
* collate (batch padding + nibble pack, consumer thread);
* runner.dispatch (uploader threads): on the card this is the enqueue of
  the copies and the step on the runner's CUDA stream, which returns
  without waiting;
* runner.finalize (fetcher threads): the wait for the batch's event, the
  copy out of pinned memory and the unpack; ``device_wait`` is the part of
  it spent in the runner's own wait on the batch's CUDA events, so the
  device's share of the run shows beside the host's stages;
* extract (native featgen, consumer thread);
* the engine's ``StageTimers`` (featgen and consumer stall).

Runs on the card unless ``--device cpu`` is given. The last line printed is
the run's numbers as one JSON object, with the kernels' launches on the card.
The native phases are read only when HT_PROF=1 is set before the process
first builds a window (the command line sets it).

Usage: HT_PROF=1 python tools/profile_e2e_torch.py [30|90] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (n_reads, genome_len) of the two profiles, as tools/profile_e2e.py:70-74
PROFILES = {"90": (264, 66_000), "30": (200, 150_000)}
STAGES = ("tensorize", "collate", "dispatch", "finalize", "device_wait", "extract")


class StageAcct:
    def __init__(self, name: str):
        self.name = name
        self.wall = 0.0
        self.cpu = 0.0
        self.calls = 0

    def wrap(self, fn):
        def inner(*a, **kw):
            w0 = time.perf_counter()
            c0 = time.thread_time()
            out = fn(*a, **kw)
            self.cpu += time.thread_time() - c0
            self.wall += time.perf_counter() - w0
            self.calls += 1
            return out

        return inner

    def row(self) -> str:
        return (
            f"  {self.name:18s} wall {self.wall:7.2f}s  cpu {self.cpu:7.2f}s"
            f"  ({self.calls} calls)"
        )


def profile(n_reads: int, genome_len: int, device=None, ckpt: str | None = None,
            window_size: int = 4096, batch_size: int = 32) -> dict:
    """One warm-up and one timed run of the profile; returns its numbers."""
    from herro_tpu_torch import native
    from herro_tpu_torch.features import extract as extract_mod
    from herro_tpu_torch.ops.cuda import launch_counts
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.pipeline import batching, engine
    from herro_tpu_torch.pipeline.batching import BucketSpec
    from herro_tpu_torch.pipeline.engine import StageTimers, run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner
    from herro_tpu_torch.training.simulate import paf_rows, simulate

    ds = simulate(
        genome_len=genome_len,
        n_reads=n_reads,
        read_len=(3 * window_size, 8 * window_size),
        sub_rate=0.02,
        ins_rate=0.02,
        del_rate=0.02,
        het_rate=0.005,
        seed=97,
    )
    rows = paf_rows(ds, min_overlap=window_size)
    cfg, params = load_model(ckpt or os.path.join(ROOT, "resources", "model_r10_sim"))
    runner = CorrectionRunner(cfg, params, device=device)

    acct = {k: StageAcct(k) for k in STAGES}
    kept = (engine.tensorize, batching.collate, extract_mod.extract_read_tensors)
    engine.tensorize = acct["tensorize"].wrap(batching.tensorize)
    batching.collate = acct["collate"].wrap(batching.collate)
    # the engine imports extract_read_tensors inside run_correction, so
    # wrapping the module attribute catches the live path
    extract_mod.extract_read_tensors = acct["extract"].wrap(
        extract_mod.extract_read_tensors
    )
    runner.dispatch = acct["dispatch"].wrap(runner.dispatch)
    runner.finalize = acct["finalize"].wrap(runner.finalize)
    fetch = runner._fetch

    @acct["device_wait"].wrap
    def wait_events(inflight) -> None:
        for event in inflight.events:
            if event is not None:
                event.synchronize()

    def waited_fetch(inflight):
        wait_events(inflight)
        return fetch(inflight)

    runner._fetch = waited_fetch

    try:
        with tempfile.TemporaryDirectory() as tmp:
            fastq = os.path.join(tmp, "reads.fastq")
            ds.write_fastq(fastq)
            reads = load_reads(fastq, min_length=window_size)
            t0 = time.perf_counter()
            grouped = parse_paf(rows, reads.name_to_id)
            parse_s = time.perf_counter() - t0

            # warmup (builds the kernels) over a quarter, as the reference's
            warm = dict(list(grouped.items())[: max(6, len(grouped) // 4)])
            run_correction(
                reads, iter(warm.items()), runner,
                os.path.join(tmp, "warm.fasta"), window_size, batch_size,
                bucket_spec=BucketSpec(),
            )
            for a in acct.values():
                a.wall = a.cpu = 0.0
                a.calls = 0
            native.prof_dump(reset=True)
            launches0 = launch_counts.snapshot()

            n_windows = sum(-(-reads.length(rid) // window_size) for rid in grouped)
            timers = StageTimers()
            depth = int(os.environ.get("HT_DEPTH", "8"))
            w0 = time.perf_counter()
            c0 = time.process_time()
            run_correction(
                reads, iter(grouped.items()), runner,
                os.path.join(tmp, "corrected.fasta"), window_size, batch_size,
                bucket_spec=BucketSpec(), timers=timers, pipeline_depth=depth,
            )
            wall = time.perf_counter() - w0
            cpu = time.process_time() - c0
            launches = {k: v - launches0[k] for k, v in launch_counts.snapshot().items()}
    finally:
        engine.tensorize, batching.collate, extract_mod.extract_read_tensors = kept

    nat = native.prof_dump()
    return dict(
        device=str(runner.device), windows=n_windows, wall_s=wall, process_cpu_s=cpu,
        windows_per_s=n_windows / wall, featgen_s=timers.featgen_s,
        device_stall_s=timers.device_s, batches=timers.n_batches, parse_paf_s=parse_s,
        stages={a.name: dict(wall_s=a.wall, cpu_s=a.cpu, calls=a.calls)
                for a in acct.values()},
        rows=[a.row() for a in acct.values()],
        native_total_build_s=nat.pop("total_build", 0.0), native=nat,
        launches={k: v for k, v in launches.items() if v},
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("profile", nargs="?", default="90", choices=sorted(PROFILES))
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = ap.parse_args()
    os.environ.setdefault("HT_PROF", "1")
    n_reads, genome_len = PROFILES[args.profile]
    r = profile(n_reads, genome_len, device=args.device)

    print(f"profile={args.profile}x device={r['device']} windows={r['windows']} "
          f"wall={r['wall_s']:.2f}s process_cpu={r['process_cpu_s']:.2f}s -> "
          f"{r['windows_per_s']:.1f} w/s")
    print(f"  engine featgen_s={r['featgen_s']:.2f} "
          f"device_stall_s={r['device_stall_s']:.2f} batches={r['batches']}")
    print(f"  parse_paf {r['parse_paf_s']:.2f}s (outside the run)")
    for row in r["rows"]:
        print(row)
    print(f"  native build total {r['native_total_build_s']:.2f}s:")
    for k, v in r["native"].items():
        print(f"    {k:18s} {v:7.2f}s")
    print(json.dumps({k: v for k, v in r.items() if k != "rows"}))


if __name__ == "__main__":
    main()
