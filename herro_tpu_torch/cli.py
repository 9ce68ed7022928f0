"""Command-line interface of the PyTorch/CUDA port.

    python -m herro_tpu_torch.cli inference [--read-alns D | --write-alns D] \\
        [-w W] [-t N] -m MODEL [-b B] [-c CLUSTER] [--device cuda|cpu] \\
        READS OUTPUT

The ``inference`` subcommand of ``herro_tpu`` on one device, with its flags.
It runs on the card unless ``--device cpu`` is given. The reference's
multi-device, multi-host, int8 and featgen-process flags are accepted but
raise until the port carries them.
"""

from __future__ import annotations

import argparse
import sys
import time

from .constants import DEFAULT_WINDOW_SIZE


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="herro-tpu-torch")
    sub = ap.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("inference", help="error-correct reads")
    g = pi.add_mutually_exclusive_group()
    g.add_argument("--read-alns", help="folder with *.oec.zst alignment batches to read")
    g.add_argument(
        "--write-alns", help="folder where *.oec.zst alignment batches will be saved"
    )
    pi.add_argument(
        "-w", "--window-size", type=int, default=DEFAULT_WINDOW_SIZE,
        help="target chunking window size (default 4096)",
    )
    pi.add_argument(
        "-t", "--feat-gen-threads", type=int, default=1,
        help="feature generation threads (default 1)",
    )
    pi.add_argument(
        "--feat-gen-procs", type=int, default=0,
        help="feature generation worker processes (not ported yet: > 1 raises)",
    )
    pi.add_argument("reads", help="fastq reads, optionally gzipped (file or dir)")
    pi.add_argument(
        "-m", "--model", required=True,
        help="model checkpoint dir, or a named config (tiny/r10/r9/r10w/r10deep)",
    )
    pi.add_argument(
        "-b", "--batch-size", type=int, default=32, help="windows per device batch"
    )
    pi.add_argument("-c", "--cluster", default="", help="path to a cluster .part file")
    pi.add_argument(
        "--device", default="cuda",
        help="torch device to run on: cuda (default, the current card), "
        "cuda:N, or cpu",
    )
    pi.add_argument(
        "--devices", default="1",
        help="data-parallel device count (only 1 is ported yet)",
    )
    pi.add_argument(
        "--tp", type=int, default=1, help="tensor-parallel degree (only 1 is ported yet)"
    )
    pi.add_argument(
        "--int8", action=argparse.BooleanOptionalAction, default=None,
        help="int8 layer-stack matmuls (not ported yet)",
    )
    pi.add_argument(
        "--resume", action="store_true",
        help="append to an existing output, skipping already-corrected reads",
    )
    pi.add_argument(
        "--shard", default="",
        help="'i/n': correct only targets with rid %% n == i (combine per-shard "
        "outputs afterwards)",
    )
    pi.add_argument(
        "--pipeline-depth", type=int, default=8,
        help="device batches kept in flight",
    )
    pi.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler trace (Chrome JSON) of the run to this directory",
    )
    pi.add_argument("--coordinator", default="", help="multi-host (not ported yet)")
    pi.add_argument(
        "--num-processes", type=int, default=0, help="multi-host (not ported yet)"
    )
    pi.add_argument(
        "--process-id", type=int, default=0, help="multi-host (not ported yet)"
    )
    pi.add_argument("output", help="corrected reads FASTA path")
    return ap


def _check_ported(args) -> None:
    """Raise a clear error for the reference flags a later slice carries."""
    devices = str(args.devices)
    if "," in devices or int(devices) not in (0, 1):
        raise SystemExit(
            f"--devices {devices}: only one device is ported yet; pick the card "
            "with --device cuda:N"
        )
    if args.tp != 1:
        raise SystemExit("--tp: tensor parallelism is not ported yet")
    if args.coordinator or args.num_processes or args.process_id:
        raise SystemExit("multi-host flags are not ported yet")
    if args.int8:
        raise SystemExit("--int8: int8 inference is not ported yet")
    if args.feat_gen_procs > 1:
        raise SystemExit("--feat-gen-procs > 1: the featgen process pool is not "
                         "ported yet; use -t for threads")


def cmd_inference(args) -> None:
    from .io.fastx import load_reads, read_cluster
    from .models.checkpoint import load_or_init
    from .overlaps.paf import ParseStats
    from .pipeline.engine import AlnMode, StageTimers, alignment_stream, run_correction
    from .pipeline.infer import CorrectionRunner
    from .pipeline.progress import Progress

    _check_ported(args)
    core, neighbour = read_cluster(args.cluster)
    t0 = time.time()
    reads = load_reads(args.reads, args.window_size, core, neighbour)
    print(f"Parsed {len(reads)} reads in {time.time() - t0:.1f}s.", file=sys.stderr)

    cfg, params = load_or_init(args.model)
    runner = CorrectionRunner(cfg, params, int8=args.int8, device=args.device)

    progress = Progress()
    mode = AlnMode(read_path=args.read_alns, write_path=args.write_alns)
    paf_stats = ParseStats()
    source = alignment_stream(
        reads,
        args.reads,
        mode,
        args.feat_gen_threads,
        core=core,
        on_batch=progress.add_batch,
        stats=paf_stats,
    )
    if args.shard:
        i, _, n_shards = args.shard.partition("/")
        i, n_shards = int(i), int(n_shards)
        source = ((rid, a) for rid, a in source if rid % n_shards == i)

    profiler = None
    if args.profile_dir:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if runner.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(args.profile_dir),
        )
        profiler.start()

    timers = StageTimers()
    t0 = time.time()
    try:
        n = run_correction(
            reads,
            source,
            runner,
            args.output,
            args.window_size,
            args.batch_size,
            feat_threads=args.feat_gen_threads,
            on_read_done=lambda rid: progress.inc(),
            resume=args.resume,
            timers=timers,
            pipeline_depth=args.pipeline_depth,
        )
    finally:
        if profiler is not None:
            profiler.stop()
    progress.finish()
    print(
        f"Corrected {n} reads in {time.time() - t0:.1f}s ({timers.summary()}).",
        file=sys.stderr,
    )
    if paf_stats.n_skipped:
        print(f"[herro-tpu-torch] PAF ingest: {paf_stats.summary()}", file=sys.stderr)


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    cmd_inference(args)


if __name__ == "__main__":
    main()
