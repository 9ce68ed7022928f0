"""Command-line interface of the PyTorch/CUDA port.

    python -m herro_tpu_torch.cli features  [--read-alns D | --write-alns D] \\
        [-w W] [-t N] [--feat-gen-procs N] READS OUTPUT_DIR
    python -m herro_tpu_torch.cli inference [--read-alns D | --write-alns D] \\
        [-w W] [-t N] [--feat-gen-procs N] -m MODEL [-b B] [-c CLUSTER] \\
        [--device cuda|cpu] [--devices N|I,J,..] [--tp N] [--coordinator H:P \\
        --num-processes N --process-id I] READS OUTPUT
    python -m herro_tpu_torch.cli eval MODEL [--mode model|counting|oracle] \\
        [--with-baseline] [--device cuda|cpu] ...
    python -m herro_tpu_torch.cli train [--config NAME|DIR] [--steps N] \\
        [--batch-size B] [--curriculum] [--max-len L] [--device cuda|cpu] \\
        [--devices N|I,J,..] [--tp N] ... OUTPUT
    python -m herro_tpu_torch.cli distill FEATURES_DIR OUTPUT --teacher CKPT \\
        [--student NAME|DIR] [--device cuda|cpu] ...

The ``features``, ``inference``, ``eval``, ``train`` and ``distill``
subcommands of ``herro_tpu``, with their flags. All but ``features`` run on
the card unless ``--device cpu`` is given; ``features`` runs on the host
alone. ``inference`` and ``train`` take the reference's multi-device flags:
``--devices`` (a count of local cards or an index list like '0,1,3', data
parallel; default all) and ``--tp N`` (Megatron tensor parallelism over a
2-D data x model mesh); ``train`` then sums the replicas' gradients into one
global step. ``inference`` also takes the multi-host flags
``--coordinator`` / ``--num-processes`` / ``--process-id`` (processes that
each correct every n-th alignment batch into ``OUTPUT.shardNNN``); the
reference's ``train`` has none. ``--int8`` takes any ``--tp``, and an int8
config trains on every layout. ``--int8`` / ``--no-int8`` override the
checkpoint's ``config.json``.
"""

from __future__ import annotations

import argparse
import sys
import time

from .constants import DEFAULT_WINDOW_SIZE


def _add_common(p: argparse.ArgumentParser) -> None:
    g = p.add_mutually_exclusive_group()
    g.add_argument("--read-alns", help="folder with *.oec.zst alignment batches to read")
    g.add_argument(
        "--write-alns", help="folder where *.oec.zst alignment batches will be saved"
    )
    p.add_argument(
        "-w", "--window-size", type=int, default=DEFAULT_WINDOW_SIZE,
        help="target chunking window size (default 4096)",
    )
    p.add_argument(
        "-t", "--feat-gen-threads", type=int, default=1,
        help="feature generation threads (default 1)",
    )
    p.add_argument(
        "--feat-gen-procs", type=int, default=0,
        help="feature generation worker *processes* (GIL-free; read arenas "
        "shared zero-copy via fork). Overrides -t for featgen when > 1",
    )
    p.add_argument("reads", help="fastq reads, optionally gzipped (file or dir)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="herro-tpu-torch")
    sub = ap.add_subparsers(dest="command", required=True)

    pf = sub.add_parser("features", help="generate training features")
    _add_common(pf)
    pf.add_argument("output", help="folder where features will be stored")

    pi = sub.add_parser("inference", help="error-correct reads")
    _add_common(pi)
    pi.add_argument(
        "-m", "--model", required=True,
        help="model checkpoint dir, or a named config (tiny/r10/r9/r10w/r10deep)",
    )
    pi.add_argument(
        "-b", "--batch-size", type=int, default=32, help="windows per device batch"
    )
    pi.add_argument("-c", "--cluster", default="", help="path to a cluster .part file")
    _add_device(pi)
    pi.add_argument(
        "--devices", default="0",
        help="local devices for data parallelism: a count, or an explicit index "
        "list like '0,1,3' (reference -d, src/main.rs:86-92); 0 = all cards "
        "(the card --device cuda:N names, if it names one); with --device cpu "
        "the number of CPU replicas, 0 = one",
    )
    pi.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel degree (heads and the FFN hidden shard over a 2-D "
        "data x model mesh; must divide the device count); each shard runs the "
        "same kernels at its own widths, bf16 or --int8",
    )
    pi.add_argument(
        "--int8", action=argparse.BooleanOptionalAction, default=None,
        help="quantize the qkv and FFN matmuls of the layer stack to int8 "
        "(per-row activations, per-channel weights); default follows the "
        "checkpoint's config. On the card it takes bf16 and float32 configs "
        "at d_model a multiple of 32 up to 512, d_ff (a shard's under --tp) a "
        "multiple of 32 up to 2048 and head dims 16-128: bf16 at the shipped "
        "widths runs the int8 tensor-core kernels, the rest the SIMT int8 ones; "
        "the entry and attention take the --device widths",
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
    pi.add_argument(
        "--coordinator", default="",
        help="multi-host: coordinator address host:port (torch.distributed, gloo "
        "over TCP, served by process 0)",
    )
    pi.add_argument(
        "--num-processes", type=int, default=0, help="multi-host: process count"
    )
    pi.add_argument(
        "--process-id", type=int, default=0, help="multi-host: this process's index"
    )
    pi.add_argument("output", help="corrected reads FASTA path")

    pe = sub.add_parser(
        "eval", help="score correction quality on held-out simulated data"
    )
    pe.add_argument("model", help="checkpoint dir or named config")
    pe.add_argument("-w", "--window-size", type=int, default=DEFAULT_WINDOW_SIZE)
    pe.add_argument("-b", "--batch-size", type=int, default=16)
    pe.add_argument("--genome-len", type=int, default=120_000)
    pe.add_argument("--n-reads", type=int, default=120)
    pe.add_argument("--sub-rate", type=float, default=0.02)
    pe.add_argument("--indel-rate", type=float, default=0.04)
    pe.add_argument("--het-rate", type=float, default=0.005)
    pe.add_argument("--seed", type=int, default=12345)
    pe.add_argument(
        "--profile", choices=["systematic"], default=None,
        help="named simulator stress profile: 'systematic' adds "
        "locus-correlated confident miscalls (half strand-biased), "
        "adapter-chimera junction reads, and coverage dropouts "
        "(training/eval.py SIM_PROFILES)",
    )
    pe.add_argument(
        "--counting-only", action="store_true",
        help="diagnostic: decode with the counting rule only (model disabled "
        "at supported columns)",
    )
    pe.add_argument(
        "--mode", choices=["model", "counting", "oracle"], default=None,
        help="decode mode: model (default), counting (the floor), or oracle "
        "(truth at supported columns — the ceiling of any model)",
    )
    pe.add_argument(
        "--with-baseline", action="store_true",
        help="also decode the identical features with the counting rule and "
        "report the matched-seed model_gain_db",
    )
    pe.add_argument(
        "--int8", action=argparse.BooleanOptionalAction, default=None,
        help="quantize the qkv and FFN matmuls of the layer stack to int8; "
        "default follows the checkpoint's config (on the card: bf16 or float32, "
        "the widths inference --int8 takes)",
    )
    pe.add_argument(
        "--shuffle-quals", action="store_true",
        help="ablation control: permute each read's quality string (seeded) "
        "before correction — the matched-seed gap vs a normal run is the "
        "quality channel's contribution",
    )
    _add_device(pe)

    pt = sub.add_parser("train", help="train a correction model (synthetic pretraining)")
    pt.add_argument("--config", default="r10", help="model config name or ckpt dir")
    pt.add_argument("--steps", type=int, default=2000)
    pt.add_argument("--batch-size", type=int, default=32)
    pt.add_argument("--lr", type=float, default=3e-4)
    pt.add_argument("-w", "--window-size", type=int, default=DEFAULT_WINDOW_SIZE)
    pt.add_argument("--genome-len", type=int, default=200_000)
    pt.add_argument("--n-reads", type=int, default=400)
    pt.add_argument("--sub-rate", type=float, default=0.03)
    pt.add_argument("--indel-rate", type=float, default=0.04)
    pt.add_argument("--het-rate", type=float, default=0.005)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument(
        "--data-cache", default="",
        help="cache path for the simulated labelled windows (featgen on one "
        "core takes minutes; restarts reuse the cache). A pickle file for "
        "the single-profile path, a directory with --curriculum. The pickles "
        "hold the port's LabelledWindow: herro_tpu's do not load here",
    )
    pt.add_argument(
        "--curriculum", action="store_true",
        help="train on the pooled multi-regime curriculum (coverage 15-60x, "
        "R10/R9 error profiles, haploid/het shards) instead of one profile",
    )
    pt.add_argument(
        "--hard-weight", type=float, default=3.0,
        help="extra cross-entropy weight on columns where truth != target "
        "(0 = unweighted)",
    )
    pt.add_argument(
        "--max-len", type=int, default=0,
        help="pad every batch to one fixed window length instead of the "
        "(5120/8192/9216/10240) production-width bucket ladder",
    )
    pt.add_argument(
        "--max-sup", type=int, default=640,
        help="padded supported count (only with --max-len)",
    )
    pt.add_argument(
        "--devices", default="0",
        help="local devices for data parallelism: a count, or an index list like "
        "'0,1,3'; 0 = all cards (the card --device cuda:N names, if it names one); "
        "with --device cpu the number of CPU replicas, 0 = one. The batch size "
        "must divide by the data axis",
    )
    pt.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel degree (heads and the FFN hidden shard over a 2-D "
        "data x model mesh; must divide the device count); int8 configs too",
    )
    _add_device(pt)
    pt.add_argument("output", help="checkpoint output directory")

    pd = sub.add_parser(
        "distill", help="train a student model on teacher-labelled `features` dumps"
    )
    pd.add_argument("features_dir", help="output tree of the features subcommand")
    pd.add_argument("output", help="student checkpoint output directory")
    pd.add_argument("--teacher", required=True, help="teacher ckpt dir or config")
    pd.add_argument("--student", default="tiny", help="student config or ckpt dir")
    pd.add_argument("--steps", type=int, default=500)
    pd.add_argument("--batch-size", type=int, default=16)
    pd.add_argument("--lr", type=float, default=3e-4)
    pd.add_argument("--max-len", type=int, default=5120)
    pd.add_argument("--max-sup", type=int, default=640)
    pd.add_argument("--seed", type=int, default=0)
    _add_device(pd)
    return ap


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run on: cuda (default, the current card), "
        "cuda:N, or cpu. The card takes bf16 and float32 configs at d_model a "
        "multiple of 32 up to 512, d_ff a multiple of 32 up to 2048 (bf16: or any "
        "multiple of 128 at d_model 256, 384 or 512) and head dims 16, 32, 64 "
        "or 128: bf16 at the shipped widths on the tensor-core kernels, the "
        "rest on the SIMT ones",
    )


def _device_mesh(args):
    """(the devices ``--devices`` names, the mesh over them or None) by the
    reference's rules; a bad spec, a card the host lacks or a degree that
    does not divide the devices exits with the reason."""
    from .parallel.mesh import local_devices, parse_devices

    try:
        devices = local_devices(args.devices, args.device)
    except ValueError as e:  # more cards than the host has, or a bad spec
        raise SystemExit(str(e)) from None
    mesh = _build_mesh(devices, isinstance(parse_devices(args.devices), list), args.tp)
    if mesh is not None and args.batch_size % mesh.n_data:
        raise SystemExit(
            f"batch size {args.batch_size} not divisible by data size {mesh.n_data}"
        )
    return devices, mesh


def _build_mesh(devices: list, explicit: bool, tp: int):
    """The reference's mesh rules (herro_tpu/cli.py:272-290): a 1-D data mesh,
    or a 2-D (data, model) mesh when tp > 1; None for one device."""
    from .parallel.mesh import make_mesh, make_mesh_2d

    if tp < 1:
        raise SystemExit(f"--tp {tp}: the degree is at least 1")
    if explicit:
        if tp > 1:
            raise SystemExit("--tp with an explicit device list is unsupported")
        return make_mesh(devices)
    if tp > 1:
        if len(devices) % tp:
            raise SystemExit(f"--tp {tp} does not divide {len(devices)} devices")
        return make_mesh_2d(len(devices) // tp, tp, devices)
    if len(devices) > 1:
        return make_mesh(devices)
    return None


def _load(args, core=None, neighbour=None):
    from .io.fastx import load_reads

    t0 = time.time()
    reads = load_reads(args.reads, args.window_size, core, neighbour)
    print(f"Parsed {len(reads)} reads in {time.time() - t0:.1f}s.", file=sys.stderr)
    return reads


def cmd_features(args) -> None:
    from .features.extract import extract_read_features
    from .features.npy import write_window_features
    from .overlaps.paf import ParseStats
    from .pipeline.engine import AlnMode, _parallel_featgen, alignment_stream

    reads = _load(args)
    mode = AlnMode(read_path=args.read_alns, write_path=args.write_alns)
    stats = ParseStats()
    source = alignment_stream(
        reads, args.reads, mode, args.feat_gen_threads, stats=stats
    )

    # Count reads at the (rid, alns) source level so the summary is
    # identical across the serial / threaded / process paths (zero-window
    # reads included everywhere).
    n_reads = 0

    def counted(src):
        nonlocal n_reads
        for item in src:
            n_reads += 1
            yield item

    source = counted(source)

    def handle(wf) -> None:
        write_window_features(args.output, reads, [wf])

    # Parallel featgen (reference: -t threads, src/lib.rs:84-104): worker
    # processes fork-share the read arenas; the npy writes stay on this
    # thread. Otherwise GIL-sharing threads, or serial.
    if args.feat_gen_procs > 1:
        from .pipeline.procpool import parallel_featgen_procs

        parallel_featgen_procs(
            reads, source, args.window_size, args.feat_gen_procs, handle,
            tensorized=False,
        )
    elif args.feat_gen_threads > 1:
        _parallel_featgen(
            reads, source, args.window_size, args.feat_gen_threads, handle,
            tensorized=False,
        )
    else:
        for rid, alns in source:
            feats = extract_read_features(rid, reads, alns, args.window_size)
            write_window_features(args.output, reads, feats)
    print(f"Generated features for {n_reads} reads.", file=sys.stderr)
    if stats.n_skipped:
        print(f"[herro-tpu-torch] PAF ingest: {stats.summary()}", file=sys.stderr)


def cmd_inference(args) -> None:
    from .io.fastx import read_cluster
    from .parallel.mesh import init_distributed, shutdown_distributed

    core, neighbour = read_cluster(args.cluster)
    reads = _load(args, core, neighbour)

    # Fork the featgen worker pool BEFORE the first CUDA call of the process:
    # a child forked after CUDA is initialised inherits a CUDA context it
    # cannot use. The arenas are inherited zero-copy; everything below (model
    # load, the runner and its stream) happens only in the parent.
    featgen_pool = None
    if args.feat_gen_procs > 1:
        from .pipeline.procpool import FeatgenPool

        featgen_pool = FeatgenPool(reads, args.window_size, args.feat_gen_procs)
    failed = True
    try:
        # the process group (a TCP store and gloo's threads) joins after the fork
        try:
            init_distributed(args.coordinator, args.num_processes, args.process_id)
        except ValueError as e:  # no coordinator, or an id past the count
            raise SystemExit(str(e)) from None
        _run_inference(args, reads, core, featgen_pool)
        failed = False
    finally:
        # Always tear the pool down: leaked worker queues wedge interpreter
        # shutdown on their feeder-thread join (see procpool.close).
        if featgen_pool is not None:
            featgen_pool.close(terminate=failed)
        shutdown_distributed(wait=not failed)


def _run_inference(args, reads, core, featgen_pool) -> None:
    from .models.checkpoint import load_or_init
    from .overlaps.paf import ParseStats
    from .parallel.mesh import process_count, process_index
    from .pipeline.engine import AlnMode, StageTimers, alignment_stream, run_correction
    from .pipeline.infer import CorrectionRunner
    from .pipeline.progress import Progress

    cfg, params = load_or_init(args.model)
    devices, mesh = _device_mesh(args)
    runner = CorrectionRunner(cfg, params, int8=args.int8, device=devices[0], mesh=mesh)

    progress = Progress()
    mode = AlnMode(read_path=args.read_alns, write_path=args.write_alns)
    paf_stats = ParseStats()
    # Multi-host: each process takes every k-th target-partitioned alignment
    # batch and writes its own shard output.
    stride = (process_index(), process_count())
    output_path = args.output
    if stride[1] > 1:
        output_path = f"{args.output}.shard{stride[0]:03d}"
    source = alignment_stream(
        reads,
        args.reads,
        mode,
        args.feat_gen_threads,
        core=core,
        on_batch=progress.add_batch,
        stride=stride,
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
            output_path,
            args.window_size,
            args.batch_size,
            feat_threads=args.feat_gen_threads,
            on_read_done=lambda rid: progress.inc(),
            resume=args.resume,
            timers=timers,
            pipeline_depth=args.pipeline_depth,
            featgen_pool=featgen_pool,
        )
    finally:
        if profiler is not None:
            profiler.stop()
    progress.finish()
    print(
        f"Corrected {n} reads in {time.time() - t0:.3f}s ({timers.summary()}).",
        file=sys.stderr,
    )
    if featgen_pool is not None:
        counts = sorted(featgen_pool.reads_by_worker.values())
        print(
            f"[herro-tpu-torch] featgen pool: {len(counts)} of "
            f"{featgen_pool.n_procs} workers ran"
            + (f" ({counts[0]}-{counts[-1]} reads each)" if counts else ""),
            file=sys.stderr,
        )
    if paf_stats.n_skipped:
        print(f"[herro-tpu-torch] PAF ingest: {paf_stats.summary()}", file=sys.stderr)


def cmd_eval(args) -> None:
    import json

    from .models.checkpoint import load_or_init
    from .training.eval import SIM_PROFILES, evaluate

    cfg, params = load_or_init(args.model)
    res = evaluate(
        cfg,
        params,
        window_size=args.window_size,
        genome_len=args.genome_len,
        n_reads=args.n_reads,
        sub_rate=args.sub_rate,
        ins_rate=args.indel_rate / 2,
        del_rate=args.indel_rate / 2,
        het_rate=args.het_rate,
        seed=args.seed,
        batch_size=args.batch_size,
        counting_only=args.counting_only,
        mode=args.mode,
        with_baseline=args.with_baseline,
        int8=args.int8,
        shuffle_quals=args.shuffle_quals,
        sim_extra=SIM_PROFILES[args.profile] if args.profile else None,
        device=args.device,
    )
    print(json.dumps(res.as_dict(), indent=1))


def cmd_train(args) -> None:
    import tempfile

    from .models.checkpoint import load_or_init, save_model
    from .training.data import (
        batch_iterator,
        bucketed_batch_iterator,
        curriculum_windows,
        simulated_windows,
    )
    from .training.simulate import simulate
    from .parallel.mesh import make_mesh
    from .training.train import Trainer

    cfg, params = load_or_init(args.config)
    devices, mesh = _device_mesh(args)

    windows = None
    if args.curriculum:
        windows = curriculum_windows(args.window_size, cache_dir=args.data_cache or None)
    if windows is None and args.data_cache:
        import pickle

        try:
            with open(args.data_cache, "rb") as fh:
                windows = pickle.load(fh)
            print(
                f"Loaded {len(windows)} cached windows from {args.data_cache}.",
                file=sys.stderr,
            )
        except FileNotFoundError:
            pass
    if windows is None:
        print("Simulating training data...", file=sys.stderr)
        ds = simulate(
            genome_len=args.genome_len,
            n_reads=args.n_reads,
            read_len=(4 * args.window_size, 12 * args.window_size),
            sub_rate=args.sub_rate,
            ins_rate=args.indel_rate / 2,
            del_rate=args.indel_rate / 2,
            het_rate=args.het_rate,
            seed=args.seed,
        )
        with tempfile.TemporaryDirectory() as tmp:
            windows = simulated_windows(ds, f"{tmp}/reads.fastq", args.window_size)
        if args.data_cache:
            import pickle

            with open(args.data_cache, "wb") as fh:
                pickle.dump(windows, fh)
    print(f"{len(windows)} labelled windows.", file=sys.stderr)

    trainer = Trainer(
        cfg, params, lr=args.lr, total_steps=args.steps, hard_weight=args.hard_weight,
        mesh=mesh if mesh is not None else make_mesh(devices),
    )
    if args.max_len:
        it = batch_iterator(
            windows, args.batch_size, L=args.max_len, S=args.max_sup, n_epochs=10_000,
            seed=args.seed,
        )
    else:
        it = bucketed_batch_iterator(
            windows, args.batch_size, n_epochs=10_000, seed=args.seed
        )
    for batch in it:
        metrics = trainer.train_step(batch)
        if trainer.state.step % 50 == 0:
            print(
                f"step {trainer.state.step}: "
                + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
                file=sys.stderr,
            )
        if trainer.state.step % 250 == 0:
            trainer.save(args.output)
        if trainer.state.step >= args.steps:
            break

    save_model(args.output, cfg, trainer.state.params)
    print(f"Saved checkpoint to {args.output}", file=sys.stderr)


def cmd_distill(args) -> None:
    from .training.distill import distill_from_dump

    res = distill_from_dump(
        args.features_dir,
        args.teacher,
        args.student,
        args.output,
        steps=args.steps,
        batch_size=args.batch_size,
        lr=args.lr,
        max_len=args.max_len,
        max_sup=args.max_sup,
        seed=args.seed,
        device=args.device,
    )
    print(
        f"Distilled {res['n_windows']} windows -> {args.output} "
        f"(final {res['final']})",
        file=sys.stderr,
    )


COMMANDS = {
    "features": cmd_features,
    "inference": cmd_inference,
    "eval": cmd_eval,
    "train": cmd_train,
    "distill": cmd_distill,
}


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    COMMANDS[args.command](args)


if __name__ == "__main__":
    main()
