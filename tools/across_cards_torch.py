"""Every layout of the port across distinct cards.

    python3 tools/across_cards_torch.py                 # on a host with four cards
    python3 tools/across_cards_torch.py --device cpu    # the CLI rows on CPU replicas

On the card it needs ``NEED_CARDS`` distinct cards: on a host with fewer it
exits 2 and names the shortfall, and it never runs a layout on one card
named again and again (``chip_smoke.py`` does that). It prints the card's
name and power limit, ``nvidia-smi topo -m`` and which cards reach each
other's memory (``torch.cuda.can_device_access_peer``), then one JSON line a
run, on the demo-size simulation of ``chip_smoke.py``'s ``e2e`` phase
(whose single-card run is the reference) with ``resources/model_r10_sim``:

* ``inference`` — the ``inference`` CLI (``cli.main``, in this process, over
  alignment batches under ``--read-alns``) at each row of ``CLI_ROWS``: the
  default (no ``--devices``: every card), ``--devices 2``, ``--devices 4
  --tp 2``, ``--devices 4 --tp 4`` and ``--int8`` at ``--devices 2 --tp 2``
  and ``--devices 4 --tp 4``. Data parallelism must write the single card's
  FASTA records; tensor parallelism must agree with the single card's step
  (bf16, or int8 for an int8 row) on at least ``chip_smoke.TP_MIN_AGREE``
  of the supported columns with equal decisions. Every row's mesh is made
  of distinct cards, each of which launches its own shards' kernels (K4,
  K1-K3 or K10, K2 and K11's modes; K5 on each replica's first card);
* ``parallel`` and ``multihost`` — ``chip_smoke.phase_parallel`` (every
  row of ``PARALLEL_LAYOUTS`` through ``CorrectionRunner(mesh=...)``) and
  ``chip_smoke.phase_multihost`` (two CLI processes, each on a card of its
  own) over distinct cards, with their bars;
* ``train`` — the ``train --config r10`` CLI at its default ``--devices``
  (every card: data parallelism), 3 steps at batch 32: every parameter
  moves and the checkpoint loads back; ``train_parallel`` — the int8
  layouts of ``chip_smoke.TRAIN_LAYOUTS`` (one card, TP 1 x 2 on two
  cards) on that run's windows, at ``chip_smoke.train_layouts``' bars;
* ``dryrun`` — ``dryrun_multichip(4)`` and ``(2)`` over distinct cards;
* ``steps`` — the correct step's time at B=32 a data replica, L=9216, on
  one card and under each of ``STEP_LAYOUTS`` (bf16 and int8), with
  windows/s a card, the launches by card and each card's peak memory;
* ``all_reduce`` — CUDA-event times of one [32, 9216, 512] bf16 partial
  copied from each card to the first (the link's rate), and of
  ``parallel.tensor.all_reduce`` and ``all_reduce_max`` at the step's
  shapes (that partial, a [32, 9216] float32 row maximum) over 2 and 4
  distinct cards, beside the same over one card named as often.

With ``--device cpu`` the ``inference`` and ``train`` rows run on CPU
replicas, at TINY_CONFIG's widths with 4 heads of 8 (so that every row's
tp divides them), over a small simulation, at the same bars but the
launches (no kernel runs on the CPU). Ends with one JSON line ``{"ok":
...}``; exits 1 when a run failed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEED_CARDS = 4
# (tag, inference flags, cards, int8, tp); "default" names no --devices, which
# on the card is every card (on the CPU the tool gives it --devices 4)
CLI_ROWS = (
    ("default", [], 4, False, 1),
    ("dp2", ["--devices", "2"], 2, False, 1),
    ("dp2_tp2", ["--devices", "4", "--tp", "2"], 4, False, 2),
    ("tp4", ["--devices", "4", "--tp", "4"], 4, False, 4),
    ("tp2_int8", ["--int8", "--devices", "2", "--tp", "2"], 2, True, 2),
    ("tp4_int8", ["--int8", "--devices", "4", "--tp", "4"], 4, True, 4),
)
# (tag, data replicas, tp) of the step times, each in bf16 and in int8
STEP_LAYOUTS = (("single", 1, 1), ("dp2", 2, 1), ("dp4", 4, 1), ("tp2", 1, 2), ("tp4", 1, 4))
STEP_ITERS = 5
# the CPU rows: window, batch, and the simulation (seeded)
CPU_WINDOW, CPU_BATCH = 256, 4
CPU_SIM = dict(genome_len=4000, n_reads=24, read_len=(900, 1600), sub_rate=0.03,
               ins_rate=0.01, del_rate=0.01, seed=11)
CPU_TRAIN = ["-w", "128", "--genome-len", "3000", "--n-reads", "20", "--max-len", "256",
             "--max-sup", "64", "--batch-size", "4"]


def emit(run: str, **kw) -> dict:
    row = dict(run=run, **kw)
    print(json.dumps(row, default=str), flush=True)
    return row


def shortfall(torch) -> str | None:
    """Why this host cannot run the layouts on distinct cards, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device is available (pass --device cpu for the CPU rows)"
    have = torch.cuda.device_count()
    if have < NEED_CARDS:
        return (f"the layouts need {NEED_CARDS} distinct cards, this host has {have} "
                f"({NEED_CARDS - have} short); no layout runs on one card named again here "
                f"(chip_smoke.py runs them so)")
    return None


def links(torch) -> dict:
    """``nvidia-smi topo -m`` and ``nvidia-smi nvlink -s`` (what each prints,
    its error where it fails) and each pair's peer access."""
    def smi(*args):
        res = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True)
        return (res.stdout + res.stderr).rstrip().splitlines()

    n = torch.cuda.device_count()
    return dict(topo=smi("topo", "-m"), nvlink=smi("nvlink", "-s"),
                peer_access={f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
                             for i in range(n) for j in range(n) if i != j})


def write_batches(tmp: str, rows, n: int = 2) -> str:
    """The alignments as ``n`` target-partitioned batches for ``--read-alns``."""
    from herro_tpu_torch.overlaps.batches import BatchWriter

    rows = [r if r.endswith(b"\n") else r + b"\n" for r in rows]
    targets = sorted({r.split(b"\t")[5] for r in rows})
    out = os.path.join(tmp, "alns")
    for k in range(n):
        part = targets[k * len(targets) // n:(k + 1) * len(targets) // n]
        keep = set(part)
        with BatchWriter(out, k, part) as bw:
            for r in rows:
                if r.split(b"\t")[5] in keep:
                    bw.write(r)
    return out


def cpu_reference(torch, tmp: str) -> dict:
    """The CPU rows' data, model and single-replica run: a small simulation,
    TINY_CONFIG with 4 heads of 8 saved as a checkpoint, ``run_correction``
    on one CPU replica."""
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.models.checkpoint import save_model
    from herro_tpu_torch.models.model import TINY_CONFIG, CorrectionModel
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.pipeline.engine import run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner
    from herro_tpu_torch.training.simulate import paf_rows, simulate

    ds = simulate(**CPU_SIM)
    fastq = os.path.join(tmp, "reads.fastq")
    ds.write_fastq(fastq)
    reads = load_reads(fastq, min_length=CPU_WINDOW)
    rows = paf_rows(ds, min_overlap=CPU_WINDOW)
    cfg = dataclasses.replace(TINY_CONFIG, n_heads=4)
    params = CorrectionModel(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
    ckpt = os.path.join(tmp, "tiny_h4")
    save_model(ckpt, cfg, params)
    runner = CorrectionRunner(cfg, params, device="cpu")
    fasta = os.path.join(tmp, "single.fasta")
    n = run_correction(reads, iter(parse_paf(rows, reads.name_to_id).items()), runner, fasta,
                       CPU_WINDOW, CPU_BATCH)
    return dict(runner=runner, fastq=fastq, rows=rows, fasta=fasta, reads_written=n,
                ckpt=ckpt, window=CPU_WINDOW, batch=CPU_BATCH)


@contextlib.contextmanager
def recording_fetch(recorded: list):
    """Every ``CorrectionRunner._fetch``: (runner, batch, packed) into
    ``recorded``."""
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    fetch = CorrectionRunner._fetch

    def rec(self, inflight):
        info, packed = fetch(self, inflight)
        recorded.append((self, inflight.batch, packed))
        return info, packed

    CorrectionRunner._fetch = rec
    try:
        yield
    finally:
        CorrectionRunner._fetch = fetch


def inference_rows(torch, tmp: str, ref: dict, device: str) -> list[dict]:
    """Each row of ``CLI_ROWS`` through the CLI, held against the single
    run (``ref``): its records (data parallelism) or its classes and
    decisions on every batch (tensor parallelism); on the card also its
    mesh's cards and their launches."""
    import chip_smoke
    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    alns = write_batches(tmp, ref["rows"])
    want_records = chip_smoke._fasta_records(ref["fasta"])
    on_card = device != "cpu"
    singles = {False: ref["runner"]}
    rows = []
    for tag, flags, cards, int8, tp in CLI_ROWS:
        if not on_card:
            flags = flags or ["--devices", str(cards)]
            flags = [*flags, "--device", "cpu"]
        out = os.path.join(tmp, f"cli_{tag}.fasta")
        recorded: list = []
        if on_card:
            torch.cuda.synchronize()
        kernels.launch_counts.reset()
        t0 = time.perf_counter()
        with recording_fetch(recorded):
            cli.main(["inference", "--read-alns", alns, "-m", ref["ckpt"], "-w",
                      str(ref["window"]), "-b", str(ref["batch"]), *flags, ref["fastq"], out])
        wall = time.perf_counter() - t0
        by_card = kernels.launch_counts.by_device()
        runner = recorded[0][0]
        n_windows = sum(len(batch.windows) for _, batch, _ in recorded)
        mesh = runner.mesh.devices if runner.mesh is not None else ((runner.device,),)
        devices = [d for row in mesh for d in row]
        if int8 not in singles:
            cfg, params = load_or_init(ref["ckpt"])
            singles[int8] = CorrectionRunner(cfg, params, int8=True, device=devices[0])
        n_sup = n_agree = 0
        dec_equal = True
        for _, batch, packed in recorded:
            single = singles[int8]
            agree, dec = chip_smoke._agreement(packed, single._fetch(single.dispatch(batch))[1],
                                               batch.support_mask)
            k = int(batch.support_mask.sum())
            n_sup, n_agree = n_sup + k, n_agree + agree * k
            dec_equal = dec_equal and dec
        agree = n_agree / max(n_sup, 1)
        records_equal = chip_smoke._fasta_records(out) == want_records
        ok = (len(devices) == cards and runner.mesh is not None and runner.mesh.tp == tp
              and dec_equal and n_sup > 0)
        ok = ok and (records_equal if tp == 1 else agree >= chip_smoke.TP_MIN_AGREE)
        want_cards = None
        if on_card:
            want_cards = chip_smoke.want_by_card(devices, tp, int8, runner.cfg.n_layers,
                                                 len(recorded))
            ok = ok and len({d.index for d in devices}) == cards and by_card == want_cards
        rows.append(emit("inference", layout=tag, flags=flags,
                         mesh=[[str(d) for d in row] for row in mesh], int8=int8, tp=tp,
                         records_equal=records_equal, class_agreement=agree,
                         supported_columns=n_sup, decisions_equal=dec_equal,
                         batches=len(recorded), wall_s=wall, windows_per_s=n_windows / wall,
                         launches_by_card=by_card,
                         want_launches_by_card=want_cards, ok=ok))
        del recorded, runner
    return rows


def train_row(torch, tmp: str, device: str, config: str) -> dict:
    """The ``train`` CLI at its default ``--devices`` (on the CPU: 4
    replicas), 3 steps: every parameter of the checkpoint moved from the
    initial weights, and the checkpoint loads back with its config."""
    import chip_smoke
    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_model, load_or_init

    out = os.path.join(tmp, "trained")
    cache = os.path.join(tmp, "train_windows.pkl")
    if device == "cpu":
        args = ["--config", config, *CPU_TRAIN, "--steps", "3", "--devices", "4",
                "--device", "cpu"]
    else:  # the smoke run's train phase, 3 steps
        args = list(chip_smoke.TRAIN_ARGS)
        args[args.index("--steps") + 1] = "3"
    t0 = time.perf_counter()
    cli.main(["train", *args, "--data-cache", cache, out])
    wall = time.perf_counter() - t0
    cfg0, init = load_or_init(config)
    cfg, trained = load_model(out)
    still = [k for k, v in init.items() if torch.equal(v.float(), trained[k].float())]
    ok = cfg == cfg0 and list(trained) == list(init) and not still
    return emit("train", args=args, wall_s=wall, parameters=len(init), unmoved=still,
                config_equal=cfg == cfg0, ok=ok)


def step_rows(torch, devices: list) -> list[dict]:
    """The correct step at B=32 a data replica, L=9216, under each of
    ``STEP_LAYOUTS`` over the first cards of ``devices``, bf16 and int8:
    ms a step (``chip_smoke._layout_step_ms``), windows/s a card, launches by
    card and each card's peak of allocated memory."""
    import chip_smoke
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel import make_mesh_2d
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    cfg, params = load_model(chip_smoke.CKPT)
    rows = []
    for int8 in (False, True):
        for tag, n_data, tp in STEP_LAYOUTS:
            n = n_data * tp
            cards = [d.index for d in devices[:n]]
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            mesh = None if n == 1 else make_mesh_2d(n_data, tp, devices)
            runner = CorrectionRunner(cfg, params, int8=int8, device=devices[0], mesh=mesh)
            batches = [chip_smoke._step_batch(seed, batch=chip_smoke.B * n_data)
                       for seed in (4321, 4322)]
            kernels.launch_counts.reset()
            t = chip_smoke._layout_step_ms(torch, runner, batches, iters=STEP_ITERS)
            windows = chip_smoke.B * n_data
            rows.append(emit(
                "steps", layout=tag + ("_int8" if int8 else ""), data=n_data, tp=tp,
                cards=cards, batch=windows, L=chip_smoke.L, **t,
                windows_per_s_per_card=windows * 1e3 / t["step_ms"] / n,
                launches_by_card=kernels.launch_counts.by_device(),
                peak_gib_by_card={c: torch.cuda.max_memory_allocated(c) / 2 ** 30
                                  for c in cards}))
            del runner
            torch.cuda.empty_cache()
    return rows


def all_reduce_rows(torch, devices: list, iters: int = 5) -> list[dict]:
    """CUDA-event ms (the first card's stream, after it has waited for every
    other card's) of a [32, 9216, 512] bf16 partial copied from each card to
    the first, then of ``all_reduce`` over such partials and of
    ``all_reduce_max`` over [32, 9216] float32 ones, at tp 2 and 4, over
    distinct cards and over the first card named tp times."""
    import chip_smoke
    from herro_tpu_torch.parallel.tensor import all_reduce, all_reduce_max

    rows = []
    shape = (chip_smoke.B, chip_smoke.L, 512)
    for j, src_dev in enumerate(devices[1:], start=1):  # one partial over the link
        src = torch.ones(shape, dtype=torch.bfloat16, device=src_dev)
        dst = torch.empty(shape, dtype=torch.bfloat16, device=devices[0])
        cards = [devices[0].index, src_dev.index]
        dst.copy_(src)
        chip_smoke._sync_cards(torch, cards)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record(torch.cuda.current_stream(cards[0]))
        for _ in range(iters):
            dst.copy_(src)  # on the source card's stream, card 0's waiting for it
        e1.record(torch.cuda.current_stream(cards[0]))
        chip_smoke._sync_cards(torch, cards)
        ms = e0.elapsed_time(e1) / iters
        rows.append(emit("all_reduce", op="copy", devices=[str(src_dev), str(devices[0])],
                         partial_mb=src.numel() * 2 / 1e6, ms=ms,
                         gb_per_s=src.numel() * 2 / ms / 1e6))
        del src, dst
    shapes = {"all_reduce": (shape, torch.bfloat16, all_reduce),
              "all_reduce_max": ((chip_smoke.B, chip_smoke.L), torch.float32, all_reduce_max)}
    for name, (shape, dtype, fn) in shapes.items():
        for tp in (2, 4):
            for where, devs in (("distinct", devices[:tp]), ("one card", [devices[0]] * tp)):
                cards = sorted({d.index for d in devs})
                g = torch.Generator(device=devs[0]).manual_seed(tp)
                parts = [torch.randn(shape, generator=g, device=devs[0]).to(dtype).to(d)
                         for d in devs]
                with torch.inference_mode():
                    for _ in range(2):
                        fn(parts)
                    chip_smoke._sync_cards(torch, cards)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record(torch.cuda.current_stream(cards[0]))
                    for _ in range(iters):
                        out = fn(parts)
                    chip_smoke._join_cards(torch, cards)
                    e1.record(torch.cuda.current_stream(cards[0]))
                    chip_smoke._sync_cards(torch, cards)
                want = parts[0].float()
                for p in parts[1:]:
                    want = (want + p.to(want.device).float()) if name == "all_reduce" \
                        else torch.maximum(want, p.to(want.device).float())
                exact = all(torch.equal(o.to(want.device).float(), want.to(dtype).float())
                            for o in out)
                nbytes = parts[0].numel() * parts[0].element_size()
                rows.append(emit("all_reduce", op=name, tp=tp, cards=where,
                                 devices=[str(d) for d in devs], partial_mb=nbytes / 1e6,
                                 ms=e0.elapsed_time(e1) / iters, equal_on_every_shard=exact,
                                 ok=exact))
                del parts, out
                torch.cuda.empty_cache()
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): every run on distinct cards; cpu: the CLI rows "
                         "on CPU replicas")
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, ROOT)
    if args.device == "cuda":
        why = shortfall(torch)
        if why:
            print(f"across_cards_torch: {why}", file=sys.stderr)
            return 2
    import chip_smoke

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        # the alignment batches as raw bytes, as chip_smoke's multihost phase
        # writes them: the card's host has no zstandard
        sys.path.insert(0, chip_smoke.zstd_stand_in(os.path.join(tmp, "zstandard_stand_in")))
        if args.device == "cpu":
            emit("env", device="cpu", torch=torch.__version__)
            ref = cpu_reference(torch, tmp)
            rows += inference_rows(torch, tmp, ref, "cpu")
            rows.append(train_row(torch, tmp, "cpu", ref["ckpt"]))
        else:
            rows += run_on_cards(torch, tmp)
    ok = bool(rows) and all(r.get("ok", True) for r in rows)
    device = {"platform": "cpu"} if args.device == "cpu" else {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}
    print(json.dumps({"ok": ok, "failed": [r.get("layout") or r["run"] for r in rows
                                           if not r.get("ok", True)], "device": device}))
    return 0 if ok else 1


def warm_up(torch, devices: list) -> None:
    """One small batch over a data mesh of every card: each card's context,
    library handles and rope tables made before the timed CLI rows."""
    import chip_smoke
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.parallel import make_mesh
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    cfg, params = load_model(chip_smoke.CKPT)
    runner = CorrectionRunner(cfg, params, mesh=make_mesh(devices))
    runner._fetch(runner.dispatch(chip_smoke._step_batch(batch=2 * len(devices))))


def run_on_cards(torch, tmp: str) -> list[dict]:
    """The card's runs in order, each reported; a failed one does not stop
    the next."""
    import pickle

    import chip_smoke
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel.dryrun import dryrun_multichip
    from herro_tpu_torch.pipeline.infer import keep_float32_exact
    from herro_tpu_torch.training.data import TRAIN_BUCKETS, collate_train

    devices = [torch.device("cuda", i) for i in range(NEED_CARDS)]
    keep_float32_exact(devices[0])
    emit("env", card=chip_smoke.nvidia_smi(), torch=torch.__version__, cuda=torch.version.cuda,
         cards=[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())],
         build_s=kernels.build_all(), **links(torch))
    rows = []

    def guarded(run: str, fn, *args):
        """One run; a failure is reported as a row and the next run goes on."""
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception as err:  # noqa: BLE001 - every run is reported
            rows.append(emit(run, ok=False, error=f"{type(err).__name__}: {err}"[-4000:]))
            return None
        rows.append(emit(run, ok=True, wall_s=time.perf_counter() - t0))
        return out

    e2e = guarded("e2e", chip_smoke.phase_e2e, torch, tmp)
    if e2e is None:
        return rows
    ref = dict(e2e, ckpt=chip_smoke.CKPT, window=4096, batch=chip_smoke.B)
    guarded("warm-up", warm_up, torch, devices)
    got = guarded("inference rows", inference_rows, torch, tmp, ref, "cuda")
    rows += got or []
    guarded("parallel", chip_smoke.phase_parallel, torch, tmp, e2e, devices)
    guarded("multihost", chip_smoke.phase_multihost, tmp, e2e, devices[:2])
    del e2e, ref
    torch.cuda.empty_cache()
    train = guarded("train cli", train_row, torch, tmp, "cuda", "r10")
    if train is not None:
        rows.append(train)
        with open(os.path.join(tmp, "train_windows.pkl"), "rb") as fh:
            windows = pickle.load(fh)
        batch = collate_train(windows[:chip_smoke.B], *TRAIN_BUCKETS[2])  # L 9216, S 1152
        got = guarded("train_parallel int8", chip_smoke.train_layouts, torch, tmp, batch,
                      chip_smoke.TRAIN_INT8_LAYOUTS, devices)
        if got is not None and got[2]:
            rows.append(emit("train_parallel int8", ok=False, failed=got[2]))
    for n in (4, 2):
        got = guarded(f"dryrun_multichip({n})", dryrun_multichip, n, "cuda")
        if got is not None:
            emit("dryrun", n_devices=n, **got)
    rows += guarded("steps", step_rows, torch, devices) or []
    rows += guarded("all_reduce", all_reduce_rows, torch, devices) or []
    return rows


if __name__ == "__main__":
    sys.exit(main())
