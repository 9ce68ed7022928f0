"""The port end to end, held against herro_tpu.

* the port's ``run_correction`` and herro_tpu's, on the same simulated reads
  and PAF (as tests/test_e2e.py), both with the flagship R10 checkpoint in
  float32, write byte-identical FASTA;
* the runner's collect_info / collect_counting / counting_only results
  equal herro_tpu's on one batch (float32);
* the port's CLI on the CPU with ``--read-alns`` writes what a direct
  ``run_correction`` writes;
* importing every module of the port (``herro_tpu_torch.parallel`` too)
  leaves jax, flax, optax, msgpack, zstandard and herro_tpu out of
  ``sys.modules``;
* a runner asked for no device raises without a card instead of falling
  back to the CPU.
"""

import dataclasses
import glob
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from herro_tpu.training.simulate import paf_rows, simulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R10_CKPT = os.path.join(ROOT, "resources", "model_r10_sim")
WINDOW = 256
SPEC = dict(lengths=(320, 512, 1024), sup_fractions=(0.25, 1.0))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    ds = simulate(
        genome_len=2500, n_reads=30, read_len=(900, 1600), sub_rate=0.01,
        ins_rate=0.005, del_rate=0.005, seed=11,
    )
    fastq = tmp / "reads.fastq"
    ds.write_fastq(str(fastq))
    return tmp, str(fastq), paf_rows(ds, min_overlap=200)


def _jax_fasta(fastq, rows, out):
    from herro_tpu.io.fastx import load_reads
    from herro_tpu.models.checkpoint import load_model
    from herro_tpu.overlaps.paf import parse_paf
    from herro_tpu.pipeline.batching import BucketSpec
    from herro_tpu.pipeline.engine import run_correction
    from herro_tpu.pipeline.infer import CorrectionRunner

    cfg, params = load_model(R10_CKPT)
    runner = CorrectionRunner(dataclasses.replace(cfg, dtype="float32"), params)
    reads = load_reads(fastq, min_length=WINDOW)
    grouped = parse_paf(rows, reads.name_to_id)
    n = run_correction(reads, iter(grouped.items()), runner, out, WINDOW, 4,
                       bucket_spec=BucketSpec(**SPEC))
    return n, open(out, "rb").read()


def _port_fasta(fastq, rows, out, cfg, params):
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.pipeline.batching import BucketSpec
    from herro_tpu_torch.pipeline.engine import run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    runner = CorrectionRunner(cfg, params, device="cpu")
    reads = load_reads(fastq, min_length=WINDOW)
    grouped = parse_paf(rows, reads.name_to_id)
    n = run_correction(reads, iter(grouped.items()), runner, out, WINDOW, 4,
                       bucket_spec=BucketSpec(**SPEC))
    return n, open(out, "rb").read()


def test_fasta_identical_to_jax_float32(dataset):
    from herro_tpu_torch.models.checkpoint import load_model

    tmp, fastq, rows = dataset
    n_ref, ref = _jax_fasta(fastq, rows, str(tmp / "jax.fasta"))
    cfg, params = load_model(R10_CKPT)
    cfg = dataclasses.replace(cfg, dtype="float32")
    n, got = _port_fasta(fastq, rows, str(tmp / "port.fasta"), cfg, params)
    assert n == n_ref > 0
    assert got == ref


def _golden_batch(batching):
    """The frozen golden feature batch as a runner Batch of ``batching``'s
    classes (herro_tpu's or the port's), one window per row."""
    fx = np.load(os.path.join(ROOT, "tests", "golden", "logits_r10.npz"))
    windows = [
        batching.WindowTensors(
            rid=i, wid=0, n_alns=int(fx["n_alns"][i]), n_total_wins=1, tokens=None,
            quals=None, support_flat=fx["support_idx"][i][fx["support_mask"][i]],
            supported=None, tokens_packed=fx["tokens_packed"][i], quals_rm=fx["quals"][i],
        )
        for i in range(fx["n_alns"].shape[0])
    ]
    return batching.Batch(fx["tokens_packed"], fx["quals"], fx["support_idx"],
                          fx["support_mask"], fx["n_alns"], windows)


def test_runner_flags_match_jax():
    """collect_info / collect_counting / counting_only on one batch, port
    against herro_tpu, both float32: same decisions, same counting decode,
    info logits within 2e-4."""
    from herro_tpu.models.checkpoint import load_model as jax_load_model
    from herro_tpu.pipeline import batching as jax_batching
    from herro_tpu.pipeline.infer import CorrectionRunner as JaxRunner
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.pipeline import batching
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    jcfg, jparams = jax_load_model(R10_CKPT)
    cfg, params = load_model(R10_CKPT)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    cfg = dataclasses.replace(cfg, dtype="float32")
    flags = dict(collect_info=True, collect_counting=True)
    want = JaxRunner(jcfg, jparams, **flags).run_batch(_golden_batch(jax_batching))
    got = CorrectionRunner(cfg, params, device="cpu", **flags).run_batch(
        _golden_batch(batching)
    )
    counting_only = CorrectionRunner(cfg, params, device="cpu", counting_only=True)
    only = counting_only.run_batch(_golden_batch(batching))
    assert len(got) == len(want) == len(only) == 4
    for g, w, c in zip(got, want, only):
        np.testing.assert_array_equal(g.decisions, w.decisions)
        np.testing.assert_array_equal(g.counting, w.counting)
        np.testing.assert_allclose(g.info, w.info, atol=2e-4)
        np.testing.assert_array_equal(c.decisions, w.counting)
        assert c.info is None and c.counting is None


def test_cli_read_alns_on_cpu(dataset):
    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.overlaps.batches import BatchWriter

    tmp, fastq, rows = dataset
    aln_dir = str(tmp / "alns")
    targets = sorted({r.split(b"\t")[5] for r in rows})
    with BatchWriter(aln_dir, 0, targets) as bw:
        for r in rows:
            bw.write(r)
    out = str(tmp / "cli.fasta")
    cli.main(["inference", "--device", "cpu", "--read-alns", aln_dir, "-m", "tiny",
              "-w", str(WINDOW), "-b", "4", fastq, out])
    got = open(out, "rb").read()
    assert got.count(b">") > 0

    # the same reads and alignments straight through run_correction, with
    # the default bucket ladder the CLI uses
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.pipeline.engine import run_correction
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    cfg, params = load_or_init("tiny")
    reads = load_reads(fastq, WINDOW)
    grouped = parse_paf(rows, reads.name_to_id)
    direct = str(tmp / "direct.fasta")
    run_correction(reads, iter(grouped.items()),
                   CorrectionRunner(cfg, params, device="cpu"), direct, WINDOW, 4)
    assert got == open(direct, "rb").read()


@pytest.mark.parametrize(
    "flags",
    [["--tp", "2"], ["--devices", "2"], ["--int8"], ["--coordinator", "host:1"],
     ["--num-processes", "2"]],
)
def test_cli_unported_flags_raise(flags, tmp_path, dataset):
    """What the port does not carry raises: ``--num-processes 2`` with no
    coordinator to meet at. The rest of the reference's flags are ported:
    ``inference`` and ``train`` take ``--tp`` and ``--devices``, int8
    included (``inference --int8 --tp 2 --devices 2`` corrects on two CPU
    shards), ``inference`` a ``--coordinator`` that one process ignores, as
    the reference's CLI does, and ``--int8``, which parses on ``inference``
    and ``eval`` and corrects through the CLI on the CPU."""
    from herro_tpu_torch import cli
    from herro_tpu_torch.overlaps.batches import BatchWriter

    parser = cli.build_parser()
    _, fastq, rows = dataset
    aln_dir = str(tmp_path / "alns")
    with BatchWriter(aln_dir, 0, sorted({r.split(b"\t")[5] for r in rows})) as bw:
        for r in rows:
            bw.write(r)

    def corrects(*extra):
        out = tmp_path / "out.fasta"
        cli.main(["inference", "--device", "cpu", "--read-alns", aln_dir, "-m", "tiny",
                  *extra, "-w", str(WINDOW), "-b", "4", fastq, str(out)])
        assert out.read_bytes().count(b">") > 0

    if flags == ["--int8"]:
        for sub, rest in (("inference", ["-m", "tiny", "r.fastq", "o.fasta"]),
                          ("eval", ["tiny"])):
            assert parser.parse_args([sub, *rest]).int8 is None  # follows the config
            assert parser.parse_args([sub, *rest, "--int8"]).int8 is True
            assert parser.parse_args([sub, *rest, "--no-int8"]).int8 is False
        corrects("--int8")
        return
    if flags[0] == "--coordinator":
        assert parser.parse_args(["inference", "-m", "tiny", *flags, "r", "o"]).coordinator \
            == "host:1"
        corrects(*flags)  # one process: no group to join
        return
    if flags[0] == "--num-processes":
        with pytest.raises(SystemExit, match="need a coordinator"):
            corrects(*flags)
        return
    # --tp 2, --devices 2: ported for inference and train, int8 included
    layout = [*flags, "--devices", "2"] if flags[0] == "--tp" else flags
    corrects(*layout, "--int8")
    train_args = parser.parse_args(["train", *layout, "ckpt"])
    assert (train_args.devices, train_args.tp) == ("2", 2 if flags[0] == "--tp" else 1)


def test_port_imports_no_jax():
    import herro_tpu_torch

    names = [  # the Python modules (not the native library next to them)
        m.name for m in pkgutil.walk_packages(herro_tpu_torch.__path__, "herro_tpu_torch.")
        if not m.name.rsplit(".", 1)[-1].startswith("lib")
    ]
    # and every ported tool, tools/*_torch.py, imported by path
    tools = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(ROOT, "tools", "*_torch.py")))
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tools')!r})\n"
        f"for name in {tools!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'msgpack', 'zstandard', 'herro_tpu', 'bench', "
        "'__graft_entry__')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "herro_tpu_torch.cli" in names and "herro_tpu_torch.ops.fused" in names
    for tool in ("eval_battery_torch", "merge_battery_torch", "soup_ckpt_torch",
                 "finetune_sys_torch", "diag_systematic_torch", "profile_e2e_torch",
                 "variant_step_time_torch", "ablate_fused_torch", "demo_record_torch",
                 "micro_kernels_torch"):
        assert tool in tools, tool
    for new in ("utils.edist", "utils.align", "training.labels", "training.eval",
                "features.npy", "pipeline.procpool", "ops.attention", "ops.cuda",
                "training.train", "training.data", "training.distill", "parallel",
                "parallel.mesh", "parallel.tensor"):
        assert f"herro_tpu_torch.{new}" in names
    demo = open(os.path.join(ROOT, "demo", "run_demo_torch.py")).read()
    for mod in ("jax", "flax", "herro_tpu.", "herro_tpu import"):
        assert f"import {mod}" not in demo and f"from {mod}" not in demo


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    for mod in ("jax", "flax", "optax", "herro_tpu.", "herro_tpu import", "msgpack"):
        assert f"import {mod}" not in src and f"from {mod}" not in src


def test_runner_without_card_raises():
    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    if torch.cuda.is_available():
        pytest.skip("a card is present: the runner takes it")
    cfg, params = load_or_init("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CorrectionRunner(cfg, params)
    runner = CorrectionRunner(cfg, params, device="cpu")
    assert runner.device.type == "cpu" and runner.stream is None
