"""The port's distillation: features dump -> teacher labels -> student
training, as ``tests/test_distill.py`` holds herro_tpu's, on the CPU.

* ``windows_from_dump`` reads the port's ``features`` tree;
* ``teacher_label_windows`` labels every dumped window, and its labels and
  info flags equal herro_tpu's label for label on the same dump with the same
  float32 parameters;
* a student trained through ``distill --device cpu`` agrees with the teacher
  far better than an untrained copy does, and its checkpoint loads in
  herro_tpu as well as in the port.

Every test runs under a time limit of its own (``SIGALRM``).
"""

import functools
import signal

import numpy as np
import pytest
import torch

from herro_tpu_torch.cli import main as cli_main
from herro_tpu_torch.models.checkpoint import load_model, load_or_init, save_model
from herro_tpu_torch.overlaps.batches import BatchWriter
from herro_tpu_torch.training.distill import teacher_label_windows, windows_from_dump
from herro_tpu_torch.training.simulate import paf_rows, simulate

WINDOW = 512


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small models' many small ops: under
    pytest-xdist, six workers' thread pools on a few cores slow them tenfold
    and more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_distill")
    ds = simulate(
        genome_len=4000, n_reads=22, read_len=(1200, 1900), sub_rate=0.03,
        ins_rate=0.015, del_rate=0.015, seed=13,
    )
    fastq = tmp / "reads.fastq"
    ds.write_fastq(str(fastq))
    alns = tmp / "alns"
    alns.mkdir()
    with BatchWriter(str(alns), 0, [r.name for r in ds.reads]) as w:
        for line in paf_rows(ds, min_overlap=300):
            w.write(line)
    out = tmp / "feats"
    cli_main(["features", "--read-alns", str(alns), "-w", str(WINDOW), str(fastq), str(out)])
    return tmp, str(out)


def _teacher(seed: int = 3):
    """TINY (float32) weights from a seeded generator."""
    return load_or_init("tiny", rng_seed=seed)


@time_limit(60)
def test_windows_from_dump(dump):
    _, feats_dir = dump
    dumped = windows_from_dump(feats_dir)
    assert len(dumped) > 10
    bases, quals, supported = dumped[0]
    assert bases.shape == quals.shape and bases.shape[1] == 31
    assert supported.dtype.names == ("pos", "ins")


@time_limit(120)
def test_teacher_labelling_matches_direct_forward(dump):
    _, feats_dir = dump
    dumped = [d for d in windows_from_dump(feats_dir) if len(d[2])][:6]
    cfg, params = _teacher()
    labelled = teacher_label_windows(cfg, params, dumped, batch_size=2, device="cpu")
    assert len(labelled) == len(dumped)
    for lw in labelled:
        assert lw.labels.shape == lw.support_flat.shape
        assert lw.labels.max(initial=0) <= 4


@time_limit(180)
def test_teacher_labels_equal_reference(dump):
    """The same dump and the same float32 TINY parameters (herro_tpu's
    init_params through params_from_jax) give the same labels and info flags
    from either package's teacher_label_windows."""
    import jax

    from herro_tpu.models.model import TINY_CONFIG, init_params
    from herro_tpu.training.distill import teacher_label_windows as jax_teacher
    from herro_tpu.training.distill import windows_from_dump as jax_windows
    from herro_tpu_torch.models.checkpoint import params_from_jax
    from herro_tpu_torch.models.model import TINY_CONFIG as PORT_TINY

    _, feats_dir = dump
    dumped = windows_from_dump(feats_dir)
    ref_dumped = jax_windows(feats_dir)
    assert len(dumped) == len(ref_dumped)
    jparams = init_params(TINY_CONFIG, jax.random.PRNGKey(3))
    want = jax_teacher(TINY_CONFIG, jparams, ref_dumped, batch_size=4)
    got = teacher_label_windows(
        PORT_TINY, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)), dumped,
        batch_size=4, device="cpu",
    )
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        for field in ("tokens", "quals", "support_flat", "labels", "info"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field


@time_limit(300)
def test_distill_cli_student_agrees_with_teacher(dump, tmp_path):
    from herro_tpu.models.checkpoint import load_model as jax_load_model

    tmp, feats_dir = dump
    teacher_dir = str(tmp / "teacher")
    cfg, tparams = _teacher()
    save_model(teacher_dir, cfg, tparams)

    student_dir = str(tmp_path / "student")
    cli_main(
        ["distill", feats_dir, student_dir, "--teacher", teacher_dir,
         "--student", "tiny", "--steps", "60", "--batch-size", "4",
         "--max-len", "1024", "--max-sup", "128", "--lr", "3e-3", "--device", "cpu"]
    )

    # agreement of student vs teacher on the dumped windows
    scfg, sparams = load_model(student_dir)
    jcfg, _ = jax_load_model(student_dir)  # herro_tpu reads the student too
    assert jcfg.d_model == scfg.d_model
    dumped = [d for d in windows_from_dump(feats_dir) if len(d[2])]
    label = lambda c, p: teacher_label_windows(c, p, dumped, batch_size=4, device="cpu")
    t_lab, s_lab = label(cfg, tparams), label(scfg, sparams)
    agree = np.concatenate([(a.labels == b.labels) for a, b in zip(t_lab, s_lab)]).mean()

    f_lab = label(*_teacher(99))
    base = np.concatenate([(a.labels == b.labels) for a, b in zip(t_lab, f_lab)]).mean()

    assert agree > base + 0.05, (agree, base)
    assert agree > 0.8, agree
