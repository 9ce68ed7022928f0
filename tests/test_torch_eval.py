"""The port's ``evaluate`` and its helpers held against herro_tpu's.

Both packages evaluate the same small simulation (same seed, so the same
reads, PAF and truth) with the same weights (``params_from_jax`` carries the
JAX tree across) in float32 on the CPU: every field of ``EvalResult.as_dict``
must agree, counts exactly and ratios within 1e-9 (both sides divide the same
integers; the corrected FASTA is byte-identical in float32, as
tests/test_torch_e2e.py holds). ``align_to_truth``, ``qscore``, the edit
distances and ``read_labels`` are pure numpy (or the native library) on both
sides and must be equal on random inputs.
"""

import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest

from herro_tpu.models import model as jmodel
from herro_tpu.pipeline.batching import BucketSpec as JaxBucketSpec
from herro_tpu.training import eval as jeval
from herro_tpu_torch.models.checkpoint import params_from_jax
from herro_tpu_torch.models.model import ModelConfig
from herro_tpu_torch.pipeline.batching import BucketSpec
from herro_tpu_torch.training import eval as teval

WINDOW = 256
SPEC = dict(lengths=(320, 512, 1024), sup_fractions=(0.25, 1.0))
SIM = dict(window_size=WINDOW, genome_len=2500, n_reads=24, het_rate=0.01,
           seed=4321, batch_size=4)

# tiny (full attention) and a narrow banded stack, both float32
JAX_CONFIGS = {
    "tiny": jmodel.TINY_CONFIG,
    "banded": dataclasses.replace(jmodel.TINY_CONFIG, local_window=24, n_layers=1),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(JAX_CONFIGS))
def models(request):
    jcfg = JAX_CONFIGS[request.param]
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(7))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, cfg, params_from_jax(_numpy_tree(jparams))


def _assert_same(got, want, path="result"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-9, rel=0), path
    else:
        assert got == want, path


def _both(models, **kw):
    jcfg, jparams, cfg, params = models
    want = jeval.evaluate(jcfg, jparams, bucket_spec=JaxBucketSpec(**SPEC), **SIM, **kw)
    got = teval.evaluate(cfg, params, bucket_spec=BucketSpec(**SPEC), device="cpu",
                         **SIM, **kw)
    return got, want


def test_evaluate_model_mode_with_baseline(models):
    got, want = _both(models, with_baseline=True)
    assert got.mode == want.mode == "model"
    assert want.n_reads > 0 and want.counting is not None
    _assert_same(got.as_dict(), want.as_dict())
    assert got.model_gain_db == pytest.approx(want.model_gain_db, abs=1e-9)
    for prop in ("n_reads", "raw_q", "corrected_q", "corrected_identity",
                 "raw_identity", "corrected_infix_q", "corrected_infix_identity"):
        assert getattr(got, prop) == pytest.approx(getattr(want, prop), abs=1e-9)


def test_evaluate_model_mode_shuffled_quals(models):
    got, want = _both(models, shuffle_quals=True)
    _assert_same(got.as_dict(), want.as_dict())


@pytest.mark.parametrize("mode", ["counting", "oracle"])
def test_evaluate_modes_without_model(mode, models):
    got, want = _both(models, mode=mode)
    assert got.mode == want.mode == mode
    _assert_same(got.as_dict(), want.as_dict())


def test_evaluate_counting_only_flag(models):
    got, want = _both(models, counting_only=True)
    assert got.mode == "counting"
    _assert_same(got.as_dict(), want.as_dict())


def test_evaluate_profile_and_sim_profiles_equal(models):
    assert teval.SIM_PROFILES == jeval.SIM_PROFILES
    got, want = _both(models, mode="counting",
                      sim_extra=teval.SIM_PROFILES["systematic"])
    _assert_same(got.as_dict(), want.as_dict())


def test_evaluate_int8_raises(models):
    """``int8=True`` no longer raises: the port's int8 evaluation equals
    herro_tpu's in float32, and is not the float evaluation relabelled (the
    int8 runner's weights are quantized)."""
    got, want = _both(models, int8=True, with_baseline=True)
    assert got.mode == want.mode == "model" and want.n_reads > 0
    _assert_same(got.as_dict(), want.as_dict())
    assert got.model_gain_db == pytest.approx(want.model_gain_db, abs=1e-9)


def test_evaluate_without_card_raises(models):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: evaluate takes it")
    _, _, cfg, params = models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.evaluate(cfg, params, **SIM)


def test_cli_eval_prints_evaluate_json():
    """``eval`` on the CPU prints one JSON document: what ``evaluate``
    returns for the same arguments."""
    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_or_init

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval", "tiny", "--device", "cpu", "-w", str(WINDOW), "-b", "4",
                  "--genome-len", "2500", "--n-reads", "24", "--seed", "4321",
                  "--with-baseline"])
    printed = json.loads(buf.getvalue())
    cfg, params = load_or_init("tiny")
    want = teval.evaluate(cfg, params, window_size=WINDOW, genome_len=2500, n_reads=24,
                          het_rate=0.005, seed=4321, batch_size=4, with_baseline=True,
                          device="cpu")
    _assert_same(printed, json.loads(json.dumps(want.as_dict())))
    assert printed["mode"] == "model" and "counting_baseline" in printed


# ---------------------------------------------------------------------------
# the numpy helpers
# ---------------------------------------------------------------------------


def _mutate(rng, seq, rate):
    out = []
    for c in seq:
        u = rng.random()
        if u < rate:
            out.append(rng.choice(list(b"ACGT")))
        elif u < 2 * rate:
            continue
        elif u < 3 * rate:
            out.extend([c, rng.choice(list(b"ACGT"))])
        else:
            out.append(c)
    return bytes(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_to_truth_equal(seed):
    from herro_tpu.utils.align import align_to_truth as jalign
    from herro_tpu_torch.utils.align import align_to_truth as talign

    rng = np.random.default_rng(seed)
    truth = bytes(rng.choice(list(b"ACGT"), size=1500).tolist())
    lo = int(rng.integers(0, 200))
    frag = _mutate(rng, truth[lo : lo + 1100], 0.01 * (seed + 1))
    want, got = jalign(frag, truth), talign(frag, truth)
    assert want is not None and got is not None
    for f in ("distance", "j0", "j1", "matches", "subs", "ins", "dels", "span_len"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.b2a, want.b2a)
    np.testing.assert_array_equal(got.ins_after, want.ins_after)
    assert talign(b"", truth) is None and talign(b"ACGT" * 10, b"T" * 50) is None


def test_fit_align_numpy_twin_equal():
    from herro_tpu.utils.align import _fit_align_np as jfit
    from herro_tpu_torch.utils.align import _fit_align_np as tfit

    rng = np.random.default_rng(5)
    truth = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=300)
    frag = np.frombuffer(_mutate(rng, truth[40:260].tobytes(), 0.03), dtype=np.uint8)
    want, got = jfit(frag, truth, 40, 32), tfit(frag, truth, 40, 32)
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[4], want[4])


def test_edit_distances_and_qscore_equal():
    from herro_tpu.utils import edist as jed
    from herro_tpu_torch.utils import edist as ted

    rng = np.random.default_rng(6)
    for _ in range(4):
        a = bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(80, 200))).tolist())
        b = _mutate(rng, a, 0.05)
        assert ted.banded_edit_distance(a, b) == jed.banded_edit_distance(a, b)
        assert ted.fitting_edit_distance(b[10:60], a) == jed.fitting_edit_distance(b[10:60], a)
        assert ted.identity(b, a) == jed.identity(b, a)
        assert ted.infix_identity(b[10:60], a) == jed.infix_identity(b[10:60], a)
    for ident in (0.0, 0.5, 0.9, 0.999, 0.999999, 1.0):
        assert ted.qscore(ident) == jed.qscore(ident)


def test_read_labels_equal(tmp_path):
    """Same simulation, each package's own featgen and labels."""
    import importlib

    import herro_tpu.features.extract as jext
    import herro_tpu.io.fastx as jfx
    import herro_tpu.overlaps.paf as jpaf
    import herro_tpu.training.labels as jlab
    import herro_tpu_torch.features.extract as text
    import herro_tpu_torch.io.fastx as tfx
    import herro_tpu_torch.overlaps.paf as tpaf
    import herro_tpu_torch.training.labels as tlab

    # the packages re-export simulate(), which shadows the module attribute
    jsim = importlib.import_module("herro_tpu.training.simulate")
    tsim = importlib.import_module("herro_tpu_torch.training.simulate")

    def labels(sim, fx, paf, ext, lab, name):
        ds = sim.simulate(genome_len=2500, n_reads=20, read_len=(800, 1500),
                          het_rate=0.01, seed=99)
        fastq = str(tmp_path / f"{name}.fastq")
        ds.write_fastq(fastq)
        reads = fx.load_reads(fastq, min_length=WINDOW)
        grouped = paf.parse_paf(sim.paf_rows(ds, min_overlap=WINDOW), reads.name_to_id)
        by_name = {r.name: r for r in ds.reads}
        out = []
        for rid, alns in list(grouped.items())[:6]:
            feats = ext.extract_read_features(rid, reads, alns, WINDOW)
            out.append(lab.read_labels(ds, by_name[reads.ids[rid]], feats, WINDOW))
        return out

    want = labels(jsim, jfx, jpaf, jext, jlab, "jax")
    got = labels(tsim, tfx, tpaf, text, tlab, "port")
    assert len(got) == len(want) > 0
    n = 0
    for g_read, w_read in zip(got, want):
        assert len(g_read) == len(w_read)
        for (g_cls, g_info), (w_cls, w_info) in zip(g_read, w_read):
            np.testing.assert_array_equal(g_cls, w_cls)
            np.testing.assert_array_equal(g_info, w_info)
            n += len(w_cls)
    assert n > 0
