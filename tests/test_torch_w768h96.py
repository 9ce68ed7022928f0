"""The ``w768h96`` model (d 768, 8 heads of 96, d_ff 3072, 3 layers, band
512) through the port, against herro_tpu on the CPU.

* Its seeded parameters (``tests/torch_data/w768h96.py``) have herro_tpu's
  tree, its biases and LayerNorm scales, and its initialisers' spread.
* Its checkpoint directory, as the port writes it, loads in herro_tpu's
  ``load_model`` (the tree bit for bit) and in the port's ``load_model`` and
  ``load_or_init``.
* The port's float32 forward against herro_tpu's within 2e-4 and every
  class (``tests/test_torch_model.py``'s bar), at B 4, L 1024.
* ``golden_w768h96.npz`` against herro_tpu rebuilding it
  (``make_widths_golden.py``): the parameters' digest, the float32 and bf16
  logits, and the port's bf16 CPU gap it records, recomputed.

The kernels at these widths: ``tests/test_torch_widths.py``; on the card:
``chip_smoke.py``'s ``widths`` phase.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_data")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(DATA, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_init():
    """herro_tpu's ``init_params`` at w768h96's config (flax's initialisers;
    about 15 s, made once)."""
    import jax

    from herro_tpu.models.model import ModelConfig, init_params

    return init_params(ModelConfig(**_load("w768h96").CONFIG), jax.random.PRNGKey(0))


def test_w768h96_recipe_has_herro_tpu_tree_and_scales(jax_init):
    """Every leaf's path and shape are ``init_params``'s, the biases and
    LayerNorm scales its values, each kernel's spread its initialiser's
    within 3% (the smallest, info_head's 768 values, within 10%)."""
    import jax

    w = _load("w768h96")
    mine = w.leaves()
    theirs = {tuple(p.key for p in path)[1:]: np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_leaves_with_path(jax_init)}
    assert sorted(mine) == sorted(theirs) == sorted(w.shapes())
    for path, leaf in theirs.items():
        assert mine[path].shape == leaf.shape and mine[path].dtype == np.float32
        if path[-1] != "kernel":
            np.testing.assert_array_equal(mine[path], leaf)
        else:
            bar = 0.03 if leaf.size >= 10_000 else 0.1
            assert abs(mine[path].std() / leaf.std() - 1) < bar, path
            assert np.abs(mine[path]).max() <= 2 * leaf.std() / 0.87 * 1.05, path
    assert sum(v.size for v in mine.values()) == 21_580_038


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _load("w768h96").write_checkpoint(str(tmp_path_factory.mktemp("w768h96")))


def test_w768h96_checkpoint_loads_in_both_packages(ckpt, jax_init, monkeypatch):
    """The config.json and params.msgpack the port writes: herro_tpu's
    ``load_model`` (its template the init above, which it would build
    itself) reads the seeded tree back bit for bit; the port's
    ``load_model`` and ``load_or_init`` give the same state dict, and its
    model takes it at these widths."""
    from herro_tpu.models import checkpoint as jax_ckpt

    from herro_tpu_torch.models.checkpoint import load_model, load_or_init, params_from_jax
    from herro_tpu_torch.models.model import CorrectionModel

    w = _load("w768h96")
    monkeypatch.setattr(jax_ckpt, "init_params", lambda cfg, rng: jax_init)
    jcfg, tree = jax_ckpt.load_model(ckpt)
    assert dataclasses.asdict(jcfg) == w.CONFIG
    assert w.digest(tree) == w.digest(w.params())
    want = params_from_jax(w.params())
    for loaded in (load_model(ckpt), load_or_init(ckpt)):
        cfg, sd = loaded
        assert dataclasses.asdict(cfg) == w.CONFIG
        assert sorted(sd) == sorted(want) and all(torch.equal(sd[k], want[k]) for k in want)
    model = CorrectionModel(cfg)
    model.load_state_dict(sd)
    assert (model.cfg.d_model // model.cfg.n_heads, model.cfg.d_ff) == (96, 3072)


@pytest.fixture(scope="module")
def rebuilt():
    """herro_tpu's w768h96 forwards, float32 and bf16, built anew."""
    return _load("make_widths_golden").build()


def test_w768h96_float32_forward_matches_herro_tpu(rebuilt):
    gap = _load("make_widths_golden").port_gap(rebuilt, "float32")
    assert gap["n"] > 400 and gap["finite"] and gap["launches"] == {}
    assert gap["max_dlogit"] <= 2e-4 and gap["max_dinfo"] <= 2e-4
    assert gap["flipped"] == 0


def test_w768h96_golden_rebuilds_from_herro_tpu(rebuilt):
    """The file holds what herro_tpu computes (float32 within float32 noise
    of one XLA build against another, bf16 within 2^-6), for the parameters
    whose digest it names; the port's bf16 CPU gap it records is the port's
    gap today."""
    mk = _load("make_widths_golden")
    frozen = np.load(mk.GOLDEN)
    assert str(frozen["params_sha256"]) == str(rebuilt["params_sha256"])
    for key in ("info_f32", "logits_f32"):
        np.testing.assert_allclose(rebuilt[key], frozen[key], atol=1e-5, rtol=0)
    for key in ("info_bf16", "logits_bf16"):
        np.testing.assert_allclose(rebuilt[key], frozen[key], atol=2 ** -6, rtol=0)
    gap = mk.port_gap(frozen)
    assert gap["max_dlogit"] == pytest.approx(float(frozen["cpu_max_dlogit"]), abs=1e-6)
    assert gap["max_dinfo"] == pytest.approx(float(frozen["cpu_max_dinfo"]), abs=1e-6)
    assert gap["flipped"] == int(frozen["cpu_flipped"])
