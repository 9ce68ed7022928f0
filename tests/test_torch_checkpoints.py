"""The three other shipped checkpoints through the port against herro_tpu,
in float32: ``resources/model_r10_deep_sim`` (d 256, 8 layers, H 2 x 128),
``model_r10_sys`` (the flagship's widths, other weights) and
``model_r9_sim`` (d 256, 8 layers, d_ff 1536), as
``tests/test_torch_model.py`` holds ``model_r10_sim``: max |dlogit| and
|dinfo| within 2e-4 over the supported columns and every class equal, on
the inputs of ``tests/torch_data/golden_tiny_f32.npz`` (B 4, L 1024: a
small L, as the CPU runs herro_tpu's jnp twins). Then
``golden_r10deep_f32.npz`` (``tests/torch_data/make_float32_golden.py``,
the float32 logits the card's bf16 ``model_r10_deep_sim`` forward is held to)
against herro_tpu rebuilding it.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "torch_data")


def _inputs():
    """The batch of ``golden_tiny_f32.npz`` (B 4, L 1024, 417 supported
    columns), as the model takes them."""
    spec = importlib.util.spec_from_file_location(
        "make_widths_golden", os.path.join(DATA, "make_widths_golden.py"))
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    return mk.inputs()


@pytest.mark.parametrize("name", ["model_r10_deep_sim", "model_r10_sys", "model_r9_sim"])
def test_shipped_checkpoint_float32_logits_match_herro_tpu(name):
    """herro_tpu's side takes the checkpoint's tree as the port's msgpack
    reader gives it (held equal to flax's on every shipped checkpoint by
    ``tests/test_torch_model.py``), which spares its ``init_params``
    template."""
    import json

    import jax.numpy as jnp

    from herro_tpu.models.model import CorrectionModel as JaxModel
    from herro_tpu.models.model import ModelConfig as JaxConfig

    from herro_tpu_torch.models.checkpoint import load_model, read_msgpack_tree
    from herro_tpu_torch.models.model import CorrectionModel

    ckpt = os.path.join(ROOT, "resources", name)
    inputs = _inputs()
    mask = inputs[3]
    assert mask.sum() > 400
    with open(os.path.join(ckpt, "config.json")) as fh:
        jcfg = JaxConfig(**json.load(fh))
    with open(os.path.join(ckpt, "params.msgpack"), "rb") as fh:
        params = read_msgpack_tree(fh.read())
    j_info, j_logits = (np.asarray(a) for a in JaxModel(
        dataclasses.replace(jcfg, dtype="float32")).apply(params, *map(jnp.asarray, inputs)))
    cfg, sd = load_model(ckpt)
    model = CorrectionModel(dataclasses.replace(cfg, dtype="float32"))
    model.load_state_dict(sd)
    with torch.inference_mode():
        p_info, p_logits = (a.numpy() for a in model(*map(torch.from_numpy, inputs)))
    assert np.abs(p_logits - j_logits)[mask].max() <= 2e-4
    assert np.abs(p_info - j_info)[mask].max() <= 2e-4
    np.testing.assert_array_equal(p_logits.argmax(-1)[mask], j_logits.argmax(-1)[mask])


def test_r10deep_float32_golden_rebuilds_from_herro_tpu():
    spec = importlib.util.spec_from_file_location(
        "make_float32_golden", os.path.join(DATA, "make_float32_golden.py"))
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    frozen = np.load(mk.R10DEEP_GOLDEN)
    got = mk.build_r10deep()
    for key in ("info", "logits"):
        np.testing.assert_allclose(got[key], frozen[key], atol=1e-5, rtol=0)
