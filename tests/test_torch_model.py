"""The port's model and checkpoint loader held against herro_tpu.

* ``params_from_jax`` carries the JAX parameter tree across (tiny and R10);
* the port's logits equal the JAX logits with both sides in float32: 2e-4
  absolute on logits of order 10 (float32 summation order over d <= 1024
  terms, through three blocks, and two libraries' exp/tanh/rsqrt), with the
  argmax exact;
* the port in bf16 against the frozen JAX golden (tests/golden/logits_r10.npz):
  argmax agreement >= 99.5% at supported columns — the bf16 roundings fall
  in other places in the two frameworks, so the logits themselves differ at
  bf16 noise, and the measured gap is printed;
* the port's own msgpack reader against flax.serialization on every
  checkpoint in resources/.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from herro_tpu.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
from herro_tpu.models.checkpoint import load_model as jax_load_model
from herro_tpu.models.model import R10_CONFIG as JAX_R10
from herro_tpu.models.model import TINY_CONFIG as JAX_TINY
from herro_tpu.models.model import CorrectionModel as JaxModel
from herro_tpu.models.model import init_params
from herro_tpu.pipeline.batching import unpack_tokens_np
from herro_tpu_torch.models.checkpoint import load_model, params_from_jax, read_msgpack_tree
from herro_tpu_torch.models.model import CONFIGS, CorrectionModel, ModelConfig
from herro_tpu_torch.ops.fused import COL_SLOT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R10_CKPT = os.path.join(ROOT, "resources", "model_r10_sim")
GOLDEN = os.path.join(ROOT, "tests", "golden", "logits_r10.npz")
CHECKPOINTS = ["model_r10_sim", "model_r10_deep_sim", "model_r10_sys", "model_r9_sim"]


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name,jcfg", [("tiny", JAX_TINY), ("r10", JAX_R10)])
def test_params_from_jax_layout(name, jcfg):
    tree = _numpy_tree(init_params(jcfg, jax.random.PRNGKey(3)))
    sd = params_from_jax(tree)
    model = CorrectionModel(CONFIGS[name])
    model.load_state_dict(sd, strict=True)  # every key, every shape

    p = tree["params"]
    h, dh = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
    ck = p["col_proj"]["kernel"]  # rows r*13 + v
    np.testing.assert_array_equal(sd["col_proj.w_embT"].numpy()[:, 5 * 12 + 7], ck[5 * 13 + 7])
    np.testing.assert_array_equal(sd["col_proj.w_qT"].numpy()[:, 9], ck[9 * 13 + 12])
    qkv = p["block_1"]["attn"]["qkv"]["kernel"]  # [d, 3, h, dh]
    flat = sd["blocks.1.attn.qkv_kernel"].numpy()
    # k of the last head is column block h + (h-1)
    np.testing.assert_array_equal(
        flat[:, (2 * h - 1) * dh : 2 * h * dh], qkv[:, 1, h - 1]
    )
    out = p["block_0"]["attn"]["out"]["kernel"]  # [h*dh, d]
    np.testing.assert_array_equal(
        sd["blocks.0.attn.out_kernel"].numpy()[h - 1], out[(h - 1) * dh :]
    )


def _golden_inputs():
    fx = np.load(GOLDEN)
    return fx, (
        unpack_tokens_np(fx["tokens_packed"], N_ROWS),
        (QUAL_SCALE * fx["quals"].astype(np.float32) - QUAL_OFFSET).astype(np.float32),
        fx["support_idx"],
        fx["support_mask"],
    )


def _port_forward(cfg, sd, inputs):
    model = CorrectionModel(cfg)
    model.load_state_dict(sd)
    with torch.inference_mode():
        info, logits = model(*(torch.from_numpy(np.ascontiguousarray(a)) for a in inputs))
    return info.numpy(), logits.numpy()


def _jax_forward(jcfg, params, inputs):
    info, logits = JaxModel(jcfg).apply(params, *map(jnp.asarray, inputs))
    return np.asarray(info), np.asarray(logits)


def _assert_logits_match(port, ref, mask):
    (p_info, p_logits), (j_info, j_logits) = port, ref
    assert np.abs(p_logits - j_logits)[mask].max() <= 2e-4
    assert np.abs(p_info - j_info)[mask].max() <= 2e-4
    np.testing.assert_array_equal(
        p_logits.argmax(-1)[mask], j_logits.argmax(-1)[mask]
    )


def test_r10_logits_match_jax_float32():
    _, inputs = _golden_inputs()
    jcfg, params = jax_load_model(R10_CKPT)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    cfg, sd = load_model(R10_CKPT)
    cfg = dataclasses.replace(cfg, dtype="float32")
    _assert_logits_match(
        _port_forward(cfg, sd, inputs), _jax_forward(jcfg, params, inputs), inputs[3]
    )


def test_tiny_logits_match_jax_float32():
    """TINY runs full (unbanded) attention and narrow widths."""
    rng = np.random.default_rng(8)
    B, L, S = 2, 96, 16
    tok = rng.integers(0, 11, size=(B, N_ROWS, L)).astype(np.uint8)
    tok[1, :, 70:] = 11
    quals = rng.uniform(-1, 1, size=(B, N_ROWS, L)).astype(np.float32)
    sidx = np.sort(rng.integers(0, 70, size=(B, S)), axis=1).astype(np.int32)
    smask = np.ones((B, S), bool)
    smask[0, 12:] = False
    inputs = (tok, quals, sidx, smask)
    params = init_params(JAX_TINY, jax.random.PRNGKey(5))
    sd = params_from_jax(_numpy_tree(params))
    _assert_logits_match(
        _port_forward(CONFIGS["tiny"], sd, inputs),
        _jax_forward(JAX_TINY, params, inputs),
        smask,
    )


def test_r10_bf16_matches_golden_argmax():
    fx, inputs = _golden_inputs()
    cfg, sd = load_model(R10_CKPT)
    assert cfg.dtype == "bfloat16"
    info, logits = _port_forward(cfg, sd, inputs)
    mask = fx["support_mask"]
    d_log = np.abs(logits - fx["logits"])[mask].max()
    d_info = np.abs(info - fx["info"])[mask].max()
    agree = (logits.argmax(-1) == fx["logits"].argmax(-1))[mask].mean()
    print(f"bf16 vs golden: max |dlogit| {d_log:.3e}, max |dinfo| {d_info:.3e}, "
          f"argmax agreement {agree:.4f} over {mask.sum()} columns")
    assert np.isfinite(logits).all() and np.isfinite(info).all()
    assert agree >= 0.995


def test_compute_weights_built_once_per_parameter_state():
    """The ops' weights and the col_proj table are built once, reused across
    forwards, and rebuilt when the parameters change in place."""
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype="bfloat16")
    model = CorrectionModel(cfg, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        w = model.compute_weights()
        assert model.compute_weights() is w
        # one slot of COL_SLOT rows per pileup row: 12 one-hot rows, the
        # qual row, zeros; zero rows up to a multiple of 64
        slot = COL_SLOT
        assert w["wc"].dtype == torch.bfloat16 and w["wc"].shape[0] % 64 == 0
        cp = model.col_proj
        tab = w["wc"][: N_ROWS * slot].view(N_ROWS, slot, -1)
        assert torch.equal(tab[4, 7], cp.w_embT[:, 4 * 12 + 7].to(torch.bfloat16))
        assert torch.equal(tab[4, 12], cp.w_qT[:, 4].to(torch.bfloat16))
        assert not tab[:, 13:].any()
        assert not w["wc"][N_ROWS * slot :].any()
    sd = {k: v + 1 for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    with torch.inference_mode():
        w2 = model.compute_weights()
    assert w2 is not w
    assert torch.equal(w2["blocks"][1]["w1"], sd["blocks.1.ff1.kernel"].to(torch.bfloat16))


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_msgpack_reader_matches_flax(name):
    with open(os.path.join(ROOT, "resources", name, "params.msgpack"), "rb") as fh:
        data = fh.read()
    mine = read_msgpack_tree(data)
    ref = serialization.msgpack_restore(data)
    mine_leaves = jax.tree_util.tree_flatten_with_path(mine)[0]
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in mine_leaves] == [p for p, _ in ref_leaves]
    for (_, a), (_, b) in zip(mine_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    cfg, sd = load_model(os.path.join(ROOT, "resources", name))
    CorrectionModel(cfg).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_or_init_named_configs(name):
    from herro_tpu_torch.models.checkpoint import load_or_init

    cfg, sd = load_or_init(name, rng_seed=1)
    assert cfg == CONFIGS[name]
    again = load_or_init(name, rng_seed=1)[1]
    assert all(torch.equal(sd[k], again[k]) for k in sd)  # seeded
    CorrectionModel(cfg).load_state_dict(sd, strict=True)
