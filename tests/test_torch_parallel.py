"""The port's multi-device inference held against herro_tpu's
(tests/test_parallel.py, one case per reference test), on CPU replicas:

* the port's tensor-parallel model (tp=2 over two CPU shards, float32, d 32,
  2 heads, d_ff 64) against herro_tpu's single-device step on the same
  numpy-seeded batch and weights, at the reference's 5e-4;
* the port's runner over a 4 x 2 (data, model) mesh of CPU devices against
  herro_tpu's TP fast path over ``make_mesh_2d(4, 2)``;
* the trained flagship in bf16 at tp=2 (B=4, L=192) against herro_tpu's
  ``CorrectionRunner(mesh=make_mesh_2d(2, 2))``: the classes agree on more
  than 0.99 of the supported columns, the decisions are equal;
* ``shard_weights``: the Megatron layout, and the shards put back together
  give the whole weights;
* data parallelism over two CPU replicas equals one device; the runner
  and the CLI refuse a batch the data axis does not divide, and run
  ``--int8`` with tp > 1 (held against herro_tpu in
  ``tests/test_torch_int8_parallel.py``). (The reference's TP train step has no counterpart: ``train``
  runs on one device.)
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from herro_tpu.models.model import ModelConfig as JaxConfig
from herro_tpu.models.model import init_params
from herro_tpu.parallel.tensor import make_mesh_2d as jax_mesh_2d
from herro_tpu.pipeline.infer import CorrectionRunner as JaxRunner
from herro_tpu.pipeline.infer import make_correct_step as jax_correct_step
from herro_tpu_torch.models.checkpoint import load_model, params_from_jax
from herro_tpu_torch.models.model import CorrectionModel, ModelConfig
from herro_tpu_torch.parallel import (
    Mesh,
    TensorParallelModel,
    all_reduce,
    make_mesh,
    make_mesh_2d,
    make_tp_correct_step,
    shard_weights,
)
from herro_tpu_torch.parallel.tensor import block_params
from herro_tpu_torch.pipeline.batching import Batch
from herro_tpu_torch.pipeline.infer import CorrectionRunner

from __graft_entry__ import _example_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R10_CKPT = os.path.join(ROOT, "resources", "model_r10_sim")
# 2 heads / d_ff 64 divide tp=2; float32 so tolerances are meaningful
JCFG = JaxConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64, base_embed_dim=4,
                 dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(JCFG))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    params = init_params(JCFG, jax.random.PRNGKey(7))
    batch = _example_batch(B=8, L=128, S=16, seed=5)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return params, sd, batch


def _jax_run(step, params, batch):
    info, classes, dec = step(params, *batch)
    return np.asarray(info), np.asarray(classes), np.asarray(dec)


def _jax_packed(runner, batch):
    info, packed = runner._step(runner.params, *batch)
    packed = np.asarray(packed)
    S = batch[2].shape[1]
    return np.asarray(info), packed[:, -S:], packed[:, :-S]


def _port_packed(runner, batch):
    """The runner's step on one batch: (info, classes, decisions), the parts
    of every data replica joined."""
    info, packed = runner._fetch(runner.dispatch(Batch(*batch, windows=[])))
    S = batch[2].shape[1]
    return info, packed[:, -S:], packed[:, :-S]


def _port_step(step, batch):
    with torch.inference_mode():
        info, packed = step(*(torch.from_numpy(a) for a in batch))
    S = batch[2].shape[1]
    return info.numpy(), packed[:, -S:].numpy(), packed[:, :-S].numpy()


def test_tp_matches_single_device(setup):
    params, sd, batch = setup
    base = _jax_run(jax.jit(jax_correct_step(JCFG)), params, batch)
    model = TensorParallelModel(CFG, sd, [CPU, CPU])
    tp = _port_step(make_tp_correct_step(model), batch)

    np.testing.assert_allclose(tp[0], base[0], rtol=5e-4, atol=5e-4)
    assert (tp[1] == base[1]).mean() > 0.999
    np.testing.assert_array_equal(tp[2], base[2])


def test_tp_fast_path_matches_single_device(setup):
    """The port's runner over a 4 x 2 mesh against herro_tpu's TP fast path
    over its 4 x 2 mesh of virtual CPU devices."""
    params, sd, batch = setup
    ref = JaxRunner(JCFG, params, mesh=jax_mesh_2d(4, 2), collect_info=True)
    assert ref.tp_fast_path
    base = _jax_packed(ref, batch)

    runner = CorrectionRunner(CFG, sd, device="cpu", collect_info=True,
                              mesh=make_mesh_2d(4, 2, [CPU] * 8))
    assert runner.tp_fast_path and runner.mesh.shape == {"data": 4, "model": 2}
    tp = _port_packed(runner, batch)

    np.testing.assert_allclose(tp[0], base[0], rtol=5e-4, atol=5e-4)
    assert (tp[1] == base[1]).mean() > 0.999
    np.testing.assert_array_equal(tp[2], base[2])


def test_tp_fast_path_production_widths():
    """The trained flagship in bf16 at tp=2 (heads 4 -> 2, d_ff 1024 -> 512 a
    shard), as a real ``--tp 2`` run shards it, against herro_tpu's TP fast
    path: bf16 and other reduction orders, so classes, not logits."""
    from herro_tpu.models.checkpoint import load_or_init

    jcfg, jparams = load_or_init(R10_CKPT)
    batch = _example_batch(B=4, L=192, S=24, seed=11)
    ref = JaxRunner(jcfg, jparams, mesh=jax_mesh_2d(2, 2))
    assert ref.tp_fast_path
    base = _jax_packed(ref, batch)

    cfg, sd = load_model(R10_CKPT)
    assert cfg.dtype == "bfloat16"
    runner = CorrectionRunner(cfg, sd, device="cpu", mesh=make_mesh_2d(2, 2, [CPU] * 4))
    assert runner.tp_fast_path
    tp = _port_packed(runner, batch)

    assert (tp[1] == base[1]).mean() > 0.99
    np.testing.assert_array_equal(tp[2], base[2])


def test_shard_weights_layout(setup):
    """Shard j holds heads j*h_loc.. of q, k and v, the same heads of the out
    projection, its d_ff columns of ff1 and rows of ff2, and 1/tp of the
    row-parallel biases; the shards put back together are the weights."""
    _, sd, _ = setup
    model = CorrectionModel(CFG)
    model.load_state_dict(sd)
    w = block_params(model.blocks[1])
    H, D, d = w["wo"].shape
    f = w["w1"].shape[1]
    tp = 2
    shards = [shard_weights(w, tp, j) for j in range(tp)]
    qkv = w["w_qkv"].reshape(d, 3, H, D)
    for j, s in enumerate(shards):
        assert s["w_qkv"].shape == (d, 3 * (H // tp) * D) and s["w_qkv"].is_contiguous()
        # k (part 1) of this shard's only head is its column block 1
        assert torch.equal(s["w_qkv"][:, D:2 * D], qkv[:, 1, j])
        assert torch.equal(s["wo"], w["wo"][j:j + 1])
        assert s["w1"].shape == (d, f // tp) and s["w2"].shape == (f // tp, d)
        assert torch.equal(s["bo"] * tp, w["bo"]) and torch.equal(s["b2"] * tp, w["b2"])

    cat = torch.cat
    assert torch.equal(
        cat([s["w_qkv"].reshape(d, 3, H // tp, D) for s in shards], dim=2).reshape(d, -1),
        w["w_qkv"])
    assert torch.equal(
        cat([s["b_qkv"].reshape(3, H // tp, D) for s in shards], dim=1).reshape(-1),
        w["b_qkv"])
    assert torch.equal(cat([s["wo"] for s in shards]), w["wo"])
    assert torch.equal(cat([s["w1"] for s in shards], dim=1), w["w1"])
    assert torch.equal(cat([s["b1"] for s in shards]), w["b1"])
    assert torch.equal(cat([s["w2"] for s in shards]), w["w2"])
    assert torch.equal(sum(s["bo"] for s in shards), w["bo"])

    # the reference's divisibility assertions (herro_tpu/parallel/tensor.py:60-66)
    with pytest.raises(ValueError, match="n_heads 2 is not divisible by tp=4"):
        shard_weights(w, 4, 0)
    w3 = dict(w, w1=w["w1"][:, :63])
    with pytest.raises(ValueError, match="d_ff 63 is not divisible by tp=2"):
        shard_weights(w3, 2, 0)


def test_all_reduce_sums_in_shard_order():
    """One float32 sum in shard order, rounded once, shared by every shard."""
    g = torch.Generator().manual_seed(3)
    parts = [torch.randn(4, 64, generator=g).to(torch.bfloat16) for _ in range(4)]
    out = all_reduce(parts)
    want = (((parts[0].float() + parts[1].float()) + parts[2].float())
            + parts[3].float()).to(torch.bfloat16)
    assert all(o is out[0] for o in out) and torch.equal(out[0], want)
    assert all_reduce(parts[:1])[0] is parts[0]
    f32 = [p.float() for p in parts[:2]]
    kept = f32[0].clone()
    assert torch.equal(all_reduce(f32)[0], kept + f32[1]) and torch.equal(f32[0], kept)


def test_dp_matches_single_device(setup):
    """Data parallelism over two CPU replicas: each takes half the batch,
    and the joined result is the single device's, bit for bit."""
    _, sd, batch = setup
    one = CorrectionRunner(CFG, sd, device="cpu", collect_info=True)
    dp = CorrectionRunner(CFG, sd, device="cpu", collect_info=True,
                          mesh=make_mesh([CPU, CPU]))
    assert not dp.tp_fast_path and len(dp.replicas) == 2
    for a, b in zip(_port_packed(one, batch), _port_packed(dp, batch)):
        np.testing.assert_array_equal(a, b)


def test_mesh_refusals(setup, tmp_path):
    """A batch the data axis does not divide raises, in the runner and in the
    CLI; so do a ragged mesh and more shards than devices. int8 with tp > 1
    runs: the runner over 1 x 2 gives one device's int8 decisions and
    classes, and the CLI corrects with ``--int8 --tp 2``."""
    from herro_tpu_torch import cli

    _, sd, batch = setup
    mesh = make_mesh_2d(1, 2, [CPU, CPU])
    tp8 = CorrectionRunner(CFG, sd, device="cpu", int8=True, mesh=mesh)
    one8 = CorrectionRunner(CFG, sd, device="cpu", int8=True)
    assert tp8.tp_fast_path and tp8.cfg.int8
    for a, b in zip(_port_packed(tp8, batch)[1:], _port_packed(one8, batch)[1:]):
        np.testing.assert_array_equal(a, b)
    dp = CorrectionRunner(CFG, sd, device="cpu", mesh=make_mesh([CPU] * 3))
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        dp.dispatch(Batch(*batch, windows=[]))
    with pytest.raises(ValueError, match="grid"):
        Mesh(((CPU, CPU), (CPU,)))
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh_2d(2, 2, [CPU] * 3)

    args = ["inference", "--device", "cpu", "-m", "tiny", str(tmp_path / "r.fastq"),
            str(tmp_path / "o.fasta")]
    (tmp_path / "r.fastq").write_text("@r\nACGT\n+\nIIII\n")
    cli.main([*args[:-2], "--devices", "2", "--tp", "2", "--int8", *args[-2:]])
    assert (tmp_path / "o.fasta").exists()
    with pytest.raises(SystemExit, match="batch size 3 not divisible by data size 2"):
        cli.main([*args[:-2], "--devices", "2", "-b", "3", *args[-2:]])
    with pytest.raises(SystemExit, match="--tp 2 does not divide 3 devices"):
        cli.main([*args[:-2], "--devices", "3", "--tp", "2", *args[-2:]])
    with pytest.raises(SystemExit, match="explicit device list"):
        cli.main([*args[:-2], "--devices", "0,1", "--tp", "2", *args[-2:]])
