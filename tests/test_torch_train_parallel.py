"""The port's training over a device mesh held against herro_tpu's
``Trainer(mesh=...)`` and against its own single-device trainer, on CPU
replicas (a mesh may name the CPU more than once; the reference runs on the
8 virtual CPU devices of ``tests/conftest.py``).

* Three steps of TINY (float32, herro_tpu's ``init_params``, lr 0.3,
  ``hard_weight`` 3.0) on three ``collate_train`` batches of B=8 whose rows
  0-3 keep only half of their supported columns, so the replicas' supported
  counts differ and a mean of per-replica losses would show: over DP 2, DP 4,
  2 x 2 and 1 x 2, every metric within 1e-4 relative and every parameter
  within 1e-5 of herro_tpu's trainer over the same mesh shape (which XLA
  runs as the single-device step), every parameter moved; and within 1e-5
  of the port's own single-device trainer.
* The data replicas' parameters are bit-identical after every step.
* One TP 2 backward: the gradients of the replicated parameters (entry,
  LayerNorms, ``bo``, ``b2``, tail) are the sums of the shards' parts, and
  every gradient equals one device's within 1e-5 of its largest magnitude.
* A TP 2 checkpoint holds the logical, unscaled parameters and loads in
  herro_tpu with float32 logits within 2e-4 of one device's.
* ``attention_shard`` (the TP attention op under autograd) against
  ``jax.vjp`` through herro_tpu's ``ln_qkv_rope`` and ``flash_outproj`` with
  the residual apart; ``all_reduce``'s gradient; ``gather_weights`` against
  ``shard_weights``; remat under TP; the refusals; int8 under DP and TP (and
  against herro_tpu's int8 mesh trainers over 1 x 2 and 2 x 2).
* ``distill_from_dump`` over ``make_mesh([cpu] * 2)`` against herro_tpu's over
  ``make_mesh(2)``; ``dryrun_multichip(4, device="cpu")``, and its bars
  rejecting two faults planted in a data-parallel step.

Every test runs under a time limit of its own (``SIGALRM``); the ``gpu`` test
holds ``attention_shard`` on the card and skips without one.
"""

import dataclasses
import functools
import os
import signal

import numpy as np
import pytest
import torch

from herro_tpu_torch.constants import QUAL_OFFSET, QUAL_SCALE
from herro_tpu_torch.models.checkpoint import load_model, params_from_jax, params_to_jax
from herro_tpu_torch.models.model import CorrectionModel, ModelConfig
from herro_tpu_torch.ops import fused
from herro_tpu_torch.parallel import (
    TensorParallelModel,
    all_reduce,
    gather_weights,
    make_mesh,
    make_mesh_2d,
    shard_weights,
)
from herro_tpu_torch.parallel.tensor import block_params
from herro_tpu_torch.training.data import batch_iterator, simulated_windows
from herro_tpu_torch.training.simulate import simulate
from herro_tpu_torch.training.train import Trainer, loss_fn

CPU = torch.device("cpu")
WINDOW = 128
# (data replicas, tensor-parallel degree): the reference's dryrun and test
# meshes, make_mesh(2), make_mesh(4), make_mesh_2d(2, 2), make_mesh_2d(1, 2)
LAYOUTS = {"dp2": (2, 1), "dp4": (4, 1), "2x2": (2, 2), "1x2": (1, 2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models' many small ops (see
    tests/test_torch_training.py), the module's fixtures included: under
    pytest-xdist, six workers' thread pools on a few cores slow them
    tenfold and more."""
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


def _jax_tiny(int8: bool = False):
    import jax

    from herro_tpu.models.model import TINY_CONFIG, init_params

    jcfg = dataclasses.replace(TINY_CONFIG, int8=int8)
    params = jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, params


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _flat(tree):
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_mesh(layout: str):
    n_data, tp = LAYOUTS[layout]
    return make_mesh_2d(n_data, tp, [CPU] * (n_data * tp))


def _jax_mesh(layout: str):
    from herro_tpu.parallel.mesh import make_mesh as jax_mesh
    from herro_tpu.parallel.tensor import make_mesh_2d as jax_mesh_2d

    n_data, tp = LAYOUTS[layout]
    return jax_mesh(n_data) if tp == 1 else jax_mesh_2d(n_data, tp)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Three B=8 batches (L 256, S 64) whose rows 0-3 keep only the first
    half of their supported columns: every data replica of every layout
    holds another supported count."""
    tmp = tmp_path_factory.mktemp("torch_train_parallel")
    ds = simulate(
        genome_len=2000, n_reads=40, read_len=(600, 1100), sub_rate=0.05,
        ins_rate=0.03, del_rate=0.03, seed=5,
    )
    windows = simulated_windows(ds, str(tmp / "r.fastq"), WINDOW, min_overlap=150)
    out = [b for _, b in zip(range(3), batch_iterator(windows, 8, L=256, S=64, n_epochs=1,
                                                      seed=0))]
    for b in out:
        for i in range(4):
            b.support_mask[i, b.support_mask[i].sum() // 2:] = False
        counts = b.support_mask.sum(axis=1)
        assert counts[:4].sum() < counts[4:].sum()
        assert len({int(c) for c in counts.reshape(4, 2).sum(axis=1)}) > 1
    return out


def _train(cfg, params, batches, mesh=None, **kw):
    where = dict(device="cpu") if mesh is None else dict(mesh=mesh)
    trainer = Trainer(cfg, params, lr=0.3, total_steps=50, hard_weight=3.0, **where, **kw)
    return trainer, [trainer.train_step(b) for b in batches]


@pytest.fixture(scope="module")
def one_device(batches):
    jcfg, params = _jax_tiny()
    return _train(_port_cfg(jcfg), params_from_jax(params), batches)


def _assert_metrics_close(got: list, want: list, rel: float = 1e-4, batches=None):
    """Every metric within ``rel`` relative. With ``batches`` (int8 against
    herro_tpu), acc and hard_acc may differ by one column of the step's
    supported (hard) columns: the port's one-device int8 forward already
    rounds a column to the next int8 step now and then where herro_tpu's does
    not (torch and XLA sum LayerNorm and take tanh in other orders), and on
    these batches one such column flips its class at step 3 at one device
    as over a mesh."""
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"loss", "ce", "info_bce", "acc", "hard_acc"}
        one = {}
        if batches is not None:  # one column's share of the step's batch
            b = batches[step]
            one = {"acc": 1.0 / b.support_mask.sum(),
                   "hard_acc": 1.0 / (b.support_mask & (b.info_labels > 0)).sum()}
        for k in w:
            tol = max(rel * max(abs(w[k]), 1e-3), one.get(k, 0.0) * 1.0001)
            assert abs(g[k] - w[k]) <= tol, (step, k, g[k], w[k])


# int8 against herro_tpu: the port's one-device int8 trainer already ends
# 1.8e-4 from herro_tpu's after these three steps (one int8 step taken
# otherwise in a forward moves that step's gradient, and Adam's early steps
# turn a small gradient's change into a whole update), so the int8 cases hold
# the first step's gradient (Adam's first moment) at the one-device bar of
# tests/test_torch_training.py, 1e-5 of its largest magnitude, and the
# parameters after three steps within INT8_PARAMS_ATOL
INT8_PARAMS_ATOL = 5e-4


@pytest.mark.parametrize("layout", [*LAYOUTS, "1x2-int8", "2x2-int8"])
@time_limit(120)
def test_mesh_trainer_matches_reference(layout, batches):
    """herro_tpu's and the port's trainers over the same mesh shape, three
    steps: metrics within 1e-4 relative, parameters within 1e-5, every
    parameter moved (the steps move them by about 9e-3). ``-int8``: an int8
    config, which herro_tpu trains by pjit over its jnp twins and the port
    on the int8 ops with the FFN's row maximum across the shards; its bars
    are ``_assert_metrics_close``'s and ``INT8_PARAMS_ATOL``'s."""
    import jax

    from herro_tpu.training.train import Trainer as JaxTrainer

    layout, int8 = layout.removesuffix("-int8"), layout.endswith("-int8")
    jcfg, params = _jax_tiny(int8)
    jt = JaxTrainer(jcfg, params, lr=0.3, total_steps=50, mesh=_jax_mesh(layout),
                    hard_weight=3.0)
    pt = Trainer(_port_cfg(jcfg), params_from_jax(params), lr=0.3, total_steps=50,
                 hard_weight=3.0, mesh=_port_mesh(layout))
    want_metrics, got_metrics = [jt.train_step(batches[0])], [pt.train_step(batches[0])]
    if int8:  # the first step's summed gradient, through Adam's first moment
        want_mu = _flat(jax.tree_util.tree_map(np.asarray, jt.state.opt_state[1][0].mu))
        got_mu = _flat(params_to_jax(pt.state.replicas[0].gather(pt.state.opt_states[0].mu)))
        for k in want_mu:
            scale = np.abs(want_mu[k]).max()
            assert scale > 0 and np.abs(got_mu[k] - want_mu[k]).max() <= 1e-5 * scale, k
    want_metrics += [jt.train_step(b) for b in batches[1:]]
    got_metrics += [pt.train_step(b) for b in batches[1:]]
    _assert_metrics_close(got_metrics, want_metrics, batches=batches if int8 else None)
    assert pt.state.step == 3
    want = _flat(jax.tree_util.tree_map(np.asarray, jt.state.params))
    got = _flat(params_to_jax(pt.state.params))
    start = _flat(params)
    assert set(got) == set(want)
    atol = INT8_PARAMS_ATOL if int8 else 1e-5
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= atol, (layout, k)
        assert np.abs(want[k] - start[k]).max() > 1e-3, (layout, k)  # every parameter moved


@pytest.mark.parametrize("layout", list(LAYOUTS))
@time_limit(60)
def test_mesh_trainer_matches_one_device(layout, batches, one_device):
    """The port over each layout against its own single-device trainer: the
    same names, parameters within 1e-5, metrics within 1e-4 relative."""
    one, one_metrics = one_device
    jcfg, params = _jax_tiny()
    pt, metrics = _train(_port_cfg(jcfg), params_from_jax(params), batches,
                         _port_mesh(layout))
    _assert_metrics_close(metrics, one_metrics)
    want, got = one.state.params, pt.state.params
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        assert float((got[k] - want[k]).detach().abs().max()) <= 1e-5, (layout, k)


@pytest.mark.parametrize("layout", ["dp2", "2x2"])
@time_limit(60)
def test_data_replicas_bit_identical(layout, batches):
    """Every data replica holds the same bits, parameters and Adam moments,
    after every step: one summed gradient, the same update."""
    jcfg, params = _jax_tiny()
    trainer = Trainer(_port_cfg(jcfg), params_from_jax(params), lr=0.3, total_steps=50,
                      hard_weight=3.0, mesh=_port_mesh(layout))
    state = trainer.state
    assert len(state.replicas) == LAYOUTS[layout][0]
    start = [p.detach().clone() for p in state.replicas[0].parameters()]
    for b in batches:
        trainer.train_step(b)
        first = list(state.replicas[0].parameters())
        for r, opt in zip(state.replicas[1:], state.opt_states[1:]):
            assert all(torch.equal(a, c) for a, c in zip(first, r.parameters()))
            assert all(torch.equal(a, c) for a, c in zip(state.opt_states[0].mu, opt.mu))
            assert all(torch.equal(a, c) for a, c in zip(state.opt_states[0].nu, opt.nu))
    assert all(float((a - p).abs().max()) > 0 for a, p in zip(first, start))  # all moved


@time_limit(60)
def test_tp_replicated_gradients_summed(batches):
    """One TP 2 backward: the replicated parameters are one leaf each, read
    by both shards, so their gradients are the shards' parts summed; every
    gradient, the shards' put back together, equals one device's within
    1e-5 (the FFN shards normalise the stream / tp, whose LayerNorm eps
    differs by 1e-6 relative) and within 2e-5 of its largest magnitude."""
    jcfg, params = _jax_tiny()
    cfg, sd = _port_cfg(jcfg), params_from_jax(params)
    one = CorrectionModel(cfg)
    one.load_state_dict(sd)
    tp = TensorParallelModel(cfg, sd, [CPU, CPU])
    want, got = {}, {}
    for model, into, names in ((one, want, [n for n, _ in one.named_parameters()]),
                               (tp, got, None)):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            batches[0].tokens, batches[0].quals, batches[0].support_idx,
            batches[0].support_mask, batches[0].labels, batches[0].info_labels)]
        loss, _ = loss_fn(model, *tensors, 0.1, 3.0)
        params_ = list(model.parameters())
        grads = torch.autograd.grad(loss, params_)
        into.update(dict(zip(names, grads)) if names else model.gather(grads))
    assert list(got) == list(want)
    for name in ("blocks.0.ln1.scale", "col_proj.bias", "blocks.1.attn.out_bias",
                 "blocks.0.ff2.bias"):
        assert float(want[name].abs().max()) > 0, name
    for name in want:
        scale = float(want[name].abs().max())
        assert scale > 0, name
        err = float((got[name] - want[name]).abs().max())
        assert err <= 1e-5 and err <= 2e-5 * scale, (name, err, scale)


@time_limit(60)
def test_tp_train_step(batches):
    """herro_tpu's test_tp_train_step over a 4 x 2 mesh: the loss is finite
    and does not blow up, and every shard keeps its shard widths and its
    device after the steps."""
    jcfg, params = _jax_tiny()
    cfg = _port_cfg(jcfg)
    trainer = Trainer(cfg, params_from_jax(params), lr=1e-3, total_steps=4,
                      mesh=make_mesh_2d(4, 2, [CPU] * 8))
    m1 = trainer.train_step(batches[0])
    m2 = trainer.train_step(batches[0])
    assert np.isfinite(m1["loss"]) and m2["loss"] < m1["loss"] + 1.0
    d, h, D = cfg.d_model, cfg.n_heads // 2, cfg.d_model // cfg.n_heads
    for replica in trainer.state.replicas:
        assert replica.tp == 2
        for shard in replica.shards:
            w = shard[0]
            assert w["w_qkv"].shape == (d, 3 * h * D) and w["wo"].shape == (h, D, d)
            assert w["w1"].shape == (d, cfg.d_ff // 2) and w["w2"].shape == (cfg.d_ff // 2, d)
            assert w["w_qkv"].is_leaf and w["w_qkv"].dtype == torch.float32


def _jax_logits(ckpt: str, inputs):
    import jax.numpy as jnp

    from herro_tpu.models.checkpoint import load_model as jax_load_model
    from herro_tpu.models.model import CorrectionModel as JaxModel

    jcfg, jparams = jax_load_model(ckpt)
    info, logits = JaxModel(jcfg).apply(jparams, *map(jnp.asarray, inputs))
    return np.asarray(info), np.asarray(logits)


@time_limit(90)
def test_tp_checkpoint_loads_in_reference(batches, one_device, tmp_path):
    """``Trainer.save`` of a TP 2 run holds the logical parameters (the
    shards put back together, ``bo`` and ``b2`` unscaled: within 1e-5 of the
    single-device run's) and loads in herro_tpu, whose float32 logits are
    within 2e-4 of one device's forward on the same checkpoint."""
    one, _ = one_device
    jcfg, params = _jax_tiny()
    cfg = _port_cfg(jcfg)
    trainer, _ = _train(cfg, params_from_jax(params), batches, _port_mesh("1x2"))
    ckpt = str(tmp_path / "tp2")
    trainer.save(ckpt)
    cfg2, sd = load_model(ckpt)
    assert cfg2 == cfg and open(os.path.join(ckpt, "step.txt")).read() == "3"
    logical = trainer.state.params
    assert list(sd) == list(logical)
    assert all(torch.equal(sd[k], v) for k, v in logical.items())
    for k, v in one.state.params.items():
        assert float((sd[k] - v.detach()).abs().max()) <= 1e-5, k

    b = batches[0]
    quals = (QUAL_SCALE * b.quals.astype(np.float32) - QUAL_OFFSET).astype(np.float32)
    inputs = (b.tokens, quals, b.support_idx, b.support_mask)
    want_info, want_logits = _jax_logits(ckpt, inputs)
    model = CorrectionModel(cfg2)
    model.load_state_dict(sd)
    with torch.no_grad():
        got_info, got_logits = model(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got_info.numpy(), want_info, rtol=0, atol=2e-4)


@time_limit(60)
def test_attention_shard_matches_reference():
    """``attention_shard`` under autograd (float32, d 64, H 2 of D 32, L 256,
    band 64, mixed lengths) against ``jax.vjp`` through herro_tpu's
    ``ln_qkv_rope`` then ``flash_outproj`` with the residual apart, as its
    ``_tp_forward`` calls them: the output within 1e-4, each gradient within
    1e-5 of its largest magnitude; the forward is the op's direct output and
    the gradients the plain version's, bit for bit."""
    import jax
    import jax.numpy as jnp

    from herro_tpu.ops import fused as jfused

    B, L, d, H, D, band = 3, 256, 64, 2, 32, 64
    lengths = np.array([256, 200, 131], dtype=np.int32)
    rng = np.random.default_rng(21)
    f32 = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    x = f32(B, L, d)
    diff = dict(x=x, residual=0.5 * x + f32(B, L, d, scale=0.1), ln_s=1 + f32(d, scale=0.1),
                ln_b=f32(d, scale=0.1), w_qkv=f32(d, 3 * H * D, scale=d ** -0.5),
                b_qkv=f32(3 * H * D, scale=0.1), wo=f32(H, D, d, scale=(H * D) ** -0.5),
                bo=f32(d, scale=0.1))
    g = rng.standard_normal((B, L, d)).astype(np.float32)
    g[np.arange(L)[None, :] >= lengths[:, None]] = 0.0  # padding rows are read by nothing

    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in diff.items()}
    lt = torch.from_numpy(lengths)
    out = fused.attention_shard(*leaves.values(), lt, H, band)
    assert "RecomputePlain" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, list(leaves.values()), torch.from_numpy(g))
    with torch.no_grad():
        assert torch.equal(out.detach(), fused.attention_shard(*leaves.values(), lt, H, band))

    def ref(x, res, ln_s, ln_b, w_qkv, b_qkv, wo, bo):
        q, k, v = jfused.ln_qkv_rope(x, ln_s, ln_b, w_qkv, b_qkv, H)
        return jfused.flash_outproj(q, k, v, res, wo, bo, jnp.asarray(lengths), band)

    ref_out, vjp = jax.vjp(ref, *diff.values())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0, atol=1e-4)
    for name, got, want in zip(diff, grads, vjp(g)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale, name

    plain = {k: torch.from_numpy(v).requires_grad_(True) for k, v in diff.items()}
    p_out = fused._attention_shard_plain(*plain.values(), lt, H, band)
    for got, want in zip(grads, torch.autograd.grad(p_out, list(plain.values()),
                                                    torch.from_numpy(g))):
        assert torch.equal(got, want)


@time_limit(30)
def test_all_reduce_gradient():
    """The sum is differentiable through its float32 copy, the in-place sum
    and the per-device copies: every partial's gradient is the sum of the
    outputs' gradients (Megatron's g operator), in float32 and bf16, up to
    the order autograd sums them in (1e-6 of their magnitude; bf16: one
    rounding, 2^-7)."""
    gen = torch.Generator().manual_seed(5)
    for dt in (torch.float32, torch.bfloat16):
        parts = [torch.randn(4, 8, generator=gen).to(dt).requires_grad_() for _ in range(3)]
        outs = all_reduce(parts)
        assert all(o is outs[0] for o in outs)
        cots = [torch.randn(4, 8, generator=gen).to(dt) for _ in outs]
        loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cots))
        grads = torch.autograd.grad(loss, parts)
        want = sum(c.float() for c in cots).to(dt)
        for gp in grads:
            assert gp.dtype == dt
            tol = 1e-6 if dt == torch.float32 else 2 ** -7
            assert float((gp.float() - want.float()).abs().max()) <= \
                tol * float(want.float().abs().max())


@time_limit(30)
def test_gather_inverts_shard_weights():
    """``gather_weights`` puts ``shard_weights``' shards of a block back
    together bit for bit, at tp 2 and 4, and passes gradients to each."""
    cfg = ModelConfig(d_model=64, n_layers=1, n_heads=4, d_ff=128, base_embed_dim=4,
                      dtype="float32")
    model = CorrectionModel(cfg, generator=torch.Generator().manual_seed(2))
    w = {k: v.detach() for k, v in block_params(model.blocks[0]).items()}
    for tp in (2, 4):
        shards = [{k: v.clone().requires_grad_() for k, v in shard_weights(w, tp, j).items()}
                  for j in range(tp)]
        whole = gather_weights(shards)
        assert set(whole) == {"w_qkv", "b_qkv", "wo", "w1", "b1", "w2"}
        for k, v in whole.items():
            assert torch.equal(v, w[k]), (tp, k)
        grads = torch.autograd.grad(sum(v.sum() for v in whole.values()),
                                    [s["w_qkv"] for s in shards])
        assert all(torch.equal(g, torch.ones_like(g)) for g in grads)


@time_limit(60)
def test_tp_remat_gradients_bit_equal(batches):
    """Under TP, remat (each shard's half-block a checkpoint region) changes
    no gradient bit."""
    jcfg, params = _jax_tiny()
    grads = {}
    for remat in (True, False):
        cfg = dataclasses.replace(_port_cfg(jcfg), remat=remat)
        trainer = Trainer(cfg, params_from_jax(params), mesh=_port_mesh("1x2"))
        loss, _ = loss_fn(trainer.model, *trainer.tensors(batches[0]), 0.1, 3.0)
        grads[remat] = torch.autograd.grad(loss, trainer.model.parameters())
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))


@time_limit(60)
def test_mesh_refusals_and_int8_data_parallel(batches):
    """A device beside a mesh raises; a batch the data axis does not
    divide raises; an int8 config trains under DP 2 and TP 1 x 2 on the CPU
    as on one device (the plain int8 ops; metrics within 1e-4 relative,
    parameters within 1e-5)."""
    jcfg, params = _jax_tiny()
    cfg, sd = _port_cfg(jcfg), params_from_jax(params)
    with pytest.raises(ValueError, match="a device or a mesh, not both"):
        Trainer(cfg, sd, device="cpu", mesh=make_mesh([CPU] * 2))
    dp3 = Trainer(cfg, sd, mesh=make_mesh([CPU] * 3))
    with pytest.raises(ValueError, match="batch size 8 is not divisible by the data axis"):
        dp3.train_step(batches[0])
    icfg = dataclasses.replace(cfg, int8=True)
    one, want = _train(icfg, sd, batches[:2])
    for mesh in (make_mesh([CPU, CPU]), _port_mesh("1x2")):
        layout, got = _train(icfg, sd, batches[:2], mesh)
        _assert_metrics_close(got, want)
        for k, v in one.state.params.items():
            assert float((layout.state.params[k] - v).abs().max()) <= 1e-5, k


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """The features tree of tests/test_torch_distill.py (22 reads, window
    512), a float32 TINY teacher and student from herro_tpu's init_params,
    saved where both packages load them."""
    import jax

    from herro_tpu.models.model import TINY_CONFIG, init_params
    from herro_tpu_torch.cli import main as cli_main
    from herro_tpu_torch.models.checkpoint import save_model
    from herro_tpu_torch.overlaps.batches import BatchWriter
    from herro_tpu_torch.training.simulate import paf_rows

    tmp = tmp_path_factory.mktemp("torch_distill_mesh")
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
    feats = tmp / "feats"
    cli_main(["features", "--read-alns", str(alns), "-w", "512", str(fastq), str(feats)])
    cfg = _port_cfg(TINY_CONFIG)
    for name, seed in (("teacher", 3), ("student", 0)):
        p = init_params(TINY_CONFIG, jax.random.PRNGKey(seed))
        save_model(str(tmp / name), cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, p)))
    return tmp, str(feats)


@time_limit(120)
def test_distill_over_mesh_matches_reference(dump, tmp_path):
    """``distill_from_dump`` over ``make_mesh([cpu] * 2)`` (the teacher's
    labels through the DP runner, the student through the DP trainer)
    against herro_tpu's over ``make_mesh(2)``, the same teacher and student
    checkpoints, batch 4, 3 steps at lr 0.3, L 1024, S 128: the same window count,
    the last step's metrics within 1e-4 relative, the students within 1e-5."""
    from herro_tpu.models.checkpoint import load_model as jax_load_model
    from herro_tpu.parallel.mesh import make_mesh as jax_mesh
    from herro_tpu.training.distill import distill_from_dump as jax_distill
    from herro_tpu_torch.training.distill import distill_from_dump

    tmp, feats = dump
    kw = dict(steps=3, batch_size=4, lr=0.3, max_len=1024, max_sup=128, seed=0)
    args = (feats, str(tmp / "teacher"), str(tmp / "student"))
    want = jax_distill(*args, str(tmp_path / "ref"), mesh=jax_mesh(2), **kw)
    got = distill_from_dump(*args, str(tmp_path / "port"), mesh=make_mesh([CPU, CPU]), **kw)
    assert got["n_windows"] == want["n_windows"] > 10
    _assert_metrics_close([got["final"]], [want["final"]])
    _, ref = jax_load_model(str(tmp_path / "ref"))
    _, port = jax_load_model(str(tmp_path / "port"))
    ref, port = _flat(ref), _flat(port)
    start = _flat(jax_load_model(str(tmp / "student"))[1])
    for k in ref:
        assert np.abs(port[k] - ref[k]).max() <= 1e-5, k
    assert any(np.abs(ref[k] - start[k]).max() > 1e-3 for k in ref)


@time_limit(120)
def test_dryrun_multichip_cpu(capsys):
    """The port's dryrun over four CPU devices: two ``r10`` train steps over
    a 2 x 2 mesh beside one device's (bf16; the first step's loss within
    2e-3 and its summed gradient within 2e-2 relative, the replicas'
    parameters and moments equal, every parameter moved), then the sharded
    runner against one device (2 x 2 and an odd 1-D mesh of 3): finite
    loss, equal decisions, agreement above 0.98."""
    from herro_tpu_torch.parallel.dryrun import GRAD_RTOL, LOSS_RTOL, dryrun_multichip

    res = dryrun_multichip(4, device="cpu")
    assert res["mesh"] == [2, 2] and np.isfinite(res["loss"])
    assert res["loss_gap"] <= LOSS_RTOL["model"] == 2e-3
    assert res["grad_gap"] <= GRAD_RTOL["model"] == 2e-2
    assert res["agreement"] > 0.98 and res["odd_agreement"] > 0.98
    assert "train ok over (2, 2)" in capsys.readouterr().out


@pytest.mark.parametrize("fault", ["gradient dropped", "mean of means"])
@time_limit(60)
def test_dryrun_rejects_planted_faults(fault, monkeypatch):
    """The dryrun's bars have the power to see a wrong data-parallel step:
    over DP 2 of CPU replicas (r10, bf16, B=4), replica 1 handing back a
    zero gradient, or each replica's loss over its own rows' denominators
    halved and summed (DDP's mean of means), makes it raise."""
    from herro_tpu_torch.parallel.dryrun import dryrun_multichip
    from herro_tpu_torch.training import train as train_mod

    gradients, loss_fn = train_mod.gradients, train_mod.loss_fn
    calls = []

    def dropped(loss, params):
        calls.append(1)
        grads = gradients(loss, params)
        return grads if len(calls) % 2 == 1 else [g * 0 for g in grads]

    def mean_of_means(model, *args):
        loss, metrics = loss_fn(model, *args[:-1])
        return loss / 2, {k: v / 2 for k, v in metrics.items()}

    if fault == "gradient dropped":
        monkeypatch.setattr(train_mod, "gradients", dropped)
    else:
        monkeypatch.setattr(train_mod, "loss_fn", mean_of_means)
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(2\): loss .* gradient gap"):
        dryrun_multichip(2, device="cpu")


@pytest.mark.gpu
def test_attention_shard_on_card():
    """On the card ``attention_shard`` at r10's tp 2 shard (H 2, d 512, L
    1024, band 512, bf16) launches K1 and K2 once each under autograd, its
    forward the direct call's bit for bit, its gradients the plain
    version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    from herro_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    B, L, d, H, D = 2, 1024, 512, 2, 128
    r = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=g, device=dev))
    x = r(B, L, d).to(torch.bfloat16)
    diff = dict(x=x, residual=x * 0.5, ln_s=1 + r(d, scale=0.1), ln_b=r(d, scale=0.1),
                w_qkv=r(d, 3 * H * D, scale=d ** -0.5).to(torch.bfloat16),
                b_qkv=r(3 * H * D, scale=0.1).to(torch.bfloat16),
                wo=r(H, D, d, scale=(H * D) ** -0.5).to(torch.bfloat16),
                bo=r(d, scale=0.1).to(torch.bfloat16))
    lengths = torch.tensor([L, 700], dtype=torch.int32, device=dev)
    leaves = {k: v.clone().requires_grad_() for k, v in diff.items()}
    before = kernels.launch_counts.snapshot()
    out = fused.attention_shard(*leaves.values(), lengths, H, 512)
    after = kernels.launch_counts.snapshot()
    assert after["ln_qkv_rope"] - before["ln_qkv_rope"] == 1
    assert after["flash_outproj"] - before["flash_outproj"] == 1
    cot = r(B, L, d).to(torch.bfloat16)
    grads = torch.autograd.grad(out, list(leaves.values()), cot)
    with torch.no_grad():
        assert torch.equal(out, fused.attention_shard(*leaves.values(), lengths, H, 512))
    plain = {k: v.clone().requires_grad_() for k, v in diff.items()}
    p_out = fused._attention_shard_plain(*plain.values(), lengths, H, 512)
    for a, b in zip(grads, torch.autograd.grad(p_out, list(plain.values()), cot)):
        assert torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
