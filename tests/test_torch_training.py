"""The port's training path held against herro_tpu's.

On the same numpy inputs:

* per op, the gradients of ``entry_embed``, ``ln_ffn`` and ``attention_block``
  (the three ``_RecomputePlain`` Functions of ``ops/fused.py``) against
  ``jax.vjp`` through herro_tpu's ops, which on the CPU are their custom_vjp
  over the jnp twins; in float32, at d 64, H 2, D 32, L 256, band 64 and
  mixed lengths. Each gradient within 1e-5 of its largest magnitude
  (float32 summation order through LayerNorm, two products and a softmax);
* the optimiser against optax's ``chain(clip_by_global_norm(1.0),
  adamw(warmup_cosine_decay_schedule(...), weight_decay=1e-4))`` on random
  gradients through warmup, decay, its end, and a step with the clip and one
  without: 1e-6 of each parameter's range;
* three steps of the port's ``Trainer`` against herro_tpu's ``Trainer``
  (``mesh=None``) on the same three ``collate_train`` batches with
  ``hard_weight`` 3.0, TINY in float32 from herro_tpu's ``init_params``:
  every metric within 1e-4 relative, every parameter within 1e-5 (the steps
  move them by about 9e-3: lr 0.3 is 0.006 at step 3 of the 100-step
  warmup, and the first update is at lr 0 as in optax);
* remat on and off give bit-equal gradients;
* an int8 config trains on the CPU as herro_tpu's does: the int8 roundings
  pass no gradient, the scales do; the first step's Adam moment within 1e-5
  of its largest magnitude, the metrics within 1e-5;
* torch versions of ``tests/test_training.py`` without the mesh;
* checkpoints: one the port writes loads in herro_tpu with float32 logits
  within 2e-4 of the port's; ``resources/model_r10_sim`` read and rewritten
  by the port is the same file, byte for byte; ``Trainer.save`` writes
  ``step.txt``;
* the ``train`` CLI on the CPU, over two CPU replicas (``--devices 2``) and
  two replicas of two shards (``--devices 2 --tp 2``), whose checkpoints
  load in both packages, and its refusal of a degree that does not divide
  the devices and of ``--tp`` with an explicit device list.

Every test runs under a time limit of its own (``SIGALRM``). The ``gpu`` tests
hold the three Functions on the card (kernel forward, plain backward) and an
int8 step there (the int8 ops under autograd); they skip without a card.
"""

import dataclasses
import functools
import os
import signal

import numpy as np
import pytest
import torch

from herro_tpu_torch.constants import QUAL_OFFSET, QUAL_SCALE
from herro_tpu_torch.models.checkpoint import (
    load_model,
    params_from_jax,
    params_to_jax,
    save_model,
)
from herro_tpu_torch.models.model import CorrectionModel, ModelConfig
from herro_tpu_torch.ops import cuda as kernels
from herro_tpu_torch.ops import fused
from herro_tpu_torch.training.data import batch_iterator, simulated_windows
from herro_tpu_torch.training.simulate import simulate
from herro_tpu_torch.training.train import Trainer, loss_fn, make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R10_CKPT = os.path.join(ROOT, "resources", "model_r10_sim")
WINDOW = 128
B, L, d, H, D, F_FF, BAND = 3, 256, 64, 2, 32, 128, 64
LENGTHS = [256, 200, 131]
OPS = ["entry_embed", "ln_ffn", "attention_block"]


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


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train")
    # high error rates -> plenty of supported columns to learn from
    ds = simulate(
        genome_len=2000, n_reads=40, read_len=(600, 1100), sub_rate=0.05,
        ins_rate=0.03, del_rate=0.03, seed=5,
    )
    return simulated_windows(ds, str(tmp / "r.fastq"), WINDOW, min_overlap=150)


def _op_inputs(op: str, rng):
    """(differentiable float32 inputs by name, the other arguments) of one op
    at the small widths."""
    f32 = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    if op == "entry_embed":
        R, V = 31, 12
        bases = rng.integers(0, 13, (B, R, L)).astype(np.uint8)  # 12: out of vocab
        diff = dict(quals=rng.uniform(-1, 1, (B, R, L)).astype(np.float32),
                    w_embT=f32(d, R * V, scale=0.1), w_qT=f32(d, R, scale=0.1),
                    cb=f32(d, scale=0.1))
        return diff, dict(bases=bases)
    x = f32(B, L, d)
    if op == "ln_ffn":
        return dict(x=x, scale=1 + f32(d, scale=0.1), bias=f32(d, scale=0.1),
                    w1=f32(d, F_FF, scale=d ** -0.5), b1=f32(F_FF, scale=0.1),
                    w2=f32(F_FF, d, scale=F_FF ** -0.5), b2=f32(d, scale=0.1)), {}
    return dict(x=x, ln_s=1 + f32(d, scale=0.1), ln_b=f32(d, scale=0.1),
                w_qkv=f32(d, 3 * H * D, scale=d ** -0.5), b_qkv=f32(3 * H * D, scale=0.1),
                wo=f32(H, D, d, scale=(H * D) ** -0.5), bo=f32(d, scale=0.1)), \
        dict(lengths=np.array(LENGTHS, dtype=np.int32))


def _port_op(op: str, diff: dict, other: dict):
    """The port's op on torch tensors (entry_embed through col_proj_table, as
    the model calls it)."""
    if op == "entry_embed":
        wc = fused.col_proj_table(diff["w_embT"], diff["w_qT"])
        return fused.entry_embed(other["bases"], diff["quals"], wc, diff["cb"],
                                 torch.float32)
    if op == "ln_ffn":
        return fused.ln_ffn(*diff.values())
    return fused.attention_block(*diff.values(), other["lengths"], H, BAND)


def _jax_op(op: str, diff: dict, other: dict):
    import jax.numpy as jnp

    from herro_tpu.ops import fused as jfused

    if op == "entry_embed":
        return lambda q, we, wq, cb: jfused.entry_embed(
            jnp.asarray(other["bases"]), q, we, wq, cb, jnp.float32)
    if op == "ln_ffn":
        return jfused.ln_ffn
    lengths = jnp.asarray(other["lengths"])
    return lambda *a: jfused.attention_block(*a, lengths, H, BAND)


def _cotangent(rng, shape):
    """A random output cotangent, zero on padding rows (read by no later
    stage of the model)."""
    g = rng.standard_normal(shape).astype(np.float32)
    g[np.arange(L)[None, :] >= np.array(LENGTHS)[:, None]] = 0.0
    return g


@pytest.mark.parametrize("op", OPS)
@time_limit(120)
def test_op_gradients_match_reference(op):
    """torch.autograd.grad through the port's op against jax.vjp through
    herro_tpu's, every differentiable input; the Function's forward is the
    op's direct output and its gradient the plain version's, bit for bit."""
    import jax

    rng = np.random.default_rng(11 + OPS.index(op))
    diff, other = _op_inputs(op, rng)
    out_shape = (B, L, d)
    g = _cotangent(rng, out_shape)

    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in diff.items()}
    other_t = {k: torch.from_numpy(v) for k, v in other.items()}
    out = _port_op(op, leaves, other_t)
    assert out.grad_fn is not None and "RecomputePlain" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, list(leaves.values()), torch.from_numpy(g))

    with torch.no_grad():  # the direct call: no Function
        direct = _port_op(op, leaves, other_t)
    assert torch.equal(out.detach(), direct)

    ref_out, vjp = jax.vjp(_jax_op(op, diff, other), *diff.values())
    ref_grads = vjp(g)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0, atol=1e-4)
    for name, got, want in zip(diff, grads, ref_grads):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * scale, (op, name, err, scale)

    # through the plain version under autograd: the Function's backward is it
    plain_leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in diff.items()}
    if op == "entry_embed":
        wc = fused.col_proj_table(plain_leaves["w_embT"], plain_leaves["w_qT"])
        p_out = fused._entry_embed_plain(other_t["bases"], plain_leaves["quals"], wc,
                                         plain_leaves["cb"], torch.float32)
    elif op == "ln_ffn":
        p_out = fused._ln_ffn_plain(*plain_leaves.values())
    else:
        p_out = fused._attention_block_plain(*plain_leaves.values(), other_t["lengths"],
                                             H, BAND)
    p_grads = torch.autograd.grad(p_out, list(plain_leaves.values()), torch.from_numpy(g))
    for got, want in zip(grads, p_grads):
        assert torch.equal(got, want)


@time_limit(60)
def test_optimizer_matches_optax():
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(3)
    shapes = [(7, 5), (5,), (3, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    lr, warmup, total = 0.05, 2, 5
    ref = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total),
                    weight_decay=1e-4),
    )
    jp = [jnp.asarray(p) for p in params]
    jstate = ref.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = make_optimizer(lr, warmup=warmup, total_steps=total)
    tstate = opt.init(tp)
    for step in range(7):  # warmup, cosine, past its end
        scale = 0.01 if step % 2 else 3.0  # a norm below the clip, then above
        grads = [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
        upd, jstate = ref.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.from_numpy(g) for g in grads], tstate)
        for a, b in zip(jp, tp):
            a = np.asarray(a)
            assert np.abs(a - b.numpy()).max() <= 1e-6 * max(np.abs(a).max(), 1.0), step
    assert opt.learning_rate(0) == 0.0  # the first update is at lr 0, as in optax


def _same_batches(windows, n=3):
    return [b for _, b in zip(range(n), batch_iterator(windows, 8, L=256, S=64,
                                                       n_epochs=1, seed=0))]


@time_limit(180)
def test_trainer_matches_reference(windows):
    import jax

    from herro_tpu.training.train import Trainer as JaxTrainer

    jcfg, params = _jax_tiny()
    batches = _same_batches(windows)
    jt = JaxTrainer(jcfg, params, lr=0.3, total_steps=50, mesh=None, hard_weight=3.0)
    pt = Trainer(_port_cfg(jcfg), params_from_jax(params), lr=0.3, total_steps=50,
                 hard_weight=3.0, device="cpu")
    for step, batch in enumerate(batches):
        want, got = jt.train_step(batch), pt.train_step(batch)
        assert set(got) == set(want) == {"loss", "ce", "info_bce", "acc", "hard_acc"}
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-3), (step, k)
    assert pt.state.step == 3
    want = _flat(jax.tree_util.tree_map(np.asarray, jt.state.params))
    got = _flat(params_to_jax(pt.state.params))
    start = _flat(params)
    assert set(got) == set(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-5, k
        assert np.abs(want[k] - start[k]).max() > 1e-3, k  # every parameter moved


@time_limit(120)
def test_remat_gradients_bit_equal(windows):
    jcfg, params = _jax_tiny()
    batch = _same_batches(windows, 1)[0]
    grads = {}
    for remat in (True, False):
        cfg = dataclasses.replace(_port_cfg(jcfg), remat=remat)
        trainer = Trainer(cfg, params_from_jax(params), device="cpu")
        loss, _ = loss_fn(trainer.model, *trainer.tensors(batch), 0.1, 3.0)
        grads[remat] = torch.autograd.grad(loss, list(trainer.state.params.values()))
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    assert all(bool(g.abs().max() > 0) for g in grads[True])


@time_limit(180)
def test_int8_config_trains_as_reference(windows):
    """herro_tpu's model takes the int8 ops under ``cfg.int8`` in training too
    (its flag comment says training ignores it, its code does not): the
    roundings to int8 pass no gradient, the per-row and per-column scales
    do. The port on the CPU does the same."""
    import jax

    from herro_tpu.training.train import Trainer as JaxTrainer

    jcfg, params = _jax_tiny(int8=True)
    batch = _same_batches(windows, 1)[0]
    jt = JaxTrainer(jcfg, params, lr=0.3, total_steps=50, mesh=None, hard_weight=3.0)
    pt = Trainer(_port_cfg(jcfg), params_from_jax(params), lr=0.3, total_steps=50,
                 hard_weight=3.0, device="cpu")
    want, got = jt.train_step(batch), pt.train_step(batch)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-3), k
    # the first Adam moment is 0.1 x the clipped gradient
    adam = jt.state.opt_state[1][0]
    want_mu = _flat(jax.tree_util.tree_map(np.asarray, adam.mu))
    names = list(pt.state.params)
    got_mu = _flat(params_to_jax(dict(zip(names, pt.state.opt_state.mu))))
    for k in want_mu:
        scale = np.abs(want_mu[k]).max()
        assert scale > 0, k  # every parameter gets a gradient, the quantized ones too
        assert np.abs(got_mu[k] - want_mu[k]).max() <= 1e-5 * scale, k


@time_limit(60)
def test_labels_mostly_match_counting_consensus(windows):
    """Sanity: at supported columns the truth should usually equal the pileup
    majority (errors are random, not systematic)."""
    from herro_tpu_torch.constants import TOKEN_TO_CLASS

    assert len(windows) > 20
    n_sup = sum(len(w.labels) for w in windows)
    assert n_sup > 100
    agree = total = 0
    for w in windows:
        cls = TOKEN_TO_CLASS[w.tokens]  # [L, R]
        for flat, lab in zip(w.support_flat, w.labels):
            col = cls[flat]
            counts = np.bincount(col[col < 5], minlength=5)
            agree += int(np.argmax(counts) == lab)
            total += 1
    assert agree / total > 0.7, f"labels vs majority: {agree}/{total}"


@time_limit(240)
def test_training_learns(windows):
    from herro_tpu_torch.models.checkpoint import load_or_init

    cfg, params = load_or_init("tiny")
    trainer = Trainer(cfg, params, lr=1e-3, total_steps=400, device="cpu")
    history = []
    for batch in batch_iterator(windows, batch_size=8, L=256, S=64, n_epochs=40, seed=0):
        history.append(trainer.train_step(batch))
        if len(history) >= 120:
            break
    first = np.mean([h["ce"] for h in history[:10]])
    last = np.mean([h["ce"] for h in history[-10:]])
    acc = np.mean([h["acc"] for h in history[-10:]])
    assert last < 0.7 * first, f"CE did not decrease: {first:.3f} -> {last:.3f}"
    assert acc > 0.70, f"supported-column accuracy too low: {acc:.3f}"


def _jax_logits(ckpt: str, inputs):
    import jax.numpy as jnp

    from herro_tpu.models.checkpoint import load_model as jax_load_model
    from herro_tpu.models.model import CorrectionModel as JaxModel

    jcfg, jparams = jax_load_model(ckpt)
    info, logits = JaxModel(jcfg).apply(jparams, *map(jnp.asarray, inputs))
    return np.asarray(info), np.asarray(logits)


@time_limit(120)
def test_port_checkpoint_loads_in_reference(windows, tmp_path):
    """A checkpoint the port trains and saves loads in herro_tpu and gives the
    port's float32 logits within 2e-4."""
    from herro_tpu_torch.models.checkpoint import load_or_init

    cfg, params = load_or_init("tiny", rng_seed=4)
    trainer = Trainer(cfg, params, lr=0.3, total_steps=50, device="cpu")
    batch = _same_batches(windows, 2)
    for b in batch:
        trainer.train_step(b)
    ckpt = str(tmp_path / "ckpt")
    save_model(ckpt, cfg, trainer.state.params)

    b = batch[0]
    quals = (QUAL_SCALE * b.quals.astype(np.float32) - QUAL_OFFSET).astype(np.float32)
    inputs = (b.tokens, quals, b.support_idx, b.support_mask)
    want_info, want_logits = _jax_logits(ckpt, inputs)
    with torch.no_grad():
        got_info, got_logits = trainer.model(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got_info.numpy(), want_info, rtol=0, atol=2e-4)
    cfg2, sd = load_model(ckpt)  # and in the port's own loader
    assert cfg2 == cfg
    assert all(torch.equal(sd[k], v.detach()) for k, v in trainer.state.params.items())


@time_limit(120)
def test_shipped_checkpoint_round_trip(tmp_path):
    """model_r10_sim read by the port and written back (params_to_jax and the
    msgpack writer) loads in herro_tpu with every array bit-equal, and is the
    same file byte for byte."""
    from herro_tpu.models.checkpoint import load_model as jax_load_model

    cfg, sd = load_model(R10_CKPT)
    out = str(tmp_path / "rewritten")
    save_model(out, cfg, sd)
    with open(os.path.join(R10_CKPT, "params.msgpack"), "rb") as a, \
            open(os.path.join(out, "params.msgpack"), "rb") as b:
        assert a.read() == b.read()
    _, want = jax_load_model(R10_CKPT)
    jcfg, got = jax_load_model(out)
    want, got = _flat(want), _flat(got)
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


@time_limit(60)
def test_trainer_save_writes_step(windows, tmp_path):
    from herro_tpu_torch.models.checkpoint import load_or_init

    cfg, params = load_or_init("tiny")
    trainer = Trainer(cfg, params, device="cpu")
    history = trainer.fit(iter(_same_batches(windows, 2)), log_every=1, save_every=2,
                          save_dir=str(tmp_path / "mid"))
    assert len(history) == 2
    assert open(tmp_path / "mid" / "step.txt").read() == "2"
    cfg2, sd = load_model(str(tmp_path / "mid"))
    assert cfg2 == cfg and set(sd) == set(trainer.state.params)


@time_limit(180)
def test_cli_train_tiny_cpu(tmp_path):
    from herro_tpu.models.checkpoint import load_model as jax_load_model
    from herro_tpu_torch.cli import main

    out = str(tmp_path / "ckpt")
    cache = str(tmp_path / "windows.pkl")
    args = ["train", "--config", "tiny", "--device", "cpu", "--steps", "3",
            "--batch-size", "4", "-w", "128", "--genome-len", "3000", "--n-reads", "20",
            "--max-len", "256", "--max-sup", "64", "--data-cache", cache, out]
    main(args)
    assert os.path.exists(cache)
    jcfg, jparams = jax_load_model(out)
    cfg, sd = load_model(out)
    assert jcfg.d_model == cfg.d_model == 32
    want = _flat(jparams)
    got = _flat(params_to_jax(sd))
    assert all(np.array_equal(want[k], got[k]) for k in want)
    main(args)  # again, from the cache


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--devices", "2", "--tp", "2"]])
@time_limit(180)
def test_cli_train_multi_device(flag, tmp_path):
    """``train`` over CPU replicas (data parallelism, and 2 x 2 with tensor
    parallelism): a few steps, then a checkpoint of the logical parameters
    that both packages load."""
    from herro_tpu.models.checkpoint import load_model as jax_load_model
    from herro_tpu_torch.cli import main

    out = str(tmp_path / "ckpt")
    main(["train", "--config", "tiny", "--device", "cpu", *flag, "--steps", "2",
          "--batch-size", "4", "-w", "128", "--genome-len", "3000", "--n-reads", "20",
          "--max-len", "256", "--max-sup", "64", out])
    jcfg, jparams = jax_load_model(out)
    cfg, sd = load_model(out)
    assert jcfg.d_model == cfg.d_model == 32
    from herro_tpu_torch.models.checkpoint import load_or_init

    start = _flat(params_to_jax(load_or_init("tiny")[1]))  # the weights train starts from
    got = _flat(params_to_jax(sd))
    want = _flat(jparams)
    assert set(got) == set(want) == set(start)
    assert all(np.array_equal(want[k], got[k]) for k in want)
    assert all(np.isfinite(v).all() for v in got.values())
    assert any(not np.array_equal(got[k], start[k]) for k in got)  # the steps trained


@pytest.mark.parametrize("flag", [["--devices", "2", "--tp", "3"],
                                  ["--devices", "0,1", "--tp", "2"]])
def test_cli_train_refuses_multi_device(flag, tmp_path):
    """The layouts the reference's mesh rules refuse: a degree that does not
    divide the devices, ``--tp`` with an explicit device list."""
    from herro_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="does not divide 2 devices|explicit device list"):
        main(["train", "--config", "tiny", "--device", "cpu", *flag, str(tmp_path / "o")])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda")


def _card_inputs(op: str, dev, g):
    """R10 widths, bf16 activations, float32 LayerNorm parameters: B 2, L 1024."""
    Bc, Lc, dc, Hc, Dc, Fc = 2, 1024, 512, 4, 128, 1024
    bf = torch.bfloat16
    r = lambda *s, scale=1.0, dt=bf: (scale * torch.randn(*s, generator=g, device=dev)).to(dt)
    if op == "entry_embed":
        bases = torch.randint(0, 13, (Bc, 31, Lc), generator=g, device=dev).to(torch.uint8)
        quals = torch.rand(Bc, 31, Lc, generator=g, device=dev) * 2 - 1
        return dict(quals=quals, w_embT=r(dc, 31 * 12, scale=0.05),
                    w_qT=r(dc, 31, scale=0.05), cb=r(dc, scale=0.1, dt=torch.float32)), \
            dict(bases=bases)
    x = r(Bc, Lc, dc)
    ln = dict(scale=1 + r(dc, scale=0.1, dt=torch.float32),
              bias=r(dc, scale=0.1, dt=torch.float32))
    if op == "ln_ffn":
        return dict(x=x, **ln, w1=r(dc, Fc, scale=dc ** -0.5), b1=r(Fc, scale=0.1),
                    w2=r(Fc, dc, scale=Fc ** -0.5), b2=r(dc, scale=0.1)), {}
    return dict(x=x, ln_s=ln["scale"], ln_b=ln["bias"], w_qkv=r(dc, 3 * Hc * Dc, scale=dc ** -0.5),
                b_qkv=r(3 * Hc * Dc, scale=0.1), wo=r(Hc, Dc, dc, scale=(Hc * Dc) ** -0.5),
                bo=r(dc, scale=0.1)), \
        dict(lengths=torch.tensor([1024, 700], dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
def test_functions_on_card(op):
    """On the card: the Function's forward is the kernel's output bit for bit
    (one launch of each of its kernels), and its gradient is autograd's
    through the plain version on the same inputs, finite and nonzero."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    diff, other = _card_inputs(op, dev, g)
    leaves = {k: v.clone().requires_grad_(True) for k, v in diff.items()}

    def run(p):
        if op == "entry_embed":
            wc = fused.col_proj_table(p["w_embT"], p["w_qT"])
            return fused.entry_embed(other["bases"], p["quals"], wc, p["cb"], torch.bfloat16)
        if op == "ln_ffn":
            return fused.ln_ffn(*p.values())
        return fused.attention_block(*p.values(), other["lengths"], 4, 512)

    with torch.no_grad():
        direct = run(leaves)
    kernels.launch_counts.reset()
    out = run(leaves)
    torch.cuda.synchronize()
    launched = {k: n for k, n in kernels.launch_counts.snapshot().items() if n}
    want = {"entry_embed": {"entry_embed": 1}, "ln_ffn": {"ln_ffn": 1},
            "attention_block": {"ln_qkv_rope": 1, "flash_outproj": 1}}[op]
    assert torch.equal(out.detach(), direct) and launched == want
    cot = torch.randn(out.shape, generator=g, device=dev).to(out.dtype)
    grads = torch.autograd.grad(out, list(leaves.values()), cot)

    plain = {k: v.clone().requires_grad_(True) for k, v in diff.items()}
    if op == "entry_embed":
        wc = fused.col_proj_table(plain["w_embT"], plain["w_qT"])
        p_out = fused._entry_embed_plain(other["bases"], plain["quals"], wc, plain["cb"],
                                         torch.bfloat16)
    elif op == "ln_ffn":
        p_out = fused._ln_ffn_plain(*plain.values())
    else:
        p_out = fused._attention_block_plain(*plain.values(), other["lengths"], 4, 512)
    p_grads = torch.autograd.grad(p_out, list(plain.values()), cot)
    for name, a, b in zip(diff, grads, p_grads):
        assert torch.isfinite(a).all() and bool(a.abs().max() > 0), name
        assert float((a.float() - b.float()).abs().max()) == 0.0, name


@pytest.mark.gpu
def test_int8_training_refused_on_card():
    """int8 is no longer refused under autograd on the card (the name is the
    refusal this test held before): an int8 step of a one-layer R10 model
    (remat off) launches K4, K10, K2 and K11 once each, its forward equals
    the no-grad forward bit for bit, and every parameter gets a finite
    gradient; ``attention_block_q`` and ``ln_ffn_q`` at the R10 widths give
    the gradients of autograd through their plain versions, exactly."""
    dev = _card()
    cfg = ModelConfig(d_model=512, n_layers=1, n_heads=4, d_ff=1024, local_window=512,
                      int8=True, remat=False)
    model = CorrectionModel(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    bases = torch.randint(0, 12, (2, 31, 512), generator=g, device=dev).to(torch.uint8)
    quals = torch.rand(2, 31, 512, generator=g, device=dev) * 2 - 1
    sidx = torch.randint(0, 512, (2, 8), generator=g, device=dev).sort(dim=1).values.int()
    smask = torch.ones(2, 8, dtype=torch.bool, device=dev)
    with torch.no_grad():
        direct = model(bases, quals, sidx, smask)
    kernels.launch_counts.reset()
    info, logits = model(bases, quals, sidx, smask)
    torch.cuda.synchronize()
    launched = {k: n for k, n in kernels.launch_counts.snapshot().items() if n}
    assert launched == {"entry_embed": 1, "ln_qkv_rope_q": 1, "flash_outproj": 1,
                        "ln_ffn_q": 1}
    assert torch.equal(info.detach(), direct[0]) and torch.equal(logits.detach(), direct[1])
    grads = torch.autograd.grad(info.sum() + logits.square().sum(), list(model.parameters()))
    assert all(bool(torch.isfinite(t).all()) for t in grads)

    w = model.blocks[0].compute_weights()
    blk = model.blocks[0]
    x = (torch.randn(2, 1024, 512, generator=g, device=dev)).to(torch.bfloat16)
    lengths = torch.tensor([1024, 700], dtype=torch.int32, device=dev)
    ops = {  # (float leaves, the op, its plain version) on those leaves
        "attention_block_q": (
            dict(x=x, ln_s=blk.ln1.scale.detach(), ln_b=blk.ln1.bias.detach(),
                 s=w["sqkv"].detach(), b=w["b_qkv"].detach(), wo=w["wo"].detach(),
                 bo=w["bo"].detach() + 0.1),
            lambda p: fused.attention_block_q(p["x"], p["ln_s"], p["ln_b"], w["wqkv_i8"],
                                              p["s"], p["b"], p["wo"], p["bo"], lengths, 4,
                                              512),
            lambda p: fused._attention_shard_q_plain(p["x"], p["x"], p["ln_s"], p["ln_b"],
                                                     w["wqkv_i8"], p["s"], p["b"], p["wo"],
                                                     p["bo"], lengths, 4, 512)),
        "ln_ffn_q": (
            dict(x=x, scale=blk.ln2.scale.detach(), bias=blk.ln2.bias.detach(),
                 s1=w["s1"].detach(), b1=w["b1"].detach() + 0.1, s2=w["s2"].detach(),
                 b2=w["b2"].detach() + 0.1),
            lambda p: fused.ln_ffn_q(p["x"], p["scale"], p["bias"], w["w1_i8"], p["s1"],
                                     p["b1"], w["w2_i8"], p["s2"], p["b2"]),
            lambda p: fused._ln_ffn_q_plain(p["x"], p["scale"], p["bias"], w["w1_i8"],
                                            p["s1"], p["b1"], w["w2_i8"], p["s2"], p["b2"])),
    }
    for op, (inputs, fn, plain) in ops.items():
        leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
        out = fn(leaves)
        cot = torch.randn(out.shape, generator=g, device=dev).to(out.dtype)
        got = torch.autograd.grad(out, list(leaves.values()), cot)
        ref = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
        want = torch.autograd.grad(plain(ref), list(ref.values()), cot)
        for name, a, b in zip(inputs, got, want):
            assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0, (op, name)
            assert torch.equal(a, b), (op, name)
