"""int8 under tensor parallelism: the port's sharded int8 model, runner and
CLI held against herro_tpu's int8 GSPMD runs, on CPU replicas (the reference
on the 8 virtual CPU devices of ``tests/conftest.py``).

herro_tpu runs ``--int8 --tp N`` by GSPMD over its jnp twins
(herro_tpu/pipeline/infer.py:153-163), which computes the one-device int8
function; the port shards the int8 kernels' plain versions (the kernels on
the card) and has to hit the same function:

* the port's int8 runner at tp 2 and over a 4 x 2 mesh (float32, d 32, H 2,
  d_ff 64) against ``CorrectionRunner(int8=True, mesh=make_mesh_2d(...))``:
  info within 1e-3 at the supported columns, classes and decisions equal;
  the TP model's logits against the reference model's within 1e-3;
* the flagship in bf16 with int8 at tp 2 (B=4, L=192) against herro_tpu's
  over ``make_mesh_2d(2, 2)``: classes agree on at least 0.99 of the
  supported columns, decisions equal;
* the FFN half's two passes (``ln_ffn_q_rowmax``, the maximum over shards,
  ``ln_ffn_q_rowscale``) summed over the shards against herro_tpu's
  ``_ln_ffn_q_jnp`` on the whole width, and a shard-local row scale
  missing that bar on the same inputs;
* the shards' int8 weights and scales, ``s2`` included, equal to slices of
  herro_tpu's ``quantize_weight`` of the whole weights;
* ``all_reduce_max`` and its gradient;
* ``inference --int8 --tp 2 --devices 2 --device cpu`` byte-identical to
  herro_tpu's CLI with the same arguments.

K11's two modes and K10 at the shard widths are held on the card in
``tests/test_torch_int8.py`` (the ``gpu`` tests live in files that import no
JAX at the top: the chip machine has none).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herro_tpu.models.model import ModelConfig as JaxConfig
from herro_tpu.models.model import CorrectionModel as JaxModel
from herro_tpu.models.model import init_params
from herro_tpu.parallel.tensor import make_mesh_2d as jax_mesh_2d
from herro_tpu.pipeline.infer import CorrectionRunner as JaxRunner
from herro_tpu_torch.models.checkpoint import load_model, params_from_jax
from herro_tpu_torch.models.model import CorrectionModel, ModelConfig
from herro_tpu_torch.ops import fused
from herro_tpu_torch.parallel import (
    TensorParallelModel,
    all_reduce,
    all_reduce_max,
    make_mesh_2d,
    shard_weights,
)
from herro_tpu_torch.pipeline.batching import Batch
from herro_tpu_torch.pipeline.infer import CorrectionRunner

from __graft_entry__ import _example_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R10_CKPT = os.path.join(ROOT, "resources", "model_r10_sim")
JCFG = JaxConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64, base_embed_dim=4,
                 dtype="float32", int8=True)
CFG = ModelConfig(**dataclasses.asdict(JCFG))
CPU = torch.device("cpu")
TOL = 1e-3  # the bar of tests/test_torch_int8.py for the int8 model in float32
# The port's one-device int8 forward and herro_tpu's sum LayerNorm and take
# tanh in other orders (torch against XLA): a float32 value one ulp apart can
# round to the next int8 step and move a column's outputs by about 0.02. On
# these weights and inputs one column of 44 does so at one device. The TP
# runs must equal the port's one device (ONE_DEVICE) and the reference within
# TOL on every other column, with at most this share of such columns.
ONE_DEVICE = 1e-5
MAX_FLIPPED = 1 / 40


@pytest.fixture(scope="module")
def setup():
    params = init_params(JCFG, jax.random.PRNGKey(7))
    batch = _example_batch(B=8, L=128, S=16, seed=5)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return params, sd, batch


def _jax_packed(runner, batch):
    info, packed = runner._step(runner.params, *batch)
    packed, S = np.asarray(packed), batch[2].shape[1]
    return np.asarray(info), packed[:, -S:], packed[:, :-S]


def _port_packed(runner, batch):
    info, packed = runner._fetch(runner.dispatch(Batch(*batch, windows=[])))
    S = batch[2].shape[1]
    return info, packed[:, -S:], packed[:, :-S]


def _hold(tp, one, want, smask):
    """The TP outputs ``tp`` against the port's one-device outputs ``one``
    (within ONE_DEVICE) and the reference's ``want`` (within TOL but for the
    columns where ``one`` is an int8 step off too, at most MAX_FLIPPED of
    them); classes (or argmax) and decisions as given by the caller."""
    tp, one, want = (np.asarray(a, np.float32) for a in (tp, one, want))
    if tp.ndim == 3:  # logits [B, S, 5]: a column's largest gap
        gap = lambda a, b: np.abs(a - b).max(-1)
    else:
        gap = lambda a, b: np.abs(a - b)
    assert gap(tp, one)[smask].max() <= ONE_DEVICE
    flipped = (gap(one, want) > TOL) & smask
    assert flipped.sum() <= MAX_FLIPPED * smask.sum(), flipped.sum()
    assert gap(tp, want)[smask & ~flipped].max() <= TOL


@pytest.mark.parametrize("n_data", [1, 4])
def test_int8_tp_runner_matches_reference(n_data, setup):
    """The port's int8 runner over an n_data x 2 mesh against herro_tpu's int8
    runner over its n_data x 2 mesh (GSPMD over the jnp twins)."""
    params, sd, batch = setup
    ref = JaxRunner(JCFG, params, mesh=jax_mesh_2d(n_data, 2), collect_info=True)
    assert ref.cfg.int8
    want = _jax_packed(ref, batch)

    runner = CorrectionRunner(CFG, sd, device="cpu", collect_info=True, int8=True,
                              mesh=make_mesh_2d(n_data, 2, [CPU] * (2 * n_data)))
    # the port's flag: the shards run the fused ops at their own widths
    assert runner.tp_fast_path and runner.cfg.int8 and len(runner.replicas) == n_data
    got = _port_packed(runner, batch)
    one = _port_packed(CorrectionRunner(CFG, sd, device="cpu", collect_info=True), batch)

    smask = batch[3]
    _hold(got[0], one[0], want[0], smask)
    np.testing.assert_array_equal(got[1][smask], want[1][smask])
    np.testing.assert_array_equal(got[2], want[2])


def test_int8_tp_logits_match_reference(setup):
    """The TP model's int8 logits against herro_tpu's int8 model (the
    function its GSPMD runner partitions) on the same inputs."""
    params, sd, _ = setup
    rng = np.random.default_rng(40)
    B, L, S = 3, 96, 16
    tok = rng.integers(0, 11, size=(B, 31, L)).astype(np.uint8)
    tok[1, :, 70:] = 11  # a padded suffix
    quals = rng.uniform(-1, 1, size=(B, 31, L)).astype(np.float32)
    sidx = np.sort(rng.integers(0, 70, size=(B, S)), axis=1).astype(np.int32)
    smask = np.ones((B, S), bool)
    smask[0, 12:] = False
    inputs = (tok, quals, sidx, smask)
    j_info, j_logits = JaxModel(JCFG).apply(params, *map(jax.numpy.asarray, inputs))
    model = TensorParallelModel(CFG, sd, [CPU, CPU])
    one = CorrectionModel(CFG)
    one.load_state_dict(sd)
    with torch.inference_mode():
        info, logits = model(*map(torch.from_numpy, inputs))
        one_info, one_logits = one(*map(torch.from_numpy, inputs))
    _hold(logits, one_logits, j_logits, smask)
    _hold(info, one_info, j_info, smask)
    np.testing.assert_array_equal(logits.numpy().argmax(-1)[smask],
                                  np.asarray(j_logits).argmax(-1)[smask])


def test_int8_tp_flagship_bf16():
    """The trained flagship in bf16 with int8 at tp 2 (heads 4 -> 2, d_ff 1024
    -> 512 a shard) against herro_tpu's int8 runner over make_mesh_2d(2, 2):
    bf16 and other summation orders, so classes, not logits."""
    from herro_tpu.models.checkpoint import load_or_init

    jcfg, jparams = load_or_init(R10_CKPT)
    batch = _example_batch(B=4, L=192, S=24, seed=11)
    ref = JaxRunner(jcfg, jparams, mesh=jax_mesh_2d(2, 2), int8=True)
    assert ref.cfg.int8 and ref.cfg.dtype == "bfloat16"
    want = _jax_packed(ref, batch)

    cfg, sd = load_model(R10_CKPT)
    runner = CorrectionRunner(cfg, sd, device="cpu", int8=True,
                              mesh=make_mesh_2d(2, 2, [CPU] * 4))
    got = _port_packed(runner, batch)
    assert (got[1] == want[1])[batch[3]].mean() >= 0.99
    np.testing.assert_array_equal(got[2], want[2])


def _ffn_inputs(seed, d=64, f=256, rows=512):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    s = (1 + rng.normal(0, 0.1, size=(d,))).astype(np.float32)
    b = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    w1 = rng.normal(0, d ** -0.5, size=(d, f)).astype(np.float32)
    b1 = rng.normal(0, 0.1, size=(f,)).astype(np.float32)
    w2 = rng.normal(0, f ** -0.5, size=(f, d)).astype(np.float32)
    b2 = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    return x, s, b, w1, b1, w2, b2


def _ffn_shards(tp, x, s, b, w1, b1, w2, b2, row_scale="global"):
    """The TP FFN half on CPU shards: the reference's int8 weights of the
    whole width cut into shards, pass A on each, the maximum over shards
    (or each shard's own, ``row_scale="local"``), pass B, the sum."""
    from herro_tpu.ops import fused as jfused

    (q1, s1), (q2, s2) = (tuple(torch.from_numpy(np.array(a)) for a in
                                jfused.quantize_weight(jax.numpy.asarray(w)))
                          for w in (w1, w2))
    t = torch.from_numpy
    fl = w1.shape[1] // tp
    xs, ln = t(x), (t(s), t(b))
    shard = [dict(w1_i8=q1[:, j * fl:(j + 1) * fl], s1=s1[j * fl:(j + 1) * fl],
                  b1=t(b1)[j * fl:(j + 1) * fl], w2_i8=q2[j * fl:(j + 1) * fl],
                  s2=s2, b2=t(b2) / tp) for j in range(tp)]
    hmax, ties = zip(*(fused.ln_ffn_q_rowmax(xs, *ln, w["w1_i8"], w["s1"], w["b1"])
                       for w in shard))
    if row_scale == "global":
        hmax = all_reduce_max(list(hmax), None if ties[0] is None else list(ties))
    parts = [fused.ln_ffn_q_rowscale(xs, *ln, w["w1_i8"], w["s1"], w["b1"], w["w2_i8"],
                                     w["s2"], w["b2"], m, 1.0 / tp)
             for w, m in zip(shard, hmax)]
    return all_reduce(parts)[0].numpy()


@pytest.mark.parametrize("tp", [2, 4])
def test_ffn_two_passes_match_whole_width(tp):
    """The two passes summed over tp shards equal herro_tpu's ``_ln_ffn_q_jnp``
    of the whole width within 1e-4 (float32: the shards' sums in another
    order); with each shard's own row maximum instead of the maximum over
    shards, the same inputs miss that bar by far."""
    from herro_tpu.ops import fused as jfused

    args = _ffn_inputs(3)
    jnp = jax.numpy
    (q1, s1), (q2, s2) = (jfused.quantize_weight(jnp.asarray(w)) for w in (args[3], args[5]))
    x, s, b, _, b1, _, b2 = (jnp.asarray(a) for a in args)
    want = np.asarray(jfused._ln_ffn_q_jnp(x, s, b, q1, s1, b1, q2, s2, b2))
    got = _ffn_shards(tp, *args)
    assert np.abs(got - want).max() <= 1e-4
    local = _ffn_shards(tp, *args, row_scale="local")
    assert np.abs(local - want).max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shard_int8_weights_are_slices_of_the_reference(dtype):
    """Each shard's int8 weights and scales are the slices of herro_tpu's
    ``quantize_weight`` of the whole weights, bit for bit: the qkv weight
    after its cast to the compute dtype, W1 and W2 from float32, and ``s2``
    (the maximum of each column over every shard's rows) whole on every
    shard."""
    from herro_tpu.ops import fused as jfused
    from herro_tpu_torch.parallel.tensor import block_params

    cfg = dataclasses.replace(CFG, dtype=dtype, d_ff=128)
    model = CorrectionModel(cfg, generator=torch.Generator().manual_seed(4))
    sd = model.state_dict()
    tp = 2
    shards = TensorParallelModel(cfg, sd, [CPU] * tp).compute_weights()
    jnp = jax.numpy
    jdt = getattr(jnp, dtype)
    for i, block in enumerate(model.blocks):
        w = {k: v.detach() for k, v in block_params(block).items()}
        want = {}
        for name, kernel in (("qkv", jnp.asarray(w["w_qkv"].numpy()).astype(jdt)),
                             ("1", jnp.asarray(w["w1"].numpy())),
                             ("2", jnp.asarray(w["w2"].numpy()))):
            q, sc = jfused.quantize_weight(kernel)
            want[name] = (torch.from_numpy(np.array(q)), torch.from_numpy(np.array(sc)))
        # the whole int8 weights cut as shard_weights cuts the float ones
        cut = [shard_weights(dict(w_qkv=want["qkv"][0], b_qkv=want["qkv"][1], wo=w["wo"],
                                  bo=w["bo"], w1=want["1"][0], b1=want["1"][1],
                                  w2=want["2"][0], b2=w["b2"]), tp, j) for j in range(tp)]
        for j, got in enumerate(s["blocks"][i] for s in shards):
            assert torch.equal(got["wqkv_i8"], cut[j]["w_qkv"])
            assert torch.equal(got["sqkv"], cut[j]["b_qkv"])
            assert torch.equal(got["w1_i8"], cut[j]["w1"]) and torch.equal(got["s1"],
                                                                          cut[j]["b1"])
            assert torch.equal(got["w2_i8"], cut[j]["w2"]) and torch.equal(got["s2"],
                                                                          want["2"][1])


def test_all_reduce_max_and_its_gradient():
    """One maximum on shard 0's device, shared by every shard; the gradient
    reaches the shard that holds each maximum, split evenly between tied
    shards."""
    a = torch.tensor([1.0, 5.0, 2.0, 3.0], requires_grad=True)
    b = torch.tensor([4.0, 1.0, 2.0, 3.0], requires_grad=True)
    out = all_reduce_max([a, b])
    assert out[0] is out[1] and torch.equal(out[0], torch.tensor([4.0, 5.0, 2.0, 3.0]))
    ga, gb = torch.autograd.grad(out[0].sum(), [a, b])
    assert torch.equal(ga, torch.tensor([0.0, 1.0, 0.5, 0.5]))
    assert torch.equal(gb, torch.tensor([1.0, 0.0, 0.5, 0.5]))
    assert all_reduce_max([a])[0] is a


@pytest.mark.parametrize("counts", [(2, 1), (1, 2), (2, 1, 0, 1), (1, 2, 2, 4), (4, 0, 2, 1)])
def test_all_reduce_max_gradient_shares_ties_by_element(counts):
    """Rows split into tp shards, shard j holding counts[j] elements equal to
    the row's maximum (row 0's maximum alone in shard 0): each shard's
    maximum (``amax``), its tied count, then ``all_reduce_max``. The gradient
    must equal ``jax.vjp`` of the reference's maximum over the whole row,
    which splits it evenly between the tied elements (not between the tied
    shards)."""
    tp, n, rows = len(counts), 8, 3
    rng = np.random.default_rng(sum(counts) + tp)
    x = rng.integers(0, 3, size=(rows, tp * n)).astype(np.float32)
    for j, c in enumerate(counts):
        x[:, j * n : j * n + c] = 9.0
    x[0, 0] = 10.0
    g = rng.normal(size=(rows,)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jnp.max(a, axis=-1), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    parts = xt.split(n, dim=-1)
    maxima = [p.amax(dim=-1) for p in parts]
    ties = [(p == m[:, None]).sum(dim=-1, dtype=torch.int32) for p, m in zip(parts, maxima)]
    out = all_reduce_max(maxima, ties)
    assert all(o is out[0] for o in out)
    np.testing.assert_array_equal(out[0].detach().numpy(), x.max(axis=-1))
    (gx,) = torch.autograd.grad((out[0] * torch.from_numpy(g)).sum(), [xt])
    np.testing.assert_array_equal(gx.numpy(), want)


@pytest.mark.parametrize("tp", [2, 4])
def test_rowmax_counts_its_ties(tp):
    """``ln_ffn_q_rowmax`` gives each row's maximum |h| over the shard's
    columns and, under autograd, how many of them reach it, as the plain
    hidden shows them; the count takes no gradient and the maximum's goes
    to the tied columns."""
    d, f, rows = 256, 512, 64
    x, s, b, w1, b1, _, _ = (np.asarray(a) for a in _ffn_inputs(90 + tp, d, f, rows))
    q1, s1 = fused.quantize_weight(torch.from_numpy(w1))
    fl = f // tp
    xs = torch.from_numpy(x).requires_grad_()
    args = (torch.from_numpy(s), torch.from_numpy(b), q1[:, :fl], s1[:fl],
            torch.from_numpy(b1)[:fl])
    assert fused.ln_ffn_q_rowmax(xs.detach(), *args)[1] is None  # asked under autograd only
    top, ties = fused.ln_ffn_q_rowmax(xs, *args)
    a = fused._ffn_q_hidden(xs.detach(), *args).abs()
    assert torch.equal(top.detach(), a.amax(dim=-1))
    assert ties.dtype == torch.int32 and not ties.requires_grad
    assert torch.equal(ties, (a == a.amax(dim=-1, keepdim=True)).sum(dim=-1, dtype=torch.int32))
    assert int(ties.min()) >= 1
    (gx,) = torch.autograd.grad(top.sum(), [xs])
    assert bool(torch.isfinite(gx).all()) and float(gx.abs().sum()) > 0


def test_cli_int8_tp_fasta_identical_to_reference(tmp_path):
    """``inference --int8 --tp 2 --devices 2 --device cpu`` on a saved float32
    TINY checkpoint writes the bytes herro_tpu's CLI writes with the same
    arguments."""
    from herro_tpu.cli import main as jax_cli_main
    from herro_tpu.models.model import TINY_CONFIG
    from herro_tpu_torch.cli import main as port_cli_main
    from herro_tpu_torch.models.checkpoint import save_model
    from herro_tpu_torch.overlaps.batches import BatchWriter
    from herro_tpu_torch.training.simulate import paf_rows, simulate

    ds = simulate(genome_len=2500, n_reads=24, read_len=(900, 1500), sub_rate=0.03,
                  ins_rate=0.01, del_rate=0.01, seed=21)
    fastq = str(tmp_path / "reads.fastq")
    ds.write_fastq(fastq)
    alns = str(tmp_path / "alns")
    with BatchWriter(alns, 0, [r.name for r in ds.reads]) as w:
        for line in paf_rows(ds, min_overlap=200):
            w.write(line)
    ckpt = str(tmp_path / "tiny")
    params = init_params(TINY_CONFIG, jax.random.PRNGKey(3))
    save_model(ckpt, ModelConfig(**dataclasses.asdict(TINY_CONFIG)),
               params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    outs = {}
    for name, main, extra in (("jax", jax_cli_main, []),
                              ("port", port_cli_main, ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.fasta")
        main(["inference", *extra, "--read-alns", alns, "-m", ckpt, "--int8", "--tp", "2",
              "--devices", "2", "-w", "256", "-b", "4", fastq, outs[name]])
    want = open(outs["jax"], "rb").read()
    assert want.count(b">") > 0 and open(outs["port"], "rb").read() == want
