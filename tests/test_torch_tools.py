"""The port's tools (``tools/*_torch.py``) held against the reference's tools.

Each ported tool runs here on the CPU at a reduced size, beside its JAX tool
(``tools/*.py``) on the same inputs:

* ``eval_battery_torch.run_battery`` equals ``eval_battery.run_battery`` in
  every field, both modules' ``DEFAULTS`` cut alike (float32 ``tiny``
  weights written once and read by both packages: the runs are then equal
  byte for byte, as ``tests/test_torch_eval.py`` holds for ``evaluate``);
* the soup of two shipped checkpoints within 1 float32 ulp of the
  reference tool's, and loading in herro_tpu;
* the fine-tune's shard mix resolving to the reference's ``SimProfile``s,
  two of its steps equal to the reference ``Trainer``'s within 1e-5, and a
  curriculum cache that herro_tpu wrote refused by name;
* the systematic audit equal to the reference's on one simulation;
* the ablation's toggled forward within 2e-4 of the reference's in float32
  (both sum a few thousand float32 products in other orders);
* the step-time probe's parameter counts and example batch equal to the
  reference's;
* ``profile_e2e_torch`` end to end with ``device="cpu"``;
* K1-K4's plain versions at the d 384 width the new kernel instances take
  against the JAX jnp twins, 1e-4 (2e-4 after the out projection), as
  ``tests/test_torch_kernels.py`` at its widths.

Every test runs under a time limit of its own (``SIGALRM``).
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
sys.path.insert(0, TOOLS)

import ablate_fused_torch  # noqa: E402
import diag_systematic_torch  # noqa: E402
import eval_battery_torch  # noqa: E402
import finetune_sys_torch  # noqa: E402
import profile_e2e_torch  # noqa: E402
import soup_ckpt_torch  # noqa: E402
import variant_step_time_torch  # noqa: E402

from herro_tpu_torch.models.checkpoint import load_or_init, params_to_jax, save_model  # noqa: E402
from herro_tpu_torch.models.model import CorrectionModel, ModelConfig  # noqa: E402
from herro_tpu_torch.ops import fused  # noqa: E402


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


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """Seeded float32 ``tiny`` weights as a checkpoint directory both
    packages read (their own random inits differ)."""
    path = str(tmp_path_factory.mktemp("tools") / "tiny")
    cfg, params = load_or_init("tiny")
    save_model(path, cfg, params)
    return path


# ---------------------------------------------------------------------------
# eval battery and its gate
# ---------------------------------------------------------------------------

SMALL_DEFAULTS = dict(window_size=512, genome_len=4000, n_reads=20, sub_rate=0.02,
                      ins_rate=0.02, del_rate=0.02, het_rate=0.005, seed=12345,
                      batch_size=4)


@time_limit(240)
def test_run_battery_equals_reference(tiny_ckpt, monkeypatch):
    import eval_battery

    for mod in (eval_battery, eval_battery_torch):
        monkeypatch.setattr(mod, "DEFAULTS", dict(SMALL_DEFAULTS))
    assert eval_battery_torch.REGIMES == eval_battery.REGIMES
    # one regime runs every step of the loop: the oracle, the model with its
    # counting baseline, and the profile resolved to the simulator's kwargs
    regimes = ["systematic"]
    want = eval_battery.run_battery([tiny_ckpt], regimes, with_oracle=True)
    got = eval_battery_torch.run_battery([tiny_ckpt], regimes, with_oracle=True,
                                         device="cpu")
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    entry = got["regimes"]["systematic"]
    assert entry["params"]["sim_extra"]["sys_rate"] == 0.002
    assert set(entry) == {"params", "oracle", tiny_ckpt}
    assert "counting_baseline" in entry[tiny_ckpt]


@time_limit(60)
def test_merge_battery_gates_the_committed_battery(tmp_path, monkeypatch, capsys):
    """No ``--run``: the gate over the committed battery, the incumbent against
    itself, passes, and the file is written back unchanged in content."""
    import merge_battery_torch

    bat = tmp_path / "battery.json"
    with open(os.path.join(ROOT, "resources", "eval_battery.json")) as fh:
        original = json.load(fh)
    bat.write_text(json.dumps(original))
    monkeypatch.setattr(sys, "argv", ["merge_battery_torch.py", str(bat),
                                      "resources/model_r10_sim"])
    merge_battery_torch.main()
    out = capsys.readouterr().out
    assert "gate: PASS" in out and "+0.00 dB" in out
    assert json.loads(bat.read_text()) == original


# ---------------------------------------------------------------------------
# soup, fine-tune
# ---------------------------------------------------------------------------


@time_limit(120)
def test_soup_within_one_ulp_of_reference(tmp_path, monkeypatch):
    import soup_ckpt
    from herro_tpu.models.checkpoint import load_model as jload

    base = os.path.join(ROOT, "resources", "model_r10_sim")
    other = os.path.join(ROOT, "resources", "model_r10_sys")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    soup_ckpt_torch.soup(base, other, ours, 0.3)
    monkeypatch.setattr(sys, "argv", ["soup_ckpt.py", base, other, theirs, "--alpha", "0.3"])
    soup_ckpt.main()
    cfg_p, got = jload(ours)  # the port's soup loads in herro_tpu
    cfg_r, want = jload(theirs)
    assert cfg_p == cfg_r
    got, want, start = _flat(got), _flat(want), _flat(jload(base)[1])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        ulps = np.abs(got[k].view(np.int32).astype(np.int64)
                      - want[k].view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, (k, ulps.max())
    assert any(np.abs(want[k] - start[k]).max() > 0 for k in want)  # a real mix


def test_soup_refuses_a_topology_mismatch(tmp_path):
    with pytest.raises(ValueError, match="topology mismatch"):
        soup_ckpt_torch.soup(os.path.join(ROOT, "resources", "model_r10_sim"),
                             os.path.join(ROOT, "resources", "model_r9_sim"),
                             str(tmp_path / "out"), 0.5)
    assert not os.path.exists(tmp_path / "out")


def _reference_mix_names() -> tuple[str, ...]:
    """The shard names tools/finetune_sys.py hard-codes in its main()."""
    tree = ast.parse(open(os.path.join(TOOLS, "finetune_sys.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.GeneratorExp) and isinstance(node.generators[0].iter,
                                                             ast.Tuple):
            return tuple(e.value for e in node.generators[0].iter.elts)
    raise AssertionError("no shard tuple in tools/finetune_sys.py")


def test_finetune_mix_resolves_to_reference_profiles():
    from herro_tpu.training.data import CURRICULUM as JCURRICULUM

    names = _reference_mix_names()
    assert finetune_sys_torch.MIX == names and len(names) == 10
    by_name = {p.name: p for p in JCURRICULUM}
    got = finetune_sys_torch.mix_profiles()
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(by_name[n]) for n in names]


@time_limit(120)
def test_finetune_two_steps_equal_reference(tmp_path, monkeypatch):
    """Two steps of the tool's loop on small windows, the bucket ladder cut to
    one (256, 64) bucket on both sides (the ladder's smallest, 5120 columns,
    takes tens of seconds a step on the CPU)."""
    from herro_tpu.models.model import TINY_CONFIG, init_params
    from herro_tpu.training.data import bucketed_batch_iterator as jbatches
    from herro_tpu.training.train import Trainer as JaxTrainer
    from herro_tpu_torch.models.checkpoint import load_model, params_from_jax
    from herro_tpu_torch.training import data as tdata
    from herro_tpu_torch.training.data import simulated_windows
    from herro_tpu_torch.training.simulate import simulate

    ladder = ((256, 64),)
    monkeypatch.setattr(tdata, "bucketed_batch_iterator",
                        functools.partial(tdata.bucketed_batch_iterator, buckets=ladder))

    ds = simulate(genome_len=2000, n_reads=40, read_len=(600, 1100), sub_rate=0.05,
                  ins_rate=0.03, del_rate=0.03, seed=5)
    windows = simulated_windows(ds, str(tmp_path / "r.fastq"), 256, min_overlap=150)
    params = jax.tree_util.tree_map(np.asarray, init_params(TINY_CONFIG,
                                                            jax.random.PRNGKey(0)))
    cfg = ModelConfig(**dataclasses.asdict(TINY_CONFIG))
    out = str(tmp_path / "ft")
    trainer = finetune_sys_torch.finetune(windows, cfg, params_from_jax(params), out,
                                          steps=2, lr=0.3, batch_size=4, device="cpu")
    jt = JaxTrainer(TINY_CONFIG, params, lr=0.3, total_steps=2, hard_weight=3.0)
    for _, batch in zip(range(2), jbatches(windows, 4, n_epochs=10_000, seed=0,
                                           buckets=ladder)):
        jt.train_step(batch)
    assert trainer.state.step == 2
    want = _flat(jax.tree_util.tree_map(np.asarray, jt.state.params))
    got = _flat(params_to_jax(load_model(out)[1]))  # what the tool saved
    start = _flat(params)
    assert set(got) == set(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-5, k
    assert any(np.abs(want[k] - start[k]).max() > 1e-3 for k in want)


@time_limit(120)
def test_finetune_refuses_a_cache_herro_tpu_wrote(tmp_path):
    from herro_tpu.training.data import SimProfile as JProfile
    from herro_tpu.training.data import profile_windows as jprofile_windows
    from herro_tpu_torch.training.data import SimProfile, profile_windows

    kw = dict(name="tiny-shard", sub_rate=0.05, ins_rate=0.03, del_rate=0.03,
              het_rate=0.0, n_reads=8, genome_len=1500, seed=3)
    theirs, ours = tmp_path / "theirs", tmp_path / "ours"
    jprofile_windows(JProfile(**kw), 128, cache_dir=str(theirs))
    profile_windows(SimProfile(**kw), 128, cache_dir=str(ours))
    foreign = finetune_sys_torch.foreign_caches(str(theirs), [SimProfile(**kw)], 128)
    assert foreign == [str(theirs / "tiny-shard-w128-v3.pkl")]
    assert finetune_sys_torch.pickled_module(foreign[0]) == "herro_tpu.training.data"
    assert finetune_sys_torch.foreign_caches(str(ours), [SimProfile(**kw)], 128) == []
    assert finetune_sys_torch.foreign_caches(str(tmp_path / "none"),
                                             [SimProfile(**kw)], 128) == []


# ---------------------------------------------------------------------------
# systematic audit
# ---------------------------------------------------------------------------


@time_limit(120)
def test_audit_equals_reference(tmp_path):
    """Both audits over the raw reads of one systematic simulation, written as
    a corrected FASTA (every error class occurs in them)."""
    import diag_systematic
    from herro_tpu.training.eval import SIM_PROFILES as JPROFILES
    from herro_tpu.training.simulate import simulate as jsimulate
    from herro_tpu_torch.training.eval import SIM_PROFILES
    from herro_tpu_torch.training.simulate import simulate

    kw = dict(diag_systematic_torch.SIM_KW, genome_len=20_000, n_reads=20,
              read_len=(1500, 4000))
    ds = simulate(**kw, **SIM_PROFILES["systematic"])
    jds = jsimulate(**kw, **JPROFILES["systematic"])
    fasta = tmp_path / "raw.fasta"
    with open(fasta, "wb") as fh:
        for r in ds.reads:
            fh.write(b">" + r.name + b":0\n" + r.seq + b"\n")
    got = diag_systematic_torch._audit(ds, None, str(fasta))
    want = diag_systematic._audit(jds, None, str(fasta))
    assert got == want
    assert got["normal"]["errors"] > 0 and sum(b["covered"] for b in got["buckets"]) > 0


# ---------------------------------------------------------------------------
# ablation, step time
# ---------------------------------------------------------------------------

# a float32 model with the R10 layout at small widths: H 2 x D 32, a band
ABLATE_CFG = ModelConfig(d_model=64, n_layers=2, n_heads=2, d_ff=128, local_window=48,
                         dtype="float32")


def _reference_toggled_forward(params, tokens, quals, sidx, cfg, *, attn=True, ffn=True,
                               entry=True, qkv_only=False, heads=True, final_ln=True):
    """tools/ablate_fused.py:step_variant's ``fwd`` on herro_tpu's ops (the
    reference keeps it inside a function that times it on the chip)."""
    import jax.numpy as jnp
    from herro_tpu.constants import TOKEN_PAD, VOCAB_SIZE
    from herro_tpu.ops import fused as jf

    dt = jnp.float32
    Bb, R, Ll = tokens.shape
    p = params["params"]
    ck, cb = p["col_proj"]["kernel"], p["col_proj"]["bias"]
    idx = np.arange(R * (VOCAB_SIZE + 1)).reshape(R, VOCAB_SIZE + 1)
    w_emb = ck[idx[:, :VOCAB_SIZE].reshape(-1)]
    w_q = ck[idx[:, VOCAB_SIZE]]
    if entry:
        x = jf.entry_embed(tokens, quals, w_emb.T, w_q.T, cb, dt)
    else:
        x = jnp.zeros((Bb, Ll, cfg.d_model), dt) + quals[:, 0, :, None]
    lengths = (tokens[:, 0, :] != TOKEN_PAD).astype(jnp.int32).sum(axis=1)
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    for i in range(cfg.n_layers):
        bp = p[f"block_{i}"]
        qkv_k = bp["attn"]["qkv"]["kernel"].reshape(cfg.d_model, 3 * h * dh)
        qkv_b = bp["attn"]["qkv"]["bias"].reshape(3 * h * dh)
        if attn and qkv_only:
            q_, k_, v_ = jf.ln_qkv_rope(x, bp["ln1"]["scale"], bp["ln1"]["bias"], qkv_k,
                                        qkv_b, h)
            mix = q_.sum(axis=(1, 3)) + k_.sum(axis=(1, 3)) + v_.sum(axis=(1, 3))
            x = x + mix[:, :, None] * 1e-6
        elif attn:
            x = jf.attention_block(
                x, bp["ln1"]["scale"], bp["ln1"]["bias"], qkv_k, qkv_b,
                bp["attn"]["out"]["kernel"].reshape(h, dh, cfg.d_model),
                bp["attn"]["out"]["bias"], lengths, h, cfg.local_window)
        if ffn:
            x = jf.ln_ffn(x, bp["ln2"]["scale"], bp["ln2"]["bias"], bp["ff1"]["kernel"],
                          bp["ff1"]["bias"], bp["ff2"]["kernel"], bp["ff2"]["bias"])
    if not heads:
        Sn = sidx.shape[1]
        return x[:, :Sn, 0], x[:, :Sn, :5]
    g = jnp.take_along_axis(x, sidx[..., None], axis=1)
    if final_ln:
        mu = g.mean(-1, keepdims=True)
        var = jnp.maximum((g * g).mean(-1, keepdims=True) - mu * mu, 0.0)
        g = (g - mu) * jax.lax.rsqrt(var + 1e-6) * p["ln_f"]["scale"] + p["ln_f"]["bias"]
    logits = g @ p["bases_head"]["kernel"] + p["bases_head"]["bias"]
    info = (g @ p["info_head"]["kernel"] + p["info_head"]["bias"])[..., 0]
    return info, logits


@time_limit(120)
@pytest.mark.parametrize("toggles", [
    {},
    dict(qkv_only=True, ffn=False, final_ln=False),
    dict(attn=False, heads=False),
])
def test_ablation_forward_equals_reference(toggles):
    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu_torch.pipeline.batching import unpack_tokens_np
    from herro_tpu_torch.pipeline.steptime import example_batch

    model = CorrectionModel(ABLATE_CFG, generator=torch.Generator().manual_seed(7)).eval()
    packed, quals_u8, sidx, smask, _ = example_batch(2, 256, 32, seed=3)
    tokens = unpack_tokens_np(packed, N_ROWS)
    quals = (QUAL_SCALE * quals_u8.astype(np.float32) - QUAL_OFFSET).astype(np.float32)
    with torch.no_grad():
        got = ablate_fused_torch.toggled_forward(
            model, torch.from_numpy(tokens), torch.from_numpy(quals),
            torch.from_numpy(sidx), **toggles)
    params = jax.tree_util.tree_map(np.asarray, params_to_jax(model.state_dict()))
    want = _reference_toggled_forward(params, tokens, quals, sidx, ABLATE_CFG, **toggles)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=0)


@time_limit(60)
def test_variant_shapes_parameter_counts_equal_reference():
    """The reference tool's count (``n_params``: the sizes of
    ``init_params``'s leaves), read from the shapes alone."""
    from herro_tpu.models.model import R10_CONFIG as JR10
    from herro_tpu.models.model import init_params

    ref_cfgs = {
        "r10 d512x3L ff1024": JR10,
        "d384x5L ff1280": dataclasses.replace(JR10, d_model=384, n_layers=5, n_heads=3,
                                              d_ff=1280),
    }
    assert variant_step_time_torch.STEPS == ((64, 4608, 128), (32, 9216, 256))
    for name, cfg in variant_step_time_torch.SHAPES.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfgs[name])
        shapes = jax.eval_shape(lambda c=ref_cfgs[name]: init_params(c, jax.random.PRNGKey(0)))
        want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
        assert variant_step_time_torch.n_params(cfg) == want


def test_example_batch_equals_reference():
    from __graft_entry__ import _example_batch
    from herro_tpu_torch.pipeline.steptime import example_batch

    for got, want in zip(example_batch(4, 512, 32, seed=5), _example_batch(4, 512, 32, 5)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_step_timer_refuses_the_cpu():
    from herro_tpu_torch.pipeline.steptime import time_step

    with pytest.raises(RuntimeError, match="on the card"):
        time_step(lambda x: x, [[torch.zeros(2)]], windows=2)


# ---------------------------------------------------------------------------
# e2e profile
# ---------------------------------------------------------------------------


@time_limit(180)
def test_profile_e2e_runs_on_the_cpu(tiny_ckpt):
    r = profile_e2e_torch.profile(16, 6000, device="cpu", ckpt=tiny_ckpt, window_size=512,
                                  batch_size=4)
    assert r["device"] == "cpu" and r["windows"] > 0 and r["batches"] > 0
    stages = r["stages"]
    assert set(stages) == set(profile_e2e_torch.STAGES)
    for name in ("collate", "dispatch", "finalize", "device_wait", "extract"):
        assert stages[name]["calls"] > 0, name
    assert stages["dispatch"]["calls"] == stages["finalize"]["calls"] \
        == stages["device_wait"]["calls"] == r["batches"]
    assert r["launches"] == {}  # the CPU launches no kernel
    assert len(r["rows"]) == len(profile_e2e_torch.STAGES)


# ---------------------------------------------------------------------------
# K1-K4's plain versions at d 384 (H 3 x D 128, d_ff 1280)
# ---------------------------------------------------------------------------

D384, H384, F384, L384, HD = 384, 3, 1280, 128, 128


@time_limit(120)
def test_d384_plain_versions_match_jnp_twins():
    import jax.numpy as jnp
    from herro_tpu.ops import fused as jf

    rng = np.random.default_rng(384)
    B, R, V = 2, 31, 12
    lengths = np.array([L384, L384 - 50], np.int32)
    # K4: tokens (pad suffix) and quals
    tok = rng.integers(0, 11, size=(B, R, L384)).astype(np.uint8)
    tok[1, :, L384 - 50:] = 11
    quals = rng.uniform(-1, 1, size=(B, R, L384)).astype(np.float32)
    w_embT = rng.normal(0, 0.2, size=(D384, R * V)).astype(np.float32)
    w_qT = rng.normal(0, 0.2, size=(D384, R)).astype(np.float32)
    cb = rng.normal(0, 0.1, size=(D384,)).astype(np.float32)
    want = jf._entry_embed_jnp(*map(jnp.asarray, (tok, quals, w_embT, w_qT, cb)), jnp.float32)
    got = fused.entry_embed(torch.from_numpy(tok), torch.from_numpy(quals),
                            fused.col_proj_table(torch.from_numpy(w_embT),
                                                 torch.from_numpy(w_qT)),
                            torch.from_numpy(cb), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # K1 on that stream
    x = got.numpy()
    s = (1 + rng.normal(0, 0.1, size=(D384,))).astype(np.float32)
    b = rng.normal(0, 0.1, size=(D384,)).astype(np.float32)
    w = rng.normal(0, D384 ** -0.5, size=(D384, 3 * H384 * HD)).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(3 * H384 * HD,)).astype(np.float32)
    want = jf._ln_qkv_rope_jnp(*map(jnp.asarray, (x, s, b, w, bias)), H384)
    qkv = fused.ln_qkv_rope(*map(torch.from_numpy, (x, s, b, w, bias)), H384)
    for g, r in zip(qkv, want):
        assert g.shape == (B, H384, L384, HD)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)
    # K2 over the same q, k, v, band 64
    wo = rng.normal(0, 0.05, size=(H384, HD, D384)).astype(np.float32)
    bo = rng.normal(0, 0.1, size=(D384,)).astype(np.float32)
    q, k, v = (t.numpy() for t in qkv)
    want = np.asarray(jf._flash_outproj_jnp(
        *map(jnp.asarray, (q, k, v, x, wo, bo, lengths)), 64))
    y = fused.flash_outproj(*map(torch.from_numpy, (q, k, v, x, wo, bo, lengths)), 64).numpy()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(y[i, :n], want[i, :n], atol=2e-4, rtol=0)
    # K3 on the rows of that output
    rows = y.reshape(-1, D384)
    w1 = rng.normal(0, D384 ** -0.5, size=(D384, F384)).astype(np.float32)
    b1 = rng.normal(0, 0.1, size=(F384,)).astype(np.float32)
    w2 = rng.normal(0, F384 ** -0.5, size=(F384, D384)).astype(np.float32)
    b2 = rng.normal(0, 0.1, size=(D384,)).astype(np.float32)
    args = (rows, s, b, w1, b1, w2, b2)
    want = jf._ln_ffn_jnp(*map(jnp.asarray, args))
    got = fused.ln_ffn(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_d384_widths_are_taken_by_the_wrappers():
    """The new instances' widths pass the wrappers' checks (these CPU tensors
    then fail only the device check); K10 keeps 256 and 512."""
    assert 384 in fused.QKV_WIDTHS and 384 not in fused.QKV_Q_WIDTHS
    assert (3, 384) in fused.ATTENTION_WIDTHS
    assert 384 in fused.FFN_WIDTHS and 384 in fused.EMBED_WIDTHS
    bf = torch.bfloat16
    x = torch.zeros(1, 64, D384, dtype=bf)
    with pytest.raises(ValueError, match="not on the card"):
        fused._ln_qkv_rope_cuda(x, torch.ones(D384), torch.zeros(D384),
                                torch.zeros(D384, 3 * H384 * HD, dtype=bf),
                                torch.zeros(3 * H384 * HD, dtype=bf), H384)
    with pytest.raises(ValueError, match="not on the card"):
        fused._ln_ffn_cuda(x, torch.ones(D384), torch.zeros(D384),
                           torch.zeros(D384, F384, dtype=bf), torch.zeros(F384, dtype=bf),
                           torch.zeros(F384, D384, dtype=bf), torch.zeros(D384, dtype=bf))
