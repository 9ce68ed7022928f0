"""float32 and narrow widths on the card: the four float32 kernels' plain
versions, the frozen float32 goldens and the reference's two kernel knobs.

* Each plain version that a float32 kernel (``csrc/*_f32.cu``) stands
  beside is held against herro_tpu's Pallas kernel in interpret mode at
  TINY_CONFIG's widths (d 32, H 2, D 16, d_ff 64), float32: the entry, both
  rope routes, ``flash_outproj`` at band None, 512 and 40, the FFN and
  ``attention()`` (K9). Tolerance as in ``tests/test_torch_kernels.py``:
  1e-4 absolute, 2e-4 after the out projection.
* The port's ``tiny`` and float32 ``r10`` forwards against the frozen JAX
  logits of ``tests/torch_data/`` (2e-4, argmax equal), and those files
  against herro_tpu rebuilding them (``make_float32_golden.py``).
* Each float32 wrapper names a width its kernel lacks in a ValueError
  before it looks at the device, and launches nothing.
* ``HERRO_TPU_PALLAS=0``, read at every call, refused on the card;
  ``HERRO_TPU_FLASH`` read nowhere.
* ``gpu``: each float32 kernel against its plain version on the card
  (skips inside the test without one).
"""

import importlib.util
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import attention as tattn
from herro_tpu_torch.ops import consensus, fused
from herro_tpu_torch.ops import cuda as kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "torch_data")
B, L, d, H, D, F_FF, R, V = 2, 512, 32, 2, 16, 64, 31, 12
ATOL = 1e-4


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "make_float32_golden", os.path.join(DATA, "make_float32_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import attention as jattn
    from herro_tpu.ops import fused as jfused

    return SimpleNamespace(jnp=jnp, pltpu=pltpu, fused=jfused, attn=jattn)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pileup(seed, B=B, L=L):
    rng = np.random.default_rng(seed)
    lengths = np.array([L, L - 70][:B], dtype=np.int32)
    n_alns = rng.integers(1, R, size=B).astype(np.int32)
    tok = rng.integers(0, 11, size=(B, R, L)).astype(np.uint8)
    tok[:, 0] = rng.integers(0, 5, size=(B, L))
    for b in range(B):
        tok[b, n_alns[b] + 1 :] = 11
        tok[b, :, lengths[b] :] = 11
    quals = rng.uniform(-1, 1, size=(B, R, L)).astype(np.float32)
    return tok, quals


def _embed_weights(seed, d=d, R=R):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.2, size=(d, R * V)).astype(np.float32),
            rng.normal(0, 0.2, size=(d, R)).astype(np.float32),
            rng.normal(0, 0.1, size=(d,)).astype(np.float32))


def _ln_params(rng, d=d):
    return ((1 + rng.normal(0, 0.1, size=(d,))).astype(np.float32),
            rng.normal(0, 0.1, size=(d,)).astype(np.float32))


def _qkv_inputs(seed, d=d, H=H, D=D, L=L, B=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    s, b = _ln_params(rng, d)
    w = rng.normal(0, d ** -0.5, size=(d, 3 * H * D)).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(3 * H * D,)).astype(np.float32)
    return x, s, b, w, bias


def _attn_inputs(seed, d=d, H=H, D=D, L=L, lengths=(L, L - 70)):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(len(lengths), H, L, D)).astype(np.float32) for _ in range(3))
    x = rng.normal(size=(len(lengths), L, d)).astype(np.float32)
    wo = rng.normal(0, 0.1, size=(H, D, d)).astype(np.float32)
    bo = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    return q, k, v, x, wo, bo, np.asarray(lengths, dtype=np.int32)


def _ffn_inputs(seed, d=d, f=F_FF, rows=B * L):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    s, b = _ln_params(rng, d)
    w1 = rng.normal(0, d ** -0.5, size=(d, f)).astype(np.float32)
    b1 = rng.normal(0, 0.1, size=(f,)).astype(np.float32)
    w2 = rng.normal(0, f ** -0.5, size=(f, d)).astype(np.float32)
    b2 = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    return x, s, b, w1, b1, w2, b2


def _close_valid_rows(got, want, lengths, atol, row_axis=1):
    """Rows at or past a window's length are padding no later stage reads:
    [B, L, ...] (row_axis 1) or [B, H, L, D] (row_axis 2)."""
    for b, n in enumerate(lengths):
        sl = (b, slice(None, n)) if row_axis == 1 else (b, slice(None), slice(None, n))
        np.testing.assert_allclose(got[sl], want[sl], atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# plain versions against herro_tpu's Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def test_entry_embed_plain_matches_pallas_interpret_at_tiny_width(ref):
    tok, quals = _pileup(60)
    w_embT, w_qT, cb = _embed_weights(61)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._entry_embed_pallas(
            *map(ref.jnp.asarray, (tok, quals, w_embT, w_qT, cb)), ref.jnp.float32,
            blk_l=128)
    wc = fused.col_proj_table(_t(w_embT), _t(w_qT))
    got = fused.entry_embed(_t(tok), _t(quals), wc, _t(cb), torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("route", ["tbl", "split"])
def test_ln_qkv_rope_plain_matches_pallas_interpret_at_tiny_width(route, ref, monkeypatch):
    """Both rope routes of the reference (tables handed in, tables built in
    the kernel) against the one plain version; the port reads
    ``HERRO_TPU_ROPE`` only to pick the kernel on the card."""
    monkeypatch.setenv("HERRO_TPU_ROPE", route)
    x, s, b, w, bias = _qkv_inputs(62)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._ln_qkv_rope_pallas(*map(ref.jnp.asarray, (x, s, b, w, bias)), H,
                                             blk_t=128, rope_tbl=route == "tbl")
    got = fused.ln_qkv_rope(*map(_t, (x, s, b, w, bias)), H)
    for g, r in zip(got, want):
        assert g.shape == (B, H, L, D)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=0)


@pytest.mark.parametrize("local_window", [None, 512, 40])
def test_flash_outproj_plain_matches_pallas_interpret_at_tiny_width(local_window, ref):
    """The reference's own choice of kernel at each band: the rotation-slot
    kernel (512), the banded one (40) and the full one (None)."""
    args = _attn_inputs(63)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._flash_outproj_pallas(*map(ref.jnp.asarray, args), local_window)
    got = fused.flash_outproj(*map(_t, args), local_window)
    _close_valid_rows(got.numpy(), np.asarray(want), args[-1], 2 * ATOL)


def test_ln_ffn_plain_matches_pallas_interpret_at_tiny_width(ref):
    args = _ffn_inputs(64)
    with ref.pltpu.force_tpu_interpret_mode():
        want = ref.fused._ln_ffn_pallas(*map(ref.jnp.asarray, args), blk_t=256)
    got = fused.ln_ffn(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("local_window", [None, 512, 40])
def test_flash_attention_plain_matches_pallas_interpret_at_tiny_width(local_window, ref):
    """K9's plain version (the float32 kernel's twin under ``attention()``
    on the card) against the reference's flash kernel, one example of
    length 0 (all zeros on both sides); ``attention()`` on the CPU (chunked)
    on the other rows."""
    q, k, v, _, _, _, lengths = _attn_inputs(65, lengths=(L, L - 70, 0))
    with ref.pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref.attn.flash_attention(*map(ref.jnp.asarray, (q, k, v, lengths)),
                                                   local_window))
    got = tattn._flash_attention_plain(*map(_t, (q, k, v, lengths)), local_window).numpy()
    _close_valid_rows(got, want, lengths, ATOL, row_axis=2)
    assert not got[2].any() and not want[2].any()
    chunked = tattn.attention(*map(_t, (q, k, v, lengths)), local_window)  # auto on the CPU
    _close_valid_rows(chunked.numpy(), want, lengths[:2], ATOL, row_axis=2)


# ---------------------------------------------------------------------------
# the frozen float32 goldens of tests/torch_data
# ---------------------------------------------------------------------------


def _port_forward(ckpt, fx, dtype=None):
    import dataclasses

    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.pipeline.batching import unpack_tokens_np

    cfg, sd = load_model(ckpt)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = CorrectionModel(cfg)
    model.load_state_dict(sd)
    inputs = (unpack_tokens_np(fx["tokens_packed"], N_ROWS),
              (QUAL_SCALE * fx["quals"].astype(np.float32) - QUAL_OFFSET).astype(np.float32),
              fx["support_idx"], fx["support_mask"])
    with torch.inference_mode():
        info, logits = model(*map(_t, inputs))
    return cfg, info.numpy(), logits.numpy()


GOLDENS = {
    "tiny": ("tiny_seed5", "golden_tiny_f32.npz", None, None),
    "r10_f32": ("../../resources/model_r10_sim", "golden_r10_f32.npz",
                "../golden/logits_r10.npz", "float32"),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_float32_forward_matches_frozen_jax_logits(name):
    ckpt, out, inputs, dtype = GOLDENS[name]
    want = np.load(os.path.join(DATA, out))
    fx = np.load(os.path.join(DATA, inputs)) if inputs else want
    cfg, info, logits = _port_forward(os.path.join(DATA, ckpt), fx, dtype)
    assert cfg.dtype == "float32"
    mask = fx["support_mask"]
    assert mask.sum() > 0
    assert np.abs(logits - want["logits"])[mask].max() <= 2e-4
    assert np.abs(info - want["info"])[mask].max() <= 2e-4
    np.testing.assert_array_equal(logits.argmax(-1)[mask], want["logits"].argmax(-1)[mask])


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_frozen_float32_goldens_rebuild_from_herro_tpu(name, tmp_path):
    """The JAX package rebuilds what the files hold: the same inputs and
    checkpoint bit for bit, the same logits within float32 noise of one
    XLA build against another."""
    from herro_tpu_torch.models.checkpoint import load_model

    mk = _golden_module()
    ckpt, out, _, _ = GOLDENS[name]
    frozen = np.load(os.path.join(DATA, out))
    if name == "tiny":
        got = mk.build_tiny()
        for key in ("tokens_packed", "quals", "support_idx", "support_mask", "n_alns"):
            np.testing.assert_array_equal(got[key], frozen[key])
        mk.write_tiny_checkpoint(str(tmp_path / "tiny"))
        (cfg_a, sd_a), (cfg_b, sd_b) = (load_model(p) for p in (str(tmp_path / "tiny"),
                                                                 os.path.join(DATA, ckpt)))
        assert cfg_a == cfg_b and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_b)
    else:
        got = mk.build_r10()
    for key in ("info", "logits"):
        np.testing.assert_allclose(got[key], frozen[key], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the float32 wrappers refuse what their kernels lack
# ---------------------------------------------------------------------------


def _entry_args(d=d, R=R):
    tok, quals = _pileup(70, L=64)
    tok = np.repeat(tok, -(-R // tok.shape[1]), axis=1)[:, :R]
    quals = np.repeat(quals, -(-R // quals.shape[1]), axis=1)[:, :R]
    w_embT, w_qT, cb = _embed_weights(71, d=d, R=R)
    return (_t(tok), _t(quals), fused.col_proj_table(_t(w_embT), _t(w_qT)), _t(cb),
            torch.float32)


def _refusal_case(op, width):
    """(wrapper, args) of a float32 op at ``width``: d_model, head dim, d_ff
    or pileup rows as the op has them."""
    if op == "entry_embed":
        key, val = width
        return fused._entry_embed_cuda, _entry_args(**{key: val})
    if op.startswith("ln_qkv_rope"):
        dd, hd = width
        x, s, b, w, bias = map(_t, _qkv_inputs(72, d=dd, H=2, D=hd, L=64))
        kernel = "ln_qkv_rope_f32" if op == "ln_qkv_rope" else "ln_qkv_rope_f32_split"
        return (lambda *a: fused._ln_qkv_rope_cuda(*a, kernel=kernel)), (x, s, b, w, bias, 2)
    if op in ("flash_outproj", "flash_outproj_full"):
        dd, hd = width
        args = list(map(_t, _attn_inputs(73, d=dd, D=hd, L=64, lengths=(64, 30))))
        return fused._flash_outproj_cuda, (*args, 40 if op == "flash_outproj" else None)
    if op == "flash_attention":
        q, k, v, _, _, _, lengths = map(_t, _attn_inputs(74, D=width, L=64, lengths=(64, 30)))
        return tattn._flash_attention_cuda, (q, k, v, lengths, 40)
    dd, f = width
    return fused._ln_ffn_cuda, tuple(map(_t, _ffn_inputs(75, d=dd, f=f, rows=64)))


@pytest.mark.parametrize(
    "op,width,match",
    [("entry_embed", ("d", 48), r"d_model 48: the float32 kernels take a multiple of 32"),
     ("entry_embed", ("d", 1056), r"d_model 1056"),
     ("entry_embed", ("R", 64), r"R 64 pileup rows")]
    + [(op, w, m) for op in ("ln_qkv_rope", "ln_qkv_rope_split", "flash_outproj",
                             "flash_outproj_full")
       for w, m in [((32, 8), r"head dim 8: the float32 kernels take a multiple of 16 from "
                               r"16 to 128"),
                    ((32, 256), r"head dim 256"), ((48, 16), r"d_model 48"),
                    ((1056, 16), r"d_model 1056")]]
    + [(op, (32, 48), r"head dim 48 at d_model 32: the float32 kernels take "
                      r"\(16, 32, 64, 128\)") for op in ("ln_qkv_rope", "ln_qkv_rope_split")]
    + [("flash_attention", 8, r"head dim 8"), ("flash_attention", 24, r"head dim 24"),
       ("flash_attention", 136, r"head dim 136")]
    + [("ln_ffn", (32, 48), r"d_ff 48: the float32 kernel takes a multiple of 32 up to 4096"),
       ("ln_ffn", (32, 4128), r"d_ff 4128"), ("ln_ffn", (40, 64), r"d_model 40")],
)
def test_float32_wrappers_name_widths_the_kernels_lack(op, width, match):
    """A float32 operand the float32 kernels do not take raises a ValueError
    that names its width before the wrapper looks at the device (these are
    CPU tensors), and launches nothing."""
    call, args = _refusal_case(op, width)
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match=match):
        call(*args)
    assert kernels.launch_counts.snapshot() == before


@pytest.mark.parametrize(
    "op,width",
    [("entry_embed", ("d", 32)), ("entry_embed", ("R", 1)), ("entry_embed", ("d", 1024)),
     ("ln_qkv_rope", (32, 16)), ("ln_qkv_rope_split", (512, 128)),
     ("ln_qkv_rope", (768, 96)), ("ln_qkv_rope_split", (1024, 48)),
     ("flash_outproj", (32, 16)), ("flash_outproj_full", (64, 64)),
     ("flash_outproj", (768, 96)), ("flash_outproj_full", (1024, 112)),
     ("flash_attention", 32), ("flash_attention", 80), ("ln_ffn", (32, 64)),
     ("ln_ffn", (1024, 4096))],
)
def test_float32_wrappers_take_their_widths_and_refuse_the_cpu(op, width):
    """At widths the float32 kernels take, the wrapper chooses the float32
    route by dtype and gets as far as the device, which it refuses: a CPU
    tensor never runs a kernel, nor its plain version through a wrapper."""
    call, args = _refusal_case(op, width)
    before = kernels.launch_counts.snapshot()
    with pytest.raises(ValueError, match="not on the card"):
        call(*args)
    assert kernels.launch_counts.snapshot() == before


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrappers_refuse_other_dtypes(dtype):
    """bf16 goes to the Hopper kernels, float32 to the float32 ones; any
    other dtype raises, naming what the kernels take."""
    x, s, b, w1, b1, w2, b2 = (t.to(dtype) if t.is_floating_point() else t
                               for t in map(_t, _ffn_inputs(76, d=256, f=256, rows=64)))
    with pytest.raises(ValueError, match="bfloat16"):
        fused._ln_ffn_cuda(x, s.float(), b.float(), w1, b1, w2, b2)


# ---------------------------------------------------------------------------
# the knobs, read at every call
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what ``on_card`` reads."""

    is_cuda = property(lambda self: True)


@pytest.mark.parametrize(
    "flash,local_window,dtype,name",
    [(None, 512, torch.bfloat16, "flash_outproj"), ("rot", 512, torch.bfloat16, "flash_outproj"),
     ("tile", 512, torch.bfloat16, "flash_outproj"),
     ("tile", 256, torch.bfloat16, "flash_outproj"),
     ("tile", 384, torch.bfloat16, "flash_outproj_band"),
     ("tile", None, torch.bfloat16, "flash_outproj_full"),
     (None, 384, torch.bfloat16, "flash_outproj_band"),
     (None, None, torch.float32, "flash_f32_full"), (None, 512, torch.float32, "flash_f32"),
     ("tile", 512, torch.float32, "flash_f32"), (None, 40, torch.float32, "flash_f32")],
)
def test_flash_route_is_chosen_by_band_and_dtype(flash, local_window, dtype, name, monkeypatch):
    """An aligned band takes K2, any other band K6, none K7; float32 has one
    banded kernel. The reference's ``HERRO_TPU_FLASH=tile`` has no
    counterpart in the port (K6 runs K2's instance at an aligned band), and
    moves nothing."""
    if flash is None:
        monkeypatch.delenv("HERRO_TPU_FLASH", raising=False)
    else:
        monkeypatch.setenv("HERRO_TPU_FLASH", flash)
    assert fused.flash_kernel_name(local_window, dtype) == name
    assert name in kernels.launch_counts.snapshot()


@pytest.mark.parametrize(
    "rope,dtype,name",
    [(None, torch.float32, "ln_qkv_rope_f32"), ("tbl", torch.float32, "ln_qkv_rope_f32"),
     ("split", torch.float32, "ln_qkv_rope_f32_split"),
     ("split", torch.bfloat16, "ln_qkv_rope_split"), (None, torch.bfloat16, "ln_qkv_rope")],
)
def test_rope_knob_picks_the_float32_route_at_the_call(rope, dtype, name, monkeypatch):
    if rope is None:
        monkeypatch.delenv("HERRO_TPU_ROPE", raising=False)
    else:
        monkeypatch.setenv("HERRO_TPU_ROPE", rope)
    assert fused.rope_kernel_name(dtype) == name
    assert name in kernels.launch_counts.snapshot()


def _knob_ops():
    """(op, args on tensors that say they are on the card, plain version)
    of every op whose reference counterpart reads ``_use_pallas()``."""
    oc = lambda t: t.as_subclass(_OnCard)
    tok, quals = _pileup(80, L=64)
    w_embT, w_qT, cb = _embed_weights(81)
    wc = fused.col_proj_table(_t(w_embT), _t(w_qT))
    entry = (oc(_t(tok)), oc(_t(quals)), oc(wc), oc(_t(cb)), torch.float32)
    qkv = (*map(lambda a: oc(_t(a)), _qkv_inputs(82, L=64)), H)
    attn = (*map(lambda a: oc(_t(a)), _attn_inputs(83, L=64, lengths=(64, 30))), 40)
    ffn = tuple(oc(_t(a)) for a in _ffn_inputs(84, rows=64))
    x, s, b, w1, b1, w2, b2 = ffn
    (q1, s1), (q2, s2) = fused.quantize_weight(w1), fused.quantize_weight(w2)
    ffn_q = (x, s, b, oc(q1), oc(s1), b1, oc(q2), oc(s2), b2)
    xq, sq, bq, wq, bias_q = qkv[:5]
    wq_i8, sq_col = fused.quantize_weight(wq)
    qkv_q = (xq, sq, bq, oc(wq_i8), oc(sq_col), bias_q, H)
    count = (oc(_t(tok)), oc(_t(np.array([5, 20], np.int32))))
    return {
        "entry_embed": (fused.entry_embed, entry, fused._entry_embed_plain),
        "ln_qkv_rope": (fused.ln_qkv_rope, qkv, fused._ln_qkv_rope_plain),
        "flash_outproj": (fused.flash_outproj, attn, fused._flash_outproj_plain),
        "ln_ffn": (fused.ln_ffn, ffn, fused._ln_ffn_plain),
        "ln_qkv_rope_q": (fused.ln_qkv_rope_q, qkv_q, fused._ln_qkv_rope_q_plain),
        "ln_ffn_q": (fused.ln_ffn_q, ffn_q, fused._ln_ffn_q_plain),
        "count_decisions": (consensus.count_decisions, count, consensus._count_decisions_plain),
    }


@pytest.mark.parametrize("op", sorted(_knob_ops()))
def test_pallas_knob_is_read_at_every_call(op, monkeypatch):
    """``HERRO_TPU_PALLAS=0`` makes a CUDA tensor raise a ValueError that
    names the setting, and launches nothing; set to 1 or unset again, the
    same call goes to the kernel's wrapper (which refuses these tensors,
    being on the CPU, on other grounds): the setting is read at the call, not
    when the module was imported. On CPU tensors it changes nothing."""
    call, args, plain = _knob_ops()[op]
    cpu = tuple(a.as_subclass(torch.Tensor) if isinstance(a, torch.Tensor) else a
                for a in args)
    before = kernels.launch_counts.snapshot()
    monkeypatch.setenv("HERRO_TPU_PALLAS", "0")
    with pytest.raises(ValueError, match="HERRO_TPU_PALLAS=0"):
        call(*args)
    got, want = call(*cpu), plain(*cpu)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    # past its checks of shapes and dtypes, a wrapper stops where it would
    # take the operands' device pointers (these lie on the CPU)
    def no_card(**tensors):
        raise ValueError("the operands are on the CPU")

    monkeypatch.setattr(kernels, "require_operands", no_card)
    monkeypatch.setenv("HERRO_TPU_PALLAS", "1")
    with pytest.raises(ValueError) as refused:
        call(*args)
    assert "HERRO_TPU_PALLAS" not in str(refused.value)
    monkeypatch.delenv("HERRO_TPU_PALLAS")
    with pytest.raises(ValueError) as refused:
        call(*args)
    assert "HERRO_TPU_PALLAS" not in str(refused.value)
    assert kernels.launch_counts.snapshot() == before


@pytest.mark.parametrize("setting", ["0", "1", None])
def test_on_card_refuses_the_pallas_knob_only_on_the_card(setting, monkeypatch):
    """``on_card``: False on the CPU whatever the setting; True on the card,
    or a ValueError there under ``HERRO_TPU_PALLAS=0``: no op runs its plain
    version on a CUDA tensor."""
    if setting is None:
        monkeypatch.delenv("HERRO_TPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("HERRO_TPU_PALLAS", setting)
    assert kernels.on_card(torch.zeros(2)) is False
    x = torch.zeros(2).as_subclass(_OnCard)
    if setting == "0":
        with pytest.raises(ValueError, match="HERRO_TPU_PALLAS=0"):
            kernels.on_card(x)
    else:
        assert kernels.on_card(x) is True


# ---------------------------------------------------------------------------
# the float32 kernels against their plain versions, on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(fn):
    before = kernels.launch_counts.snapshot()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    return out, {n: after[n] - before[n] for n in after if after[n] != before[n]}


# (d, H, D, d_ff): TINY_CONFIG, r10 in float32, a tensor-parallel shard of
# r10 (H 1), and head dims 32 and 64
GPU_WIDTHS = [(32, 2, 16, 64), (512, 4, 128, 1024), (512, 1, 128, 512), (64, 2, 32, 128),
              (256, 4, 64, 2048)]
GPU_LENGTHS = [(1024, (1024, 1000, 77, 0)), (1000, (1000, 937, 600, 1))]


@pytest.mark.gpu
@pytest.mark.parametrize("gl,lengths", GPU_LENGTHS)
@pytest.mark.parametrize("dd", [32, 512])
def test_entry_embed_f32_kernel_matches_plain_on_card(dd, gl, lengths):
    dev = _card()
    tok, quals = _pileup(90, B=2, L=gl)
    w_embT, w_qT, cb = _embed_weights(91, d=dd)
    wc = fused.col_proj_table(_t(w_embT).to(dev), _t(w_qT).to(dev))
    args = (_t(tok).to(dev), _t(quals).to(dev), wc, _t(cb).to(dev), torch.float32)
    got, launched = _launched(lambda: fused._entry_embed_cuda(*args))
    assert launched == {"entry_embed_f32": 1}
    np.testing.assert_allclose(got.cpu().numpy(), fused._entry_embed_plain(*args).cpu().numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("gl,lengths", GPU_LENGTHS)
@pytest.mark.parametrize("width", GPU_WIDTHS)
def test_ln_qkv_rope_f32_kernel_matches_plain_on_card(width, gl, lengths):
    """Both routes within 1e-4 of the plain version, and the split route
    (tables built in the kernel) bit-equal to the table route."""
    dev = _card()
    dd, hh, hd, _ = width
    args = tuple(_t(a).to(dev) for a in _qkv_inputs(92, d=dd, H=hh, D=hd, L=gl)) + (hh,)
    want = fused._ln_qkv_rope_plain(*args)
    outs = {}
    for kernel in ("ln_qkv_rope_f32", "ln_qkv_rope_f32_split"):
        outs[kernel], launched = _launched(
            lambda: fused._ln_qkv_rope_cuda(*args, kernel=kernel))
        assert launched == {kernel: 1}
        for g, w in zip(outs[kernel], want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=ATOL, rtol=0)
    for a, b in zip(*outs.values()):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("gl,lengths", GPU_LENGTHS)
@pytest.mark.parametrize("width", GPU_WIDTHS)
@pytest.mark.parametrize("band", [None, 0, 40, 512, 5000])
def test_flash_f32_kernel_matches_plain_on_card(band, width, gl, lengths):
    """The out projection's two routes (band and full), 2e-4 on the valid
    rows, and K9's mode, 1e-4 on the valid rows and 0 on a length-0
    example."""
    dev = _card()
    dd, hh, hd, _ = width
    q, k, v, x, wo, bo, lens = (
        _t(a).to(dev) for a in _attn_inputs(93, d=dd, H=hh, D=hd, L=gl, lengths=lengths))
    got, launched = _launched(
        lambda: fused._flash_outproj_cuda(q, k, v, x, wo, bo, lens, band))
    assert launched == {fused.flash_kernel_name(band, torch.float32): 1}
    want = fused._flash_outproj_plain(q, k, v, x, wo, bo, lens, band)
    _close_valid_rows(got.cpu().numpy(), want.cpu().numpy(), lengths, 2 * ATOL)
    got, launched = _launched(lambda: tattn._flash_attention_cuda(q, k, v, lens, band))
    assert launched == {"flash_f32_attention": 1}
    want = tattn._flash_attention_plain(q, k, v, lens, band)
    _close_valid_rows(got.cpu().numpy(), want.cpu().numpy(), lengths, ATOL, row_axis=2)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [2048, 1000, 37])
@pytest.mark.parametrize("width", GPU_WIDTHS)
def test_ln_ffn_f32_kernel_matches_plain_on_card(width, rows):
    dev = _card()
    dd, _, _, f = width
    args = tuple(_t(a).to(dev) for a in _ffn_inputs(94, d=dd, f=f, rows=rows))
    got, launched = _launched(lambda: fused._ln_ffn_cuda(*args))
    assert launched == {"ln_ffn_f32": 1}
    np.testing.assert_allclose(got.cpu().numpy(), fused._ln_ffn_plain(*args).cpu().numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_tiny_model_runs_the_float32_kernels_on_card():
    """The seeded tiny checkpoint's forward on the card launches the four
    float32 kernels and no bf16 instance, and lands within 2e-4 of the
    frozen JAX logits."""
    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.pipeline.batching import unpack_tokens_np

    dev = _card()
    fx = np.load(os.path.join(DATA, "golden_tiny_f32.npz"))
    cfg, sd = load_model(os.path.join(DATA, "tiny_seed5"))
    model = CorrectionModel(cfg)
    model.load_state_dict(sd)
    model = model.to(dev).eval()
    inputs = (unpack_tokens_np(fx["tokens_packed"], N_ROWS),
              (QUAL_SCALE * fx["quals"].astype(np.float32) - QUAL_OFFSET).astype(np.float32),
              fx["support_idx"], fx["support_mask"])
    with torch.inference_mode():
        (info, logits), launched = _launched(lambda: model(*(_t(a).to(dev) for a in inputs)))
    assert launched == {"entry_embed_f32": 1, "ln_qkv_rope_f32": cfg.n_layers,
                        "flash_f32_full": cfg.n_layers, "ln_ffn_f32": cfg.n_layers}
    mask = fx["support_mask"]
    assert np.abs(logits.cpu().numpy() - fx["logits"])[mask].max() <= 2e-4
    assert np.abs(info.cpu().numpy() - fx["info"])[mask].max() <= 2e-4
    assert math.isfinite(float(logits[torch.from_numpy(mask).to(dev)].abs().max()))
