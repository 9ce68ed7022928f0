"""The frozen int8 goldens of ``tests/torch_data``, and why the int8 bars
stay above float32 noise.

* ``make_int8_golden.py`` froze herro_tpu's int8 ``info`` / ``logits`` of the
  seeded tiny checkpoint (``tiny_seed5``) on the inputs of
  ``golden_tiny_f32.npz``, and of ``model_r10_sim`` in float32 on those of
  ``tests/golden/logits_r10.npz``; the JAX package rebuilds both here.
* The port's plain int8 forward (the CPU path) is held against them at
  ``chip_smoke.INT8_GOLDEN_BARS``; ``chip_smoke.py`` and the ``gpu`` test of
  ``tests/test_torch_int8_simt.py`` hold the card's forward, through the
  SIMT int8 kernels, to the same bars.
* The bars are int8's, not float32's: the port's LayerNorm takes another
  int8 step than herro_tpu's now and then. Its two sums can follow XLA's CPU
  order bit for bit (32-wide chunks left to right, then the chunk sums left
  to right), but XLA's LayerNorm then still differs in its own rsqrt and in
  the affine fused into one multiply-add, so following the sums removes no
  flip: the test below measures it.

Nothing here runs on the card; ``int8_forward_gap`` and ``within_bars``
import no JAX, so the card's tests import them.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "torch_data")

# name -> (checkpoint, frozen int8 outputs, inputs, dtype forced)
INT8_GOLDENS = {
    "tiny": (os.path.join(DATA, "tiny_seed5"), "golden_tiny_int8.npz",
             os.path.join(DATA, "golden_tiny_f32.npz"), None),
    "r10_f32": (os.path.join(ROOT, "resources", "model_r10_sim"), "golden_r10_int8.npz",
                os.path.join(ROOT, "tests", "golden", "logits_r10.npz"), "float32"),
}


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_int8_golden", os.path.join(DATA, "make_int8_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def int8_forward_gap(name: str, device="cpu") -> dict:
    """The port's int8 forward of golden ``name`` on ``device`` against the
    frozen JAX int8 outputs: max |dlogit|, max |dinfo|, the columns whose
    class differs, their count and the kernels launched."""
    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.pipeline.batching import unpack_tokens_np

    ckpt, frozen, inputs, dtype = INT8_GOLDENS[name]
    cfg, sd = load_model(ckpt)
    cfg = dataclasses.replace(cfg, int8=True, **({"dtype": dtype} if dtype else {}))
    model = CorrectionModel(cfg)
    model.load_state_dict(sd)
    model = model.to(device).eval()
    fx, want = np.load(inputs), np.load(os.path.join(DATA, frozen))
    args = (unpack_tokens_np(fx["tokens_packed"], N_ROWS),
            (QUAL_SCALE * fx["quals"].astype(np.float32) - QUAL_OFFSET).astype(np.float32),
            fx["support_idx"], fx["support_mask"])
    before = kernels.launch_counts.snapshot()
    with torch.inference_mode():
        info, logits = model(*(torch.from_numpy(a).to(device) for a in args))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    info, logits = info.float().cpu().numpy(), logits.float().cpu().numpy()
    mask = fx["support_mask"]
    flipped = (logits.argmax(-1) != want["logits"].argmax(-1)) & mask
    return dict(cfg=cfg, n=int(mask.sum()), flipped=int(flipped.sum()),
                max_dlogit=float(np.abs(logits - want["logits"])[mask].max()),
                max_dinfo=float(np.abs(info - want["info"])[mask].max()),
                finite=bool(np.isfinite(logits[mask]).all()),
                launches={k: after[k] - before[k] for k in after if after[k] != before[k]})


def within_bars(gap: dict) -> bool:
    """``gap`` within ``chip_smoke.INT8_GOLDEN_BARS``, the bars the card's
    int8 forwards are held to: 0.05 on |dlogit| and |dinfo|, 1 column in 40
    whose class differs (the plain version reads 0.0149 / 0.0145 and 0 of
    417 for tiny, 0.0174 / 0.0253 and 0 of 22 for r10 in float32)."""
    from chip_smoke import INT8_GOLDEN_BARS as bars

    return (gap["finite"] and gap["max_dlogit"] <= bars["max_dlogit"]
            and gap["max_dinfo"] <= bars["max_dinfo"]
            and gap["flipped"] <= bars["flipped_share"] * gap["n"])


@pytest.mark.parametrize("name", sorted(INT8_GOLDENS))
def test_plain_int8_forward_matches_frozen_jax_int8_logits(name):
    gap = int8_forward_gap(name)
    assert gap["cfg"].int8 and gap["cfg"].dtype == "float32" and gap["n"] > 0
    assert gap["launches"] == {}  # the CPU takes the plain versions
    assert within_bars(gap), gap


@pytest.mark.parametrize("name", sorted(INT8_GOLDENS))
def test_frozen_int8_goldens_rebuild_from_herro_tpu(name):
    """The JAX package rebuilds what the files hold, within float32 noise of
    one XLA build against another."""
    mk = _maker()
    got = mk.build_tiny() if name == "tiny" else mk.build_r10()
    frozen = np.load(os.path.join(DATA, INT8_GOLDENS[name][1]))
    for key in ("info", "logits"):
        np.testing.assert_allclose(got[key], frozen[key], atol=1e-5, rtol=0)


def _xla_order_sum(t):
    """Row sums in XLA's CPU order: 32-wide chunks summed left to right, then
    the chunk sums left to right."""
    c = t.reshape(*t.shape[:-1], -1, min(t.shape[-1], 32))
    s = c[..., 0]
    for i in range(1, c.shape[-1]):
        s = s + c[..., i]
    out = s[..., 0]
    for i in range(1, s.shape[-1]):
        out = out + s[..., i]
    return out[..., None]


@pytest.mark.parametrize("d", [32, 512])
def test_layernorm_sums_follow_xla_but_its_int8_steps_do_not(d):
    """On 16,384 rows: torch's own sums differ from jnp's on many rows, and
    sums in XLA's order equal jnp's on every row. LayerNorm with those sums
    still differs from herro_tpu's (its rsqrt and its fused affine), and its
    int8 values still differ from herro_tpu's in about as many rows as the
    port's LayerNorm does (at d 512, 8 rows of 16,384 against the port's 9):
    the port keeps torch's sums."""
    import jax
    import jax.numpy as jnp

    from herro_tpu.ops import fused as jfused
    from herro_tpu_torch.ops import fused

    rng = np.random.default_rng(2)
    x = rng.normal(size=(16384, d)).astype(np.float32)
    s = (1 + rng.normal(0, 0.1, size=(d,))).astype(np.float32)
    b = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    xt, st, bt = map(torch.from_numpy, (x, s, b))
    for v, vt in ((x, xt), (x * x, xt * xt)):
        want = np.asarray(jnp.sum(jnp.asarray(v), axis=-1, keepdims=True))
        assert (vt.sum(-1, keepdim=True).numpy() != want).sum() > 1000
        np.testing.assert_array_equal(_xla_order_sum(vt).numpy(), want)

    def xla_sums_layernorm(x, scale, bias, eps: float = 1e-6):
        mu = _xla_order_sum(x) / d
        var = torch.clamp(_xla_order_sum(x * x) / d - mu * mu, min=0.0)
        return (x - mu) * torch.rsqrt(var + eps) * scale + bias

    ref_ln = jax.jit(jfused.layernorm)(*map(jnp.asarray, (x, s, b)))
    ref_q = np.asarray(jfused._quant_rows(ref_ln)[0])
    assert (xla_sums_layernorm(xt, st, bt).numpy() != np.asarray(ref_ln)).mean() > 0.05
    rows = {}
    for name, ln in (("port", fused.layernorm), ("xla sums", xla_sums_layernorm)):
        q = fused._quant_rows(ln(xt, st, bt).float())[0].numpy()
        rows[name] = int((q != ref_q).any(axis=-1).sum())
    assert 2 * rows["xla sums"] >= rows["port"], rows
    assert rows["port"] == 0 or rows["xla sums"] > 0, rows
