"""Freeze herro_tpu's forwards of the ``w768h96`` model (d 768, 8 heads of
96, d_ff 3072, 3 layers, band 512) for the card, which has no JAX.

Run from the repo root:  JAX_PLATFORMS=cpu python tests/torch_data/make_widths_golden.py

Writes ``golden_w768h96.npz`` beside this script: herro_tpu's ``info`` and
``logits`` of the seeded parameters of ``w768h96.py`` in float32
(``info_f32``, ``logits_f32``) and in bf16 (``info_bf16``, ``logits_bf16``;
on the CPU, its jnp twins of the Pallas kernels), at B 4, L 1024 on the
inputs of ``golden_tiny_f32.npz``; ``params_sha256``, the digest of the
parameters they came from; and the port's own CPU gap to the bf16 logits (its
plain versions), as ``make_bf16_golden.py`` records it: ``cpu_max_dlogit``,
``cpu_max_dinfo`` over the supported columns and ``cpu_flipped``, the
supported columns whose class differs.

``chip_smoke.py`` holds the card's float32 forward to the float32 logits
within the float32 goldens' bar and the bf16 one to twice the recorded gap
and the class on every supported column but the near-ties that bar allows
to flip; ``tests/test_torch_w768h96.py`` rebuilds the file with the JAX
package and compares it with the file, so that it cannot go stale.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
GOLDEN = os.path.join(HERE, "golden_w768h96.npz")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recipe():
    """``w768h96.py``: the config and the seeded parameters."""
    return _load("w768h96")


def inputs() -> tuple:
    """(tokens, quals, support_idx, support_mask) of ``golden_tiny_f32.npz``,
    as the model takes them (no JAX needed)."""
    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu_torch.pipeline.batching import unpack_tokens_np

    fx = np.load(_load("make_float32_golden").TINY_GOLDEN)
    return (unpack_tokens_np(fx["tokens_packed"], N_ROWS),
            (QUAL_SCALE * fx["quals"].astype(np.float32) - QUAL_OFFSET).astype(np.float32),
            fx["support_idx"], fx["support_mask"])


def build(tree=None) -> dict:
    """herro_tpu's float32 and bf16 forwards of w768h96 on :func:`inputs`."""
    from herro_tpu.models.model import ModelConfig

    w = recipe()
    tree = w.params() if tree is None else tree
    mk = _load("make_float32_golden")
    out = {"params_sha256": np.array(w.digest(tree))}
    for dtype, sfx in (("float32", "f32"), ("bfloat16", "bf16")):
        jcfg = ModelConfig(**dict(w.CONFIG, dtype=dtype))
        got = mk.jax_forward(jcfg, tree, inputs())
        out[f"info_{sfx}"], out[f"logits_{sfx}"] = got["info"], got["logits"]
    return out


def port_model(device="cpu", dtype: str = "bfloat16", tree=None):
    """The port's w768h96 model in ``dtype`` on ``device``, eval mode."""
    import torch

    from herro_tpu_torch.models.checkpoint import params_from_jax
    from herro_tpu_torch.models.model import CorrectionModel, ModelConfig

    w = recipe()
    cfg = dataclasses.replace(ModelConfig(**w.CONFIG), dtype=dtype)
    model = CorrectionModel(cfg)
    model.load_state_dict(params_from_jax(w.params() if tree is None else tree))
    return model.to(torch.device(device)).eval()


def port_gap(want, dtype: str = "bfloat16", device="cpu", model=None) -> dict:
    """The port's forward in ``dtype`` on ``device`` against the frozen
    outputs of that dtype: max |dlogit| and |dinfo| and the columns whose
    class differs (how many, and which: [example, column]), over the
    supported columns, and the kernels launched."""
    import torch

    from herro_tpu_torch.ops import cuda as kernels

    sfx = "f32" if dtype == "float32" else "bf16"
    model = port_model(device, dtype) if model is None else model
    args = inputs()
    before = kernels.launch_counts.snapshot()
    with torch.inference_mode():
        info, logits = model(*(torch.from_numpy(a).to(device) for a in args))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    info, logits = info.float().cpu().numpy(), logits.float().cpu().numpy()
    mask = args[3]
    ref_logits, ref_info = want[f"logits_{sfx}"], want[f"info_{sfx}"]
    flipped = (logits.argmax(-1) != ref_logits.argmax(-1)) & mask
    return dict(n=int(mask.sum()), flipped=int(flipped.sum()),
                flipped_at=[[int(b), int(c)] for b, c in zip(*np.nonzero(flipped))],
                max_dlogit=float(np.abs(logits - ref_logits)[mask].max()),
                max_dinfo=float(np.abs(info - ref_info)[mask].max()),
                finite=bool(np.isfinite(logits[mask]).all()),
                launches={k: after[k] - before[k] for k in after if after[k] != before[k]})


def main() -> None:
    sys.path.insert(0, ROOT)
    frozen = build()
    gap = port_gap(frozen)
    np.savez_compressed(GOLDEN, **frozen, cpu_max_dlogit=gap["max_dlogit"],
                        cpu_max_dinfo=gap["max_dinfo"], cpu_flipped=gap["flipped"])
    f32 = port_gap(frozen, "float32")
    print(GOLDEN, os.path.getsize(GOLDEN), "bytes", {k: gap[k] for k in (
        "n", "flipped", "max_dlogit", "max_dinfo")}, "float32",
        {k: f32[k] for k in ("flipped", "max_dlogit", "max_dinfo")})


if __name__ == "__main__":
    main()
