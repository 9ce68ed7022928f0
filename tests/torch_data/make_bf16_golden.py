"""Freeze herro_tpu's bf16 forwards at widths no Hopper instance takes, for
the card, which has no JAX.

Run from the repo root:  JAX_PLATFORMS=cpu python tests/torch_data/make_bf16_golden.py

Writes, beside this script, herro_tpu's ``info`` and ``logits`` in bf16 (on
the CPU: its jnp twins of the Pallas kernels):

* ``golden_tiny_bf16.npz`` — the seeded ``tiny_seed5`` checkpoint (a
  ``TINY_CONFIG``: d 32, H 2 x D 16, d_ff 64) under ``dtype="bfloat16"``, on
  the inputs of ``golden_tiny_f32.npz``;
* ``golden_r10h64_bf16.npz`` — the flagship at head dim 64 ("r10h64"):
  ``resources/model_r10_sim``'s parameters with the qkv kernel [512, 3, 4,
  128] and its bias [3, 4, 128] read as [512, 3, 8, 64] and [3, 8, 64] under
  ``n_heads=8`` (d 512, H 8 x D 64, d_ff 1024, band 512), on the inputs of
  ``tests/golden/logits_r10.npz``. Both packages derive it in memory from the
  one checkpoint on disk (``jax_r10h64``, ``port_r10h64``): the same bytes,
  since the (3, H, D) axes flatten alike at either head count.

Each file also records the port's own gap to it on the CPU (its plain
versions): ``cpu_max_dlogit`` and ``cpu_max_dinfo`` over the supported
columns, and ``cpu_flipped``, the supported columns whose class differs.
``chip_smoke.py`` holds the card's forwards through the bf16 SIMT kernels
to at most twice that gap, and the class on every supported column;
``tests/test_torch_bf16_widths.py`` rebuilds both files with the JAX package,
compares them with the files so that they cannot go stale, and recomputes
the recorded gap.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TINY_GOLDEN = os.path.join(HERE, "golden_tiny_bf16.npz")
R10H64_GOLDEN = os.path.join(HERE, "golden_r10h64_bf16.npz")
R10H64_HEADS = 8


def _float32_golden():
    spec = importlib.util.spec_from_file_location(
        "make_float32_golden", os.path.join(HERE, "make_float32_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_r10h64():
    """herro_tpu's (config, params) of r10h64: model_r10_sim with every
    block's qkv kernel and bias read at 8 heads of 64."""
    import jax

    from herro_tpu.models.checkpoint import load_model

    jcfg, params = load_model(_float32_golden().R10_CKPT)

    def at_h64(path, a):
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        if "qkv" in names:
            return a.reshape(*a.shape[:-2], R10H64_HEADS, a.shape[-1] * a.shape[-2]
                             // R10H64_HEADS)
        return a

    return (dataclasses.replace(jcfg, n_heads=R10H64_HEADS),
            jax.tree_util.tree_map_with_path(at_h64, params))


def port_r10h64():
    """The port's (config, state dict) of r10h64: model_r10_sim with every
    block's out kernel [4, 128, 512] read as [8, 64, 512] under 8 heads (its
    qkv kernel and bias keep their flat [512, 1536] and [1536])."""
    from herro_tpu_torch.models.checkpoint import load_model

    cfg, sd = load_model(os.path.join(ROOT, "resources", "model_r10_sim"))
    cfg = dataclasses.replace(cfg, n_heads=R10H64_HEADS)
    dh = cfg.d_model // R10H64_HEADS
    sd = {k: v.reshape(R10H64_HEADS, dh, cfg.d_model) if k.endswith("attn.out_kernel") else v
          for k, v in sd.items()}
    return cfg, sd


def build_tiny() -> dict:
    """herro_tpu's bf16 forward of the seeded tiny model on its inputs."""
    mk = _float32_golden()
    jcfg, params = mk.tiny_params()
    fx = np.load(mk.TINY_GOLDEN)
    return mk.jax_forward(dataclasses.replace(jcfg, dtype="bfloat16"), params,
                          mk.model_inputs(fx))


def build_r10h64() -> dict:
    """herro_tpu's bf16 forward of r10h64 on the golden inputs."""
    mk = _float32_golden()
    jcfg, params = jax_r10h64()
    return mk.jax_forward(jcfg, params, mk.model_inputs(np.load(mk.R10_INPUTS)))


def port_models() -> dict:
    """name -> (the port's config, state dict, the inputs' npz path), both
    in bf16."""
    from herro_tpu_torch.models.checkpoint import load_model

    mk = _float32_golden()
    cfg, sd = load_model(mk.TINY_CKPT)
    return {"tiny": (dataclasses.replace(cfg, dtype="bfloat16"), sd, mk.TINY_GOLDEN),
            "r10h64": (*port_r10h64(), mk.R10_INPUTS)}


def port_gap(name: str, want, device="cpu", tp: int = 1, int8: bool = False) -> dict:
    """The port's bf16 forward of golden ``name`` on ``device`` (``tp``: over
    that many tensor-parallel shards on it; ``int8``: under the int8 config)
    against the JAX outputs ``want``: max |dlogit| and |dinfo| and the
    columns whose class differs, over the supported columns, and the kernels
    launched."""
    import torch

    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel.tensor import TensorParallelModel
    from herro_tpu_torch.pipeline.batching import unpack_tokens_np

    cfg, sd, inputs = port_models()[name]
    cfg = dataclasses.replace(cfg, int8=int8)
    if tp > 1:
        model = TensorParallelModel(cfg, sd, [device] * tp)
    else:
        model = CorrectionModel(cfg)
        model.load_state_dict(sd)
        model = model.to(device).eval()
    fx = np.load(inputs)
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
    return dict(cfg=cfg, n=int(mask.sum()),
                flipped=int(((logits.argmax(-1) != want["logits"].argmax(-1)) & mask).sum()),
                max_dlogit=float(np.abs(logits - want["logits"])[mask].max()),
                max_dinfo=float(np.abs(info - want["info"])[mask].max()),
                finite=bool(np.isfinite(logits[mask]).all()),
                launches={k: after[k] - before[k] for k in after if after[k] != before[k]})


def main() -> None:
    sys.path.insert(0, ROOT)
    for name, path, build in (("tiny", TINY_GOLDEN, build_tiny),
                              ("r10h64", R10H64_GOLDEN, build_r10h64)):
        frozen = build()
        gap = port_gap(name, frozen)
        np.savez_compressed(path, **frozen, cpu_max_dlogit=gap["max_dlogit"],
                            cpu_max_dinfo=gap["max_dinfo"], cpu_flipped=gap["flipped"])
        print(path, os.path.getsize(path), "bytes", {k: gap[k] for k in (
            "n", "flipped", "max_dlogit", "max_dinfo")})


if __name__ == "__main__":
    main()
