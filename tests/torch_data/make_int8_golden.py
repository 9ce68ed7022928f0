"""Freeze herro_tpu's int8 forwards for the card, which has no JAX.

Run from the repo root:  JAX_PLATFORMS=cpu python tests/torch_data/make_int8_golden.py

Writes, beside this script, herro_tpu's ``info`` and ``logits`` under
``int8=True`` (on the CPU: its jnp twins of the int8 kernels, in float32):

* ``golden_tiny_int8.npz`` — the seeded ``tiny_seed5`` checkpoint (a
  ``TINY_CONFIG``, float32) on the inputs of ``golden_tiny_f32.npz``;
* ``golden_r10_int8.npz`` — ``resources/model_r10_sim`` with
  ``dtype="float32"`` on the inputs of ``tests/golden/logits_r10.npz``.

Both inputs and checkpoints are those of ``make_float32_golden.py``.
``chip_smoke.py`` holds the port's int8 forwards on the card against these,
and ``tests/test_torch_int8_goldens.py`` the port's plain version on the CPU;
that file also rebuilds both with the JAX package and compares them with the
files, so that they cannot go stale.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TINY_GOLDEN = os.path.join(HERE, "golden_tiny_int8.npz")
R10_GOLDEN = os.path.join(HERE, "golden_r10_int8.npz")


def _float32_golden():
    spec = importlib.util.spec_from_file_location(
        "make_float32_golden", os.path.join(HERE, "make_float32_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_tiny() -> dict:
    """herro_tpu's int8 forward of the seeded tiny model on its inputs."""
    mk = _float32_golden()
    jcfg, params = mk.tiny_params()
    fx = np.load(mk.TINY_GOLDEN)
    return mk.jax_forward(dataclasses.replace(jcfg, int8=True), params, mk.model_inputs(fx))


def build_r10() -> dict:
    """herro_tpu's int8 forward of model_r10_sim in float32 on the golden inputs."""
    from herro_tpu.models.checkpoint import load_model

    mk = _float32_golden()
    jcfg, params = load_model(mk.R10_CKPT)
    jcfg = dataclasses.replace(jcfg, dtype="float32", int8=True)
    return mk.jax_forward(jcfg, params, mk.model_inputs(np.load(mk.R10_INPUTS)))


def main() -> None:
    sys.path.insert(0, ROOT)
    np.savez_compressed(TINY_GOLDEN, **build_tiny())
    np.savez_compressed(R10_GOLDEN, **build_r10())
    for path in (TINY_GOLDEN, R10_GOLDEN):
        print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
