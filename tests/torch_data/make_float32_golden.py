"""Freeze herro_tpu's float32 forwards for the card, which has no JAX.

Run from the repo root:  JAX_PLATFORMS=cpu python tests/torch_data/make_float32_golden.py

Writes, beside this script:

* ``tiny_seed5/`` — a seeded ``TINY_CONFIG`` checkpoint (``init_params`` at
  PRNGKey(5)) in the port's format (``herro_tpu_torch...save_model``), which
  both packages load;
* ``golden_tiny_f32.npz`` — inputs made from a numpy seed, in the layout of
  ``tests/golden/logits_r10.npz`` (packed tokens, raw quals, supported
  columns, n_alns: B 4, L 1024, S 128, lengths below L, rows past n_alns
  padded), and herro_tpu's float32 ``info`` and ``logits`` for the
  checkpoint above on them;
* ``golden_r10_f32.npz`` — herro_tpu's ``info`` and ``logits`` of
  ``resources/model_r10_sim`` with ``dtype="float32"`` on the inputs of
  ``tests/golden/logits_r10.npz``;
* ``golden_r10deep_f32.npz`` — the same of ``resources/model_r10_deep_sim``
  (d 256, 8 layers, H 2 x 128), which no other golden holds: the card's bf16
  forward through the Hopper instances is held to its classes.

``chip_smoke.py`` holds the port's float32 forwards on the card against
these; ``tests/test_torch_float32.py`` (``tests/test_torch_checkpoints.py``
for r10deep) rebuilds them with the JAX package and compares them with the
files, so that they cannot go stale.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TINY_CKPT = os.path.join(HERE, "tiny_seed5")
TINY_GOLDEN = os.path.join(HERE, "golden_tiny_f32.npz")
R10_GOLDEN = os.path.join(HERE, "golden_r10_f32.npz")
R10_CKPT = os.path.join(ROOT, "resources", "model_r10_sim")
R10DEEP_GOLDEN = os.path.join(HERE, "golden_r10deep_f32.npz")
R10DEEP_CKPT = os.path.join(ROOT, "resources", "model_r10_deep_sim")
R10_INPUTS = os.path.join(ROOT, "tests", "golden", "logits_r10.npz")
B, L, S = 4, 1024, 128
SEED = 5


def tiny_inputs(seed: int = 16) -> dict:
    """A batch as the batcher lays one out: pad suffix past each length,
    rows past n_alns padded, quals raw (33-126), sorted supported columns
    below the length, some masked."""
    from herro_tpu.constants import N_ROWS, QUAL_PAD, TOKEN_PAD
    from herro_tpu.pipeline.batching import pack_tokens

    rng = np.random.default_rng(seed)
    lengths = np.array([L, L - 100, 700, 300], dtype=np.int32)
    n_alns = np.array([30, 12, 5, 1], dtype=np.int32)
    tok = rng.integers(0, 11, size=(B, N_ROWS, L)).astype(np.uint8)
    tok[:, 0] = rng.integers(0, 5, size=(B, L))
    quals = rng.integers(33, 127, size=(B, N_ROWS, L)).astype(np.uint8)
    sidx = np.zeros((B, S), dtype=np.int32)
    smask = np.zeros((B, S), dtype=bool)
    for b in range(B):
        tok[b, n_alns[b] + 1 :] = TOKEN_PAD
        tok[b, :, lengths[b] :] = TOKEN_PAD
        quals[b, n_alns[b] + 1 :] = QUAL_PAD
        quals[b, :, lengths[b] :] = QUAL_PAD
        n_sup = min(S, int(lengths[b]) // 4) - 7 * b
        sidx[b, :n_sup] = np.sort(rng.choice(int(lengths[b]), size=n_sup, replace=False))
        smask[b, :n_sup] = True
    packed = np.ascontiguousarray(pack_tokens(tok.transpose(0, 2, 1)).transpose(0, 2, 1))
    return dict(tokens_packed=packed, quals=quals, support_idx=sidx,
                support_mask=smask, n_alns=n_alns)


def model_inputs(fx) -> tuple:
    """(tokens, quals, support_idx, support_mask) as the model takes them."""
    from herro_tpu.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu.pipeline.batching import unpack_tokens_np

    return (unpack_tokens_np(fx["tokens_packed"], N_ROWS),
            (QUAL_SCALE * fx["quals"].astype(np.float32) - QUAL_OFFSET).astype(np.float32),
            fx["support_idx"], fx["support_mask"])


def jax_forward(jcfg, params, inputs) -> dict:
    import jax.numpy as jnp

    from herro_tpu.models.model import CorrectionModel

    info, logits = CorrectionModel(jcfg).apply(params, *map(jnp.asarray, inputs))
    return dict(info=np.asarray(info), logits=np.asarray(logits))


def tiny_params():
    import jax

    from herro_tpu.models.model import TINY_CONFIG, init_params

    return TINY_CONFIG, init_params(TINY_CONFIG, jax.random.PRNGKey(SEED))


def build_tiny() -> dict:
    """herro_tpu's float32 forward of the seeded tiny model on tiny_inputs()."""
    jcfg, params = tiny_params()
    fx = tiny_inputs()
    return fx | jax_forward(jcfg, params, model_inputs(fx))


def build_r10(ckpt: str = R10_CKPT) -> dict:
    """herro_tpu's forward of model_r10_sim (or ``ckpt``) in float32 on the
    golden inputs."""
    from herro_tpu.models.checkpoint import load_model

    jcfg, params = load_model(ckpt)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    return jax_forward(jcfg, params, model_inputs(np.load(R10_INPUTS)))


def build_r10deep() -> dict:
    """herro_tpu's forward of model_r10_deep_sim in float32 on the golden
    inputs."""
    return build_r10(R10DEEP_CKPT)


def write_tiny_checkpoint(path: str = TINY_CKPT) -> None:
    import jax

    from herro_tpu_torch.models.checkpoint import params_from_jax, save_model
    from herro_tpu_torch.models.model import ModelConfig

    jcfg, params = tiny_params()
    save_model(path, ModelConfig(**dataclasses.asdict(jcfg)),
               params_from_jax(jax.tree_util.tree_map(np.asarray, params)))


def main() -> None:
    sys.path.insert(0, ROOT)
    write_tiny_checkpoint()
    np.savez_compressed(TINY_GOLDEN, **build_tiny())
    np.savez_compressed(R10_GOLDEN, **build_r10())
    np.savez_compressed(R10DEEP_GOLDEN, **build_r10deep())
    for path in (TINY_GOLDEN, R10_GOLDEN, R10DEEP_GOLDEN):
        print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
