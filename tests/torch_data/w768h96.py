"""The ``w768h96`` model: a herro_tpu checkpoint at widths no shipped one has,
its parameters made from a numpy seed.

    from w768h96 import CONFIG, params, write_checkpoint   # loaded by path

``CONFIG`` is the checkpoint directory's ``config.json`` as herro_tpu reads it
(``herro_tpu/models/checkpoint.py:load_model``: ``ModelConfig(**json)``):
d_model 768, 3 layers, 8 heads of 96, d_ff 3072, the flagship's depth and
band (``local_window`` 512), in bf16 (the goldens also run it in float32).

:func:`params` is herro_tpu's parameter tree (``init_params``'s nesting under
``"params"``) as float32 numpy arrays, each leaf drawn in turn, in the order of
its sorted path, from one ``np.random.default_rng(SEED)``, at the scale of
flax's initialisers: every kernel lecun-normal (a normal truncated at two
standard deviations, rescaled to a variance of 1 / fan_in, fan_in as
``jax.nn.initializers.variance_scaling`` counts it: the second-to-last axis
times every axis before it), every bias 0 and every LayerNorm scale 1. About
21.3M parameters, 85 MB in float32: made at run time, never committed.
:func:`digest` is the sha256 of the leaves' bytes in that order, which the
golden stores so that a change of the recipe fails.

Imports neither JAX nor either package at module level: ``chip_smoke.py`` and
``make_widths_golden.py`` load it by path.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

SEED = 768
CONFIG = {
    "d_model": 768,
    "n_layers": 3,
    "n_heads": 8,
    "d_ff": 3072,
    "base_embed_dim": 16,
    "local_window": 512,
    "attn_impl": "auto",
    "dtype": "bfloat16",
    "remat": True,
    "int8": False,
}
N_ROWS, VOCAB_SIZE = 31, 12  # herro_tpu/constants.py: the pileup rows, the tokens


def shapes(cfg: dict = CONFIG) -> dict:
    """path -> shape of every leaf of herro_tpu's tree for ``cfg``."""
    d, h, f = cfg["d_model"], cfg["n_heads"], cfg["d_ff"]
    dh = d // h
    out = {("col_proj", "kernel"): (N_ROWS * (VOCAB_SIZE + 1), d), ("col_proj", "bias"): (d,)}
    for i in range(cfg["n_layers"]):
        blk = f"block_{i}"
        for ln in ("ln1", "ln2"):
            out[(blk, ln, "scale")] = out[(blk, ln, "bias")] = (d,)
        out[(blk, "attn", "qkv", "kernel")] = (d, 3, h, dh)
        out[(blk, "attn", "qkv", "bias")] = (3, h, dh)
        out[(blk, "attn", "out", "kernel")] = (h * dh, d)
        out[(blk, "attn", "out", "bias")] = (d,)
        out[(blk, "ff1", "kernel")], out[(blk, "ff1", "bias")] = (d, f), (f,)
        out[(blk, "ff2", "kernel")], out[(blk, "ff2", "bias")] = (f, d), (d,)
    out[("ln_f", "scale")] = out[("ln_f", "bias")] = (d,)
    out[("bases_head", "kernel")], out[("bases_head", "bias")] = (d, 5), (5,)
    out[("info_head", "kernel")], out[("info_head", "bias")] = (d, 1), (1,)
    return out


def _lecun_normal(rng, shape) -> np.ndarray:
    """flax's ``lecun_normal()``: a normal truncated to [-2, 2], rescaled to
    a variance of 1 / fan_in (``variance_scaling(1, "fan_in",
    "truncated_normal")``)."""
    fan_in = shape[-2] * int(np.prod(shape[:-2], dtype=np.int64))
    z = rng.standard_normal(shape)
    out = np.abs(z) > 2
    while out.any():  # redraw outside the truncation, in place
        z[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(z) > 2
    # 0.8796...: the standard deviation of a unit normal truncated to [-2, 2]
    return (z * (np.sqrt(1.0 / fan_in) / 0.87962566103423978)).astype(np.float32)


def leaves(cfg: dict = CONFIG, seed: int = SEED) -> dict:
    """path -> leaf, drawn in sorted path order."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in sorted(shapes(cfg).items()):
        if path[-1] == "kernel":
            out[path] = _lecun_normal(rng, shape)
        elif path[-1] == "scale":
            out[path] = np.ones(shape, np.float32)
        else:
            out[path] = np.zeros(shape, np.float32)
    return out


def params(cfg: dict = CONFIG, seed: int = SEED) -> dict:
    """herro_tpu's parameter tree: {"params": nested dicts of the leaves}."""
    tree: dict = {}
    for path, leaf in leaves(cfg, seed).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return {"params": tree}


def digest(tree: dict) -> str:
    """sha256 over every leaf's path and bytes, in sorted path order."""
    flat = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                flat[path + (key,)] = np.asarray(val, np.float32)

    walk(tree.get("params", tree), ())
    h = hashlib.sha256()
    for path in sorted(flat):
        h.update("/".join(path).encode())
        h.update(np.ascontiguousarray(flat[path]).tobytes())
    return h.hexdigest()


def write_checkpoint(path: str, dtype: str | None = None) -> str:
    """The checkpoint directory (``config.json`` and ``params.msgpack``) in
    the format both packages read, written by the port's ``save_model``;
    ``dtype`` overrides the config's."""
    from herro_tpu_torch.models.checkpoint import params_from_jax, save_model
    from herro_tpu_torch.models.model import ModelConfig

    cfg = dict(CONFIG, **({} if dtype is None else {"dtype": dtype}))
    save_model(path, ModelConfig(**cfg), params_from_jax(params()))
    with open(os.path.join(path, "config.json")) as fh:
        assert json.load(fh) == cfg
    return path
