"""Model checkpoint load and save.

A checkpoint is a directory holding ``config.json`` (the ModelConfig) and
``params.msgpack`` — the parameter tree as flax serialises it, as
``herro_tpu`` reads and writes it. This module reads and writes it with a
small msgpack reader and writer of its own, so neither flax nor msgpack is
needed: flax stores each array as msgpack ext type 1 holding
``packb((shape, dtype_name, C-order bytes))``.

:func:`params_from_jax` is the one place where the JAX parameter tree becomes
the port's ``state_dict``, and :func:`params_to_jax` its exact inverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch

from ..constants import N_ROWS, VOCAB_SIZE
from .model import CONFIGS, CorrectionModel, ModelConfig

_EXT_NDARRAY = 1  # flax.serialization._MsgpackExtType.ndarray


class _Reader:
    """Decoder for the msgpack subset flax writes (maps, arrays, strings,
    binaries, ints, floats, nil/bools, ext types)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self):
        t = self.uint(1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return bytes(self.take(t & 0x1F)).decode()
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.uint(1))),
            0xC5: lambda: bytes(self.take(self.uint(2))),
            0xC6: lambda: bytes(self.take(self.uint(4))),
            0xC7: lambda: self.ext(self.uint(1)),
            0xC8: lambda: self.ext(self.uint(2)),
            0xC9: lambda: self.ext(self.uint(4)),
            0xCA: lambda: struct.unpack(">f", self.take(4))[0],
            0xCB: lambda: struct.unpack(">d", self.take(8))[0],
            0xCC: lambda: self.uint(1), 0xCD: lambda: self.uint(2),
            0xCE: lambda: self.uint(4), 0xCF: lambda: self.uint(8),
            0xD0: lambda: struct.unpack(">b", self.take(1))[0],
            0xD1: lambda: struct.unpack(">h", self.take(2))[0],
            0xD2: lambda: struct.unpack(">i", self.take(4))[0],
            0xD3: lambda: struct.unpack(">q", self.take(8))[0],
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: bytes(self.take(self.uint(1))).decode(),
            0xDA: lambda: bytes(self.take(self.uint(2))).decode(),
            0xDB: lambda: bytes(self.take(self.uint(4))).decode(),
            0xDC: lambda: [self.value() for _ in range(self.uint(2))],
            0xDD: lambda: [self.value() for _ in range(self.uint(4))],
            0xDE: lambda: self.map(self.uint(2)),
            0xDF: lambda: self.map(self.uint(4)),
        }
        if t not in fixed:
            raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")
        return fixed[t]()

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, data = _Reader(payload).value()
        return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_msgpack_tree(data: bytes) -> dict:
    """Decode flax ``serialization.to_bytes`` output into nested dicts of
    numpy arrays."""
    return _Reader(data).value()


class _Writer:
    """Encoder for what a parameter tree holds (maps, strings, bytes,
    non-negative ints, lists, arrays), byte for byte as msgpack-python packs
    it for flax (``use_bin_type``: str8 for short strings, bin for bytes; the
    smallest formats; dicts in the order given)."""

    def __init__(self):
        self.out = bytearray()

    def head(self, n: int, fix: int | None, fix_max: int, codes) -> None:
        """A length or value header: ``fix | n`` when it fits, else the
        first of ``codes`` whose field holds n."""
        if fix is not None and n <= fix_max:
            self.out.append(fix | n)
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.out += struct.pack(">B" + fmt, code, n)
                return
        raise ValueError(f"{n} does not fit msgpack")

    def value(self, v) -> None:
        if isinstance(v, int) and v >= 0:
            self.head(v, 0x00, 0x7F, ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")))
        elif isinstance(v, str):
            b = v.encode()
            self.head(len(b), 0xA0, 31, ((0xD9, "B"), (0xDA, "H"), (0xDB, "I")))
            self.out += b
        elif isinstance(v, bytes):
            self.head(len(v), None, 0, ((0xC4, "B"), (0xC5, "H"), (0xC6, "I")))
            self.out += v
        elif isinstance(v, (list, tuple)):
            self.head(len(v), 0x90, 15, ((0xDC, "H"), (0xDD, "I")))
            for x in v:
                self.value(x)
        elif isinstance(v, dict):
            self.head(len(v), 0x80, 15, ((0xDE, "H"), (0xDF, "I")))
            for k, x in v.items():
                self.value(k)
                self.value(x)
        elif isinstance(v, np.ndarray):
            self.ndarray(v)
        else:
            raise TypeError(f"cannot pack {v!r} into a parameter tree")

    def ndarray(self, a: np.ndarray) -> None:
        inner = _Writer()
        inner.value((list(a.shape), a.dtype.name, a.tobytes("C")))
        n = len(inner.out)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.out.append(fixext[n])
        else:
            self.head(n, None, 0, ((0xC7, "B"), (0xC8, "H"), (0xC9, "I")))
        self.out += struct.pack(">b", _EXT_NDARRAY) + inner.out


def write_msgpack_tree(tree: dict) -> bytes:
    """Encode nested dicts of numpy arrays as flax ``serialization.to_bytes``
    does: every map's keys in sorted order, each array as ext type 1."""

    def sort(t):
        return {k: sort(t[k]) for k in sorted(t)} if isinstance(t, dict) else t

    w = _Writer()
    w.value(sort(tree))
    return bytes(w.out)


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX parameter tree (nested dicts of numpy arrays, as
    ``herro_tpu.models.model.init_params`` or a checkpoint holds it) ->
    the port's ``state_dict`` (float32 tensors).

    qkv [d, 3, H, D] becomes [d, 3*H*D] in c-major order; out [H*D, d]
    becomes [H, D, d]; col_proj [R*(V+1), d] splits into the transposed
    one-hot table w_embT [d, R*V] (rows r*(V+1)+v, v < V) and the qual
    weights w_qT [d, R] (rows r*(V+1)+V), as herro_tpu's model does."""
    p = tree.get("params", tree)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    R, V = N_ROWS, VOCAB_SIZE
    idx = np.arange(R * (V + 1)).reshape(R, V + 1)
    ck = np.asarray(p["col_proj"]["kernel"])
    sd = {
        "col_proj.w_embT": t(ck[idx[:, :V].reshape(-1)].T),
        "col_proj.w_qT": t(ck[idx[:, V]].T),
        "col_proj.bias": t(p["col_proj"]["bias"]),
    }
    n_layers = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_layers):
        blk = p[f"block_{i}"]
        qk = np.asarray(blk["attn"]["qkv"]["kernel"])
        d, _, h, dh = qk.shape
        pre = f"blocks.{i}."
        sd.update({
            pre + "ln1.scale": t(blk["ln1"]["scale"]),
            pre + "ln1.bias": t(blk["ln1"]["bias"]),
            pre + "attn.qkv_kernel": t(qk.reshape(d, 3 * h * dh)),
            pre + "attn.qkv_bias": t(np.asarray(blk["attn"]["qkv"]["bias"]).reshape(-1)),
            pre + "attn.out_kernel": t(
                np.asarray(blk["attn"]["out"]["kernel"]).reshape(h, dh, d)
            ),
            pre + "attn.out_bias": t(blk["attn"]["out"]["bias"]),
            pre + "ln2.scale": t(blk["ln2"]["scale"]),
            pre + "ln2.bias": t(blk["ln2"]["bias"]),
            pre + "ff1.kernel": t(blk["ff1"]["kernel"]),
            pre + "ff1.bias": t(blk["ff1"]["bias"]),
            pre + "ff2.kernel": t(blk["ff2"]["kernel"]),
            pre + "ff2.bias": t(blk["ff2"]["bias"]),
        })
    sd["ln_f.scale"] = t(p["ln_f"]["scale"])
    sd["ln_f.bias"] = t(p["ln_f"]["bias"])
    for name in ("bases_head", "info_head"):
        sd[f"{name}.kernel"] = t(p[name]["kernel"])
        sd[f"{name}.bias"] = t(p[name]["bias"])
    return sd


def params_to_jax(sd: dict[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` -> the JAX parameter tree under
    ``"params"``, as ``herro_tpu.models.model.init_params`` gives it (float32
    numpy arrays): the exact inverse of :func:`params_from_jax`. col_proj
    [R*(V+1), d] is rebuilt from w_embT and w_qT, qkv becomes [d, 3, H, D]
    with its bias [3, H, D], out [H*D, d]."""
    a = lambda name: sd[name].detach().cpu().float().numpy().copy()
    R, V = N_ROWS, VOCAB_SIZE
    w_embT, w_qT = a("col_proj.w_embT"), a("col_proj.w_qT")
    d = w_qT.shape[0]
    ck = np.empty((R, V + 1, d), dtype=np.float32)
    ck[:, :V] = w_embT.T.reshape(R, V, d)
    ck[:, V] = w_qT.T
    p = {"col_proj": {"kernel": ck.reshape(R * (V + 1), d), "bias": a("col_proj.bias")}}
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(n_layers):
        pre = f"blocks.{i}."
        out = a(pre + "attn.out_kernel")  # [H, D, d]
        h, dh, _ = out.shape
        dense = lambda name: {"kernel": a(pre + name + ".kernel"), "bias": a(pre + name + ".bias")}
        ln = lambda name: {"scale": a(pre + name + ".scale"), "bias": a(pre + name + ".bias")}
        p[f"block_{i}"] = {
            "ln1": ln("ln1"),
            "attn": {
                "qkv": {
                    "kernel": a(pre + "attn.qkv_kernel").reshape(d, 3, h, dh),
                    "bias": a(pre + "attn.qkv_bias").reshape(3, h, dh),
                },
                "out": {"kernel": out.reshape(h * dh, d), "bias": a(pre + "attn.out_bias")},
            },
            "ln2": ln("ln2"),
            "ff1": dense("ff1"),
            "ff2": dense("ff2"),
        }
    p["ln_f"] = {"scale": a("ln_f.scale"), "bias": a("ln_f.bias")}
    for name in ("bases_head", "info_head"):
        p[name] = {"kernel": a(f"{name}.kernel"), "bias": a(f"{name}.bias")}
    return {"params": p}


def save_model(path: str, cfg: ModelConfig, sd: dict[str, torch.Tensor]) -> None:
    """Write a checkpoint directory that ``herro_tpu`` and :func:`load_model`
    both read: ``config.json`` from the config and ``params.msgpack`` from
    the state_dict, as ``herro_tpu/models/checkpoint.py:save_model`` writes
    them."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=1)
    with open(os.path.join(path, "params.msgpack"), "wb") as fh:
        fh.write(write_msgpack_tree(params_to_jax(sd)))


def load_model(path: str) -> tuple[ModelConfig, dict[str, torch.Tensor]]:
    with open(os.path.join(path, "config.json")) as fh:
        cfg = ModelConfig(**json.load(fh))
    with open(os.path.join(path, "params.msgpack"), "rb") as fh:
        tree = read_msgpack_tree(fh.read())
    return cfg, params_from_jax(tree)


def load_or_init(path_or_name: str, rng_seed: int = 0) -> tuple[ModelConfig, dict]:
    """Load a checkpoint directory, or initialise a named config
    ('tiny' / 'r10' / 'r9' / 'r10w' / 'r10deep') with random weights from a
    seeded generator."""
    if path_or_name in CONFIGS:
        cfg = CONFIGS[path_or_name]
        gen = torch.Generator().manual_seed(rng_seed)
        return cfg, CorrectionModel(cfg, generator=gen).state_dict()
    return load_model(path_or_name)
