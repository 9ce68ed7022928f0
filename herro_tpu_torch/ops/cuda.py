"""Build, load and count the hand-written Hopper kernels (``csrc/*.cu``).

Each CUDA source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into its own shared library with a plain C interface, loaded with ctypes. The
first kernel call builds every source at once, one ``nvcc`` per source, all
started together, into ``herro_tpu_torch/csrc/build/`` (listed in
``.gitignore``); a library is named by the hash of its source, every shared
header (``*.cuh``) and the flags, so an edited source never loads a stale
build. Nothing here runs at import: the CPU-only tests import this module
freely.

Every C entry point launches on the stream it is handed (the caller passes
``torch.cuda.current_stream()``), allocates nothing, and returns
``cudaGetLastError()``; :func:`call` raises when that is not 0.
:data:`launch_counts` counts launches per kernel, one per successful call,
and per mode for a kernel whose source has more than one entry point
(:data:`MODES`); it keeps the same counts by card as well.

The float32 kernels (``*_f32.cu``, SIMT FFMA over ``f32.cuh``) take the
float32 configs and the head dims 16-128 that the bf16 Hopper kernels do
not; their bf16 instances (``*_bf16.cu``, the same device code at bf16
storage) take bf16 at the widths and head dims no Hopper instance was built
for. The wrappers in ``ops/fused.py`` and ``ops/attention.py`` choose by the
operands' dtype, and for bf16 by their widths (``fused.bf16_kernel_name``).
The int8 kernels K10 and K11 have
a SIMT instance each as well (``*_q_simt.cu``, ``__dp4a`` over
``int8_simt.cuh``), for float32 or bf16 at those widths;
``fused.int8_kernel_name`` chooses between it and the Hopper one. :func:`on_card` reads
``HERRO_TPU_PALLAS`` at every call, as the reference reads it, and refuses
``0`` on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# the head dims of the SIMT kernels (csrc/*_f32.cu, csrc/*_bf16.cu)
F32_HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float

# kernel name -> (C function, argtypes); one source csrc/<name>.cu each
KERNELS = {
    "entry_embed": ("herro_entry_embed", [_P] * 5 + [_I] * 6 + [_P]),
    "ln_qkv_rope": ("herro_ln_qkv_rope", [_P] * 10 + [_I] * 4 + [_P]),
    "flash_outproj": (
        "herro_flash_outproj", [_P] * 8 + [_I] * 5 + [_F, _P],
    ),
    "flash_outproj_band": (
        "herro_flash_outproj_band", [_P] * 8 + [_I] * 5 + [_F, _P],
    ),
    "flash_outproj_full": (
        "herro_flash_outproj_full", [_P] * 8 + [_I] * 4 + [_F, _P],
    ),
    "ln_ffn": ("herro_ln_ffn", [_P] * 8 + [_L, _I, _I, _P]),
    "count_decisions": ("herro_count_decisions", [_P] * 3 + [_I] * 3 + [_P]),
    "ln_qkv_rope_split": ("herro_ln_qkv_rope_split", [_P] * 8 + [_I] * 4 + [_P]),
    "ln_qkv_rope_q": ("herro_ln_qkv_rope_q", [_P] * 9 + [_I] * 4 + [_P]),
    "ln_ffn_q": ("herro_ln_ffn_q", [_P] * 10 + [_L, _I, _I, _P]),
    "flash_attention": ("herro_flash_attention", [_P] * 5 + [_I] * 4 + [_F, _P]),
    # float32 at any head dim in 16-128 (SIMT FFMA, f32.cuh)
    "entry_embed_f32": ("herro_entry_embed_f32", [_P] * 5 + [_I] * 6 + [_P]),
    "ln_qkv_rope_f32": ("herro_ln_qkv_rope_f32", [_P] * 10 + [_I] * 5 + [_P]),
    "flash_f32": ("herro_flash_f32", [_P] * 9 + [_I] * 6 + [_F, _P]),
    "ln_ffn_f32": ("herro_ln_ffn_f32", [_P] * 9 + [_L, _I, _I, _P]),
    # bf16 at the float32 kernels' widths where no Hopper instance reaches
    # (the same SIMT device code at bf16 storage)
    "entry_embed_bf16": ("herro_entry_embed_bf16", [_P] * 5 + [_I] * 6 + [_P]),
    "ln_qkv_rope_bf16": ("herro_ln_qkv_rope_bf16", [_P] * 10 + [_I] * 5 + [_P]),
    "flash_bf16": ("herro_flash_bf16", [_P] * 9 + [_I] * 6 + [_F, _P]),
    "ln_ffn_bf16": ("herro_ln_ffn_bf16", [_P] * 9 + [_L, _I, _I, _P]),
    # int8 for float32 or bf16 at the float32 kernels' widths (SIMT __dp4a,
    # int8_simt.cuh); the last int says whether x is bf16
    "ln_qkv_rope_q_simt": ("herro_ln_qkv_rope_q_simt", [_P] * 11 + [_I] * 6 + [_P]),
    "ln_ffn_q_simt": ("herro_ln_ffn_q_simt", [_P] * 12 + [_L, _I, _I, _I, _P]),
}

# further entry points of a kernel's source, each a mode of its device code
# counted under its own name: mode -> (kernel, C function, argtypes). K11's
# two passes of a tensor-parallel shard (parallel/tensor.py); the float32
# qkv kernel's split route (the rope tables built in the kernel, K8's); the
# float32 attention without a band (K7's) and without the out projection
# (K9's); the same three of the bf16 SIMT instances; the SIMT K11's two
# passes, as the Hopper one's
MODES = {
    "ln_ffn_q_rowmax": ("ln_ffn_q", "herro_ln_ffn_q_rowmax", [_P] * 8 + [_L, _I, _I, _P]),
    "ln_ffn_q_rowscale": (
        "ln_ffn_q", "herro_ln_ffn_q_rowscale", [_P] * 10 + [_F, _P, _L, _I, _I, _P],
    ),
    "ln_qkv_rope_f32_split": (
        "ln_qkv_rope_f32", "herro_ln_qkv_rope_f32_split", [_P] * 8 + [_I] * 5 + [_P],
    ),
    "flash_f32_full": ("flash_f32", "herro_flash_f32_full", [_P] * 9 + [_I] * 5 + [_F, _P]),
    "flash_f32_attention": (
        "flash_f32", "herro_flash_f32_attention", [_P] * 5 + [_I] * 5 + [_F, _P],
    ),
    "ln_qkv_rope_bf16_split": (
        "ln_qkv_rope_bf16", "herro_ln_qkv_rope_bf16_split", [_P] * 8 + [_I] * 5 + [_P],
    ),
    "flash_bf16_full": ("flash_bf16", "herro_flash_bf16_full", [_P] * 9 + [_I] * 5 + [_F, _P]),
    "flash_bf16_attention": (
        "flash_bf16", "herro_flash_bf16_attention", [_P] * 5 + [_I] * 5 + [_F, _P],
    ),
    "ln_ffn_q_simt_rowmax": (
        "ln_ffn_q_simt", "herro_ln_ffn_q_simt_rowmax", [_P] * 8 + [_L, _I, _I, _I, _P],
    ),
    "ln_ffn_q_simt_rowscale": (
        "ln_ffn_q_simt", "herro_ln_ffn_q_simt_rowscale",
        [_P] * 10 + [_F, _P, _P, _L, _I, _I, _I, _P],
    ),
}


def simt_dtype(name: str):
    """The storage dtype of a SIMT kernel or mode of ``KERNELS`` / ``MODES``
    by its source's suffix: float32 for ``*_f32``, bf16 for ``*_bf16``;
    None for any other name (a Hopper kernel, a SIMT int8 one, none)."""
    import torch

    source = MODES[name][0] if name in MODES else name
    if source not in KERNELS:
        return None
    for suffix, dtype in (("_f32", torch.float32), ("_bf16", torch.bfloat16)):
        if source.endswith(suffix):
            return dtype
    return None


class LaunchCounts:
    """Per-kernel launch counters, safe to bump from several threads (the
    engine dispatches from two uploader threads); besides each kernel's
    total, the launches by card index (the device current at the launch)."""

    def __init__(self, names):
        self._lock = threading.Lock()
        self._n = {name: 0 for name in names}
        self._by_device: dict[int, dict[str, int]] = {}

    def bump(self, name: str, device: int) -> None:
        with self._lock:
            self._n[name] += 1
            per = self._by_device.setdefault(device, {})
            per[name] = per.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            for name in self._n:
                self._n[name] = 0
            self._by_device.clear()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._n)

    def by_device(self) -> dict[int, dict[str, int]]:
        """card index -> kernel -> launches, of the kernels launched there."""
        with self._lock:
            return {dev: dict(n) for dev, n in sorted(self._by_device.items())}


launch_counts = LaunchCounts([*KERNELS, *MODES])


class _Libraries:
    def __init__(self):
        self._lock = threading.Lock()
        self._fns: dict[str, ctypes._CFuncPtr] | None = None
        self.build_seconds: float | None = None

    def fn(self, name: str):
        with self._lock:
            if self._fns is None:
                self._fns = self._build_and_load()
        return self._fns[name]

    def _build_and_load(self):
        t0 = time.perf_counter()
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # every header counts towards every library's name
        common = b"".join(
            _read(os.path.join(CSRC, h))
            for h in sorted(os.listdir(CSRC)) if h.endswith(".cuh")
        )
        targets, procs = {}, []
        for name in KERNELS:
            src = os.path.join(CSRC, f"{name}.cu")
            tag = hashlib.sha256(
                _read(src) + common + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:12]
            so = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
            targets[name] = so
            if not os.path.exists(so):
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
                procs.append((name, so, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                )))
        failed = []
        for name, so, tmp, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{err.decode(errors='replace')}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        fns = {}
        entries = {name: (name, *entry) for name, entry in KERNELS.items()} | MODES
        for name, (kernel, cname, argtypes) in entries.items():
            f = getattr(ctypes.CDLL(targets[kernel]), cname)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            fns[name] = f
        self.build_seconds = time.perf_counter() - t0
        return fns


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build from source at first use")


_libs = _Libraries()


def build_all() -> float:
    """Build (if needed) and load every kernel library; returns the seconds
    the first build-and-load took."""
    _libs.fn("count_decisions")
    return _libs.build_seconds


def call(name: str, *args) -> None:
    """Launch kernel (or mode) ``name`` through its C entry point and count
    it, in its total and under the current card (every wrapper launches
    inside ``torch.cuda.device`` of its operands); raise if the launch was
    refused."""
    import torch

    err = _libs.fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    launch_counts.bump(name, torch.cuda.current_device())


def stream_of(t) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def on_card(t) -> bool:
    """Whether an op takes its kernel for ``t``: True for a CUDA tensor,
    False for a CPU one (the plain version). The reference's
    ``HERRO_TPU_PALLAS=0`` (``herro_tpu/ops/fused.py:43-48``) forces its jnp
    twins; the port has no plain route on the card, so the setting, read at
    every call, makes a CUDA tensor raise a ValueError that names it. On the
    CPU it changes nothing."""
    if not t.is_cuda:
        return False
    check(os.environ.get("HERRO_TPU_PALLAS", "1") != "0",
          "HERRO_TPU_PALLAS=0 asks for the plain versions, which the port runs "
          "only on the CPU: unset it to run the kernels on the card, or pass "
          "--device cpu")
    return True


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_operands(**tensors):
    """Every tensor lies on one card, contiguous and 32-byte aligned, as the
    kernels read them; returns the device."""
    dev = None
    for name, t in tensors.items():
        check(t.is_cuda, f"{name} is on {t.device}, not on the card")
        check(t.is_contiguous(), f"{name} is not contiguous")
        check(t.data_ptr() % 32 == 0, f"{name} is not 32-byte aligned")
        dev = dev or t.device
        check(t.device == dev, f"{name} is on {t.device}, not {dev}")
    return dev


def require_dtype(dtype, **tensors) -> None:
    for name, t in tensors.items():
        check(t.dtype == dtype, f"{name} is {t.dtype}, the kernel takes {dtype}")
