"""Where a stage's time goes in the tensor-core tile product of K1/K8, K3 and the out projection (``csrc/gemm_tc.cuh``).

    python3 tools/gemm_tc_clocks_torch.py            # every row of ROWS, B=32, L=9216
    python3 tools/gemm_tc_clocks_torch.py --rows f32-r10-qkv
    python3 tools/gemm_tc_clocks_torch.py --rows f32-r10-outproj bf16-r10h64-outproj

Builds a copy of ``gemm_tc.cuh`` with ``clock64`` laps around the phases of
a k stage of its ``product`` (``PHASES``: the wait for the stage's copies
and the barrier, issuing the copies of the stage two on, the products, a
column tile's epilogue) and around each tile product kernel's whole run
(LayerNorm's launch before it is not counted), in
a temporary directory, with ``ln_qkv_rope_f32.cu``, ``ln_qkv_rope_bf16.cu``,
``ln_ffn_f32.cu``, ``ln_ffn_bf16.cu``, ``flash_f32.cu`` and ``flash_bf16.cu``
(whose out projection, K2/K6/K7's second launch, is the same tile product:
the rows time it alone, through its ``*_outproj`` entry point, K = H D 512
and N = d 512) beside it, each with one more C function that reads and
clears the counters; the sources in the repository
are not changed. Each warp's first lane sums its laps, one ``atomicAdd`` a
phase when a tile product ends. For each row (an entry point at the widths
of ``chip_smoke.SIMT_WIDTHS``, random inputs) it prints one JSON line: the
kernel's ms by CUDA events (instrumented, so a little above the committed
build's), the share of a warp's cycles in each phase and outside the tile
product (``other``: the rope tables),
and the cycles a warp spends on a stage. Needs a CUDA card and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("wait", "issue", "products", "epilogue")
KERNEL = len(PHASES)  # the counter of the kernels' whole runs
TILE_ROWS, WARPS = 64, 4  # a tile's token rows and warps (gemm_tc.cuh kRowsT, kWarps)
SOURCES = ("ln_qkv_rope_f32", "ln_qkv_rope_bf16", "ln_ffn_f32", "ln_ffn_bf16", "flash_f32",
           "flash_bf16")
# row -> (source, dtype, chip_smoke.SIMT_WIDTHS tag)
ROWS = {
    "f32-r10-qkv": ("ln_qkv_rope_f32", "float32", "r10"),
    "f32-r10-ffn": ("ln_ffn_f32", "float32", "r10"),
    "bf16-r10h64-qkv": ("ln_qkv_rope_bf16", "bfloat16", "r10h64"),
    "f32-r10-outproj": ("flash_f32", "float32", "r10"),
    "bf16-r10h64-outproj": ("flash_bf16", "bfloat16", "r10h64"),
}
LAP = "{ const long long n_ = clock64(); clk[%d] += n_ - tk; tk = n_; }\n"
FLUSH = (f"  if (threadIdx.x % 32 == 0)\n    for (int i = 0; i < {len(PHASES)}; ++i) "
         "atomicAdd(&clocks[i], (unsigned long long)clk[i]);\n")
WHOLE = ("  if (threadIdx.x % 32 == 0) "
         f"atomicAdd(&gemm_tc::clocks[{KERNEL}], (unsigned long long)(clock64() - t0_));\n")
# (file, text, what it becomes)
EDITS = [
    ("gemm_tc.cuh", "constexpr int kBK = 32;     // k a stage\n",
     "constexpr int kBK = 32;     // k a stage\n"
     f"__device__ unsigned long long clocks[{len(PHASES) + 1}];\n"),
    ("gemm_tc.cuh", "  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;\n"
     "  const int wr = warp_row<BN, WM>(), wc = warp_col<BN, WM>();\n",
     "  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;\n"
     "  const int wr = warp_row<BN, WM>(), wc = warp_col<BN, WM>();\n"
     f"  long long clk[{len(PHASES)}] = {{}}, tk = clock64();\n"),
    ("gemm_tc.cuh", "    __syncthreads();\n    if (ln0 < N) copy(",
     "    __syncthreads();\n    " + LAP % 0 + "    if (ln0 < N) copy("),
    ("gemm_tc.cuh", "    advance(ln0, lk0);\n    const E* As = smem + s * Tl::kStage;\n",
     "    advance(ln0, lk0);\n    " + LAP % 1 + "    const E* As = smem + s * Tl::kStage;\n"),
    ("gemm_tc.cuh", "    if (k0 + kBK == K) {  // the column tile's last stage\n",
     "    " + LAP % 2 + "    if (k0 + kBK == K) {  // the column tile's last stage\n"),
    ("gemm_tc.cuh", "    advance(n0, k0);\n  }\n}\n",
     "    " + LAP % 3 + "    advance(n0, k0);\n  }\n" + FLUSH + "}\n"),
    ("gemm_tc.cuh",
     "  const long r0 = (long)blockIdx.x * kRowsT;\n  const int lane = threadIdx.x % 32",
     "  const long long t0_ = clock64();\n"
     "  const long r0 = (long)blockIdx.x * kRowsT;\n  const int lane = threadIdx.x % 32"),
    ("gemm_tc.cuh", "res, i + 1));\n            }\n          }\n      });\n}\n",
     "res, i + 1));\n            }\n          }\n      });\n" + WHOLE + "}\n"),
    ("ln_qkv_rope_simt.cuh", "  const long r0 = (long)blockIdx.x * gemm_tc::kRowsT;\n",
     "  const long long t0_ = clock64();\n  const long r0 = (long)blockIdx.x * gemm_tc::kRowsT;\n"),
    ("ln_qkv_rope_simt.cuh", "v0, v1);\n          }\n        }\n      });\n}\n",
     "v0, v1);\n          }\n        }\n      });\n" + WHOLE + "}\n"),
]
READER = f"""
extern "C" int herro_gemm_clocks(unsigned long long* out, int reset) {{
  int err = (int)cudaMemcpyFromSymbol(out, herro::gemm_tc::clocks, {len(PHASES) + 1} * 8);
  if (!err && reset) {{
    unsigned long long z[{len(PHASES) + 1}] = {{}};
    err = (int)cudaMemcpyToSymbol(herro::gemm_tc::clocks, z, {len(PHASES) + 1} * 8);
  }}
  return err;
}}
"""


def build(tmp: str) -> dict:
    """The instrumented libraries, by source."""
    from herro_tpu_torch.ops import cuda

    csrc = os.path.join(tmp, "csrc")
    shutil.copytree(cuda.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    for name, old, new in EDITS:
        path = os.path.join(csrc, name)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name} no longer holds {old!r} once")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    procs = {}
    for name in SOURCES:
        with open(os.path.join(csrc, f"{name}.cu"), "a") as fh:
            fh.write(READER)
        so = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", so, os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        libs[name] = ctypes.CDLL(so)
    return libs


def run_row(torch, lib, row: str, iters: int) -> dict:
    from chip_smoke import B, L, SIMT_WIDTHS, time_ms
    from herro_tpu_torch.ops import cuda, fused

    source, dtype, tag = ROWS[row]
    d, H, D, f, _ = SIMT_WIDTHS[tag]
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)

    def randn(*shape, std=1.0, dtype=dt):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    T = B * L
    x = randn(B, L, d)
    ln_s = 1.0 + randn(d, std=0.1, dtype=torch.float32)
    ln_b = randn(d, std=0.1, dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    entry = f"{source}_outproj" if source.startswith("flash_") else source
    fn = getattr(lib, f"herro_{entry}")
    fn.argtypes = (cuda.MODES[entry] if entry in cuda.MODES else cuda.KERNELS[entry])[-1]
    if source.startswith("flash_"):
        o = randn(B, L, H, D)
        wo, bo = randn(H * D, d, std=(H * D) ** -0.5), randn(d, std=0.25)
        y = torch.empty_like(x)
        args = (o.data_ptr(), x.data_ptr(), wo.data_ptr(), bo.data_ptr(), y.data_ptr(), T,
                H * D, d, stream)
        stages = -(-T // TILE_ROWS) * (-(-d // (64 if d <= 64 else 128))) * (H * D // 32)
    elif source.startswith("ln_qkv_rope"):
        w, b = randn(d, 3 * H * D, std=d ** -0.5), randn(3 * H * D, std=0.25)
        cos, sin = fused.rope_tables(L, D, dev)
        q, k, v = (torch.empty(B, H, L, D, device=dev, dtype=dt) for _ in range(3))
        y = torch.empty(T, d, device=dev, dtype=dt)
        args = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w.data_ptr(), b.data_ptr(),
                cos.data_ptr(), sin.data_ptr(), y.data_ptr(), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), B, L, d, H, D, stream)
        n_tiles = -(-3 * H * D // (64 if 3 * H * D <= 64 else 128))
        stages = -(-T // TILE_ROWS) * n_tiles * (d // 32)
    else:
        w1, b1 = randn(d, f, std=d ** -0.5), randn(f, std=0.25)
        w2, b2 = randn(f, d, std=f ** -0.5), randn(d, std=0.25)
        hidden, out = torch.empty(T, f, device=dev, dtype=dt), torch.empty_like(x)
        args = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), hidden.data_ptr(), out.data_ptr(), T, d, f, stream)
        tiles = -(-T // TILE_ROWS)
        stages = tiles * (-(-f // 128)) * (d // 32) + tiles * (-(-d // 128)) * (f // 32)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{source} failed to launch: error {err}")

    read = lib.herro_gemm_clocks
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    launch()
    torch.cuda.synchronize()
    if read(buf, 1):
        raise RuntimeError("clearing the counters failed")
    launch()
    torch.cuda.synchronize()
    if read(buf, 1):
        raise RuntimeError("reading the counters failed")
    counted = [int(c) for c in buf]
    whole = counted[KERNEL]
    shares = {p: c / whole for p, c in zip(PHASES, counted)}
    shares["other"] = 1.0 - sum(shares.values())
    ms = time_ms(torch, launch, iters)
    return dict(row=row, source=source, dtype=dtype, widths=dict(d=d, H=H, D=D, d_ff=f),
                B=B, L=L, ms=ms, shares=shares,
                cycles_per_warp_stage=sum(counted[:KERNEL]) / (WARPS * stages))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="*", choices=sorted(ROWS), default=sorted(ROWS))
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemm_tc_clocks_torch: no CUDA device available", file=sys.stderr)
        return 2
    from herro_tpu_torch.pipeline.infer import keep_float32_exact
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    keep_float32_exact(torch.device("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for row in args.rows:
            print(json.dumps(run_row(torch, libs[ROWS[row][0]], row, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
