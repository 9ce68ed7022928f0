"""Where a warp's time goes in the narrow kernels of K1/K8 and K3 at d 32 (``csrc/narrow.cuh``).

    python3 tools/narrow_clocks_torch.py                 # every row of ROWS, B=32, L=9216
    python3 tools/narrow_clocks_torch.py --rows f32-tiny-ffn bf16-tiny-ffn

Builds a copy of ``narrow.cuh`` with ``clock64`` laps around the phases of a
row tile (``PHASES``: the waits for the tile's copy and at the barriers,
LayerNorm with K1's cos/sin staging and K3's residual reads, issuing the next
tile's copy and any weights restaged by chunk, the products, the epilogue
arithmetic (bias, rope, gelu, K3's hidden into shared memory), the stores)
and around each kernel's whole run, in a temporary directory, with
``ln_qkv_rope_f32.cu``, ``ln_qkv_rope_bf16.cu``, ``ln_ffn_f32.cu`` and
``ln_ffn_bf16.cu`` beside it, each with one more C function that reads and
clears the counters; the sources in the repository are not changed. Each
warp's first lane sums its laps, one ``atomicAdd`` a phase when its block
ends. For each row (an entry point at the widths of
``chip_smoke.SIMT_WIDTHS``, random inputs) it prints one JSON line: the
kernel's ms by CUDA events (instrumented, so a little above the committed
build's), the share of a warp's cycles in each phase and outside the tile
loop (``other``: the weights staged once), and the cycles a warp spends on
a tile. Needs a CUDA card and nvcc; imports nothing of JAX.
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

PHASES = ("wait", "layernorm", "issue", "products", "epilogue", "stores")
KERNEL = len(PHASES)  # the counter of the kernels' whole runs
TILE_ROWS, WARPS = 128, 8  # a tile's token rows and a block's warps (narrow.cuh kRows, kThreads)
SOURCES = ("ln_qkv_rope_f32", "ln_qkv_rope_bf16", "ln_ffn_f32", "ln_ffn_bf16")
# row -> (entry point, dtype, chip_smoke.SIMT_WIDTHS tag)
ROWS = {
    "f32-tiny-qkv": ("ln_qkv_rope_f32", "float32", "tiny"),
    "f32-tiny-qkv-split": ("ln_qkv_rope_f32_split", "float32", "tiny"),
    "f32-tiny-ffn": ("ln_ffn_f32", "float32", "tiny"),
    "bf16-tiny-qkv": ("ln_qkv_rope_bf16", "bfloat16", "tiny"),
    "bf16-tiny-ffn": ("ln_ffn_bf16", "bfloat16", "tiny"),
}


def lap(phase: str) -> str:
    return ("{ const long long n_ = clock64(); clk[%d] += n_ - tk; tk = n_; }\n"
            % PHASES.index(phase))


START = (f"  long long clk[{len(PHASES)}] = {{}}, tk = 0;\n"
         "  const long long t0_ = clock64();\n")
BEGIN = "  tk = clock64();\n"
END = (f"  if (threadIdx.x % 32 == 0) {{\n    for (int i = 0; i < {len(PHASES)}; ++i) "
       "atomicAdd(&clocks[i], (unsigned long long)clk[i]);\n"
       f"    atomicAdd(&clocks[{KERNEL}], (unsigned long long)(clock64() - t0_));\n  }}\n")
LOOP = "  for (uint32_t phase = 0; tile < tiles; tile += gridDim.x, phase ^= 1) {\n"
COPY = ("    if (tid == 0 && tile + (int)gridDim.x < tiles)\n"
        "      copy_x(xs, x, T, (long)(tile + gridDim.x) * kRows, bar);\n")
WAIT = "    sm90::mbar_wait(bar, phase);\n    __syncthreads();\n"
LN = "    layernorm_tile<E>(xs, at, scale, bias);\n"
QKV_SYNC = "    __syncthreads();  // at, the tables and the row offsets are whole, xs free\n"
# (text, what it becomes, how many times the text stands in narrow.cuh)
EDITS = [
    ("constexpr int kQkvCols = 2 * kPairs;\n",
     f"constexpr int kQkvCols = 2 * kPairs;\n__device__ unsigned long long clocks[{KERNEL + 1}];\n",
     1),
    ("  const int chunks = f / kChunk;\n", START + "  const int chunks = f / kChunk;\n", 1),
    ("  const int N = 3 * H * D, chunks = H * D / 16;\n",
     START + "  const int N = 3 * H * D, chunks = H * D / 16;\n", 1),
    (LOOP, BEGIN + LOOP, 2),
    (WAIT + LN, WAIT + lap("wait") + LN, 2),
    ("    __syncthreads();  // at is whole, xs free\n" + COPY,
     lap("layernorm") + "    __syncthreads();  // at is whole, xs free\n" + lap("wait") + COPY
     + lap("issue"), 1),
    (QKV_SYNC + COPY, lap("layernorm") + QKV_SYNC + lap("wait") + COPY + lap("issue"), 1),
    ("        stage_ffn(ws, w1, b1, w2, f, c);\n        __syncthreads();\n      }\n",
     "        stage_ffn(ws, w1, b1, w2, f, c);\n        __syncthreads();\n      }\n"
     + lap("issue"), 1),
    ("        stage_qkv(ws, w, b, N, half, c);\n        __syncthreads();\n      }\n",
     "        stage_qkv(ws, w, b, N, half, c);\n        __syncthreads();\n      }\n"
     + lap("issue"), 1),
    ("      product<kAT>(h, at + 4 * rg, slot + 4 * tx, kChunk);\n",
     "      product<kAT>(h, at + 4 * rg, slot + 4 * tx, kChunk);\n" + lap("products"), 1),
    ("      __syncthreads();  // every warp is done with the last chunk's ht\n",
     lap("epilogue") + "      __syncthreads();  // every warp is done with the last chunk's ht\n"
     + lap("wait"), 1),
    ("      __syncthreads();\n"
     "      // the second product's k over the chunk's hidden columns, in order\n"
     "      product<kAS>(o, ht + 4 * rg, slot + kFfnW2 + 4 * tx, kWidth);\n",
     lap("epilogue") + "      __syncthreads();\n" + lap("wait")
     + "      product<kAS>(o, ht + 4 * rg, slot + kFfnW2 + 4 * tx, kWidth);\n" + lap("products"),
     1),
    ("      store4(out + row * kWidth + 4 * tx, y);\n    }\n  }\n}\n",
     "      store4(out + row * kWidth + 4 * tx, y);\n    }\n" + lap("stores") + "  }\n" + END
     + "}\n", 1),
    ("      product<kAT>(acc, at + 4 * rg, slot + 6 * tx, kQkvCols);\n",
     "      product<kAT>(acc, at + 4 * rg, slot + 6 * tx, kQkvCols);\n" + lap("products"), 1),
    ("          store1(out + base + ri, x1);\n          store1(out + base + ri + half, x2);\n",
     lap("epilogue") + "          store1(out + base + ri, x1);\n"
     "          store1(out + base + ri + half, x2);\n" + lap("stores"), 1),
    ("          store1(out + base + ri + half, x2);\n" + lap("stores")
     + "        }\n      }\n    }\n  }\n}\n",
     "          store1(out + base + ri + half, x2);\n" + lap("stores")
     + "        }\n      }\n    }\n  }\n" + END + "}\n", 1),
]
READER = f"""
extern "C" int herro_narrow_clocks(unsigned long long* out, int reset) {{
  int err = (int)cudaMemcpyFromSymbol(out, herro::narrow::clocks, {KERNEL + 1} * 8);
  if (!err && reset) {{
    unsigned long long z[{KERNEL + 1}] = {{}};
    err = (int)cudaMemcpyToSymbol(herro::narrow::clocks, z, {KERNEL + 1} * 8);
  }}
  return err;
}}
"""


def plant(text: str) -> str:
    """narrow.cuh's text with the laps of ``EDITS``, in order."""
    for old, new, count in EDITS:
        if text.count(old) != count:
            raise RuntimeError(f"narrow.cuh no longer holds {old!r} {count} times")
        text = text.replace(old, new)
    return text


def build(tmp: str) -> dict:
    """The instrumented libraries, by source."""
    from herro_tpu_torch.ops import cuda

    csrc = os.path.join(tmp, "csrc")
    shutil.copytree(cuda.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    path = os.path.join(csrc, "narrow.cuh")
    with open(path) as fh:
        text = plant(fh.read())
    with open(path, "w") as fh:
        fh.write(text)
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


def run_row(torch, libs, row: str, iters: int) -> dict:
    from chip_smoke import B, L, SIMT_WIDTHS, time_ms
    from herro_tpu_torch.ops import cuda, fused

    entry, dtype, tag = ROWS[row]
    source = cuda.MODES[entry][0] if entry in cuda.MODES else entry
    lib = libs[source]
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
    fn = getattr(lib, f"herro_{entry}")
    fn.argtypes = (cuda.MODES[entry] if entry in cuda.MODES else cuda.KERNELS[entry])[-1]
    if source.startswith("ln_qkv_rope"):
        w, b = randn(d, 3 * H * D, std=d ** -0.5), randn(3 * H * D, std=0.25)
        q, k, v = (torch.empty(B, H, L, D, device=dev, dtype=dt) for _ in range(3))
        tables = () if entry.endswith("_split") else tuple(
            t.data_ptr() for t in fused.rope_tables(L, D, dev))
        args = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w.data_ptr(), b.data_ptr(),
                *tables, None, q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, d, H, D, stream)
    else:
        w1, b1 = randn(d, f, std=d ** -0.5), randn(f, std=0.25)
        w2, b2 = randn(f, d, std=f ** -0.5), randn(d, std=0.25)
        out = torch.empty_like(x)
        args = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), None, out.data_ptr(), T, d, f, stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{entry} failed to launch: error {err}")

    read = lib.herro_narrow_clocks
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * (KERNEL + 1))()
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
    tiles = -(-T // TILE_ROWS)
    return dict(row=row, entry=entry, dtype=dtype, widths=dict(d=d, H=H, D=D, d_ff=f),
                B=B, L=L, ms=ms, shares=shares,
                cycles_per_warp_tile=sum(counted[:KERNEL]) / (WARPS * tiles))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="*", choices=sorted(ROWS), default=list(ROWS))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("narrow_clocks_torch: no CUDA device available", file=sys.stderr)
        return 2
    from herro_tpu_torch.pipeline.infer import keep_float32_exact
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    keep_float32_exact(torch.device("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for row in args.rows:
            print(json.dumps(run_row(torch, libs, row, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
