"""Where a key tile's time goes in the tensor-core attention (``csrc/flash_tc.cuh``).

    python3 tools/flash_tc_clocks_torch.py            # every row of ROWS, B=32, L=9216
    python3 tools/flash_tc_clocks_torch.py --rows f32-tiny bf16-tiny

Builds a copy of ``flash_tc.cuh`` with ``clock64`` laps around the phases of
a key tile (``PHASES``: the wait for the tile's copies, the barrier after
it and the next copies' issue, S = Q.K^T, the online softmax, P.V) in a
temporary directory, ``flash_f32.cu`` and
``flash_bf16.cu`` beside it with one more C function that reads and clears
the counters; the sources in the repository are not changed. Each warp's
first lane sums its laps, one ``atomicAdd`` a phase when its block ends.
For each row (the attention alone, K9's entry point, or K7's without a band,
on random q/k/v at the widths of ``chip_smoke.SIMT_WIDTHS``, the lengths
drawn as the smoke run draws them) it prints one JSON line: the kernel's ms
by CUDA events (instrumented, so a little above the committed build's), the
share of the counted cycles in each phase, and the cycles a warp spends on
a tile. Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("copy_wait", "qk", "softmax", "pv")
# row -> (dtype, d, H, D, band, entry point): K9's (attention alone) unless
# the name says full (K7: the attention, then the out projection, uncounted)
ROWS = {
    "f32-tiny": ("float32", 32, 2, 16, None, "herro_flash_f32_attention"),
    "f32-tiny-full": ("float32", 32, 2, 16, None, "herro_flash_f32_full"),
    "f32-r10": ("float32", 512, 4, 128, 512, "herro_flash_f32_attention"),
    "bf16-tiny": ("bfloat16", 32, 2, 16, None, "herro_flash_bf16_attention"),
    "bf16-tiny-full": ("bfloat16", 32, 2, 16, None, "herro_flash_bf16_full"),
    "bf16-r10h64": ("bfloat16", 512, 8, 64, 512, "herro_flash_bf16_attention"),
}
LAP = "{ const long long n_ = clock64(); clk[%d] += n_ - tk; tk = n_; }\n"
# (text of flash_tc.cuh, what it becomes)
EDITS = [
    ("namespace flash_tc {\n",
     f"namespace flash_tc {{\n__device__ unsigned long long clocks[{len(PHASES)}];\n"),
    ("  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;\n",
     "  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;\n"
     f"  long long clk[{len(PHASES)}] = {{}}, tk = 0;\n"),
    ("  for (int it = 0; it < n_tiles; ++it) {\n",
     "  for (int it = 0; it < n_tiles; ++it) {\n    tk = clock64();\n"),
    ("    const E* Ks = sm + (it % 2) * Sh::kStage;\n",
     "    " + LAP % 0 + "    const E* Ks = sm + (it % 2) * Sh::kStage;\n"),
    ("    // the online softmax: keys past the length or outside the band at\n",
     "    " + LAP % 1 + "    // the online softmax: keys past the length or outside the band at\n"),
    ("    // O = O alpha + P.V, this tile's P.V summed from zero in its own C\n",
     "    " + LAP % 2 + "    // O = O alpha + P.V, this tile's P.V summed from zero in its own C\n"),
    ("        rescale_add(O[2 * np + 1], acc[1]);\n      }\n    }\n  }\n",
     "        rescale_add(O[2 * np + 1], acc[1]);\n      }\n    }\n    " + LAP % 3 + "  }\n"),
    ("  l0 = fmaxf(l0, 1e-30f);\n",
     "  if (lane == 0)\n"
     f"    for (int i = 0; i < {len(PHASES)}; ++i) "
     "atomicAdd(&clocks[i], (unsigned long long)clk[i]);\n"
     "  l0 = fmaxf(l0, 1e-30f);\n"),
]
READER = f"""
extern "C" int herro_flash_clocks(unsigned long long* out, int reset) {{
  int err = (int)cudaMemcpyFromSymbol(out, herro::flash_tc::clocks, {len(PHASES)} * 8);
  if (!err && reset) {{
    unsigned long long z[{len(PHASES)}] = {{}};
    err = (int)cudaMemcpyToSymbol(herro::flash_tc::clocks, z, {len(PHASES)} * 8);
  }}
  return err;
}}
"""


def build(tmp: str) -> dict:
    """The instrumented flash_f32 and flash_bf16 libraries, by dtype."""
    from herro_tpu_torch.ops import cuda

    csrc = os.path.join(tmp, "csrc")
    shutil.copytree(cuda.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    path = os.path.join(csrc, "flash_tc.cuh")
    with open(path) as fh:
        text = fh.read()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"flash_tc.cuh no longer holds {old!r} once")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)
    libs, procs = {}, {}
    for dtype, name in (("float32", "flash_f32"), ("bfloat16", "flash_bf16")):
        with open(os.path.join(csrc, f"{name}.cu"), "a") as fh:
            fh.write(READER)
        so = os.path.join(tmp, f"lib{name}.so")
        procs[dtype] = (so, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", so, os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for dtype, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{err[-4000:]}")
        libs[dtype] = ctypes.CDLL(so)
    return libs


def run_row(torch, lib, row: str, iters: int) -> dict:
    import numpy as np

    from chip_smoke import B, L, time_ms

    dtype, d, H, D, band, entry = ROWS[row]
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    rng = np.random.default_rng(20)
    lens = torch.from_numpy(rng.integers(int(0.7 * L), L + 1, size=B).astype(np.int32)).to(dev)
    q, k, v = (torch.randn(B, H, L, D, generator=g, device=dev).to(dt) for _ in range(3))
    x = torch.randn(B, L, d, generator=g, device=dev).to(dt)
    wo = (torch.randn(H, D, d, generator=g, device=dev) * (H * D) ** -0.5).to(dt)
    bo = torch.zeros(d, device=dev, dtype=dt)
    out = torch.empty_like(q)
    scratch, y = torch.empty(B, L, H, D, device=dev, dtype=dt), torch.empty_like(x)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, entry)
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(D)
    if entry.endswith("_attention"):
        fn.argtypes = [P] * 5 + [I] * 5 + [F, P]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                B, H, L, D, -1 if band is None else band, scale, stream)
    else:
        fn.argtypes = [P] * 9 + [I] * 5 + [F, P]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), x.data_ptr(), wo.data_ptr(),
                bo.data_ptr(), lens.data_ptr(), scratch.data_ptr(), y.data_ptr(),
                B, H, L, d, D, scale, stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{entry} failed to launch: error {err}")

    read = lib.herro_flash_clocks
    read.argtypes = [P, I]
    buf = (ctypes.c_ulonglong * len(PHASES))()
    launch()
    torch.cuda.synchronize()
    if read(buf, 1):
        raise RuntimeError("clearing the counters failed")
    launch()
    torch.cuda.synchronize()
    if read(buf, 1):
        raise RuntimeError("reading the counters failed")
    counted = [int(c) for c in buf]
    total = sum(counted)
    kbkv = 32 if dtype == "float32" and D == 128 else 64
    lens_np = lens.cpu().numpy().astype(np.int64)
    if band is None:  # every block walks the tiles up to its example's length
        warp_tiles = sum(4 * ((L + 63) // 64) * H * ((int(n) + kbkv - 1) // kbkv)
                         for n in lens_np)
    else:
        warp_tiles = None
    ms = time_ms(torch, launch, iters)
    return dict(row=row, entry=entry, dtype=dtype, widths=dict(d=d, H=H, D=D, band=band),
                B=B, L=L, ms=ms,
                shares={p: c / total for p, c in zip(PHASES, counted)},
                cycles_per_warp_tile=total / warp_tiles if warp_tiles else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="*", choices=sorted(ROWS), default=sorted(ROWS))
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_tc_clocks_torch: no CUDA device available", file=sys.stderr)
        return 2
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for row in args.rows:
            print(json.dumps(run_row(torch, libs[ROWS[row][0]], row, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
