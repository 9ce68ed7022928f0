"""Where a warp's time goes in the hidden pass of K11's SIMT instance (``csrc/ln_ffn_q_simt.cu``).

    python3 tools/ffn_q_simt_clocks_torch.py                 # every row of ROWS, B=32, L=9216
    python3 tools/ffn_q_simt_clocks_torch.py --rows r10-float32

Builds a copy of ``int8_simt.cuh`` and ``ln_ffn_q_simt.cu`` with ``clock64``
laps around the phases of the hidden pass (``PHASES``: LayerNorm and the
row quantization; in each k stage of the tensor-core product, the wait for
its copies and the barrier, issuing the next copies, the ``mma.sync``
products, a column tile's epilogue; the row maxima's merge; h quantized
where it lies) and around the kernel's whole run, in a temporary directory,
with one more C function that reads and clears the counters; the sources in
the repository are not changed. Each warp's first lane sums its laps, one
``atomicAdd`` a phase. For each row (the whole function at a width of
``chip_smoke.SIMT8_WIDTHS``, random inputs) it prints one JSON line: the
function's ms by CUDA events (both passes, instrumented), the share of a
hidden-pass warp's cycles in each phase, and the cycles of a warp's whole
run. Needs a CUDA card and nvcc; imports nothing of JAX.
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

PHASES = ("layernorm", "wait", "issue", "products", "epilogue", "maxima", "quantize")
WHOLE = len(PHASES)  # the counter of the kernel's whole run
WARPS, TILE_ROWS = 8, 128  # a block's warps and token rows (int8_simt.cuh kThreads / 32, kBM)
ROWS = {"r10-float32": "r10", "d384-bf16": "d384", "tiny-float32": "tiny"}
LAP = "{ const long long n_ = clock64(); %s[%d] += n_ - tk_; tk_ = n_; }\n"
COUNTERS = 16  # simt8_clocks, the counters a kernel's laps sum into
STAGE = ("    cp_async_wait<kTCStages - 2>();\n    __syncthreads();\n"
         "    if (ln0 < N) copy_w<BN>(wt, K, N, ln0, lk0, ring + (s == 0 ? kTCStages - 1 : s - 1)"
         " * kStage);\n    cp_async_commit();  // empty past the last stage: the count of groups"
         " holds\n    advance(ln0, lk0);\n    stage_mma<BN, S>(acc, a + k0, as, ring + s * kStage);"
         "\n    if (k0 + kKB >= K) {  // the column tile's last stage\n      epi(n0, acc);\n"
         "      zero_acc<BN>(acc);\n    }\n")
# (file, text, what it becomes): the laps of int8_simt.cuh's product_resident,
# which both SIMT int8 kernels walk (counters 1-4: the wait, issuing copies, products,
# epilogue), then the hidden pass's own
PRODUCT_EDITS = [
    ("int8_simt.cuh", "constexpr int kKB = 64;",
     f"__device__ unsigned long long simt8_clocks[{COUNTERS}];\nconstexpr int kKB = 64;"),
    ("int8_simt.cuh", STAGE,
     "    long long tk_ = clock64();\n" + STAGE.replace(
         "    if (ln0 < N)", "    " + LAP % ("ck_", 1) + "    if (ln0 < N)").replace(
         "    stage_mma", "    " + LAP % ("ck_", 2) + "    stage_mma").replace(
         "    if (k0 + kKB", "    " + LAP % ("ck_", 3) + "    if (k0 + kKB")
     + "    " + LAP % ("ck_", 4)),
    ("int8_simt.cuh", "  AccI<BN> acc;\n  zero_acc<BN>(acc);\n  for (int n0 = 0, k0 = 0, s = 0;",
     f"  long long ck_[{WHOLE}] = {{}};\n  AccI<BN> acc;\n  zero_acc<BN>(acc);\n"
     "  for (int n0 = 0, k0 = 0, s = 0;"),
    ("int8_simt.cuh", "  cp_async_wait_all();\n  __syncthreads();\n}\n",
     "  cp_async_wait_all();\n  __syncthreads();\n  if (threadIdx.x % 32 == 0)\n"
     "    for (int i = 1; i < 5; ++i) atomicAdd(&simt8_clocks[i], (unsigned long long)ck_[i]);\n"
     "}\n"),
]
EDITS = PRODUCT_EDITS + [
    ("ln_ffn_q_simt.cu", "  layernorm_rows_i8<E>(",
     f"  long long t0_ = clock64(), tk_ = t0_;\n  long long clk_[{WHOLE}] = {{}};\n"
     "  layernorm_rows_i8<E>("),
    ("ln_ffn_q_simt.cu", "as, srow);\n  __syncthreads();\n  float m[2][2];",
     "as, srow);\n  __syncthreads();\n  " + LAP % ("clk_", 0) + "  float m[2][2];"),
    ("ln_ffn_q_simt.cu", "  if constexpr (kMode != kScaled) {\n    // the quad",
     "  tk_ = clock64();\n  if constexpr (kMode != kScaled) {\n    // the quad"),
    ("ln_ffn_q_simt.cu", "  if constexpr (kInRegs) {\n    // h quantized",
     "  " + LAP % ("clk_", 5) + "  if constexpr (kInRegs) {\n    // h quantized"),
    ("ln_ffn_q_simt.cu",
     "          *reinterpret_cast<uint2*>(hr + kVec * e) = make_uint2(w[0], w[1]);\n"
     "      }\n    }\n  }\n}\n",
     "          *reinterpret_cast<uint2*>(hr + kVec * e) = make_uint2(w[0], w[1]);\n"
     "      }\n    }\n  }\n  " + LAP % ("clk_", 6)
     + "  if (threadIdx.x % 32 == 0) {\n"
     + "".join(f"    atomicAdd(&simt8_clocks[{i}], (unsigned long long)clk_[{i}]);\n"
               for i in (0, 5, 6))
     + f"    atomicAdd(&simt8_clocks[{WHOLE}], (unsigned long long)(clock64() - t0_));\n  }}\n"
     "}\n"),
]


def reader(fn: str) -> str:
    """The C function ``fn(out, reset)`` that reads the counters into out
    (COUNTERS of them) and, where reset is set, clears them."""
    return f"""
extern "C" int {fn}(unsigned long long* out, int reset) {{
  int err = (int)cudaMemcpyFromSymbol(out, herro::simt8::simt8_clocks, {COUNTERS} * 8);
  if (!err && reset) {{
    unsigned long long z[{COUNTERS}] = {{}};
    err = (int)cudaMemcpyToSymbol(herro::simt8::simt8_clocks, z, {COUNTERS} * 8);
  }}
  return err;
}}
"""


def plant(csrc: str, edits, source: str, fn: str) -> None:
    """``csrc`` (a copy of the kernels' sources) with ``edits`` made, each
    anchor found once, and the counters' reader ``fn`` appended to
    ``source``."""
    for name, old, new in edits:
        path = os.path.join(csrc, name)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name} no longer holds {old!r} once")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    with open(os.path.join(csrc, source), "a") as fh:
        fh.write(reader(fn))


def patched(csrc: str) -> None:
    """``csrc`` (a copy of the kernels' sources) with the laps planted."""
    plant(csrc, EDITS, "ln_ffn_q_simt.cu", "herro_ffn_clocks")


def build_lib(tmp: str, patch, source: str, lib: str):
    """A copy of the sources in ``tmp``, ``patch``ed, and ``source`` built
    into the shared library ``lib`` there, loaded."""
    from herro_tpu_torch.ops import cuda

    csrc = os.path.join(tmp, "csrc")
    shutil.copytree(cuda.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    patch(csrc)
    so = os.path.join(tmp, lib)
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", so,
                           os.path.join(csrc, source)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(so)


def build(tmp: str):
    return build_lib(tmp, patched, "ln_ffn_q_simt.cu", "libffn_clocks.so")


def laps(torch, read, launch) -> list[int]:
    """The counters a second ``launch()`` sums (the first warms up, then
    ``read``, the planted C reader, clears them)."""
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * COUNTERS)()
    launch()
    torch.cuda.synchronize()
    if read(buf, 1):
        raise RuntimeError("clearing the counters failed")
    launch()
    torch.cuda.synchronize()
    if read(buf, 1):
        raise RuntimeError("reading the counters failed")
    return [int(c) for c in buf]


def run_row(torch, lib, row: str, iters: int) -> dict:
    from chip_smoke import B, L, SIMT8_WIDTHS, time_ms
    from herro_tpu_torch.ops import cuda, fused

    d, _, _, f, dtype = SIMT8_WIDTHS[ROWS[row]]
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    T = B * L
    x = randn(T, d).to(dt)
    ln_s, ln_b = 1.0 + randn(d, std=0.1), randn(d, std=0.1)
    (q1, s1), (q2, s2) = (fused.quantize_weight(randn(d, f, std=d ** -0.5)),
                          fused.quantize_weight(randn(f, d, std=f ** -0.5)))
    w1t, w2t = fused.k_major(q1), fused.k_major(q2)
    b1, b2 = randn(f, std=0.25), randn(d, std=0.25)
    hidden, hmax = torch.empty(T, f, dtype=dt, device=dev), torch.empty(T, device=dev)
    out = torch.empty_like(x)
    fn = lib.herro_ln_ffn_q_simt
    fn.argtypes = cuda.KERNELS["ln_ffn_q_simt"][1]
    args = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1t.data_ptr(),
            s1.data_ptr(), b1.data_ptr(), w2t.data_ptr(), s2.data_ptr(),
            b2.data_ptr(), hidden.data_ptr(), hmax.data_ptr(), out.data_ptr(), T, d, f,
            int(dt == torch.bfloat16), torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"ln_ffn_q_simt failed to launch: error {err}")

    counted = laps(torch, lib.herro_ffn_clocks, launch)[:WHOLE + 1]
    whole = counted[WHOLE]
    return dict(row=row, dtype=dtype, widths=dict(d=d, d_ff=f), B=B, L=L,
                ms=time_ms(torch, launch, iters),
                shares={p: c / whole for p, c in zip(PHASES, counted)},
                cycles_per_warp=whole / (WARPS * -(-T // TILE_ROWS)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="*", choices=sorted(ROWS), default=sorted(ROWS))
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ffn_q_simt_clocks_torch: no CUDA device available", file=sys.stderr)
        return 2
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for row in args.rows:
            print(json.dumps(run_row(torch, lib, row, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
