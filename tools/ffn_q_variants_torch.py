"""Design variants of the int8 FFN kernel K11 timed against the committed source.

    python3 tools/ffn_q_variants_torch.py                    # every variant, R10 width
    python3 tools/ffn_q_variants_torch.py --width r9 slots3 clocks

A variant is the committed ``herro_tpu_torch/csrc/`` with a few textual
edits to ``ln_ffn_q.cu`` and ``int8.cuh`` (``VARIANTS`` below): another cluster size, a
shallower weight ring, the quantization's quotients through a reciprocal,
LayerNorm a row at a time, or per-phase ``clock64`` counters. The edits name
lines of those files as they stand; the tool raises when one of them is
gone, and a redesign of the kernel retires the variant.

Each variant runs in a process of its own: it is built with nvcc (``-Xptxas
-v``) into a library beside an unedited build, both are launched through the
C entry ``herro_ln_ffn_q`` on the inputs of ``chip_smoke.py``'s K11 case
(B=32, L=9216, random bf16 x and int8 weights at the chosen width) and must
agree bit for bit (each computes the same roundings in the same order), then
are timed by CUDA events in turns (kept, variant, variant, kept), ``--turns``
times. The ``clocks`` variant also prints, summed over the blocks, the share
of the first consumer thread's cycles in each phase of a tile, and the share
spent waiting on the weight ring inside the two products.

Prints one JSON line per build: registers, spills and C75xx advisories from
ptxas, each turn's ms. Needs a CUDA card and nvcc; imports nothing of JAX.
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

SRC = "ln_ffn_q.cu"
LN = "int8.cuh"  # LayerNorm and the row quantization (ln_quant_tile), shared with K10
WIDTHS = {"r10": (512, 1024), "r9": (256, 1536)}

# the phases of a tile the clocks variant reports, in order; then the parts of
# the two products spent waiting on the weight ring
PHASES = ("wait_x", "layernorm", "gemm1", "gelu_epilogue", "quantize_hidden", "gemm2",
          "out_epilogue")
PARTS = ("ring_wait_in_gemm1", "ring_wait_in_gemm2")


def _clocks_edits():
    lap = "{ const long long n_ = clock64(); clk[%d] += n_ - tk; tk = n_; }\n"
    wait = ("{ const long long w_ = clock64(); mbar_wait(&full[slot], phase); "
            "clk[%d] += clock64() - w_; }\n")
    n = len(PHASES) + len(PARTS)
    return [
        (SRC, "constexpr int kCluster = 2;          // blocks sharing one weight stream\n",
         "constexpr int kCluster = 2;          // blocks sharing one weight stream\n"
         f"__device__ unsigned long long clocks[{n}];\n"),
        (SRC, "  reg_alloc<232>();\n",
         f"  reg_alloc<232>();\n  long long clk[{n}] = {{}}, tk = clock64();\n"),
        (SRC, "    mbar_wait(x_full, x_phase);\n    x_phase ^= 1;\n",
         "    mbar_wait(x_full, x_phase);\n    x_phase ^= 1;\n    " + lap % 0),
        (SRC, "    named_bar_sync(1, 256);  // y_i8 complete; both warpgroups' last GEMM2 done\n",
         "    named_bar_sync(1, 256);  // y_i8 complete; both warpgroups' last GEMM2 done\n    "
         + lap % 1),
        (SRC, "      int acc1[32];\n", "      " + lap % 3 + "      int acc1[32];\n"),
        (SRC, "        mbar_wait(&full[slot], phase);\n        const unsigned char* wb = ring + "
              "slot * kSlotBytes + wg * kBlock;\n",
         "        " + wait % 7 + "        const unsigned char* wb = ring + "
         "slot * kSlotBytes + wg * kBlock;\n"),
        (SRC, "      retire_all();\n      fence_operand(acc1);\n",
         "      retire_all();\n      fence_operand(acc1);\n      " + lap % 2),
        (SRC, "    // the row maxima over the row's four lanes, then over the warpgroups\n",
         "    " + lap % 3
         + "    // the row maxima over the row's four lanes, then over the warpgroups\n"),
        (SRC, "    if (threadIdx.x == 0) mbar_arrive(h_free);\n",
         "    if (threadIdx.x == 0) mbar_arrive(h_free);\n    " + lap % 4),
        (SRC, "      mbar_wait(&full[slot], phase);\n      const unsigned char* wb = ring + "
              "slot * kSlotBytes + wg * kW2Box;\n",
         "      " + wait % 8 + "      const unsigned char* wb = ring + "
         "slot * kSlotBytes + wg * kW2Box;\n"),
        (SRC, "    retire_all();\n    fence_operand(acc2);\n",
         "    retire_all();\n    fence_operand(acc2);\n    " + lap % 5),
        (SRC, "            __fadd_rn(xr.y, dequant(acc2[4 * j + 2 * half + 1], hs, sc1, bb1)));\n"
              "      }\n    }\n  }\n}\n",
         "            __fadd_rn(xr.y, dequant(acc2[4 * j + 2 * half + 1], hs, sc1, bb1)));\n"
         "      }\n    }\n    " + lap % 6 + "  }\n"
         f"  if (threadIdx.x == 0)\n    for (int i = 0; i < {n}; ++i)\n"
         "      atomicAdd(&clocks[i], (unsigned long long)clk[i]);\n}\n"),
        (SRC, 'extern "C" int herro_ln_ffn_q(',
         'extern "C" int herro_ffn_q_clocks(unsigned long long* out, int reset) {\n'
         f"  int err = (int)cudaMemcpyFromSymbol(out, herro::ffn_q::clocks, {n} * 8);\n"
         f"  if (!err && reset) {{\n    unsigned long long z[{n}] = {{}};\n"
         f"    err = (int)cudaMemcpyToSymbol(herro::ffn_q::clocks, z, {n} * 8);\n  }}\n"
         "  return err;\n}\n\n"
         'extern "C" int herro_ln_ffn_q('),
    ]


QUANT_NEAR = """// clip(rint(y * r), -127, 127) with r = 1/s rounded, and `tie` set where
// y * r lies within 2^-14 of a tie k + 1/2: for |y / s| <= 128, y * r lies
// within 2^-16 of y / s and the rounded quotient within 2^-17, so away from a
// tie both round to the same integer
__device__ inline int quant_near(float y, float r, bool& tie) {
  const float p = __fmul_rn(y, r);
  const float a = fabsf(p);
  tie |= fabsf(__fsub_rn(__fsub_rn(a, floorf(a)), 0.5f)) < 6.103515625e-05f;
  return max(-127, min(127, __float2int_rn(p)));
}

"""
RECIPROCAL = [
    (LN, "// LayerNorm (flax semantics", QUANT_NEAR + "// LayerNorm (flax semantics"),
    (LN, """    const float sq = quant_scale(warp_max(m));
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      const int ch = lane + 32 * i;
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[h] = pack_s8(quant(v[i][4 * h], sq), quant(v[i][4 * h + 1], sq),
                       quant(v[i][4 * h + 2], sq), quant(v[i][4 * h + 3], sq));""",
     """    const float sq = quant_scale(warp_max(m)), rq = __frcp_rn(sq);
    int qv[kCh][8];
    bool tie = false;
#pragma unroll
    for (int i = 0; i < kCh; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[i][e] = quant_near(v[i][e], rq, tie);
    if (tie)
#pragma unroll
      for (int i = 0; i < kCh; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) qv[i][e] = quant(v[i][e], sq);
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      const int ch = lane + 32 * i;
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[h] = pack_s8(qv[i][4 * h], qv[i][4 * h + 1], qv[i][4 * h + 2], qv[i][4 * h + 3]);"""),
    (SRC, """      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 a = __bfloat1622float2(p[2 * k]), b = __bfloat1622float2(p[2 * k + 1]);
        w[k] = pack_s8(quant(a.x, hs[u]), quant(a.y, hs[u]), quant(b.x, hs[u]),
                       quant(b.y, hs[u]));
      }""",
     """      const float rh = __frcp_rn(hs[u]);
      float hv[16];
      int qv[16];
      bool tie = false;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float2 f2 = __bfloat1622float2(p[k]);
        hv[2 * k] = f2.x;
        hv[2 * k + 1] = f2.y;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) qv[k] = quant_near(hv[k], rh, tie);
      if (tie)
#pragma unroll
        for (int k = 0; k < 16; ++k) qv[k] = quant(hv[k], hs[u]);
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = pack_s8(qv[4 * k], qv[4 * k + 1], qv[4 * k + 2], qv[4 * k + 3]);"""),
]

# name -> (what it changes, [(file, old text, new text)])
VARIANTS = {
    "cluster1": ("no multicast: every block streams the weights from L2 itself",
                 [(SRC, "constexpr int kCluster = 2;", "constexpr int kCluster = 1;")]),
    "cluster4": ("clusters of four blocks share one weight stream",
                 [(SRC, "constexpr int kCluster = 2;", "constexpr int kCluster = 4;")]),
    "slots3": ("a weight ring of at most three 16 KB slots (four kept)",
               [(SRC, "constexpr int kMaxSlots = 4;", "constexpr int kMaxSlots = 3;")]),
    "reciprocal": ("the quantization's quotients as y * (1/s), a group of 8 or 16 values "
                   "falling back to the true division when one lies within 2^-14 of a "
                   "rounding tie (the same integers, fewer divisions)", RECIPROCAL),
    "ln_one_row": ("LayerNorm's row loop not unrolled: a warp's rows one after another",
                   [(LN, "#pragma unroll 2  // two rows in flight", "#pragma unroll 1  // one row")]),
    "clocks": ("per-phase clock64 counters of the first consumer thread", _clocks_edits()),
}


def build(kernels, tmp: str, name: str, edits, source: str = SRC) -> tuple[ctypes.CDLL, str]:
    """csrc/ with ``edits`` applied, ``source`` built into tmp/<name>/; returns
    the library and ptxas's register, spill and C75xx lines."""
    src = os.path.join(tmp, name)
    shutil.copytree(kernels.CSRC, src, ignore=shutil.ignore_patterns("build"))
    for fname, old, new in edits:
        path = os.path.join(src, fname)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {fname} exactly once")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    so = os.path.join(src, "lib.so")
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
         os.path.join(src, source)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{res.stderr[-4000:]}")
    ptxas = " | ".join(l.strip() for l in res.stderr.splitlines()
                       if "registers" in l or "spill" in l or "(C75" in l)
    return ctypes.CDLL(so), ptxas


def run_each(script: str, names, flags, timeout: int) -> int:
    """``script`` once per variant, each in a process of its own (libraries of
    the same kernels loaded side by side in one process once hung); passes on
    their JSON lines and returns the first failure's exit code, else 0."""
    rc = 0
    for name in names:
        cmd = [sys.executable, os.path.abspath(script), *flags, name]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            print(json.dumps(dict(variant=name, timed_out=timeout)), flush=True)
            rc = rc or 1
            continue
        sys.stderr.write(res.stderr)
        print("".join(l for l in res.stdout.splitlines(True) if l.startswith("{")),
              end="", flush=True)
        rc = rc or res.returncode
    return rc


def inputs(torch, dev, d: int, f: int):
    """chip_smoke.py's K11 operands at width (d, f), B=32, L=9216."""
    from chip_smoke import B, L
    from herro_tpu_torch.ops import fused

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    x = randn(B, L, d)
    ln_s = 1.0 + randn(d, std=0.1, dtype=torch.float32)
    ln_b = randn(d, std=0.1, dtype=torch.float32)
    w1, s1 = fused.quantize_weight(randn(d, f, std=d ** -0.5, dtype=torch.float32))
    w2, s2 = fused.quantize_weight(randn(f, d, std=f ** -0.5, dtype=torch.float32))
    b1 = randn(f, std=0.25, dtype=torch.float32)
    b2 = randn(d, std=0.25, dtype=torch.float32)
    return x, ln_s, ln_b, fused.k_major(w1), s1, b1, fused.k_major(w2), s2, b2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)}; default all")
    ap.add_argument("--width", choices=sorted(WIDTHS), default="r10")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds for each variant's process")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ffn_q_variants_torch: no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi, time_ms
    from herro_tpu_torch.ops import cuda as kernels

    names = args.variants or list(VARIANTS)
    print(nvidia_smi(), flush=True)
    if len(names) > 1:
        return run_each(__file__, names, ["--turns", str(args.turns), "--width", args.width],
                        args.timeout)
    dev = torch.device("cuda")
    d, f = WIDTHS[args.width]
    ops = inputs(torch, dev, d, f)
    x = ops[0]
    T = x.numel() // d
    stream = torch.cuda.current_stream().cuda_stream
    cname, argtypes = kernels.KERNELS["ln_ffn_q"]
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name in ["kept", *names]:
            lib, ptxas = build(kernels, tmp, name, [] if name == "kept" else VARIANTS[name][1])
            fn = getattr(lib, cname)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            out = torch.empty_like(x)

            def launch(fn=fn, name=name, out=out):
                err = fn(*(t.data_ptr() for t in ops), out.data_ptr(), T, d, f, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed with error {err}")
                return out

            runs[name] = dict(launch=launch, ptxas=ptxas, ms=[], lib=lib)
            print(f"built {name}: {ptxas}", file=sys.stderr, flush=True)
        ref = runs["kept"]["launch"]().clone()
        for name, run in runs.items():
            got = run["launch"]()
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                n = int((got != ref).sum())
                raise RuntimeError(f"variant {name}: {n} outputs differ from the kept source")
        clocks = None
        if "clocks" in runs:
            read = runs["clocks"]["lib"].herro_ffn_q_clocks
            read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
            buf = (ctypes.c_ulonglong * (len(PHASES) + len(PARTS)))()
            read(buf, 1)  # from zero
            runs["clocks"]["launch"]()
            torch.cuda.synchronize()
            if read(buf, 1):
                raise RuntimeError("clocks: reading the counters failed")
            total = sum(buf[:len(PHASES)])
            clocks = {p: buf[i] / total for i, p in enumerate(PHASES + PARTS)}
            clocks["cycles_per_tile"] = total / ((T + 63) // 64)
        order = list(runs)
        for _ in range(args.turns):
            for name in order + order[::-1]:
                runs[name]["ms"].append(time_ms(torch, runs[name]["launch"], 10))
        for name, run in runs.items():
            what = "the committed source" if name == "kept" else VARIANTS[name][0]
            line = dict(variant=name, width=[d, f], what=what, ms=run["ms"],
                        mean_ms=sum(run["ms"]) / len(run["ms"]), ptxas=run["ptxas"])
            if name == "clocks":
                line["clock_shares"] = clocks
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
