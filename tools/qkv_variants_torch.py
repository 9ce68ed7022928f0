"""Design variants of the qkv kernels (K1, K8, K10) timed against the committed source.

    python3 tools/qkv_variants_torch.py                         # K10, every variant
    python3 tools/qkv_variants_torch.py --kernel ln_qkv_rope clocks
    python3 tools/qkv_variants_torch.py --width r9 clocks

A variant is the committed ``herro_tpu_torch/csrc/`` with a few textual edits
to ``ln_qkv_rope_sm90.cuh`` (the device code the three kernels share) or
``int8.cuh`` (``VARIANTS`` below): another cluster size, the row-major
tile order (K8 and K10 then build their rope tables every tile), LayerNorm
four rows at a time, or per-phase ``clock64`` counters. The edits name lines of those files as they stand;
the tool raises when one of them is gone, and a redesign of the kernel
retires the variant.

Each variant runs in a process of its own: the kernel's source is built with
nvcc (``-Xptxas -v``) into a library beside an unedited build, both are
launched through the kernel's C entry on the inputs of ``chip_smoke.py``'s
case (B=32, L=9216, random bf16 x, bf16 or int8 weights, at the R10 width or
the r9 one, d 256 and H 2) and must agree bit for bit, then are timed by CUDA
events in turns (kept, variant, variant, kept), ``--turns`` times. The
``clocks`` variant also prints, summed over the blocks, the share of the
first consumer thread's cycles in each phase of a tile, and the share spent
waiting on the weight ring inside the products.

Prints one JSON line per build: registers, spills and C75xx advisories from
ptxas, each turn's ms. Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

HDR = "ln_qkv_rope_sm90.cuh"
LN = "int8.cuh"  # K10's LayerNorm and row quantization (ln_quant_tile)
WIDTHS = {"r10": (512, 4), "r9": (256, 2)}  # d_model, n_heads
KERNELS = ("ln_qkv_rope", "ln_qkv_rope_split", "ln_qkv_rope_q")

# the phases of a tile the clocks variant reports, in order (the last three
# once per head); then the part of the products spent waiting on the ring
PHASES = ("rope_tables", "wait_x", "layernorm", "products", "epilogue", "store")
PARTS = ("ring_wait_in_products",)


def _clocks_edits(entry: str):
    n = len(PHASES) + len(PARTS)
    lap = "{ const long long n_ = clock64(); clk[%d] += n_ - tk; tk = n_; }\n"
    return [
        (HDR, "constexpr int kCluster = 2;               // blocks sharing one W stream\n",
         "constexpr int kCluster = 2;               // blocks sharing one W stream\n"
         f"__device__ unsigned long long clocks[{n}];\n"),
        (HDR, "  reg_alloc<232>();\n",
         f"  reg_alloc<232>();\n  long long clk[{n}] = {{}}, tk = clock64();\n"),
        (HDR, "    mbar_wait(x_full, x_phase);\n    x_phase ^= 1;\n",
         "    " + lap % 0 + "    mbar_wait(x_full, x_phase);\n    x_phase ^= 1;\n    "
         + lap % 1),
        (HDR, "    named_bar_sync(1 + wg, 128);  // this warpgroup's rows of LN(x) are in place\n",
         "    named_bar_sync(1 + wg, 128);  // this warpgroup's rows of LN(x) are in place\n    "
         + lap % 2),
        (HDR, "        mbar_wait(&full[slot], phase);\n"
              "        const unsigned char* wb = ring + slot * S::kStageBytes;\n",
         "        { const long long w_ = clock64(); mbar_wait(&full[slot], phase); "
         f"clk[{len(PHASES)}] += clock64() - w_; }}\n"
         "        const unsigned char* wb = ring + slot * S::kStageBytes;\n"),
        (HDR, "      retire_all();\n      fence_operand(acc);\n",
         "      retire_all();\n      fence_operand(acc);\n      " + lap % 3),
        (HDR, "      named_bar_sync(1 + wg, 128);  // the slab is in the staging tile\n",
         "      named_bar_sync(1 + wg, 128);  // the slab is in the staging tile\n      "
         + lap % 4),
        (HDR, "                ob + (c >> 3) * kOutBlk + swizzle128(r, c & 7));\n"
              "        }\n      }\n    }\n  }\n}\n",
         "                ob + (c >> 3) * kOutBlk + swizzle128(r, c & 7));\n"
         "        }\n      }\n      " + lap % 5 + "    }\n  }\n"
         f"  if (threadIdx.x == 0)\n    for (int i = 0; i < {n}; ++i)\n"
         "      atomicAdd(&clocks[i], (unsigned long long)clk[i]);\n}\n"),
        (f"{entry}.cu", f'extern "C" int herro_{entry}(',
         'extern "C" int herro_qkv_clocks(unsigned long long* out, int reset) {\n'
         f"  int err = (int)cudaMemcpyFromSymbol(out, herro::qkv::clocks, {n} * 8);\n"
         f"  if (!err && reset) {{\n    unsigned long long z[{n}] = {{}};\n"
         f"    err = (int)cudaMemcpyToSymbol(herro::qkv::clocks, z, {n} * 8);\n  }}\n"
         "  return err;\n}\n\n"
         f'extern "C" int herro_{entry}('),
    ]


# name -> (what it changes, [(file, old text, new text)]); "clocks" is added
# per kernel, as its reader goes into the kernel's entry source
VARIANTS = {
    "cluster1": ("no multicast: every block streams the weights from L2 itself",
                 [(HDR, "constexpr int kCluster = 2; ", "constexpr int kCluster = 1; ")]),
    "cluster4": ("clusters of four blocks share one weight stream",
                 [(HDR, "constexpr int kCluster = 2; ", "constexpr int kCluster = 4; ")]),
    "row_major": ("tiles dealt row-major to the clusters in rounds of the grid, so that K8 "
                  "and K10 build their rope tables every tile",
                  [(HDR, "  const long run0 = group * n_pairs / n_groups, "
                         "run1 = (group + 1) * n_pairs / n_groups;\n",
                    "  const long run0 = 0, run1 = (n_pairs - group + n_groups - 1) / n_groups;\n"),
                   (HDR, "    tile = p * C + rank;\n    b = (int)(tile % B);\n"
                         "    l0 = (int)(tile / B) * kBM;\n",
                    "    tile = (p * n_groups + group) * C + rank;\n    b = (int)(tile / per_b);\n"
                    "    l0 = (int)(tile % per_b) * kBM;\n")]),
    "ln_four_rows": ("K10's LayerNorm and quantization four rows at a time (two kept)",
                     [(LN, "#pragma unroll 2  // two rows in flight",
                       "#pragma unroll 4  // four rows in flight")]),
}
CLOCKS = "per-phase clock64 counters of the first consumer thread"


def edits_of(name: str, kernel: str):
    if name == "kept":
        return []
    if name == "clocks":
        return _clocks_edits(kernel)
    return VARIANTS[name][1]


def inputs(torch, dev, kernel: str, d: int, H: int):
    """chip_smoke.py's operands for this kernel at width (d, H), B=32,
    L=9216, as the C entry takes them (after x, before q, k, v)."""
    from chip_smoke import B, L
    from herro_tpu_torch.ops import fused

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    n = 3 * H * fused.HEAD_DIM
    x = randn(B, L, d)
    ln_s = 1.0 + randn(d, std=0.1, dtype=torch.float32)
    ln_b = randn(d, std=0.1, dtype=torch.float32)
    w, b = randn(d, n, std=d ** -0.5), randn(n, std=0.25)
    if kernel == "ln_qkv_rope_q":
        w_i8, s_col = fused.quantize_weight(w)
        w_i8 = fused.k_major(w_i8)
        return x, [ln_s, ln_b, w_i8, s_col, b], (w_i8, s_col)
    if kernel == "ln_qkv_rope":
        cos, sin = fused.rope_tables(L, fused.HEAD_DIM, dev)
        return x, [ln_s, ln_b, w, b, cos, sin], (cos, sin)
    return x, [ln_s, ln_b, w, b], ()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*",
                    help=f"of {sorted([*VARIANTS, 'clocks'])}; default all")
    ap.add_argument("--kernel", choices=KERNELS, default="ln_qkv_rope_q")
    ap.add_argument("--width", choices=sorted(WIDTHS), default="r10")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds for each variant's process")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("qkv_variants_torch: no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi, time_ms
    from ffn_q_variants_torch import build, run_each
    from herro_tpu_torch.ops import cuda as kernels

    names = args.variants or [*VARIANTS, "clocks"]
    print(nvidia_smi(), flush=True)
    if len(names) > 1:
        return run_each(__file__, names, ["--turns", str(args.turns), "--kernel", args.kernel,
                                          "--width", args.width], args.timeout)
    dev = torch.device("cuda")
    d, H = WIDTHS[args.width]
    x, ops, _keep = inputs(torch, dev, args.kernel, d, H)
    nb, L = x.shape[0], x.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    cname, argtypes = kernels.KERNELS[args.kernel]
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name in ["kept", *names]:
            lib, ptxas = build(kernels, tmp, name, edits_of(name, args.kernel),
                               f"{args.kernel}.cu")
            fn = getattr(lib, cname)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            outs = [torch.empty(nb, H, L, 128, dtype=torch.bfloat16, device=dev)
                    for _ in range(3)]

            def launch(fn=fn, name=name, outs=outs):
                err = fn(x.data_ptr(), *(t.data_ptr() for t in ops),
                         *(t.data_ptr() for t in outs), nb, L, d, H, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed with error {err}")
                return outs

            runs[name] = dict(launch=launch, ptxas=ptxas, ms=[], lib=lib)
            print(f"built {name}: {ptxas}", file=sys.stderr, flush=True)
        ref = [t.clone() for t in runs["kept"]["launch"]()]
        for name, run in runs.items():
            got = run["launch"]()
            torch.cuda.synchronize()
            if not all(torch.equal(a, r) for a, r in zip(got, ref)):
                n = sum(int((a != r).sum()) for a, r in zip(got, ref))
                raise RuntimeError(f"variant {name}: {n} outputs differ from the kept source")
        clocks = None
        if "clocks" in runs:
            read = runs["clocks"]["lib"].herro_qkv_clocks
            read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
            buf = (ctypes.c_ulonglong * (len(PHASES) + len(PARTS)))()
            read(buf, 1)  # from zero
            runs["clocks"]["launch"]()
            torch.cuda.synchronize()
            if read(buf, 1):
                raise RuntimeError("clocks: reading the counters failed")
            total = sum(buf[:len(PHASES)])
            clocks = {p: buf[i] / total for i, p in enumerate(PHASES + PARTS)}
            clocks["cycles_per_tile"] = total / (nb * -(-L // 128))
        order = list(runs)
        for _ in range(args.turns):
            for name in order + order[::-1]:
                runs[name]["ms"].append(time_ms(torch, runs[name]["launch"], 10))
        for name, run in runs.items():
            what = ("the committed source" if name == "kept"
                    else CLOCKS if name == "clocks" else VARIANTS[name][0])
            line = dict(variant=name, kernel=args.kernel, width=[d, H], what=what,
                        ms=run["ms"], mean_ms=sum(run["ms"]) / len(run["ms"]),
                        ptxas=run["ptxas"])
            if name == "clocks":
                line["clock_shares"] = clocks
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
