"""Where a warp's time goes in K10's SIMT instance (``csrc/ln_qkv_rope_q_simt.cu``).

    python3 tools/qkv_q_simt_clocks_torch.py                 # every row of ROWS, B=32, L=9216
    python3 tools/qkv_q_simt_clocks_torch.py --rows r10-float32 d384-bf16

Builds a copy of ``int8_simt.cuh`` and ``ln_qkv_rope_q_simt.cu`` with
``clock64`` laps around the kernel's phases (``PHASES``: LayerNorm and the
row quantization; in each k stage of the tensor-core product the wait for
its copies and the barrier, issuing the next copies, the ``mma.sync``
products; a column tile's epilogue, split into its arithmetic (dequantize,
bias, rounding, the rope with each value's partner from the thread's own
fragments) and its stores) and around the kernel's whole run, in a
temporary directory, with one more C function that reads and clears the
counters; the sources in the repository are not changed. The product's
laps are ``tools/ffn_q_simt_clocks_torch.py``'s (one device code), the
epilogue's stores a lap of their own inside it. Each warp's first lane
sums its laps, one ``atomicAdd`` a phase. For each row (K10 at a width of
``chip_smoke.SIMT8_WIDTHS``, random inputs) it prints one JSON line: the
kernel's ms by CUDA events (instrumented), the share of a warp's cycles in
each phase, and the cycles of a warp's whole run. Needs a CUDA card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ffn_q_simt_clocks_torch as ffn_clocks  # noqa: E402

PHASES = ("layernorm", "wait", "copies", "products", "epilogue", "stores")
WHOLE = len(PHASES)  # the counter of the kernel's whole run
EPILOGUE, STORES = 4, 5  # the product's epilogue lap holds the stores' lap
ROWS = {"r10-float32": "r10", "d384-bf16": "d384", "tiny-float32": "tiny"}
SOURCE = "ln_qkv_rope_q_simt.cu"
STORE_TAIL = ("          store2(o + T::kHalf, x2[mt][hf][0], x2[mt][hf][1]);\n"
              "        }\n    }\n  });\n}\n")
# (file, text, what it becomes)
EDITS = ffn_clocks.PRODUCT_EDITS + [
    (SOURCE, "  layernorm_rows_i8<E>(",
     f"  long long t0_ = clock64(), tk_ = t0_;\n  long long clk_[{WHOLE}] = {{}};\n"
     "  layernorm_rows_i8<E>("),
    (SOURCE, "srow);\n  __syncthreads();\n  product_resident<",
     "srow);\n  __syncthreads();\n  " + ffn_clocks.LAP % ("clk_", 0)
     + "  product_resident<"),
    (SOURCE, "      E* dst = (which == 0",
     "      const long long ts_ = clock64();\n      E* dst = (which == 0"),
    (SOURCE, STORE_TAIL,
     STORE_TAIL.replace("        }\n    }\n  });\n}\n",
                        f"        }}\n      clk_[{STORES}] += clock64() - ts_;\n    }}\n  }});\n"
                        "  if (threadIdx.x % 32 == 0) {\n"
                        + "".join(f"    atomicAdd(&simt8_clocks[{i}], (unsigned long long)"
                                  f"clk_[{i}]);\n" for i in (0, STORES))
                        + f"    atomicAdd(&simt8_clocks[{WHOLE}], (unsigned long long)"
                        "(clock64() - t0_));\n  }\n}\n")),
]


def patched(csrc: str) -> None:
    """``csrc`` (a copy of the kernels' sources) with the laps planted."""
    ffn_clocks.plant(csrc, EDITS, SOURCE, "herro_qkv_clocks")


def run_row(torch, lib, row: str, iters: int) -> dict:
    from chip_smoke import B, L, SIMT8_WIDTHS, time_ms
    from herro_tpu_torch.ops import cuda, fused

    d, H, D, _, dtype = SIMT8_WIDTHS[ROWS[row]]
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    N, T = 3 * H * D, B * L
    x = randn(B, L, d).to(dt)
    ln_s, ln_b = 1.0 + randn(d, std=0.1), randn(d, std=0.1)
    wq, sq = fused.quantize_weight(randn(d, N, std=d ** -0.5).to(dt))
    wt, b = fused.k_major(wq), randn(N, std=0.25).to(dt)
    cos, sin = fused.rope_tables(L, D, dev)
    q, k, v = (torch.empty(B, H, L, D, dtype=dt, device=dev) for _ in range(3))
    fn = lib.herro_ln_qkv_rope_q_simt
    fn.argtypes = cuda.KERNELS["ln_qkv_rope_q_simt"][1]
    args = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), wt.data_ptr(), sq.data_ptr(),
            b.data_ptr(), cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), B, L, d, H, D, int(dt == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"ln_qkv_rope_q_simt failed to launch: error {err}")

    counted = ffn_clocks.laps(torch, lib.herro_qkv_clocks, launch)[:WHOLE + 1]
    whole = counted[WHOLE]
    counted[EPILOGUE] -= counted[STORES]  # the epilogue's arithmetic alone
    return dict(row=row, dtype=dtype, widths=dict(d=d, H=H, D=D), B=B, L=L,
                ms=time_ms(torch, launch, iters),
                shares={p: c / whole for p, c in zip(PHASES, counted)},
                cycles_per_warp=whole / (ffn_clocks.WARPS * -(-T // ffn_clocks.TILE_ROWS)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="*", choices=sorted(ROWS), default=sorted(ROWS))
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("qkv_q_simt_clocks_torch: no CUDA device available", file=sys.stderr)
        return 2
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lib = ffn_clocks.build_lib(tmp, patched, SOURCE, "libqkv_clocks.so")
        for row in args.rows:
            print(json.dumps(run_row(torch, lib, row, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
