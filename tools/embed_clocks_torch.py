"""Where a warp's time goes in K4's SIMT kernel (``csrc/entry_embed_simt.cuh``).

    python3 tools/embed_clocks_torch.py                          # every row of ROWS
    python3 tools/embed_clocks_torch.py --rows f32-tiny bf16-tiny
    python3 tools/embed_clocks_torch.py --source chip_checkout/parent   # another tree's

Builds a copy of ``entry_embed_simt.cuh`` with ``clock64`` laps around the
phases of its work and around the kernel's whole run, in a temporary
directory, with ``entry_embed_f32.cu`` and ``entry_embed_bf16.cu`` beside it,
each with one more C function that reads and clears the counters; the sources
of the tree are not changed. ``--source`` takes the sources of another
checkout (one unpacked by ``git archive``). The tiled kernel gets the laps of
``TILED``: ``wait`` (waiting for a tile's tokens and quals, and the last warp
done with a slot staging the tile a ring on), ``sums`` (the token and quals
terms, one pass over the pileup rows), ``epilogue``, ``stores``. The
per-thread kernel that came before it (one output group of 4 columns a
thread, no staging) gets those of ``PER_THREAD``: ``tokens`` and ``quals``
(its two passes), ``epilogue``, ``stores``. Each warp's
first lane sums its laps, one ``atomicAdd`` a phase when the warp ends. For
each row (an entry point at B=32, R=31 and the row's d and L, a pileup like
the smoke run's) it prints one JSON line: the kernel's ms by CUDA events
(instrumented, so a little above the committed build's), the share of a
warp's cycles in each of the kernel's phases and outside them (``other``: the
table staged once, the first tiles' copies), the warps counted and the cycles
a warp spends. Needs a CUDA card and nvcc; imports nothing of JAX.
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

PHASES = ("wait", "tokens", "quals", "sums", "epilogue", "stores")
KIND_PHASES = {"tiled": ("wait", "sums", "epilogue", "stores"),
               "per-thread": ("tokens", "quals", "epilogue", "stores")}
KERNEL = len(PHASES)  # the counter of the warps' whole runs
WARPS = KERNEL + 1  # the counter of the warps
SOURCES = ("entry_embed_f32", "entry_embed_bf16")
# row -> (entry point, dtype, d, L)
ROWS = {
    "f32-r10": ("entry_embed_f32", "float32", 512, 9216),
    "f32-tiny": ("entry_embed_f32", "float32", 32, 9216),
    "bf16-tiny": ("entry_embed_bf16", "bfloat16", 32, 9216),
    "f32-tiny-1024": ("entry_embed_f32", "float32", 32, 1024),
}
B, R = 32, 31


def lap(phase: str, indent: str = "    ") -> str:
    return (indent + "{ const long long n_ = clock64(); clk[%d] += n_ - tk; tk = n_; }\n"
            % PHASES.index(phase))


START = (f"  long long clk[{len(PHASES)}] = {{}}, tk = clock64();\n"
         "  const long long t0_ = tk;\n")
END = (f"  if (threadIdx.x % 32 == 0) {{\n    for (int i = 0; i < {len(PHASES)}; ++i) "
       "atomicAdd(&clocks[i], (unsigned long long)clk[i]);\n"
       f"    atomicAdd(&clocks[{KERNEL}], (unsigned long long)(clock64() - t0_));\n"
       f"    atomicAdd(&clocks[{WARPS}], 1ull);\n  }}\n")
DECLARE = ("namespace embed_simt {\n",
           f"namespace embed_simt {{\n__device__ unsigned long long clocks[{WARPS + 1}];\n", 1)
LOOP = "  for (int k = 0; tile < tiles; tile += stride, ++k) {\n"
STORE = "      if (p0 + j < t.n) store4(out + ((t.b * L + t.l0 + p0 + j) * d + c0 + c), e[j]);\n"
# (text, what it becomes, how many times the text stands in the source):
# the tiled kernel of this tree: waiting for the tile and staging the tile a
# ring on (the last warp done with a slot) both count as "wait"
TILED = [
    DECLARE,
    (LOOP, START + LOOP, 1),
    ("    sm90::mbar_wait(&bars[s], (k / kRing) & 1);  // the tile is in\n",
     "    sm90::mbar_wait(&bars[s], (k / kRing) & 1);  // the tile is in\n" + lap("wait"), 1),
    ("    // the slot is free once", lap("sums") + "    // the slot is free once", 1),
    ("    // the epilogue, into e\n", lap("wait") + "    // the epilogue, into e\n", 1),
    ("    const Tile t = tile_at(tile, per_ex, L);\n",
     lap("epilogue") + "    const Tile t = tile_at(tile, per_ex, L);\n", 1),
    (STORE + "  }\n}\n", STORE + lap("stores") + "  }\n" + END + "}\n", 1),
]
# the per-thread kernel that came before it (a thread one output group)
PER_THREAD = [
    DECLARE,
    ("  if (idx >= total) return;\n", "  if (idx >= total) return;\n" + START, 1),
    ("  for (int r = 0; r < R; ++r) {\n    const float qv = round_to<E>(",
     lap("tokens", "  ") + "  for (int r = 0; r < R; ++r) {\n    const float qv = round_to<E>(",
     1),
    ("  const float4 cb4 = *reinterpret_cast<const float4*>(cb + c);\n",
     lap("quals", "  ") + "  const float4 cb4 = *reinterpret_cast<const float4*>(cb + c);\n", 1),
    ("  store4(out + t * d + c, y);\n}\n",
     lap("epilogue", "  ") + "  store4(out + t * d + c, y);\n" + lap("stores", "  ") + END
     + "}\n", 1),
]
READER = f"""
extern "C" int herro_embed_clocks(unsigned long long* out, int reset) {{
  int err = (int)cudaMemcpyFromSymbol(out, herro::embed_simt::clocks, {WARPS + 1} * 8);
  if (!err && reset) {{
    unsigned long long z[{WARPS + 1}] = {{}};
    err = (int)cudaMemcpyToSymbol(herro::embed_simt::clocks, z, {WARPS + 1} * 8);
  }}
  return err;
}}
"""


def plant(text: str) -> tuple[str, str]:
    """entry_embed_simt.cuh's text with the laps of ``TILED`` or, for the
    per-thread kernel, ``PER_THREAD``, in order; and which kernel it was."""
    kind, edits = ("tiled", TILED) if LOOP in text else ("per-thread", PER_THREAD)
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"entry_embed_simt.cuh ({kind}) no longer holds {old!r} "
                               f"{count} times")
        text = text.replace(old, new)
    return text, kind


def build(tmp: str, source: str) -> tuple[dict, str]:
    """The instrumented libraries of ``source``'s sources, by entry point,
    and the kernel's kind."""
    from herro_tpu_torch.ops import cuda

    csrc = os.path.join(tmp, "csrc")
    shutil.copytree(os.path.join(source, "herro_tpu_torch", "csrc"), csrc,
                    ignore=shutil.ignore_patterns("build"))
    path = os.path.join(csrc, "entry_embed_simt.cuh")
    with open(path) as fh:
        text, kind = plant(fh.read())
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
    return libs, kind


def pileup(torch, d: int, n: int, dtype, seed: int = 4242):
    """Tokens, quals, the col_proj table and the bias of a row: the smoke
    run's pileup (rows past an example's alignments and positions past its
    length padded, quals from Phred 0-93), random weights."""
    import numpy as np

    from herro_tpu_torch.constants import QUAL_OFFSET, QUAL_SCALE, TOKEN_PAD, VOCAB_SIZE
    from herro_tpu_torch.ops import fused

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    lengths = rng.integers(int(0.7 * n), n + 1, size=B)
    n_alns = rng.integers(2, R, size=B)
    tok = rng.integers(0, 11, size=(B, R, n), dtype=np.uint8)
    for b in range(B):
        tok[b, n_alns[b] + 1:] = TOKEN_PAD
        tok[b, :, lengths[b]:] = TOKEN_PAD
    quals = (QUAL_SCALE * rng.integers(33, 127, size=(B, R, n)) - QUAL_OFFSET).astype(np.float32)
    std = (R * (VOCAB_SIZE + 1)) ** -0.5
    w_embT = torch.from_numpy(rng.normal(0, std, size=(d, R * VOCAB_SIZE))).to(dev, dtype)
    w_qT = torch.from_numpy(rng.normal(0, std, size=(d, R))).to(dev, dtype)
    cb = torch.from_numpy(rng.normal(0, 0.25, size=d).astype(np.float32)).to(dev)
    return (torch.from_numpy(tok).to(dev), torch.from_numpy(quals).to(dev),
            fused.col_proj_table(w_embT, w_qT), cb)


def run_row(torch, libs, kind: str, row: str, iters: int) -> dict:
    from chip_smoke import time_ms
    from herro_tpu_torch.constants import VOCAB_SIZE
    from herro_tpu_torch.ops import cuda

    entry, dtype, d, n = ROWS[row]
    lib = libs[entry]
    dt = getattr(torch, dtype)
    tok, quals, wc, cb = pileup(torch, d, n, dt)
    out = torch.empty(B, n, d, device="cuda", dtype=dt)
    fn = getattr(lib, f"herro_{entry}")
    fn.argtypes = cuda.KERNELS[entry][1]
    args = (tok.data_ptr(), quals.data_ptr(), wc.data_ptr(), cb.data_ptr(), out.data_ptr(),
            B, R, n, d, VOCAB_SIZE, wc.shape[0], torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{entry} failed to launch: error {err}")

    read = lib.herro_embed_clocks
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * (WARPS + 1))()
    launch()
    torch.cuda.synchronize()
    if read(buf, 1):
        raise RuntimeError("clearing the counters failed")
    launch()
    torch.cuda.synchronize()
    if read(buf, 1):
        raise RuntimeError("reading the counters failed")
    counted = [int(c) for c in buf]
    whole, warps = counted[KERNEL], counted[WARPS]
    shares = {p: c / whole for p, c in zip(PHASES, counted) if p in KIND_PHASES[kind]}
    shares["other"] = 1.0 - sum(shares.values())
    ms = time_ms(torch, launch, iters)
    return dict(row=row, entry=entry, dtype=dtype, d=d, B=B, R=R, L=n, ms=ms, shares=shares,
                warps=warps, cycles_per_warp=whole / max(warps, 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="*", choices=sorted(ROWS), default=list(ROWS))
    ap.add_argument("--source", default=ROOT,
                    help="the checkout whose herro_tpu_torch/csrc is instrumented")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("embed_clocks_torch: no CUDA device available", file=sys.stderr)
        return 2
    from herro_tpu_torch.pipeline.infer import keep_float32_exact
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    keep_float32_exact(torch.device("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        libs, kind = build(tmp, os.path.abspath(args.source))
        for row in args.rows:
            print(json.dumps(dict(run_row(torch, libs, kind, row, args.iters), kernel=kind,
                                  source=args.source)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
