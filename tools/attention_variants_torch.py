"""Design variants of the full-attention kernel K7 timed against the committed source.

    python3 tools/attention_variants_torch.py                  # every variant, smoke lengths
    python3 tools/attention_variants_torch.py --lengths eval static_stride

A variant is the committed ``herro_tpu_torch/csrc/`` with a few textual
edits (``VARIANTS`` below): the (batch, query block) static stride that K2
keeps, in place of K7's longest-first order, or another tile loop for the
full mask, kept as a fragment under ``tools/kernel_variants/`` (a softmax
overlap that lost: the two warpgroups taking turns on the tensor cores, each
issuing P(it).V(it) with S(it + 1)). The edits name
lines of ``flash_outproj_sm90.cuh`` as they stand; the tool raises when one
of them is gone, and a redesign of that header retires the variant.

Each variant runs in a process of its own: it is built with nvcc (``-Xptxas
-v``) into a library beside an unedited build, both are launched through the
C entry ``herro_flash_outproj_full`` and held against each other on the rows
below each length (the same function: within 4 bf16 ulps at the largest
magnitude), then timed by CUDA events in turns (kept, variant, variant,
kept), ``--turns`` times. ``--lengths`` picks the batches:

- ``smoke``: ``chip_smoke.py``'s ``flash_outproj_full`` case, B=32, L=9216,
  mixed lengths, one of them 0;
- ``eval``: every batch the model step gets in ``chip_smoke.py``'s ``eval``
  run under ``local_window`` null (60 reads), found by running that ``eval``
  on the CPU with a runner that records each batch's lengths and computes
  nothing; a turn's time is the sum over the batches.

q, k, v, x, wo and bo are random bf16 at R10 widths: the kernel's time does
not depend on their values. Prints one JSON line per build (registers,
spills and C75xx advisories from ptxas, each turn's ms), and under ``eval``
one line with each batch's bucket and lengths.

Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEADER = "flash_outproj_sm90.cuh"

# the kept tile loop, which every mask runs: its first lines, the line after it
LOOP = ("#pragma unroll 1\n      for (int it = 0; it < band.n_kt; ++it) {\n",
        "      // O / l in bf16 over this head's Q, in this warpgroup's rows\n")


def full_loop(fragment: str):
    """Edits that give kMaskFull the tile loop in tools/kernel_variants/
    ``fragment`` and leave the kept loop to kMaskBand."""
    with open(os.path.join(ROOT, "tools", "kernel_variants", fragment)) as fh:
        loop = fh.read()
    return [(HEADER, LOOP[0], "      if constexpr (kFull) {\n" + loop + "      } else {\n" + LOOP[0]),
            (HEADER, LOOP[1], "      }\n" + LOOP[1])]


# warpgroup 1 arrives once on warpgroup 0's barrier, so warpgroup 0 issues first
PRE_ARRIVE = ("  reg_alloc<232>();\n",
              "  reg_alloc<232>();\n"
              "  if (threadIdx.x >= 128) asm volatile(\"bar.arrive 1, 256;\\n\" ::: \"memory\");\n")

# name -> (what it changes, [(file, old text, new text)])
VARIANTS = {
    "static_stride": (
        "tiles in (batch, query block) order, block i taking i, i + G, ... (K2's order)",
        [(HEADER, "    if constexpr (kFull)\n      return r * (int)gridDim.x",
          "    if constexpr (false)\n      return r * (int)gridDim.x"),
         (HEADER, "const int2 tile = full_tile_at<kStore>(lengths, B, heads, L, n_qb, n_live, "
                  "p, lane);",
          "const int2 tile = make_int2(p / n_qb, (p % n_qb) * kBQ);")],
    ),
    "pingpong": (
        "P(it).V(it) and S(it + 1) issued together, the warpgroups taking turns to "
        "issue through named barriers (kernel_variants/flash_outproj_full_pingpong.inc)",
        full_loop("flash_outproj_full_pingpong.inc") + [(HEADER, *PRE_ARRIVE)],
    ),
}


def smoke_lengths():
    """The lengths of chip_smoke.py's K7 case: the same numpy draws in the
    same order, the pileups drawn and dropped."""
    import numpy as np

    from chip_smoke import B, L

    R = 31
    rng = np.random.default_rng(1234)
    lengths = rng.integers(int(0.7 * L), L + 1, size=B).astype(np.int32)
    rng.integers(2, R, size=B)
    rng.integers(0, 11, size=(B, R, L), dtype=np.uint8)
    rng.integers(0, 5, size=(B, L), dtype=np.uint8)
    rng.integers(33, 127, size=(B, R, L), dtype=np.uint8)
    lengths[::4] = rng.integers(L // 4, L // 2, size=len(lengths[::4]))
    lengths[3] = 0
    return [(L, lengths.tolist())]


def eval_lengths(tmp: str):
    """(bucket L, lengths) of every batch of chip_smoke.py's eval run under
    local_window null, from that eval on the CPU with a runner that only
    records: a batch's lengths are its windows' lengths, then 0 for the
    rows that pad it to the batch size."""
    from chip_smoke import CKPT, EVAL_ARGS, SMALL_SIZE
    from herro_tpu_torch import cli
    from herro_tpu_torch.pipeline.infer import CorrectionRunner
    from herro_tpu_torch.training import eval as ev

    batches = []

    class Recorder(CorrectionRunner):
        def dispatch(self, batch):
            n = batch.support_idx.shape[0] - len(batch.windows)
            batches.append((batch.tokens_packed.shape[-1],
                            [w.length for w in batch.windows] + [0] * n))

        def finalize(self, inflight):
            return []

    ckpt = os.path.join(tmp, "ckpt_full")
    os.makedirs(ckpt)
    shutil.copy(os.path.join(CKPT, "params.msgpack"), ckpt)
    with open(os.path.join(CKPT, "config.json")) as fh:
        cfg = dict(json.load(fh), local_window=None)
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    kept, ev.CorrectionRunner = ev.CorrectionRunner, Recorder
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["eval", ckpt, *EVAL_ARGS, *SMALL_SIZE, "--device", "cpu"])
    finally:
        ev.CorrectionRunner = kept
    return batches


def inputs(torch, dev, batches):
    """Random bf16 q, k, v, x, wo, bo at R10 widths for each batch (one set a
    bucket) and its lengths on the card."""
    H, D, d = 4, 128, 512
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(torch.bfloat16)

    wo, bo = randn(H, D, d, std=(H * D) ** -0.5), randn(d, std=0.25)
    by_l, cases = {}, []
    for L, lens in batches:
        B = len(lens)
        if (B, L) not in by_l:
            by_l[B, L] = (*(randn(B, H, L, D) for _ in range(3)), randn(B, L, d))
        q, k, v, x = by_l[B, L]
        cases.append((q, k, v, x, wo, bo, torch.tensor(lens, dtype=torch.int32, device=dev)))
    return cases


def build(kernels, tmp: str, name: str, edits) -> tuple[ctypes.CDLL, str]:
    """csrc/ with ``edits`` applied, built into tmp/<name>/; returns the
    library and ptxas's register, spill and C75xx lines."""
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
         os.path.join(src, "flash_outproj_full.cu")],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{res.stderr[-4000:]}")
    ptxas = " | ".join(l.strip() for l in res.stderr.splitlines()
                       if "registers" in l or "spill" in l or "(C75" in l)
    return ctypes.CDLL(so), ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)}; default all")
    ap.add_argument("--lengths", choices=("smoke", "eval"), default="smoke")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds for each variant's process")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_variants_torch: no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import compare, nvidia_smi, time_ms
    from herro_tpu_torch.ops import cuda as kernels

    names = args.variants or list(VARIANTS)
    print(nvidia_smi(), flush=True)
    if len(names) > 1:
        # one process a variant, each with a kept build of its own: libraries
        # of the same kernels loaded side by side in one process once hung
        rc = 0
        for name in names:
            cmd = [sys.executable, os.path.abspath(__file__), "--turns", str(args.turns),
                   "--lengths", args.lengths, name]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            except subprocess.TimeoutExpired:
                print(json.dumps(dict(variant=name, timed_out=args.timeout)), flush=True)
                rc = 1
                continue
            sys.stderr.write(res.stderr)
            print("".join(l for l in res.stdout.splitlines(True) if l.startswith("{")),
                  end="", flush=True)
            rc = rc or res.returncode
        return rc
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cname, argtypes = kernels.KERNELS["flash_outproj_full"]
    with tempfile.TemporaryDirectory() as tmp:
        batches = smoke_lengths() if args.lengths == "smoke" else eval_lengths(tmp)
        if args.lengths == "eval":
            print(json.dumps(dict(lengths="eval", batches=[
                dict(L=L, live=sum(n > 0 for n in lens), min_live=min(n for n in lens if n),
                     max=max(lens)) for L, lens in batches])), flush=True)
        cases = inputs(torch, dev, batches)
        runs = {}
        for name in ["kept", *names]:
            lib, ptxas = build(kernels, tmp, name, [] if name == "kept" else VARIANTS[name][1])
            fn = getattr(lib, cname)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            outs = [torch.empty_like(c[3]) for c in cases]

            def launch(i, fn=fn, name=name, outs=outs):
                q, k, v, x, wo, bo, lengths = cases[i]
                B, H, L, D = q.shape
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), x.data_ptr(),
                         wo.data_ptr(), bo.data_ptr(), lengths.data_ptr(), outs[i].data_ptr(),
                         B, H, L, x.shape[-1], 1.0 / math.sqrt(D), stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed with error {err}")
                return outs[i]

            runs[name] = dict(launch=launch, ptxas=ptxas, ms=[])
            print(f"built {name}: {ptxas}", file=sys.stderr, flush=True)
        for i, c in enumerate(cases):
            ref = runs["kept"]["launch"](i).clone()
            L = c[0].shape[2]
            keep = torch.arange(L, device=dev)[None, :] < c[6][:, None]
            for name, run in runs.items():
                err, tol, _, _ = compare(torch, run["launch"](i), ref, keep)
                run["max_abs_err_vs_kept"] = max(err, run.get("max_abs_err_vs_kept", 0.0))
                if err > tol:
                    raise RuntimeError(f"variant {name} differs from the kept source in "
                                       f"batch {i}: {err} > {tol}")
        order = list(runs)
        for _ in range(args.turns):
            for name in order + order[::-1]:
                launch = runs[name]["launch"]
                runs[name]["ms"].append(sum(time_ms(torch, lambda i=i: launch(i), 10)
                                            for i in range(len(cases))))
        for name, run in runs.items():
            what = "the committed source" if name == "kept" else VARIANTS[name][0]
            print(json.dumps(dict(
                variant=name, lengths=args.lengths, what=what, ms=run["ms"],
                mean_ms=sum(run["ms"]) / len(run["ms"]),
                max_abs_err_vs_kept=run["max_abs_err_vs_kept"], ptxas=run["ptxas"],
            )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
