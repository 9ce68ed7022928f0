"""First look at the port's CUDA kernels on a card, before the full smoke run.

    python3 tools/micro_kernels_torch.py                 # registers, then one pass
    python3 tools/micro_kernels_torch.py --spread 3      # three passes, for the spread
    python3 tools/micro_kernels_torch.py --spread 0      # registers only
    python3 tools/micro_kernels_torch.py --spread 0 --step   # and the step times
    python3 tools/micro_kernels_torch.py --spread 0 --against chip_checkout/parent
    python3 tools/micro_kernels_torch.py --spread 0 --against chip_checkout/parent --sass

Compiles every ``herro_tpu_torch/csrc/*.cu`` once more with ``-Xptxas -v`` (all
at once, as the first kernel call builds them; each source's nvcc seconds from
that common start, on a line of their own) and
prints each entry function's (mangled) name, registers, spills and ptxas's
performance advisories (C75xx, such as serialised ``wgmma``; ``--against`` another checkout's
too, source by source, equal or not; with ``--sass`` each entry function's
``cuobjdump -sass`` as well, function by function), then runs ``chip_smoke.py``'s
``kernels`` phase (every kernel against its plain version at B=32, L=9216,
with its tolerance; times by CUDA events, K5's by CUDA-graph replay with the
eager loop's beside it) and the SIMT kernels' rows of its ``float32`` and
``bf16_any`` phases ``--spread`` times in one process and prints every
kernel's time per pass, to four significant digits. It is the short first
call after a kernel changes: what the compiler refuses, or a kernel that is
wrong, shows here in about a minute and fails the command. Shapes the smoke run does not
take (the r9 widths but K8's, K10's and K11's, ragged lengths) are held by
the ``gpu`` tests.

``--step`` then times the fused correct step of R10 (seeded random weights)
at bench.py's two shapes, (B, L, S) = (64, 4608, 128) and (32, 9216, 256),
with the port's step timer (``pipeline/steptime.py``). With the kernels
phase this is the port of tools/parity_fused.py: its parity half is that
phase (every kernel against its plain version on the card), its timing half
bench.py's ``_chip_only`` at those shapes.

Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def registers(kernels, csrc: str, names, sass: dict | None = None,
              seconds: dict | None = None) -> dict[str, str]:
    """Each source's registers, spills and ptxas's advisories, one line a
    source of ``csrc`` (``<name>.cu``), every nvcc started at once, as the
    first kernel call builds them; with ``sass`` (a dict) each source's
    functions' SASS into it (:func:`functions`); with ``seconds`` (a dict)
    each source's nvcc wall seconds, from the common start to its exit."""
    nvcc = kernels._nvcc()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs, done = {}, {}
        t0 = time.perf_counter()
        for name in names:
            procs[name] = subprocess.Popen(
                [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 os.path.join(tmp, f"{name}.so"), os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )

        def wait(name):  # each nvcc's output and the moment it exits
            done[name] = procs[name].communicate()[1], time.perf_counter() - t0

        threads = [threading.Thread(target=wait, args=(n,)) for n in procs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for name, proc in procs.items():
            err, took = done[name]
            if seconds is not None:
                seconds[name] = took
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
            # each entry function's (mangled) name, its registers and spills,
            # and ptxas's performance advisories (C75xx: e.g. wgmma
            # serialised, or waits it had to inject)
            lines = [l.strip().split("Compiling entry function ")[-1].split(" for ")[0]
                     if "Compiling entry function" in l else l.strip()
                     for l in err.splitlines()
                     if "registers" in l or "spill" in l or "(C75" in l
                     or "Compiling entry function" in l]
            out[name] = " | ".join(lines)
            if sass is not None:
                dump = subprocess.run(
                    [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                     os.path.join(tmp, f"{name}.so")], capture_output=True, text=True, check=True)
                sass[name] = functions(dump.stdout)
    return out


def functions(dump: str) -> dict[str, str]:
    """``cuobjdump -sass`` output split by function: mangled name -> its code
    and encodings, runs of blanks as one (the listing pads its columns to
    the widest instruction of the library)."""
    out, name = {}, None
    for line in dump.splitlines():
        if line.strip().startswith("Function : "):
            name = line.strip()[len("Function : "):]
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(" ".join(line.split()))
    return {n: "\n".join(code) for n, code in out.items()}


# a constant-bank operand: a kernel parameter (bank 0) or a constant the
# compiler placed in the module's own bank; an instruction's encoding (its
# operands and its scheduling bits), which holds the operand's offset too
CONST_OPERAND = re.compile(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]")
ENCODING = re.compile(r"/\* 0x[0-9a-f]{16} \*/")


def instructions(code: str) -> str:
    """A function's instructions alone, every constant-bank offset masked."""
    return "\n".join(line for line in (CONST_OPERAND.sub("c[][]", ENCODING.sub("", l)).strip()
                                        for l in code.splitlines()) if line)


def print_sass(mine: dict, theirs: dict, against: str) -> None:
    """Source by source, the other tree's functions whose SASS (instructions
    and encodings) is this tree's under the same name, those whose
    instructions are one of this tree's functions' (under any name) but for
    the offsets of their constant-bank operands (a parameter list or the
    module's constants laid out anew; encodings not compared), those that
    differ, and the functions of one tree alone."""
    for name in sorted(theirs):
        a, b = mine.get(name, {}), theirs[name]
        same = sorted(f for f in b if a.get(f) == b[f])
        masked = {instructions(code) for code in a.values()}
        offsets = sorted(f for f in b if f not in same and instructions(b[f]) in masked)
        rest = [f for f in b if f not in same and f not in offsets]
        differ, gone = [f for f in rest if f in a], [f for f in rest if f not in a]
        print(f"{name}: sass {len(same)} of {len(b)} functions of {against} equal; "
              f"{len(offsets)} equal but for constant-bank offsets {offsets}; "
              f"differ {differ}; only there {gone}; only here {sorted(set(a) - set(b))}",
              flush=True)


def print_registers(kernels, against: str | None = None, sass: bool = False) -> None:
    """Each kernel source's ``-Xptxas -v`` line; with ``against`` (another
    checkout's root) that tree's line for each of its sources too, and
    whether the two are equal (and with ``sass`` each function's SASS)."""
    my_sass, their_sass = ({}, {}) if sass and against else (None, None)
    my_s, their_s = {}, {}
    mine = registers(kernels, kernels.CSRC, kernels.KERNELS, my_sass, my_s)
    for name, line in mine.items():
        print(name, line, flush=True)
    print("nvcc seconds:", json.dumps({n: round(t, 1) for n, t in my_s.items()}), flush=True)
    if against is None:
        return
    csrc = os.path.join(against, "herro_tpu_torch", "csrc")
    theirs = registers(kernels, csrc, sorted(
        f[:-3] for f in os.listdir(csrc) if f.endswith(".cu")), their_sass, their_s)
    print(f"{against}: nvcc seconds:", json.dumps({n: round(t, 1) for n, t in their_s.items()}),
          flush=True)
    for name, line in theirs.items():
        print(f"{against}: {name} {line}", flush=True)
        print(f"{name}: {'equal' if mine.get(name) == line else 'DIFFERS'}", flush=True)
    print(f"{sum(mine.get(n) == l for n, l in theirs.items())} of {len(theirs)} sources "
          f"equal; only here: {sorted(set(mine) - set(theirs))}", flush=True)
    if their_sass is not None:
        print_sass(my_sass, their_sass, against)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spread", type=int, default=1,
                    help="passes of chip_smoke.py's kernels phase (0: registers only)")
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout (the parent, unpacked by git archive): compare "
                         "its sources' -Xptxas -v lines with these")
    ap.add_argument("--sass", action="store_true",
                    help="with --against: also compare each function's cuobjdump -sass")
    ap.add_argument("--step", action="store_true",
                    help="also time the R10 correct step at bench.py's two shapes")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("micro_kernels_torch: no CUDA device available", file=sys.stderr)
        return 2
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    print_registers(kernels, args.against, args.sass)
    if args.step:
        from variant_step_time_torch import STEPS, step_time

        from herro_tpu_torch.models.model import R10_CONFIG

        for B, L, S in STEPS:
            r = step_time(R10_CONFIG, B, L, S, iters=100)
            print(f"step B={B} L={L} S={S}: {r['windows_per_s']:.1f} windows/s "
                  f"({r['ms']:.3f} ms/step)", flush=True)
    if not args.spread:
        return 0
    import chip_smoke

    print(f"build and load: {kernels.build_all():.1f} s", flush=True)
    for i in range(args.spread):
        results: dict = {}
        with contextlib.redirect_stdout(io.StringIO()):
            chip_smoke.phase_kernels(torch, results)
            # and the SIMT kernels beside them (the float32 and bf16_any
            # phases' rows)
            for dtype, phase in (("float32", "float32"), ("bfloat16", "bf16_any")):
                results["kernels"] += chip_smoke.run_cases(
                    torch, chip_smoke.simt_cases(torch, dtype), phase)
        times = {}
        for k in results["kernels"]:
            times[k["case"]] = float(f"{k['ms']:.4g}")
            if "eager_ms" in k:  # a graphed time: the eager loop's beside it
                times[k["case"] + " eager"] = float(f"{k['eager_ms']:.4g}")
        print(i, times, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
