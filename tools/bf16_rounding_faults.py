"""Which of chip_smoke.py's bf16 rows catch a bf16 rounding the kernel misses.

    python3 tools/bf16_rounding_faults.py                       # every fault, tiny at L=1024
    python3 tools/bf16_rounding_faults.py --plan tiny:9216 --plan r10h64:9216
    python3 tools/bf16_rounding_faults.py --fault k9_p --out rows.jsonl

Each fault copies ``herro_tpu_torch/`` and ``chip_smoke.py`` into a
temporary directory and changes one rounding of the bf16 device code of the
widths no Hopper instance takes there: a ``round_to<E>`` taken out where the
bf16 plain version rounds (LayerNorm's output, qkv's bias and the FFN's
bias, each in the helper that the tensor-core kernels of ``gemm_tc.cuh``
and the narrow ones of ``narrow.cuh`` share), or P kept at float32
precision where K9 or the out projection rounds it to bf16 (``FAULTS``; the
attention's two on the tensor cores, ``flash_tc.cuh``). The
copy builds its four bf16 sources (all copies at once) and runs
``chip_smoke.simt_cases(torch, "bfloat16", plans)`` through
``chip_smoke.run_cases``, at the smoke run's bars, in a process of its
own; ``none`` runs the copy unchanged. Prints one
JSON line a row (the fault, the case, whether it held, its error beside its
bar, the share of outputs that differ from the plain version's), then each
fault's failed rows. Roundings the storage type makes (an output, the
attention scratch and the FFN hidden are stored as bf16) cannot be missed
without a change of type and are not planted. The repository is not
changed. Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fault -> (source under csrc/, the text, what it becomes, the rows that
# must catch it: chip_smoke case names up to their "[")
FAULTS = {
    "none": None,
    "ln_output": ("f32.cuh",
                  "  return round_to<E>(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), "
                  "scale), bias));\n",
                  "  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), scale), "
                  "bias);\n",
                  ("ln_qkv_rope_bf16", "ln_qkv_rope_bf16_split", "ln_ffn_bf16")),
    "qkv_bias": ("ln_qkv_rope_simt.cuh", "  return round_to<E>(__fadd_rn(a, b));\n",
                 "  return __fadd_rn(a, b);\n",
                 ("ln_qkv_rope_bf16", "ln_qkv_rope_bf16_split")),
    "ffn_bias": ("f32.cuh", "return round_to<E>(gelu_tanh(round_to<E>(__fadd_rn(a, bn))));",
                 "return round_to<E>(gelu_tanh(__fadd_rn(a, bn)));", ("ln_ffn_bf16",)),
    "quals": ("entry_embed_simt.cuh",
              "const float qj[kPer] = {round_to<E>(qv.x), round_to<E>(qv.y), round_to<E>(qv.z),\n"
              "                              round_to<E>(qv.w)};",
              "const float qj[kPer] = {qv.x, qv.y, qv.z, qv.w};", ("entry_embed_bf16",)),
    "k9_p": ("flash_tc.cuh", "kRoundP ? kPVRound : kPVSplitP", "kPVSplitP",
             ("flash_bf16_attention",)),
    "outproj_p": ("flash_tc.cuh", "int err = attention<E, true>(", "int err = attention<E, false>(",
                  ("flash_bf16", "flash_bf16_full")),
}

CHILD = r"""
import json, sys
import torch
import chip_smoke
from herro_tpu_torch.ops import cuda

# the bf16 SIMT sources alone: the rows run no other kernel
for name in [k for k in cuda.KERNELS if not k.endswith("_bf16")]:
    del cuda.KERNELS[name]
for name in [m for m, e in cuda.MODES.items() if e[0] not in cuda.KERNELS]:
    del cuda.MODES[name]
cuda._libs.fn("flash_bf16")  # builds and loads what is left
if sys.argv[1] == "build":
    sys.exit(0)
plans = [tuple(p) for p in json.loads(sys.argv[1])]
try:
    chip_smoke.run_cases(torch, chip_smoke.simt_cases(torch, "bfloat16", plans), "bf16_fault")
except RuntimeError as err:
    print(err, file=sys.stderr)
"""


def copy_with(fault: str, where: str) -> None:
    """The package and chip_smoke.py in ``where``, with ``fault`` planted."""
    shutil.copytree(os.path.join(ROOT, "herro_tpu_torch"), os.path.join(where, "herro_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), where)
    if FAULTS[fault] is None:
        return
    src, old, new, _ = FAULTS[fault]
    path = os.path.join(where, "herro_tpu_torch", "csrc", src)
    with open(path) as fh:
        text = fh.read()
    if text.count(old) != 1:
        raise RuntimeError(f"{fault}: {old!r} is not in {src} once")
    with open(path, "w") as fh:
        fh.write(text.replace(old, new))


def _child(where: str, arg: str, **kw) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=where)
    return subprocess.Popen([sys.executable, "-c", CHILD, arg], cwd=where, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def run(faults, plans) -> list[dict]:
    """Each fault's rows at ``plans`` ((tag, L) pairs of
    ``chip_smoke.SIMT_PLANS``): chip_smoke's row report with ``fault``."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        where = {f: os.path.join(tmp, f) for f in faults}
        for f in faults:
            copy_with(f, where[f])
        builds = {f: _child(where[f], "build") for f in faults}  # every nvcc at once
        for f, proc in builds.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"{f}: the build failed:\n{err[-4000:]}")
        for f in faults:
            proc = _child(where[f], json.dumps(plans))
            out, err = proc.communicate()
            got = [dict(json.loads(l), fault=f) for l in out.splitlines() if l.startswith("{")]
            if proc.returncode or not got:
                raise RuntimeError(f"{f}: the rows did not run:\n{err[-4000:]}")
            rows += got
    return rows


def verdicts(rows: list[dict]) -> dict[str, tuple[set, set]]:
    """Each fault's kernels whose rows failed (case names up to their "["),
    beside those of ``FAULTS`` that must fail, of the rows the plans ran."""
    out = {}
    for f in dict.fromkeys(r["fault"] for r in rows):
        mine = [r for r in rows if r["fault"] == f]
        present = {r["case"].split("[")[0] for r in mine}
        failed = {r["case"].split("[")[0] for r in mine if not r["ok"]}
        out[f] = failed, set(FAULTS[f][3]) & present if FAULTS[f] else set()
    return out


def as_expected(failed: set, want: set, fault: str) -> bool:
    """The copy unchanged fails no row; a fault fails at least its rows."""
    return not failed if FAULTS[fault] is None else want <= failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plan", action="append", default=[],
                    help="tag:L of chip_smoke.SIMT_WIDTHS (default tiny:1024); repeatable")
    ap.add_argument("--fault", action="append", choices=sorted(FAULTS), default=[],
                    help="a fault of FAULTS (default: every one); repeatable")
    ap.add_argument("--out", help="also write the rows here, one JSON line each")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bf16_rounding_faults: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    plans = [(t, int(n)) for t, n in (p.split(":") for p in args.plan or ["tiny:1024"])]
    faults = args.fault or list(FAULTS)
    rows = run(faults, plans)
    keys = ("fault", "case", "ok", "max_abs_err", "tol", "part_err", "part_tol",
            "share_differing")
    for r in rows:
        print(json.dumps({k: r.get(k) for k in keys}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in rows)
    missed = []
    for f, (failed, want) in verdicts(rows).items():
        print(f"{f}: rows failed {sorted(failed)}; must fail {sorted(want)}", flush=True)
        if not as_expected(failed, want, f):
            missed.append(f)
    if missed:
        print(f"not as expected: {missed}", flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
