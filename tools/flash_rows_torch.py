"""The SIMT-width kernel rows and the distilled student's step, beside another checkout's.

    python3 tools/flash_rows_torch.py                                 # this checkout, once
    python3 tools/flash_rows_torch.py --against chip_checkout/parent  # this, other, other, this
    python3 tools/flash_rows_torch.py --against DIR --no-steps --out rows.jsonl
    python3 tools/flash_rows_torch.py --kernels ln_ --no-steps        # K1/K8 and K3's rows
    python3 tools/flash_rows_torch.py --kernels ln_ffn_q_simt,ln_qkv_rope_q_simt --no-steps
    python3 tools/flash_rows_torch.py --against DIR --kernels ln_qkv_rope_q_simt --int8-step
    python3 tools/flash_rows_torch.py --against DIR --kernels ln_qkv_rope_q_simt --graph

Each pass runs in a process of its own, on one tree's ``herro_tpu_torch``
with this checkout's ``chip_smoke.py`` (so both trees run the same rows,
inputs, bars and bounds; the other tree is unpacked with ``git archive``),
and prints one JSON line a row, tagged with its tree and pass:

* the rows of ``chip_smoke.simt_cases`` (float32 and bf16) and
  ``chip_smoke.int8_simt_cases`` whose kernel's name starts with a prefix
  of ``--kernels`` (by default ``flash_``: K2, K6, K7 and K9's
  ``flash_f32`` and ``flash_bf16``, and their out projection alone,
  ``outproj_tc``; ``ln_`` takes K1/K8's ``ln_qkv_rope_*``, K3's
  ``ln_ffn_*`` and the SIMT int8 K10 and K11 with K11's two modes) at every
  width no Hopper instance takes (r10 in float32, the flagship at head dim
  64 in bf16, TINY_CONFIG in both, d 384 in bf16 for int8, the tp 2
  shards), held against their plain versions at the smoke run's bars and
  timed by CUDA events beside their bounds, the plain version and the
  library call, with a sha256 digest of the kernel's output bytes
  (``digest``); a row whose entry point the tree lacks is left out there;
* unless ``--no-steps``, ``chip_smoke.student_steps``: the correct step of
  distill's default student (TINY_CONFIG in float32; here the frozen
  ``tests/torch_data/tiny_seed5``) at B=32 and L 1024, 4608 and 9216,
  beside its teacher's (``model_r10_sim`` in bf16) at L=9216;
* with ``--int8-step``, :func:`int8_step`: the correct step of
  ``model_r10_sim`` in float32 under ``--int8`` (the SIMT int8 K10 and K11
  once a layer) at B=32, L=9216, with a digest of its outputs.

With ``--graph`` each row's ``ms`` is its device time, from the replay of
one CUDA graph of its launches (``chip_smoke.graph_ms``), and the eager
loop's time is ``eager_ms`` beside it: at tiny's widths a launch takes the
card less time than its wrapper takes the host, so the eager loop times the
host.

The passes run in turns (this, other, other, this) on one card, so the two
trees' times come from one call; the card's name and power limit lead the
output. Under ``--against`` one line a row then says whether the two trees'
outputs agree bit for bit (``digests_agree``: every pass of both trees gave
one digest). A row that disagrees with its plain version fails its pass and
the command (exit 1), after every pass has run.
Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, importlib.util, json, os, sys
tree, smoke, steps = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
prefixes = tuple(sys.argv[4].split(","))
tool, int8_step, graph = sys.argv[5], sys.argv[6] == "1", sys.argv[7] == "1"
sys.path.insert(0, tree)
import torch
mods = {}
for name, path in (("chip_smoke", smoke), ("flash_rows_torch", tool)):
    spec = importlib.util.spec_from_file_location(name, path)
    mods[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[name])
chip_smoke = mods["chip_smoke"]
from herro_tpu_torch.ops import cuda, fused
from herro_tpu_torch.pipeline.infer import keep_float32_exact

if not hasattr(fused, "_flash_outproj_tiled"):
    # a tree whose bf16 projection keeps P unrounded: its own yardstick
    fused._flash_outproj_tiled = fused._flash_outproj_plain


def digest(out):
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def with_digest(c):
    extra = c.get("extra")
    return dict(c, extra=lambda: {"digest": digest(c["kernel"]())} | (extra() if extra else {}),
                graph=c.get("graph") or graph)


keep_float32_exact(torch.device("cuda"))
cuda.build_all()
bad = []
for what, phase in (("float32", "float32"), ("bfloat16", "bf16_any"), ("int8", "int8_any")):
    made = (chip_smoke.int8_simt_cases(torch) if what == "int8"
            else chip_smoke.simt_cases(torch, what))
    cases = {k: with_digest(c) for k, c in made.items() if c["name"].startswith(prefixes)
             and (c.get("mode") or c["name"]) in {**cuda.KERNELS, **cuda.MODES}}
    del made
    try:
        if cases:
            chip_smoke.run_cases(torch, cases, phase)
    except RuntimeError as err:  # every row has printed its line
        print(err, file=sys.stderr)
        bad.append(what)
    del cases
    torch.cuda.empty_cache()
if steps:
    chip_smoke.student_steps(torch, os.path.join(chip_smoke.F32_DATA, "tiny_seed5"), "steps")
if int8_step:
    try:
        mods["flash_rows_torch"].int8_step(torch, chip_smoke, digest)
    except RuntimeError as err:
        print(err, file=sys.stderr)
        bad.append("int8 step")
sys.exit(1 if bad else 0)
"""


def int8_step(torch, chip_smoke, digest) -> dict:
    """One correct step (``make_correct_step``, S=256) of ``model_r10_sim`` in
    float32 under int8 at B=32, L=9216: the float32 entry and attention and
    the SIMT int8 K10 and K11 once a layer, K5 once; its ms by the port's
    step timer, its launches and a digest of its first step's outputs. One
    JSON line (phase ``int8_step``, case ``r10-float32``); raises on other
    launches or non-finite outputs."""
    import dataclasses

    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.pipeline.infer import make_correct_step
    from herro_tpu_torch.pipeline.steptime import example_batch, time_step

    B, L = chip_smoke.B, chip_smoke.L
    cfg, sd = load_model(chip_smoke.CKPT)
    cfg = dataclasses.replace(cfg, dtype="float32", int8=True)
    model = CorrectionModel(cfg)
    model.load_state_dict(sd)
    step = make_correct_step(model.cuda().eval())
    sets = [[torch.from_numpy(a).cuda() for a in example_batch(B, L, 256, seed=s)]
            for s in (3, 4)]
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = kernels.launch_counts.snapshot()
        out = step(*sets[0])
        torch.cuda.synchronize()
        after = kernels.launch_counts.snapshot()
        timed = time_step(step, sets, B, iters=10)
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    per_layer = ("ln_qkv_rope_q_simt", "ln_ffn_q_simt")
    finite = bool(torch.isfinite(out[0]).all())
    chip_smoke.emit("int8_step", case="r10-float32", card=chip_smoke.nvidia_smi(), B=B, L=L,
                    S=256, n_layers=cfg.n_layers, ms=timed["ms"],
                    windows_per_s=timed["windows_per_s"], launches=launches, finite=finite,
                    digest=digest(out))
    if not finite or any(launches.get(k) != cfg.n_layers for k in per_layer) \
            or launches.get("count_decisions") != 1:
        raise RuntimeError(f"int8 step: launches {launches}, finite {finite}")
    return timed


def run_pass(tree: str, steps: bool, kernels: str, int8_step: bool = False,
             graph: bool = False) -> tuple[list[dict], str | None]:
    """One pass on ``tree``: chip_smoke's JSON lines of its rows (and steps),
    and the end of its errors where it failed (a row that disagreed, or
    worse)."""
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, tree, os.path.join(ROOT, "chip_smoke.py"),
         "1" if steps else "0", kernels, os.path.abspath(__file__),
         "1" if int8_step else "0", "1" if graph else "0"],
        cwd=tree, env=env, capture_output=True, text=True,
    )
    rows = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    failed = proc.stderr[-4000:] if proc.returncode or not rows else None
    return rows, failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout (unpacked by git archive) to time in turns")
    ap.add_argument("--no-steps", action="store_true", help="the kernel rows alone")
    ap.add_argument("--kernels", default="flash_",
                    help="comma-separated prefixes of the rows' kernel names (default flash_)")
    ap.add_argument("--int8-step", action="store_true",
                    help="also time the float32 r10 int8 correct step (int8_step)")
    ap.add_argument("--graph", action="store_true",
                    help="time each row by CUDA-graph replay (device time)")
    ap.add_argument("--out", help="also write every line here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_rows_torch: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    trees = [("this", ROOT)]
    if args.against:
        other = ("other", os.path.abspath(args.against))
        trees = [trees[0], other, other, trees[0]]
    out, failed = [], []
    for i, (tag, tree) in enumerate(trees):
        rows, err = run_pass(tree, not args.no_steps, args.kernels, args.int8_step,
                             args.graph)
        for row in rows:
            row = dict(row, tree=tag, pass_=i)
            out.append(row)
            print(json.dumps(row), flush=True)
        if err:
            print(f"pass {i} ({tag}, {tree}) failed:\n{err}", flush=True)
            failed.append(i)
    if args.against:  # each row's outputs in the two trees, bit for bit
        digests: dict = {}
        for row in out:
            if "digest" in row:
                key = (row["phase"], row["case"])
                digests.setdefault(key, {}).setdefault(row["tree"], set()).add(row["digest"])
        for (phase, case), by_tree in digests.items():
            mine, theirs = by_tree.get("this", set()), by_tree.get("other", set())
            line = dict(phase=phase, case=case, digests_agree=len(mine) == 1 and mine == theirs,
                        this=sorted(mine), other=sorted(theirs))
            out.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in out)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
