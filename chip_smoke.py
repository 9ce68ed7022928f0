"""On-card smoke run of the PyTorch/CUDA port (herro_tpu_torch).

    python3 chip_smoke.py            # all phases, one card

Drives the port's main path on an NVIDIA card and checks it, in phases that
each print one JSON line:

1. ``env``     — the card (nvidia-smi name and power limit), torch and CUDA
   versions, the kernel build time, whether native featgen loaded;
2. ``kernels`` — every hand-written kernel (K1-K11) at the main-path shapes
   (B=32, L=9216, the R10 widths) against its plain PyTorch version on the
   same inputs, with the tolerance stated, and timed with CUDA events beside
   the plain version, a PyTorch library call and the card's bound (and the
   bound's share of the time); K1-K4, K6-K8, K10 and K11 also at L=5120,
   the bucket most windows of the demo-size run take, and K8, K10 and K11
   at the r9 width (d 256, H 2, d_ff 1536), and K1, K2 and K3 at the
   widths of one tensor-parallel shard (r10 at tp 2 and 4, r10deep at tp
   2: H 2 and 1, d_ff 512 and 256). The
   attention kernel runs under all three masks: band 512 (K2), full
   attention with mixed lengths, one of them 0 (K7), and the general band
   at 384 and at 40 (K6). The split-rope kernel (K8) must equal the
   table-fed one (K1) bit for bit; the int8 kernels (K10, K11) also report
   the share of output elements that differ from the plain version at all,
   which may be at most twice that share between two plain runs whose
   LayerNorm sums in float32 and in float64 (the floor the order of a sum
   sets); the standalone flash attention (K9) runs under band 512 and 40 and
   under no band with mixed lengths, one of them 0 (which must come out 0),
   band 512 and no band also at L=5120; the counting rule (K5) at both
   lengths must equal its plain version; K1-K4 also at the d384x5L shape of
   ``tools/variant_step_time_torch.py`` (d 384, H 3, d_ff 1280); K10 at a
   shard's head counts (H 2 and 1 at d 512, H 1 at d 256) and K11's two
   tensor-parallel modes (``ln_ffn_q_rowmax``, ``ln_ffn_q_rowscale``) at
   the four shard widths (d 512 with d_ff 512 and 256, d 256 with 768 and
   512), each to the int8 bar above;
3. ``golden``  — the port's bf16 forward of the flagship checkpoint on
   ``tests/golden/logits_r10.npz`` against the JAX logits frozen there;
4. ``e2e``     — ``run_correction`` with ``CorrectionRunner(device="cuda")``
   on a simulated demo-size dataset, with every kernel's launch count over
   that run; ``trace`` — the same run under torch.profiler, the card's
   activity alone (device busy share, device time by kernel); ``cli`` — the
   CLI with ``--read-alns`` when zstandard is present;
5. ``parallel`` — ``CorrectionRunner(mesh=...)`` with every device ``cuda:0``
   (one card holds every layout): data parallelism over a 2 x 1
   mesh must write the e2e run's FASTA records byte for byte; tensor
   parallelism at tp 2 and 4 on the golden batch and the e2e dataset must
   agree with the single-device step on at least 0.99 of the supported
   columns with equal decisions, launching a batch K4 x tp, K1-K3 x 3 x tp
   and K5 once; int8 at tp 2 and 4 the same against the single device's
   int8 step, launching K4 x tp, K10, K2 and each K11 mode x 3 x tp, K5
   once and no K1, K3 or whole K11; each layout's step at B=32, L=9216
   beside the single device's (bf16 and int8); ``multihost`` — two ``inference`` CLI processes on the card
   under a coordinator on 127.0.0.1 (``--num-processes 2``) over two
   target-partitioned alignment batches: their ``.shard000`` and
   ``.shard001`` must not overlap and together equal one process's FASTA;
6. ``eval``    — the ``eval`` subcommand for the flagship weights under
   ``local_window`` 512 at the demo size, and under none and 384 on 60 reads
   (each must launch its own attention kernel and no other), and for
   ``model_r9_sim`` on 60 reads (the eval runs of one size, here and in the
   later phases, share one simulation, its PAF rows, its feature tensors
   and the truth scores of a FASTA already scored, which the counting
   baseline's is at every run, each run's model on the card on its own);
   ``battery`` — the ``standard`` regime of
   ``tools/eval_battery_torch.py`` for the flagship at the battery's own
   size and seed, through ``tools/merge_battery.py``'s gate against the
   committed ``resources/eval_battery.json`` (within 0.2 dB, het >= 0.99),
   its counting baseline compared field for field; ``demo`` — the demo run
   (seed 777) through ``tools/demo_record_torch.py``, every corrected record
   held by name and sha256 against the JAX package's record
   (``tests/torch_data/demo_seed777_herro_tpu.json``): the share of
   byte-identical records and both Qs, the port's at most 0.2 dB below;
7. ``procpool`` — ``inference`` in a subprocess, serial and with
   ``--feat-gen-procs N`` (the pool forks before the card is opened, which
   this process cannot do any more; the pool's one run traced, its times
   read from it), alignments from a stub ``minimap2`` that replays the
   simulated PAF; ``features`` — the ``features`` subcommand the
   same way, loaded back through ``load_window_features``;
8. ``int8``    — the golden forward, the e2e run through
   ``CorrectionRunner(int8=True)`` and ``eval --int8`` (flagship weights at the
   demo size, ``model_r9_sim`` on 60 reads; each corrected identity within
   1e-4 of ``EVAL_IDENTITY_INT8``): every run must launch n_layers x
   batches of ``ln_qkv_rope_q``, ``ln_ffn_q`` and ``flash_outproj`` and none of
   ``ln_qkv_rope`` and ``ln_ffn``; ``rope_split`` — the golden and the e2e run
   under ``HERRO_TPU_ROPE=split`` (``ln_qkv_rope_split`` launched, the table
   kernel not); ``attention`` — ``attention(impl="auto")`` on CUDA tensors at
   L=9216 (must launch ``flash_attention``) and its gradient at a small size
   against autograd through ``naive_attention``;
9. ``grad``    — the three differentiable ops (``entry_embed``, ``ln_ffn``,
   ``attention_block``) and the two int8 ones (``attention_block_q``,
   ``ln_ffn_q``) under autograd on CUDA tensors at the R10 widths, B 2,
   L 1024: the forward is the op's direct output bit for bit with one launch
   of each of its kernels, every gradient autograd's through the plain
   version on the same inputs, finite and nonzero;
10. ``train``   — ``train --config r10`` through the CLI at batch 32 on the
   bucket ladder (simulated, 100 kb and 100 reads): ms a step by CUDA events
   from step 3 on, the forward/backward split, the peak of allocated memory and
   the launches of every step (K4 once, K1-K3 n_layers x 2 under remat, no
   other kernel); then in process a seeded R10 trainer: every parameter a
   finite nonzero gradient, one step at each bucket of the ladder, 20 steps
   on one fixed batch bringing CE below 0.7 x its first value, and
   ``Trainer.save`` loading back through ``load_model``; then the same
   trainer under int8 at B=32, L=9216: ms a step, the split, the peak,
   launches K4 once and K10, K2, K11 x 6 a step, CE below 0.7 x over 20
   steps;
11. ``train_parallel`` — a seeded ``r10`` trainer at B=32 on a bucket-9216
   batch of the ``train`` phase's windows, every device ``cuda:0``: one
   device, DP 2 x 1, TP 1 x 2 and DP x TP 2 x 2, 6 steps each. Each mesh's
   first step is held against its base layout's (DP 2 and TP 2 against one
   device, 2 x 2 against TP 2) by the bars of the axis it adds: loss, ce and
   info_bce within 1e-6 relative along a data axis and 1e-4 along a model
   axis, acc and hard_acc within 1e-6 along a data axis and within the
   share of flipped classes along a model axis, the summed gradient (Adam's
   first moment after the step) within 1e-2 and 2e-2; every step's CE
   within 1e-2 of the base's and falling; launches a step K4 n_data x tp and
   K1-K3 2 x n_layers x tp x n_data (no other kernel); the data replicas'
   parameters and moments bit-identical after 3 steps and at the end; ms a
   step by CUDA events from step 3 on and peak allocated memory; the
   forward's classes on the trained ``model_r10_sim`` agreeing with the
   base's on at least 0.999 of the supported columns, and on the seeded
   weights the flipped columns reported with their logit margins;
   ``Trainer.save`` of the TP 2 run loading back as the gathered
   parameters; two faults planted in a DP 2 step (replica 1's gradient
   dropped, a mean of per-replica means), each of which the bars must
   reject; the int8 config on one device and at TP 1 x 2, 3 steps each,
   TP held against one device by the model axis's bars (launches K10, K2
   and each K11 mode 2 x 3 x tp a step); then ``dryrun_multichip(4)`` over
   ``cuda:0`` four times (``herro_tpu_torch/parallel/dryrun.py``);
12. ``distill`` — ``distill`` through the CLI over the ``features`` phase's
   tree, teacher ``model_r10_sim`` (its labelling launches K1-K5), student
   ``r9`` (K1-K4 at d 256), batch 8, whose checkpoint loads;
13. ``float32`` — float32 and head dim 16 on the card, through the four
   float32 kernels (``csrc/*_f32.cu``): each against its plain version at
   B=32 (``model_r10_sim``'s widths in float32 at L=9216, TINY_CONFIG's at
   L=9216 and 1024, K9's mode under band 512, band 40 and no band) within
   1e-4 (2e-4 after the out projection), timed beside its bound, its plain
   version and SDPA in float32 or a float32 torch.matmul; then the path,
   launches counted from 0: the ``tiny`` and float32 ``r10`` forwards on the
   frozen inputs of ``tests/torch_data`` within 2e-4 of the JAX logits frozen
   there, argmax equal (``tiny`` also under ``HERRO_TPU_ROPE=split``, bit for
   bit), ``distill`` with no ``--student`` (the default ``tiny``: the
   teacher launches K1-K5, the student only float32 kernels), ``train
   --config tiny`` (each step's launches; in process every parameter a
   finite gradient and CE below 0.7 x in 20 steps), ``eval`` of the tiny
   checkpoint it wrote on 60 reads, ``inference`` of it on one device and
   with ``--devices 2 --tp 2`` on ``cuda:0`` (the same records) and
   ``attention()`` in float32; then ``HERRO_TPU_PALLAS=0``: the tiny and
   bf16 goldens refuse it on the card with a ValueError and launch nothing;
14. ``int8_any`` — int8 at float32 and at every width, through the SIMT
   int8 kernels (``csrc/*_q_simt.cu``): K10 and K11 against their plain
   versions at B=32 (r10's widths in float32 and d384x5L's in bf16 at
   L=9216, TINY_CONFIG's at 9216 and 1024; K10 at a tp 2 shard's heads and
   K11's two modes at its d_ff, r10 and tiny), each to the int8 bar, timed
   beside its bound (int8 operations at the CUDA cores' rate), its plain
   version and ``torch._int_mm``; int8 at tp 2 against one device (tiny on
   its golden batch and the e2e run, float32 r10 on its golden batch:
   classes agree on >= 0.9999 of the supported columns); then the path,
   launches counted from 0: the tiny and float32-r10 int8 forwards within
   ``INT8_GOLDEN_BARS`` of herro_tpu's int8 logits frozen in
   ``tests/torch_data``, ``inference --int8`` of the ``float32`` phase's tiny
   checkpoint on one device and at ``--devices 2 --tp 2``, ``eval --int8`` of
   it on 60 reads, one d384x5L int8 correct step (its ms) and one tiny int8
   train step;
15. ``bf16_any`` — bf16 at every width and head dim, through the bf16 SIMT
   instances (``csrc/*_bf16.cu``; the Hopper instances keep every width
   they were built for): K4, K1/K8, K2/K6/K7/K9 and K3 against their plain
   versions at B=32 (the flagship at head dim 64, "r10h64": d 512, H 8 x
   64, band 512, K1/K8, K2 and K9, at L=9216; TINY_CONFIG's widths at
   L=9216 and 1024; the tp 2 shards of both) at the bf16 bars of
   ``compare``, timed beside the bound (float32 FFMA at 67 TFLOP/s), the
   plain version and SDPA or one torch.matmul in bf16; the bf16 flagship's
   ``e2e`` launches (Hopper only, K1-K3 102, K4 34); then the path, counted
   from 0: the tiny and r10h64 bf16 forwards against herro_tpu's bf16
   logits frozen in ``tests/torch_data`` (the class on every supported
   column, the gap at most twice the CPU's; at tp 2 the classes on >= 0.99),
   ``inference`` of tiny in bf16 on one device and ``--devices 2 --tp 2``,
   both again under ``--int8``, the r10h64 correct step at B=32, L=9216 on
   one device and at tp 2 (ms, classes >= 0.99), ``attention()`` at head
   dims 16, 32 and 64 under band 512, 40 and none, and two ``train`` steps
   of tiny in bf16;
16. ``widths`` — every width a herro_tpu ``config.json`` can ask for up to
   d_model 1024, d_ff 4096 and any head dim a multiple of 16: the float32
   and bf16 SIMT kernels against their plain versions at B=32, L=9216 at
   w768h96's widths (d 768, H 8 x 96, d_ff 3072;
   ``tests/torch_data/w768h96.py``) and d 1024's (H 8 x 128, d_ff 4096):
   K4, K1, K8, K2 (band 512), K7 and K9 (band 512 and none) and K3, and K1
   and K9 at head dims 48, 80 and 112 (H 8), at the bars of ``float32`` and
   ``bf16_any``, each timed beside ``tc_bound``, the plain version (one
   call) and SDPA or one torch.matmul; then the path, counted from 0: the
   w768h96 forwards against herro_tpu's logits frozen in
   ``tests/torch_data/golden_w768h96.npz`` (float32 within 2e-4 and every
   class; bf16 within twice the CPU's recorded gap, every class but the
   near-ties that gap allows to flip) and one ``inference`` of its seeded
   bf16 checkpoint on the e2e reads: a record for every read the e2e run
   wrote, the bf16 SIMT instances launched and no Hopper one;
17. ``tools`` — each ported tool once at a reduced size, its launches
   counted: the soup, 4 fine-tune steps on the ``train`` phase's windows,
   the systematic audit and the e2e profile on 24 reads, the step-time
   probe at B=32, L=9216 for r10 and d384x5L (K1-K4's d 384 instances), and
   the ablation's variants and standalone ops at B=8, L=2048.

The ``golden`` phase also holds ``model_r10_deep_sim`` in bf16 (the Hopper
instances at d 256, H 2 x 128, 8 layers) to the classes of herro_tpu's
float32 logits frozen in ``tests/torch_data/golden_r10deep_f32.npz``.

Any failed phase exits nonzero. The last lines are each phase's seconds
(``phase_seconds``), the card line of nvidia-smi, the per-kernel JSON
summary (K1-K4 also with their launches in
``train_parallel``, counted from 0 over its layouts' steps; K1-K5 with
theirs in ``battery``, ``demo`` and ``tools``; K10 and K11's modes with
theirs in the int8 layouts of ``parallel`` and ``train_parallel``; the
float32 kernels with their launches on the ``float32`` phase's path, the
SIMT int8 ones on the ``int8_any`` phase's and the bf16 SIMT ones on the
``bf16_any`` phase's, by entry point, both SIMT kinds also on the
``widths`` phase's, the widths rows among each kernel's ``other_cases``) and
``{"ok": true, "device": ...}``.
Imports nothing of JAX or herro_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import hashlib
import importlib.util
import io
import json
import os
import re
import shutil
import stat
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "resources", "model_r10_sim")
GOLDEN = os.path.join(ROOT, "tests", "golden", "logits_r10.npz")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s by type
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
# exponentials on the SFU (ex2): the CUDA C++ Programming Guide's table of
# arithmetic instruction throughput gives compute capability 9.0 16 results
# a clock an SM for the base-2 exponential; 132 SMs at the H100 SXM's 1.98 GHz
PEAK_EXP2 = 132 * 16 * 1.98e9
# int8 on the CUDA cores (__dp4a, the SIMT int8 K10 and K11 before they
# moved onto the tensor cores, their bound beside the new one): the
# CUDA C++ Programming Guide's table of arithmetic instruction throughput
# gives compute capability 9.0 64 results a clock an SM for 32-bit integer
# multiply-add, the pipe __dp4a issues on; one __dp4a result is 4
# multiply-adds (8 operations); 132 SMs at the H100 SXM's 1.98 GHz boost
PEAK_INT8_SIMT = 132 * 64 * 8 * 1.98e9

B, L = 32, 9216  # CLI default batch at the R10 bucket (pipeline/batching.py)


START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``at_s``: seconds since the script started, where the
    time of a phase shows."""
    print(json.dumps({"phase": phase, **kw, "at_s": time.perf_counter() - START}), flush=True)


# seconds each phase took, by its name, summed over its calls (``timed``);
# printed on a line of its own near the end of the run
PHASE_S: dict = {}


def timed(phase: str, fn, *args):
    """``fn(*args)``, its seconds added to ``PHASE_S[phase]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[phase] = PHASE_S.get(phase, 0.0) + time.perf_counter() - t0


def nvidia_smi() -> str:
    """The card's name and power limit (``pipeline/steptime.py:card``)."""
    from herro_tpu_torch.pipeline.steptime import card

    return card()


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Per-call device time of ``fn`` from the replay of one CUDA graph of
    ``iters`` calls. A kernel of a few microseconds takes less time on the
    card than its Python wrapper takes to launch it, so an eager loop times
    the wrapper; the graph replays the launches alone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(torch, graph.replay, 5) / iters
    del graph
    return ms


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def tc_bound(nbytes: float, ops: float, exps: float, f32: bool) -> tuple[float, str]:
    """The tensor-core attention's bound (``csrc/flash_tc.cuh``): the
    larger of its bytes over the memory rate and its operations, the
    products at the tensor cores' peak for the operands (float32 as three
    TF32 products: a third of the TF32 peak) or its exponentials at the
    SFU's rate, whichever takes longer."""
    return bound(nbytes, max(ops, exps * (PEAK_TF32 / 3 if f32 else PEAK_BF16) / PEAK_EXP2),
                 PEAK_TF32 / 3 if f32 else PEAK_BF16)


def dp4a_bound(nbytes: float, ops: float) -> dict:
    """The bound of a SIMT int8 row at the __dp4a rate (``PEAK_INT8_SIMT``),
    which the SIMT int8 K10 and K11 ran at before the int8 tensor cores:
    reported beside their tensor-core bound."""
    ms, by = bound(nbytes, ops, PEAK_INT8_SIMT)
    return dict(bound_dp4a_ms=ms, bound_dp4a_by=by)


def compare(torch, got, ref, keep=None, residual=None, exact=False, atol=None):
    """Kernel outputs against the plain version's: (max abs error, its
    tolerance, the residual-free part's excess error, its tolerance).

    float32 outputs (``atol``) are held to the CPU tests' absolute bar, 1e-4
    (2e-4 after an out projection): the output and, where it is ``residual +
    part``, the part (the residual is exact on both sides, so the part's
    error is the output's, less one float32 rounding) at the same bar.

    bf16 outputs may differ by 4 ulps at the largest magnitude (bf16 keeps 8
    bits; the two sides sum in other orders, and K2 keeps P in bf16 in an
    online softmax). Where the output is ``residual + part``, the
    residual's magnitude would hide an error in the part, so the parts are
    held apart too: besides the one final bf16 rounding of the sum (an ulp of
    the output), they may differ by 2^-6 of the part's own largest magnitude.
    ``keep`` masks the rows to compare; integer outputs (``exact``) must be
    equal."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = scale = 0.0
    part_err = part_scale = None
    for a, r in zip(got, ref):
        if keep is not None:
            a, r = a[keep], r[keep]
        a, r = a.float(), r.float()
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError("non-finite kernel output")
        diff = (a - r).abs()
        err = max(err, float(diff.max()))
        scale = max(scale, float(r.abs().max()))
        if residual is not None:
            x = (residual[keep] if keep is not None else residual).float()
            mag = torch.maximum(a.abs(), r.abs()).clamp_min(2.0 ** -100)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            part_err = float((diff - ulp).max())
            part_scale = float((r - x).abs().max())
    if atol is not None:
        if part_err is not None:
            part_err = err - float(torch.finfo(torch.float32).eps) * scale
        return err, atol, part_err, None if part_err is None else atol
    tol = 0.0 if exact else scale * 2.0 ** -6
    part_tol = None if part_scale is None else part_scale * 2.0 ** -6
    return err, tol, part_err, part_tol


def float64_layernorm_sums(fused, plain, *args):
    """``plain`` (``fused._ln_ffn_q_plain`` or ``fused._ln_qkv_rope_q_plain``)
    with LayerNorm's two sums (of x and of x^2) taken in float64 and rounded
    to float32, every other step as it is."""
    import torch

    def layernorm(x, scale, bias, eps: float = 1e-6):
        xf = x.float()
        xd = xf.double()
        mu = xd.mean(dim=-1, keepdim=True).float()
        msq = (xd * xd).mean(dim=-1, keepdim=True).float()
        var = torch.clamp(msq - mu * mu, min=0.0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * scale.float() + bias.float()).to(x.dtype)

    kept = fused.layernorm
    fused.layernorm = layernorm
    try:
        return plain(*args)
    finally:
        fused.layernorm = kept


def share_differing(got, ref, keep=None) -> float:
    """The largest share, over the outputs, of elements that differ at all
    (of the rows ``keep`` masks, where given)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if keep is not None:
        got, ref = tuple(a[keep] for a in got), tuple(r[keep] for r in ref)
    return max(float((a != r).float().mean()) for a, r in zip(got, ref))


QKV_REPLACES = {
    "ln_qkv_rope": "herro_tpu/ops/fused.py:572",
    "ln_qkv_rope_split": "herro_tpu/ops/fused.py:541",
    "ln_qkv_rope_q": "herro_tpu/ops/fused.py:718",
}


def phase_kernels(torch, results: dict) -> None:
    """K1-K11 at the main-path shapes against their plain versions."""
    import numpy as np
    import torch.nn.functional as F

    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE, TOKEN_PAD, VOCAB_SIZE
    from herro_tpu_torch.ops import attention, consensus, fused

    dev = torch.device("cuda")
    d, H, D, f, R, V, w = 512, 4, 128, 1024, N_ROWS, VOCAB_SIZE, 512
    T = B * L
    rng = np.random.default_rng(1234)
    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    # realistic pileups: a length per window below L, pad suffix, n_alns rows
    lengths_np = rng.integers(int(0.7 * L), L + 1, size=B).astype(np.int32)
    n_alns_np = rng.integers(2, R, size=B).astype(np.int32)
    tok = rng.integers(0, 11, size=(B, R, L), dtype=np.uint8)
    tok[:, 0] = rng.integers(0, 5, size=(B, L), dtype=np.uint8)
    for b in range(B):
        tok[b, n_alns_np[b] + 1 :] = TOKEN_PAD
        tok[b, :, lengths_np[b] :] = TOKEN_PAD
    quals_u8 = rng.integers(33, 127, size=(B, R, L), dtype=np.uint8)
    tokens = torch.from_numpy(tok).to(dev)
    quals = QUAL_SCALE * torch.from_numpy(quals_u8).to(dev).float() - QUAL_OFFSET
    lengths = torch.from_numpy(lengths_np).to(dev)
    n_alns = torch.from_numpy(n_alns_np).to(dev)

    fan = R * (V + 1)
    # biases large enough that a kernel which drops one leaves its tolerance
    bias_std = 0.25
    w_embT, w_qT = randn(d, R * V, std=fan ** -0.5), randn(d, R, std=fan ** -0.5)
    wc = fused.col_proj_table(w_embT, w_qT)
    cb = randn(d, std=bias_std, dtype=torch.float32)
    x = randn(B, L, d)
    ln_s = 1.0 + randn(d, std=0.1, dtype=torch.float32)
    ln_b = randn(d, std=0.1, dtype=torch.float32)
    w_qkv, b_qkv = randn(d, 3 * H * D, std=d ** -0.5), randn(3 * H * D, std=bias_std)
    wo, bo = randn(H, D, d, std=(H * D) ** -0.5), randn(d, std=bias_std)
    w1, b1 = randn(d, f, std=d ** -0.5), randn(f, std=bias_std)
    w2, b2 = randn(f, d, std=f ** -0.5), randn(d, std=bias_std)
    q, k, v = fused._ln_qkv_rope_cuda(x, ln_s, ln_b, w_qkv, b_qkv, H, kernel="ln_qkv_rope")
    torch.cuda.synchronize()
    # int8 operands as the model builds them: qkv quantized from the weight in
    # the compute dtype, the FFN weights from float32, FFN biases float32
    N = 3 * H * D
    wq_i8, sq = fused.quantize_weight(w_qkv)
    w1_i8, s1 = fused.quantize_weight(w1.float())
    w2_i8, s2 = fused.quantize_weight(w2.float())
    wq_i8, w1_i8, w2_i8 = (fused.k_major(t) for t in (wq_i8, w1_i8, w2_i8))
    b1_f, b2_f = b1.float(), b2.float()
    # K8, K10 and K11 at the r9 width: d 256, H 2, d_ff 1536
    d9, H9, f9 = 256, 2, 1536
    x9 = randn(B, L, d9)
    ln_s9 = 1.0 + randn(d9, std=0.1, dtype=torch.float32)
    ln_b9 = randn(d9, std=0.1, dtype=torch.float32)
    w_qkv9, b_qkv9 = randn(d9, 3 * H9 * D, std=d9 ** -0.5), randn(3 * H9 * D, std=bias_std)
    wq9_i8, sq9 = fused.quantize_weight(w_qkv9)
    wq9_i8 = fused.k_major(wq9_i8)
    w19_i8, s19 = fused.quantize_weight(randn(d9, f9, std=d9 ** -0.5, dtype=torch.float32))
    w29_i8, s29 = fused.quantize_weight(randn(f9, d9, std=f9 ** -0.5, dtype=torch.float32))
    w19_i8, w29_i8 = fused.k_major(w19_i8), fused.k_major(w29_i8)
    b19 = randn(f9, std=bias_std, dtype=torch.float32)
    b29 = randn(d9, std=bias_std, dtype=torch.float32)

    def ln_rows_i8(xs=x, s=ln_s, b=ln_b):
        """LN(x) quantized per row, the left operand of torch._int_mm."""
        y = fused.layernorm(xs, s, b).float().view(-1, xs.shape[-1])
        return fused._quant_rows(y)[0]

    def ffn_q_case(xs, s, b, w1q, s1q, b1q, w2q, s2q, b2q):
        """K11 on these rows and weights. ``floor``: the plain version with
        LayerNorm's sums taken in float64, the noise that the order of two
        float32 sums alone makes."""
        ts, dd = xs.shape[0] * xs.shape[1], xs.shape[-1]
        ff = w1q.shape[1]
        args = (xs, s, b, w1q, s1q, b1q, w2q, s2q, b2q)
        return dict(
            name="ln_ffn_q", replaces="herro_tpu/ops/fused.py:420",
            kernel=lambda: fused._ln_ffn_q_cuda(*args),
            plain=lambda: fused._ln_ffn_q_plain(*args),
            floor=lambda: float64_layernorm_sums(fused, fused._ln_ffn_q_plain, *args),
            library=("torch._int_mm quant(LN(x))[T,d] @ W1[d,f] int8 -> int32, half the "
                     "operations (partial: no LN, quantization, gelu, second product)",
                     lambda y_i8: torch._int_mm(y_i8, w1q), lambda: ln_rows_i8(xs, s, b)),
            bound=bound(2 * ts * dd * 2 + 2 * dd * ff + (dd + ff) * 8, 4 * ts * dd * ff,
                        PEAK_INT8),
            residual=xs, share_differing=True,
        )

    # band pairs this data needs: every query row below the length against
    # keys j < length with |i - j| <= w (rows past it are padding nobody reads)
    i = np.arange(L)

    def band_pairs(band: int, lens=lengths_np, n_rows: int = L) -> int:
        return sum(
            int((np.minimum(rows + band, lb - 1) - np.maximum(rows - band, 0) + 1).clip(0).sum())
            for lb in lens
            for rows in [i[:min(n_rows, lb)]]
        )

    pairs = band_pairs(w)
    # full attention: mixed lengths, one window empty; the function needs
    # the pairs below each length (rows past it are padding nobody reads)
    lengths_full_np = lengths_np.copy()
    lengths_full_np[::4] = rng.integers(L // 4, L // 2, size=len(lengths_full_np[::4]))
    lengths_full_np[3] = 0
    lengths_full = torch.from_numpy(lengths_full_np).to(dev)
    pairs_full = int((lengths_full_np.astype(np.int64) ** 2).sum())
    # K1-K4 also at L=5120, the bucket most windows of the demo-size run
    # take: the first L5 columns of the same inputs, lengths drawn as above
    L5 = 5120
    T5 = B * L5
    lengths5_np = rng.integers(int(0.7 * L5), L5 + 1, size=B).astype(np.int32)
    lengths5 = torch.from_numpy(lengths5_np).to(dev)
    x5 = x[:, :L5].contiguous()
    tokens5, quals5 = (t[:, :, :L5].contiguous() for t in (tokens, quals))
    q5, k5, v5 = (t[:, :, :L5].contiguous() for t in (q, k, v))
    pairs5 = band_pairs(w, lengths5_np, L5)
    # full attention at L5: the mixed lengths above scaled to L5 (one still 0)
    lengths_full5_np = (lengths_full_np.astype(np.int64) * L5 // L).astype(np.int32)
    lengths_full5 = torch.from_numpy(lengths_full5_np).to(dev)
    pairs_full5 = int((lengths_full5_np.astype(np.int64) ** 2).sum())
    k_pos = torch.arange(L, device=dev)

    def sdpa_bias(lens, band, n=L):
        """The mask as the additive bias F.scaled_dot_product_attention takes,
        [B, 1, n, n] bf16: 0 where key j < length (and |i - j| <= band)."""
        pos = k_pos[:n]
        ok = (pos[None, :] < lens[:, None])[:, None, None, :]
        if band is not None:
            ok = ok & ((pos[:, None] - pos[None, :]).abs() <= band)[None, None]
        bias = torch.zeros(B, 1, n, n, dtype=bf, device=dev)
        return bias.masked_fill_(~ok, float("-inf"))

    def sdpa(bias, qkv=None):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        # the fused backend only: the math backend would hold [B, H, L, L]
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(*(qkv or (q, k, v)), attn_mask=bias)

    def attention_case(name, replaces, lens, lens_np, band, n_pairs, label, ops=None):
        """K2, K6 or K7 on ``ops`` = (q, k, v, x), the L=9216 inputs by default.
        The out projection counts the rows below each length: the rest are
        padding."""
        qq, kk, vv, xx = ops or (q, k, v, x)
        n = xx.shape[1]
        proj_rows = int(np.minimum(lens_np, n).sum())
        return dict(
            name=name, replaces=replaces,
            kernel=lambda: fused._flash_outproj_cuda(qq, kk, vv, xx, wo, bo, lens, band),
            plain=lambda: fused._flash_outproj_plain(qq, kk, vv, xx, wo, bo, lens, band),
            library=(f"F.scaled_dot_product_attention (memory-efficient backend) with "
                     f"{label} as an additive mask: attention only, no out projection",
                     lambda bias: sdpa(bias, (qq, kk, vv)), lambda: sdpa_bias(lens, band, n)),
            bound=bound(kv_bytes * n // L + 2 * B * n * d * 2 + H * D * d * 2,
                        4 * H * D * n_pairs + 2 * proj_rows * H * D * d, PEAK_BF16),
            rows=lens_np, residual=xx,
        )

    def flash_attention_case(lens, lens_np, band, n_pairs, label, qkv=None):
        """K9 on ``qkv``, the L=9216 inputs by default: the same function as
        SDPA with the mask, on the valid rows."""
        qq, kk, vv = qkv or (q, k, v)
        n = qq.shape[2]
        return dict(
            name="flash_attention", replaces="herro_tpu/ops/attention.py:36",
            kernel=lambda: attention._flash_attention_cuda(qq, kk, vv, lens, band),
            plain=lambda: attention._flash_attention_plain(qq, kk, vv, lens, band),
            library=(f"F.scaled_dot_product_attention (memory-efficient backend) with "
                     f"{label} as an additive mask: the same function",
                     lambda bias: sdpa(bias, (qq, kk, vv)), lambda: sdpa_bias(lens, band, n)),
            bound=bound(kv_bytes * n // L * 4 // 3, 4 * H * D * n_pairs, PEAK_BF16),
            rows=lens_np,
        )

    def count_case(toks):
        """K5 on these tokens. The function needs rows 0..n_alns of each
        batch element (row 0 at least, for the target), one byte a column
        out."""
        n = toks.shape[2]
        rows = int(np.clip(n_alns_np.astype(np.int64) + 1, 1, R).sum())
        return dict(
            name="count_decisions", replaces="herro_tpu/ops/fused.py:212",
            kernel=lambda: consensus._count_decisions_cuda(toks, n_alns),
            plain=lambda: consensus._count_decisions_plain(toks, n_alns),
            library=("none: no PyTorch call computes the counting rule", None),
            bound=bound(rows * n + B * n + 4 * B, 0, PEAK_F32),
            exact=True, graph=True,
        )

    x_bytes = T * d * 2
    kv_bytes = 3 * B * H * L * D * 2
    # the banded QK^T as one torch.matmul: 64-row query blocks against their
    # 64 + 2w key spans (a strided view of the zero-padded keys)
    kpad = F.pad(k, (0, 0, w, w))
    k_spans = kpad.unfold(2, 64 + 2 * w, 64)  # [B, H, L/64, D, 64+2w]
    q_blocks = q.view(B, H, L // 64, 64, D)
    k5_spans = F.pad(k5, (0, 0, w, w)).unfold(2, 64 + 2 * w, 64)
    q5_blocks = q5.view(B, H, L5 // 64, 64, D)
    emb_table = w_embT.t().contiguous()

    def emb_idx(toks):
        idx = toks.long() + torch.arange(R, device=dev)[None, :, None] * V
        return idx.permute(0, 2, 1).reshape(-1, R)

    def embed_case(toks, qs):
        """K4 on these tokens and quals. Its work: a multiply-add over d for
        each nonzero of the one-hot|qual rows (one per in-vocab token, one per
        nonzero bf16 qual) on bf16 operands; the one-hot's zeros and the
        padding are no work of the function."""
        nnz = int((toks < V).sum()) + int((qs.to(bf) != 0).sum())
        idx = emb_idx(toks)
        return dict(
            name="entry_embed", replaces="herro_tpu/ops/fused.py:89",
            kernel=lambda: fused._entry_embed_cuda(toks, qs, wc, cb, bf),
            plain=lambda: fused._entry_embed_plain(toks, qs, wc, cb, bf),
            library=("F.embedding_bag(mode=sum) of the token rows, no qual term",
                     lambda: F.embedding_bag(idx, emb_table, mode="sum")),
            bound=bound(toks.numel() * 5 + toks.numel() // R * d * 2 + wc.numel() * 2
                        + d * 4, 2 * d * nnz, PEAK_BF16),
        )

    def qkv_case(xs, kernel="ln_qkv_rope", s=ln_s, b=ln_b, wq=w_qkv, bq=b_qkv, heads=H):
        """K1 or K8 on these rows and weights; K8 also against K1 (``twin``),
        which must give the same bits."""
        ts, dd, n = xs.shape[0] * xs.shape[1], xs.shape[-1], wq.shape[1]
        args = (xs, s, b, wq, bq, heads)
        c = dict(
            name=kernel, replaces=QKV_REPLACES[kernel],
            kernel=lambda: fused._ln_qkv_rope_cuda(*args, kernel=kernel),
            plain=lambda: fused._ln_qkv_rope_plain(*args),
            library=("torch.matmul LN(x)[T,d] @ W_qkv[d,3HD] bf16, the dominant product",
                     lambda: torch.matmul(xs.view(ts, dd), wq)),
            bound=bound(ts * dd * 2 + ts * n * 2 + dd * n * 2, 2 * ts * dd * n, PEAK_BF16),
        )
        if kernel == "ln_qkv_rope_split":
            c["twin"] = lambda: fused._ln_qkv_rope_cuda(*args, kernel="ln_qkv_rope")
        return c

    def qkv_q_case(xs, s=ln_s, b=ln_b, wq=wq_i8, sc=sq, bq=b_qkv, heads=H):
        """K10 on these rows and weights; ``floor`` as for K11."""
        ts, dd, n = xs.shape[0] * xs.shape[1], xs.shape[-1], wq.shape[1]
        args = (xs, s, b, wq, sc, bq, heads)
        return dict(
            name="ln_qkv_rope_q", replaces=QKV_REPLACES["ln_qkv_rope_q"],
            kernel=lambda: fused._ln_qkv_rope_q_cuda(*args),
            plain=lambda: fused._ln_qkv_rope_q_plain(*args),
            floor=lambda: float64_layernorm_sums(fused, fused._ln_qkv_rope_q_plain, *args),
            library=("torch._int_mm quant(LN(x))[T,d] @ W_qkv[d,3HD] int8 -> int32, the "
                     "dominant product only (partial: no LN, quantization, scales, rope)",
                     lambda y_i8: torch._int_mm(y_i8, wq), lambda: ln_rows_i8(xs, s, b)),
            bound=bound(ts * dd * 2 + ts * n * 2 + dd * n + n * 6, 2 * ts * dd * n,
                        PEAK_INT8),
            share_differing=True,
        )

    cases = {
        "entry_embed": embed_case(tokens, quals),
        "ln_qkv_rope": qkv_case(x),
        "flash_outproj": dict(
            replaces="herro_tpu/ops/fused.py:993",
            kernel=lambda: fused._flash_outproj_cuda(q, k, v, x, wo, bo, lengths, w),
            plain=lambda: fused._flash_outproj_plain(q, k, v, x, wo, bo, lengths, w),
            library=("torch.matmul banded QK^T (64-row blocks x 1088-key spans) bf16, "
                     "the dominant product",
                     lambda: torch.matmul(q_blocks, k_spans)),
            bound=bound(kv_bytes + 2 * x_bytes + H * D * d * 2,
                        4 * H * D * pairs + 2 * int(lengths_np.sum()) * H * D * d, PEAK_BF16),
            rows=lengths_np,
            residual=x,
        ),
        "ln_ffn": dict(
            replaces="herro_tpu/ops/fused.py:286",
            kernel=lambda: fused._ln_ffn_cuda(x, ln_s, ln_b, w1, b1, w2, b2),
            plain=lambda: fused._ln_ffn_plain(x, ln_s, ln_b, w1, b1, w2, b2),
            library=("torch.matmul LN(x)[T,d] @ W1[d,f] bf16, half the FLOPs",
                     lambda: torch.matmul(x.view(T, d), w1)),
            bound=bound(2 * x_bytes + 2 * d * f * 2, 4 * T * d * f, PEAK_BF16),
            residual=x,
        ),
        "flash_outproj[L=5120]": dict(
            name="flash_outproj", replaces="herro_tpu/ops/fused.py:993",
            kernel=lambda: fused._flash_outproj_cuda(q5, k5, v5, x5, wo, bo, lengths5, w),
            plain=lambda: fused._flash_outproj_plain(q5, k5, v5, x5, wo, bo, lengths5, w),
            library=("torch.matmul banded QK^T (64-row blocks x 1088-key spans) bf16, "
                     "the dominant product",
                     lambda: torch.matmul(q5_blocks, k5_spans)),
            bound=bound(kv_bytes * L5 // L + 2 * T5 * d * 2 + H * D * d * 2,
                        4 * H * D * pairs5 + 2 * int(lengths5_np.sum()) * H * D * d,
                        PEAK_BF16),
            rows=lengths5_np,
            residual=x5,
        ),
        "entry_embed[L=5120]": embed_case(tokens5, quals5),
        "ln_qkv_rope[L=5120]": qkv_case(x5),
        "ln_ffn[L=5120]": dict(
            name="ln_ffn", replaces="herro_tpu/ops/fused.py:286",
            kernel=lambda: fused._ln_ffn_cuda(x5, ln_s, ln_b, w1, b1, w2, b2),
            plain=lambda: fused._ln_ffn_plain(x5, ln_s, ln_b, w1, b1, w2, b2),
            library=("torch.matmul LN(x)[T,d] @ W1[d,f] bf16, half the FLOPs",
                     lambda: torch.matmul(x5.view(T5, d), w1)),
            bound=bound(2 * T5 * d * 2 + 2 * d * f * 2, 4 * T5 * d * f, PEAK_BF16),
            residual=x5,
        ),
        "count_decisions": count_case(tokens),
        "count_decisions[L=5120]": count_case(tokens5),
        "flash_outproj_full": attention_case(
            "flash_outproj_full", "herro_tpu/ops/fused.py:821", lengths_full,
            lengths_full_np, None, pairs_full, "the length mask",
        ),
        "flash_outproj_band": attention_case(
            "flash_outproj_band", "herro_tpu/ops/fused.py:902", lengths, lengths_np,
            384, band_pairs(384), "the band 384 and the length mask",
        ),
        # the same kernel below one key tile; reported under its own case name
        "flash_outproj_band[w=40]": attention_case(
            "flash_outproj_band", "herro_tpu/ops/fused.py:902", lengths, lengths_np,
            40, band_pairs(40), "the band 40 and the length mask",
        ),
        # K7 and K6 at L=5120, as K1-K4 above
        "flash_outproj_full[L=5120]": attention_case(
            "flash_outproj_full", "herro_tpu/ops/fused.py:821", lengths_full5,
            lengths_full5_np, None, pairs_full5, "the length mask", (q5, k5, v5, x5),
        ),
        "flash_outproj_band[w=384, L=5120]": attention_case(
            "flash_outproj_band", "herro_tpu/ops/fused.py:902", lengths5, lengths5_np,
            384, band_pairs(384, lengths5_np, L5), "the band 384 and the length mask",
            (q5, k5, v5, x5),
        ),
        "flash_outproj_band[w=40, L=5120]": attention_case(
            "flash_outproj_band", "herro_tpu/ops/fused.py:902", lengths5, lengths5_np,
            40, band_pairs(40, lengths5_np, L5), "the band 40 and the length mask",
            (q5, k5, v5, x5),
        ),
        # K8: the same function as K1 with the tables built in the kernel
        "ln_qkv_rope_split": qkv_case(x, "ln_qkv_rope_split"),
        "ln_qkv_rope_split[L=5120]": qkv_case(x5, "ln_qkv_rope_split"),
        "ln_qkv_rope_split[d=256, H=2]": qkv_case(x9, "ln_qkv_rope_split", ln_s9, ln_b9,
                                                  w_qkv9, b_qkv9, H9),
        "ln_qkv_rope_q": qkv_q_case(x),
        "ln_qkv_rope_q[L=5120]": qkv_q_case(x5),
        "ln_qkv_rope_q[d=256, H=2]": qkv_q_case(x9, ln_s9, ln_b9, wq9_i8, sq9, b_qkv9, H9),
        "ln_ffn_q": ffn_q_case(x, ln_s, ln_b, w1_i8, s1, b1_f, w2_i8, s2, b2_f),
        "ln_ffn_q[L=5120]": ffn_q_case(x5, ln_s, ln_b, w1_i8, s1, b1_f, w2_i8, s2, b2_f),
        # the r9 width (d 256, d_ff 1536), which the int8 eval of model_r9_sim runs
        "ln_ffn_q[d=256, f=1536]": ffn_q_case(x9, ln_s9, ln_b9, w19_i8, s19, b19, w29_i8,
                                              s29, b29),
        "flash_attention": flash_attention_case(
            lengths, lengths_np, w, pairs, "the band 512 and the length mask"),
        # no band, mixed lengths, one of them 0 (that example must come out 0)
        "flash_attention[full]": flash_attention_case(
            lengths_full, lengths_full_np, None, pairs_full, "the length mask"),
        # a band below one 128-key tile, and both masks at L=5120
        "flash_attention[w=40]": flash_attention_case(
            lengths, lengths_np, 40, band_pairs(40), "the band 40 and the length mask"),
        "flash_attention[L=5120]": flash_attention_case(
            lengths5, lengths5_np, w, pairs5, "the band 512 and the length mask",
            (q5, k5, v5)),
        "flash_attention[full, L=5120]": flash_attention_case(
            lengths_full5, lengths_full5_np, None, pairs_full5, "the length mask",
            (q5, k5, v5)),
    }
    cases.update(shard_cases(
        torch, dict(x=x, x9=x9, ln_s=ln_s, ln_b=ln_b, ln_s9=ln_s9, ln_b9=ln_b9, q=q, k=k,
                    v=v, w_qkv=w_qkv, b_qkv=b_qkv, wo=wo, bo=bo, w1=w1, b1=b1, w2=w2,
                    b2=b2, w_qkv9=w_qkv9, b_qkv9=b_qkv9, lengths=lengths,
                    lengths_np=lengths_np, pairs=pairs, k_spans=k_spans,
                    q_blocks=q_blocks), qkv_case, g))
    cases.update(d384_cases(
        torch, dict(tokens=tokens, quals=quals, lengths=lengths, lengths_np=lengths_np,
                    pairs=pairs), qkv_case, g))
    cases.update(shard_q_cases(
        torch, dict(x=x, x9=x9, ln_s=ln_s, ln_b=ln_b, ln_s9=ln_s9, ln_b9=ln_b9, w_qkv=w_qkv,
                    b_qkv=b_qkv, w_qkv9=w_qkv9, b_qkv9=b_qkv9, w1=w1, b1=b1, w2=w2, b2=b2),
        qkv_q_case, ln_rows_i8, g))

    def reciprocal_share():
        # rows whose scale max|y| / 127 differs when PyTorch divides by the
        # Python number 127.0 (a multiplication by its reciprocal on the card)
        amax = fused.layernorm(x, ln_s, ln_b).float().abs().amax(dim=-1)
        return dict(share_scale_by_reciprocal_differs=float(
            (amax / 127.0 != fused._div127(amax)).float().mean()))

    cases["ln_ffn_q"]["extra"] = reciprocal_share
    report = run_cases(torch, cases)
    results["kernels"] = report
    del q, k, v, kpad, k_spans, q_blocks, q5, k5, v5, x5, k5_spans, q5_blocks
    del cases, tokens5, quals5, x9, w19_i8, w29_i8, w_qkv9, wq9_i8
    torch.cuda.empty_cache()


def run_cases(torch, cases: dict, phase: str = "kernels", quick: bool = False) -> list:
    """Each case's kernel against its plain version on the same inputs (with
    the case's tolerance), then timed beside the plain version and the
    library call, with its bound; one JSON line a case. Raises when any
    disagrees; returns the report. ``quick``: the plain version timed by one
    call (the comparison's call warmed it), the library call by two after
    one warm-up; the kernel as always."""
    report = []
    dev = torch.device("cuda")
    for case, c in cases.items():
        name = c.get("name", case)
        got, ref = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        keep = None
        if "rows" in c:  # rows at or past the length are never read
            rows = torch.from_numpy(c["rows"]).to(dev)
            n_rows = got.shape[1] if got.dim() == 3 else got.shape[2]
            keep = torch.arange(n_rows, device=dev)[None, :] < rows[:, None]
            if got.dim() == 4:  # [B, H, L, D]: the same rows of every head
                keep = keep[:, None, :].expand(got.shape[0], got.shape[1], n_rows)
                empty = rows == 0  # K9 walks no key there and leaves 0
                if bool(empty.any()) and bool(got[empty].any()):
                    raise RuntimeError(f"{case}: a length-0 example is not all 0")
            # the padding rows are compared nowhere, but must be finite
            if not bool(torch.isfinite(got.float()).all()):
                raise RuntimeError(f"{case}: non-finite values in padding rows")
        err, tol, part_err, part_tol = compare(
            torch, got, ref, keep, c.get("residual"), c.get("exact", False), c.get("atol")
        )
        ok = err <= tol and (part_err is None or part_err <= part_tol)
        extra = {}
        if c.get("share_differing"):  # int8: the int32 product is exact; bf16: roundings
            extra["share_differing"] = share_differing(got, ref, keep)
        if "max_share" in c:  # bf16 SIMT: a missed rounding moves most outputs
            extra["share_bar"] = c["max_share"]
            ok = ok and extra["share_differing"] <= c["max_share"]
        if "floor" in c:  # the same share between two plain runs, LN's sums apart
            extra["share_differing_floor"] = floor = share_differing(c["floor"](), ref, keep)
            # the kernel's LayerNorm sums in another order again: at most twice that
            if "chain" not in c:
                ok = ok and extra["share_differing"] <= 2 * floor
        if "chain" in c:  # the same bar on the outputs of the pass the case feeds
            k_out, p_out, f_out = (fn() for fn in c["chain"])
            extra["chain_share_differing"] = share_differing(k_out, p_out)
            extra["chain_share_differing_floor"] = floor = share_differing(f_out, p_out)
            ok = ok and extra["chain_share_differing"] <= 2 * floor
            del k_out, p_out, f_out
        if "extra" in c:  # figures a case reports beside the comparison
            extra.update(c["extra"]())
        if "twin" in c:  # K8 against K1: the same bits
            gap = max(float((a.float() - t.float()).abs().max())
                      for a, t in zip(got, c["twin"]()))
            extra["max_abs_err_vs_table_kernel"] = gap
            ok = ok and gap == 0
        iters = c.get("iters", 20)
        ms = time_ms(torch, c["kernel"], iters)
        if c.get("graph"):  # device time; the eager loop's is the wrapper's
            extra["eager_ms"] = ms
            ms = graph_ms(torch, c["kernel"], iters)
        plain_ms = time_ms(torch, c["plain"], *((1, 0) if quick else (3, 1)))
        del got, ref
        lib_label, lib_fn, *lib_setup = c["library"]
        lib_ms = None
        lib_iters = (2, 1) if quick else (min(iters, 5), 2)
        if lib_setup:  # a library call with an operand of its own to build
            operand = lib_setup[0]()
            lib_ms = time_ms(torch, lambda: lib_fn(operand), *lib_iters)
            del operand
            torch.cuda.empty_cache()
        elif lib_fn is not None:
            lib_ms = time_ms(torch, lib_fn, *(lib_iters if quick else (iters, 2)))
        bound_ms, bound_by = c["bound"]
        entry = dict(
            name=name, case=case, route="cuda",
            source=f"herro_tpu_torch/csrc/{name}.cu", mode=c.get("mode"),
            replaces=c["replaces"], max_abs_err=err, tol=tol,
            part_err=part_err, part_tol=part_tol, ok=ok, ms=ms,
            plain_ms=plain_ms, library=lib_label, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms, **extra,
        )
        report.append(entry)
        emit(phase, **entry)
    bad = [
        f"{e['case']} (max {e['max_abs_err']} vs {e['tol']}, residual-free part "
        f"{e['part_err']} vs {e['part_tol']})"
        for e in report if not e["ok"]
    ]
    if bad:
        raise RuntimeError(f"{phase}: kernels disagree with their plain versions: "
                           + ", ".join(bad))
    return report


# (tp, d_model): the tensor-parallel shards the kernels phase holds K1, K2 and
# K3 at: r10 (d 512, H 4, d_ff 1024) at tp 2 and 4, r10deep (d 256, H 2,
# d_ff 1024) at tp 2
SHARDS = ((2, 512), (4, 512), (2, 256))


def shard_cases(torch, t: dict, qkv_case, g) -> dict:
    """K1, K2 and K3 at the widths one shard of a tensor-parallel run takes
    (``parallel/tensor.py``), on shard 0 of the kernels phase's weights (and
    its d 256 ones, with a d_ff 1024 FFN drawn here); K2 on the stream and
    biases a shard is fed (x / tp, bo / tp) and that shard's heads of q, k
    and v. The tolerances are those of the full-width cases."""
    from herro_tpu_torch.parallel.tensor import shard_weights

    bf = torch.bfloat16
    w = 512
    cases = {}
    for tp, d in SHARDS:
        full = d == 512
        xs = t["x"] if full else t["x9"]
        s, b = (t["ln_s"], t["ln_b"]) if full else (t["ln_s9"], t["ln_b9"])
        H = 4 if full else 2
        if full:
            w1, b1, w2, b2 = t["w1"], t["b1"], t["w2"], t["b2"]
        else:
            f = 1024
            w1 = (torch.randn(d, f, generator=g, device=xs.device) * d ** -0.5).to(bf)
            b1 = (torch.randn(f, generator=g, device=xs.device) * 0.25).to(bf)
            w2 = (torch.randn(f, d, generator=g, device=xs.device) * f ** -0.5).to(bf)
            b2 = (torch.randn(d, generator=g, device=xs.device) * 0.25).to(bf)
        wo = t["wo"] if full else t["wo"][:H, :, :d].contiguous()
        sh = shard_weights(
            dict(w_qkv=t["w_qkv"] if full else t["w_qkv9"], b_qkv=t["b_qkv"] if full
                 else t["b_qkv9"], wo=wo, bo=t["bo"][:d], w1=w1, b1=b1, w2=w2, b2=b2),
            tp, 0)
        h, f_loc = H // tp, sh["w1"].shape[1]
        tag = f"d={d}, " if not full else ""
        cases[f"ln_qkv_rope[{tag}H={h}]"] = qkv_case(xs, "ln_qkv_rope", s, b, sh["w_qkv"],
                                                      sh["b_qkv"], h)
        cases[f"flash_outproj[{tag}H={h}]"] = shard_attention_case(
            torch, t, xs * (1.0 / tp), sh["wo"], sh["bo"], h, w)
        cases[f"ln_ffn[{tag}f={f_loc}]"] = ffn_case(
            torch, xs * (1.0 / tp), s, b, sh["w1"], sh["b1"], sh["w2"], sh["b2"])
    return cases


# int8 at the widths of one tensor-parallel shard: K10 at (tp, d_model) of
# SHARDS (H 2 and 1 at d 512, H 1 at d 256), and K11's two modes at (d_model,
# d_ff, tp): r10 (512, 1024) at tp 2 and 4, r9 (256, 1536) and r10deep (256,
# 1024) at tp 2
FFN_Q_SHARDS = ((512, 1024, 2), (512, 1024, 4), (256, 1536, 2), (256, 1024, 2))


def shard_q_cases(torch, t: dict, qkv_q_case, ln_rows_i8, g) -> dict:
    """K10 and K11's modes at one shard's widths, on shard 0 of the kernels
    phase's weights (at d 256 the r9 qkv weight, FFN weights drawn here),
    quantized as ``TensorParallelModel`` quantizes them (the whole W2's
    column scales). K11's ``rowmax`` mode on LayerNorm of the whole stream;
    its ``rowscale`` mode given the maxima of the whole width's hidden (what
    the maximum over the shards gives) and x / tp. Each is held to the int8
    bar of the full-width cases: at most twice the share of outputs by which
    the plain version moves when LayerNorm sums in float64."""
    from herro_tpu_torch.ops import fused

    bf = torch.bfloat16
    D = 128
    cases = {}
    for tp, d in SHARDS:
        full = d == 512
        H = 4 if full else 2
        h = H // tp
        w_qkv, b_qkv = (t["w_qkv"], t["b_qkv"]) if full else (t["w_qkv9"], t["b_qkv9"])
        wq_i8, sq = fused.quantize_weight(
            w_qkv.reshape(d, 3, H, D)[:, :, :h].reshape(d, 3 * h * D))
        tag = "" if full else f"d={d}, "
        cases[f"ln_qkv_rope_q[{tag}H={h}]"] = qkv_q_case(
            t["x"] if full else t["x9"], t["ln_s"] if full else t["ln_s9"],
            t["ln_b"] if full else t["ln_b9"], fused.k_major(wq_i8), sq,
            b_qkv.reshape(3, H, D)[:, :h].reshape(-1).contiguous(), h)
    for d, f, tp in FFN_Q_SHARDS:
        full = d == 512
        xs = t["x"] if full else t["x9"]
        s, b = (t["ln_s"], t["ln_b"]) if full else (t["ln_s9"], t["ln_b9"])
        if full:
            w1, b1, w2, b2 = (v.float() for v in (t["w1"], t["b1"], t["w2"], t["b2"]))
        else:
            r = lambda *shape, std: torch.randn(*shape, generator=g, device=xs.device) * std
            w1, b1, w2, b2 = r(d, f, std=d ** -0.5), r(f, std=0.25), r(f, d, std=f ** -0.5), \
                r(d, std=0.25)
        (q1, s1), (q2, s2) = fused.quantize_weight(w1), fused.quantize_weight(w2)
        hmax = fused._ffn_q_hidden(xs, s, b, q1, s1, b1).abs().amax(dim=-1).view(xs.shape[:-1])
        fl = f // tp
        head = (xs, s, b, fused.k_major(q1[:, :fl]), s1[:fl].contiguous(),
                b1[:fl].contiguous())
        tail = (fused.k_major(q2[:fl]), s2, b2 / tp, hmax, 1.0 / tp)
        tag = "" if full else f"d={d}, "
        cases.update(ffn_q_mode_cases(torch, f"{tag}f={fl}", head, tail, ln_rows_i8))
    return cases


def rowmax_ties(torch, fused, head: tuple, rowmax=None) -> dict:
    """K11's ``rowmax`` with the tied counts (the instance autograd takes)
    against the plain version's counts: they may differ only where the
    hidden does, in at most 1 row in 500 (2 at least), the bar of the
    ``gpu`` test on the maxima; its maxima equal the case's instance's bit
    for bit. ``rowmax``: the wrapper (the Hopper instance's by default).
    Raises past either; reports its ms."""
    rowmax = rowmax or fused._ln_ffn_q_rowmax_cuda
    (top, ties), (want_top, want_ties) = (rowmax(*head, ties=True),
                                          fused._ln_ffn_q_rowmax_plain(*head, ties=True))
    rows = ties.numel()
    out = dict(ties_differing_rows=int((ties != want_ties).sum()),
               maxima_differing_rows=int((top != want_top).sum()), rows=rows,
               max_ties=int(ties.max()),
               maxima_equal_without_ties=bool(torch.equal(top, rowmax(*head)[0])),
               ties_ms=time_ms(torch, lambda: rowmax(*head, ties=True), 20))
    if out["ties_differing_rows"] > max(2, rows // 500) or not out["maxima_equal_without_ties"]:
        raise RuntimeError(f"ln_ffn_q_rowmax's tied counts: {out}")
    return out


def ffn_q_mode_cases(torch, tag: str, head: tuple, tail: tuple, ln_rows_i8,
                     simt: bool = False) -> dict:
    """K11's ``rowmax`` mode on ``head`` (x, LayerNorm, W1's shard) and its
    ``rowscale`` mode on ``head + tail`` (W2's shard, s2, b2 / tp, the row
    maxima, 1 / tp). A row maximum is a bf16 value of h, exact where the
    plain version's is; a row whose LayerNorm rounds one int8 step apart
    moves it only where that crosses a bf16 step of its largest element, so
    few rows that a share of them is too noisy to hold against twice
    another. So ``rowmax`` is held to the int8 bar through the pass it feeds: shard
    0's ``rowscale`` on its maxima (``chain``: kernel then kernel, plain then
    plain, and both plain with LayerNorm's sums in float64), its own share
    and floor reported beside. ``simt``: the SIMT instance's modes, with the
    bound at the __dp4a rate beside the tensor cores' (``dp4a_bound``)."""
    from herro_tpu_torch.ops import fused

    name = "ln_ffn_q_simt" if simt else "ln_ffn_q"
    rowmax = fused._ln_ffn_q_rowmax_simt_cuda if simt else fused._ln_ffn_q_rowmax_cuda
    rowscale = fused._ln_ffn_q_rowscale_simt_cuda if simt else fused._ln_ffn_q_rowscale_cuda
    xs, s, b, w1q = head[:4]
    T, d, fl = xs.numel() // xs.shape[-1], xs.shape[-1], w1q.shape[1]

    def chained(x, s, b, w1, s1, b1, w2, s2, b2, res_scale):
        """The two plain passes of one shard, the second on the first's maxima."""
        hmax, _ = fused._ln_ffn_q_rowmax_plain(x, s, b, w1, s1, b1)
        return fused._ln_ffn_q_rowscale_plain(x, s, b, w1, s1, b1, w2, s2, b2, hmax,
                                              res_scale)

    library = lambda what: (
        f"torch._int_mm quant(LN(x))[T,d] @ W1 shard[d,f/tp] int8 -> int32, {what}",
        lambda y_i8: torch._int_mm(y_i8, w1q), lambda: ln_rows_i8(xs, s, b))
    vectors = (2 * d + 2 * fl) * 4
    work = {"rowmax": (T * d * xs.element_size() + d * fl + T * 4 + vectors, 2 * T * d * fl),
            "rowscale": (2 * T * d * xs.element_size() + 2 * d * fl + T * 4 + vectors + d * 8,
                         4 * T * d * fl)}

    def dp4a(mode):  # the SIMT instance's bound at the __dp4a rate, beside
        return dp4a_bound(*work[mode]) if simt else {}

    return {
        f"{name}_rowmax[{tag}]": dict(
            name=name, mode=f"{name}_rowmax", replaces="herro_tpu/ops/fused.py:420",
            kernel=lambda: rowmax(*head)[0],
            plain=lambda: fused._ln_ffn_q_rowmax_plain(*head)[0],
            floor=lambda: float64_layernorm_sums(
                fused, lambda *a: fused._ln_ffn_q_rowmax_plain(*a)[0], *head),
            extra=lambda: rowmax_ties(torch, fused, head, rowmax) | dp4a("rowmax"),
            library=library("the pass's product (partial: no LN, quantization, gelu, "
                            "row maxima)"),
            bound=bound(*work["rowmax"], PEAK_INT8),
            share_differing=True,
            chain=(lambda: rowscale(*head, *tail[:3], rowmax(*head)[0], tail[-1]),
                   lambda: chained(*head, *tail[:3], tail[-1]),
                   lambda: float64_layernorm_sums(fused, chained, *head, *tail[:3], tail[-1])),
        ),
        f"{name}_rowscale[{tag}]": dict(
            name=name, mode=f"{name}_rowscale", replaces="herro_tpu/ops/fused.py:420",
            kernel=lambda: rowscale(*head, *tail),
            plain=lambda: fused._ln_ffn_q_rowscale_plain(*head, *tail),
            floor=lambda: float64_layernorm_sums(fused, fused._ln_ffn_q_rowscale_plain,
                                                 *head, *tail),
            library=library("half the pass's operations (partial: no LN, quantization, "
                            "gelu, second product)"),
            extra=lambda: dp4a("rowscale"),
            bound=bound(*work["rowscale"], PEAK_INT8),
            residual=xs * tail[-1], share_differing=True,
        ),
    }


def d384_cases(torch, t: dict, qkv_case, g) -> dict:
    """K1-K4 at the d384x5L shape of tools/variant_step_time_torch.py (d 384,
    H 3 x D 128, d_ff 1280), B=32, L=9216, on the kernels phase's pileups and
    lengths with weights of that width drawn here, at the d 512 cases'
    scales; K2 on K1's q, k, v. The tolerances, bounds and library calls are
    those of the d 512 cases."""
    import numpy as np
    import torch.nn.functional as F

    from herro_tpu_torch.constants import N_ROWS, VOCAB_SIZE
    from herro_tpu_torch.ops import fused

    bf = torch.bfloat16
    dev = t["tokens"].device
    d, H, D, f, R, V, w = 384, 3, 128, 1280, N_ROWS, VOCAB_SIZE, 512

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    fan = R * (V + 1)
    w_embT, w_qT = randn(d, R * V, std=fan ** -0.5), randn(d, R, std=fan ** -0.5)
    wc = fused.col_proj_table(w_embT, w_qT)
    cb = randn(d, std=0.25, dtype=torch.float32)
    x = randn(B, L, d)
    s = 1.0 + randn(d, std=0.1, dtype=torch.float32)
    b = randn(d, std=0.1, dtype=torch.float32)
    w_qkv, b_qkv = randn(d, 3 * H * D, std=d ** -0.5), randn(3 * H * D, std=0.25)
    wo, bo = randn(H, D, d, std=(H * D) ** -0.5), randn(d, std=0.25)
    w1, b1 = randn(d, f, std=d ** -0.5), randn(f, std=0.25)
    w2, b2 = randn(f, d, std=f ** -0.5), randn(d, std=0.25)
    q, k, v = fused._ln_qkv_rope_cuda(x, s, b, w_qkv, b_qkv, H, kernel="ln_qkv_rope")
    toks, qs = t["tokens"], t["quals"]
    nnz = int((toks < V).sum()) + int((qs.to(bf) != 0).sum())
    idx = (toks.long() + torch.arange(R, device=dev)[None, :, None] * V).permute(0, 2, 1)
    idx = idx.reshape(-1, R)
    emb_table = w_embT.t().contiguous()
    lengths, lengths_np = t["lengths"], t["lengths_np"]
    k_spans = F.pad(k, (0, 0, w, w)).unfold(2, 64 + 2 * w, 64)
    q_blocks = q.view(B, H, L // 64, 64, D)
    n_rows = int(lengths_np.astype(np.int64).sum())
    return {
        "entry_embed[d=384]": dict(
            name="entry_embed", replaces="herro_tpu/ops/fused.py:89",
            kernel=lambda: fused._entry_embed_cuda(toks, qs, wc, cb, bf),
            plain=lambda: fused._entry_embed_plain(toks, qs, wc, cb, bf),
            library=("F.embedding_bag(mode=sum) of the token rows, no qual term",
                     lambda: F.embedding_bag(idx, emb_table, mode="sum")),
            bound=bound(toks.numel() * 5 + toks.numel() // R * d * 2 + wc.numel() * 2
                        + d * 4, 2 * d * nnz, PEAK_BF16),
        ),
        "ln_qkv_rope[d=384, H=3]": qkv_case(x, "ln_qkv_rope", s, b, w_qkv, b_qkv, H),
        "flash_outproj[d=384, H=3]": dict(
            name="flash_outproj", replaces="herro_tpu/ops/fused.py:993",
            kernel=lambda: fused._flash_outproj_cuda(q, k, v, x, wo, bo, lengths, w),
            plain=lambda: fused._flash_outproj_plain(q, k, v, x, wo, bo, lengths, w),
            library=("torch.matmul banded QK^T (64-row blocks x 1088-key spans) bf16, "
                     "the dominant product", lambda: torch.matmul(q_blocks, k_spans)),
            bound=bound(3 * q.numel() * 2 + 2 * x.numel() * 2 + wo.numel() * 2,
                        4 * H * D * t["pairs"] + 2 * n_rows * H * D * d, PEAK_BF16),
            rows=lengths_np, residual=x,
        ),
        "ln_ffn[d=384, f=1280]": ffn_case(torch, x, s, b, w1, b1, w2, b2),
    }


def shard_attention_case(torch, t: dict, xs, wo, bo, h: int, w: int) -> dict:
    """K2 at band ``w`` on the first ``h`` heads of the phase's q, k, v."""
    import numpy as np

    from herro_tpu_torch.ops import fused

    q, k, v = (t[n][:, :h].contiguous() for n in "qkv")
    lengths, lengths_np = t["lengths"], t["lengths_np"]
    d, D = xs.shape[-1], q.shape[-1]
    n_rows = int(lengths_np.astype(np.int64).sum())
    spans, blocks = t["k_spans"][:, :h], t["q_blocks"][:, :h]
    return dict(
        name="flash_outproj", replaces="herro_tpu/ops/fused.py:993",
        kernel=lambda: fused._flash_outproj_cuda(q, k, v, xs, wo, bo, lengths, w),
        plain=lambda: fused._flash_outproj_plain(q, k, v, xs, wo, bo, lengths, w),
        library=("torch.matmul banded QK^T (64-row blocks x 1088-key spans) bf16, "
                 "the dominant product", lambda: torch.matmul(blocks, spans)),
        bound=bound(3 * q.numel() * 2 + 2 * xs.numel() * 2 + wo.numel() * 2,
                    4 * h * D * t["pairs"] + 2 * n_rows * h * D * d, PEAK_BF16),
        rows=lengths_np, residual=xs,
    )


def ffn_case(torch, xs, s, b, w1, b1, w2, b2) -> dict:
    """K3 on these rows and weights."""
    from herro_tpu_torch.ops import fused

    d, f = xs.shape[-1], w1.shape[1]
    T = xs.numel() // d
    args = (xs, s, b, w1, b1, w2, b2)
    return dict(
        name="ln_ffn", replaces="herro_tpu/ops/fused.py:286",
        kernel=lambda: fused._ln_ffn_cuda(*args),
        plain=lambda: fused._ln_ffn_plain(*args),
        library=("torch.matmul LN(x)[T,d] @ W1[d,f] bf16, half the FLOPs",
                 lambda: torch.matmul(xs.view(T, d), w1)),
        bound=bound(2 * T * d * 2 + 2 * d * f * 2, 4 * T * d * f, PEAK_BF16),
        residual=xs,
    )


def phase_golden(torch, phase: str = "golden", int8: bool = False, min_agree=0.995):
    """The flagship checkpoint's forward on the golden batch against the JAX
    logits frozen there; returns the port's logits."""
    import dataclasses

    import numpy as np

    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.pipeline.batching import unpack_tokens_torch

    fx = np.load(GOLDEN)
    cfg, sd = load_model(CKPT)
    model = CorrectionModel(dataclasses.replace(cfg, int8=int8))
    model.load_state_dict(sd)
    model = model.cuda().eval()
    dev = torch.device("cuda")
    with torch.inference_mode():
        tok = unpack_tokens_torch(torch.from_numpy(fx["tokens_packed"]).to(dev), N_ROWS)
        quals = QUAL_SCALE * torch.from_numpy(fx["quals"]).to(dev).float() - QUAL_OFFSET
        info, logits = model(
            tok, quals, torch.from_numpy(fx["support_idx"]).to(dev),
            torch.from_numpy(fx["support_mask"]).to(dev),
        )
    info, logits = info.cpu().numpy(), logits.cpu().numpy()
    mask = fx["support_mask"]
    d_log = float(np.abs(logits - fx["logits"])[mask].max())
    d_info = float(np.abs(info - fx["info"])[mask].max())
    agree = float((logits.argmax(-1) == fx["logits"].argmax(-1))[mask].mean())
    finite = bool(np.isfinite(logits).all() and np.isfinite(info).all())
    emit(phase, run="golden", max_dlogit=d_log, max_dinfo=d_info, argmax_agreement=agree,
         n_supported=int(mask.sum()), finite=finite)
    if not finite or agree < min_agree:
        raise RuntimeError(
            f"{phase}: golden argmax agreement {agree} < {min_agree} or non-finite")
    return logits[mask]


R10DEEP_CKPT = os.path.join(ROOT, "resources", "model_r10_deep_sim")


def phase_golden_r10deep(torch, min_agree=0.995) -> dict:
    """``model_r10_deep_sim`` (d 256, 8 layers, H 2 x 128: the Hopper
    instances) in bf16 on the golden batch's inputs against herro_tpu's
    float32 logits frozen in ``tests/torch_data/golden_r10deep_f32.npz``: the
    argmax on at least ``min_agree`` of the supported columns, as
    ``phase_golden`` holds the flagship; the Hopper K4, K1, K2 and K3
    launched, n_layers times the block's."""
    import numpy as np

    want = np.load(os.path.join(F32_DATA, "golden_r10deep_f32.npz"))
    fx = np.load(GOLDEN)
    run = _golden_forward(torch, R10DEEP_CKPT, fx)
    cfg, mask = run["cfg"], fx["support_mask"]
    agree = float((run["logits"].argmax(-1) == want["logits"].argmax(-1))[mask].mean())
    finite = bool(np.isfinite(run["logits"]).all() and np.isfinite(run["info"]).all())
    want_launches = {"entry_embed": 1, "ln_qkv_rope": cfg.n_layers,
                     "flash_outproj": cfg.n_layers, "ln_ffn": cfg.n_layers}
    emit("golden", run="golden", model="model_r10_deep_sim", dtype=cfg.dtype,
         argmax_agreement=agree, n_supported=int(mask.sum()),
         max_dlogit=float(np.abs(run["logits"] - want["logits"])[mask].max()),
         max_dinfo=float(np.abs(run["info"] - want["info"])[mask].max()), finite=finite,
         launches=run["launches"], want_launches=want_launches)
    if not finite or agree < min_agree or run["launches"] != want_launches:
        raise RuntimeError(f"golden model_r10_deep_sim: argmax agreement {agree} < "
                           f"{min_agree}, finite {finite}, launches {run['launches']}")
    return run


def _kmer_validity(seq: bytes, truth_kmers: set, k: int = 15) -> float:
    n = len(seq) - k + 1
    if n <= 0:
        return 0.0
    return sum(seq[i : i + k] in truth_kmers for i in range(0, n, 7)) / len(range(0, n, 7))


# the kernels the flagship inference run launches; the others are driven by
# the eval, int8, rope_split and attention phases
E2E_KERNELS = ("entry_embed", "ln_qkv_rope", "flash_outproj", "ln_ffn", "count_decisions")


def _counted_run(torch, reads, grouped, runner, out: str) -> dict:
    """One ``run_correction`` at window 4096, batch 32, with the windows it
    finalized, its wall time and every kernel's launches counted from 0."""
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.pipeline.engine import StageTimers, run_correction

    n_windows = 0
    count_lock = threading.Lock()  # the engine finalizes on two threads
    finalize = runner.finalize

    def counting_finalize(inflight):
        nonlocal n_windows
        res = finalize(inflight)
        with count_lock:
            n_windows += len(res)
        return res

    runner.finalize = counting_finalize
    timers = StageTimers()
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    t0 = time.perf_counter()
    try:
        n = run_correction(reads, iter(grouped.items()), runner, out, 4096, 32,
                           timers=timers)
    finally:
        runner.finalize = finalize
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(
        reads_written=n, windows=n_windows, wall_s=wall, windows_per_s=n_windows / wall,
        batches=timers.n_batches, featgen_s=timers.featgen_s,
        windows_produced=timers.n_windows, launches=kernels.launch_counts.snapshot(),
    )


def _median_kmer_gain(ds, reads, fasta: str) -> float:
    """Quality: how many more error-free 15-mers the corrected reads carry
    than the raw reads (median over reads of the difference in shares)."""
    import numpy as np

    from herro_tpu_torch.training.simulate import true_sequence

    by_name = {r.name: r for r in ds.reads}
    gains = []
    name = None
    with open(fasta, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                name = line[1:].split()[0].split(b":")[0]
                continue
            seq = line.strip()
            sim = by_name[name]
            truth = true_sequence(ds, sim)
            kmers = {truth[i : i + 15] for i in range(len(truth) - 14)}
            raw = reads.seq(reads.name_to_id[name]).tobytes()
            gains.append(_kmer_validity(seq, kmers) - _kmer_validity(raw, kmers))
    return float(np.median(gains)) if gains else 0.0


def phase_e2e(torch, tmp: str) -> dict:
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.pipeline.infer import CorrectionRunner
    from herro_tpu_torch.training.simulate import paf_rows, simulate

    window = 4096
    t0 = time.perf_counter()
    ds = simulate(
        genome_len=150_000, n_reads=160, read_len=(3 * window, 8 * window),
        sub_rate=0.02, ins_rate=0.02, del_rate=0.02, het_rate=0.005, seed=777,
    )
    fastq = os.path.join(tmp, "reads.fastq")
    ds.write_fastq(fastq)
    reads = load_reads(fastq, min_length=window)
    rows = paf_rows(ds, min_overlap=window)
    grouped = parse_paf(rows, reads.name_to_id)
    setup_s = time.perf_counter() - t0

    cfg, params = load_model(CKPT)
    runner = CorrectionRunner(cfg, params, device="cuda")
    out = os.path.join(tmp, "corrected.fasta")
    res = _counted_run(torch, reads, grouped, runner, out)
    res["setup_s"] = setup_s
    res["kmer_validity_gain_median"] = median_gain = _median_kmer_gain(ds, reads, out)
    n, launches = res["reads_written"], res["launches"]
    emit("e2e", **res)
    missing = [k for k in E2E_KERNELS if launches[k] == 0]
    if n == 0 or missing or median_gain <= 0:
        raise RuntimeError(
            f"e2e: reads {n}, kernels never launched {missing}, median 15-mer "
            f"validity gain {median_gain}"
        )
    return dict(res, ds=ds, rows=rows, reads=reads, grouped=grouped, runner=runner,
                fastq=fastq, fasta=out)


def phase_trace(torch, tmp: str, e2e: dict, runner=None, **labels) -> None:
    """The e2e run again under torch.profiler (with ``runner``, else the e2e
    phase's): the device's busy share of the wall time and the device time
    by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from herro_tpu_torch.pipeline.engine import run_correction

    out = os.path.join(tmp, "traced.fasta")
    # the card's activity alone: the busy share and the time by kernel read
    # device events only, and the host's ops would repeat them (recording
    # them took most of the phase's time)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_correction(e2e["reads"], iter(e2e["grouped"].items()),
                       runner or e2e["runner"], out, 4096, 32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = {}
    for ev in prof.key_averages():  # device-side events only
        us = ev.self_device_time_total
        if str(ev.device_type).endswith("CUDA") and us > 0:
            dev[ev.key] = dev.get(ev.key, 0) + us
    busy_s = sum(dev.values()) / 1e6
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    emit("trace", **labels, wall_s=wall, device_s=busy_s,
         device_busy_share=busy_s / wall if busy_s else None,
         device_ms_by_name={k[:80]: v / 1e3 for k, v in top})


def phase_cli(torch, tmp: str, ds, rows) -> None:
    """The CLI with --read-alns over alignment batches of 24 targets."""
    if importlib.util.find_spec("zstandard") is None:
        emit("cli", skipped="zstandard is not installed")
        return
    from herro_tpu_torch import cli
    from herro_tpu_torch.overlaps.batches import BatchWriter

    targets = sorted({r.split(b"\t")[5] for r in rows})[:24]
    keep = set(targets)
    aln_dir = os.path.join(tmp, "alns")
    with BatchWriter(aln_dir, 0, targets) as bw:
        for r in rows:
            if r.split(b"\t")[5] in keep:
                bw.write(r if r.endswith(b"\n") else r + b"\n")
    out = os.path.join(tmp, "cli.fasta")
    t0 = time.perf_counter()
    cli.main(["inference", "--read-alns", aln_dir, "-m", CKPT, "-w", "4096",
              "-b", "32", os.path.join(tmp, "reads.fastq"), out])
    n = sum(1 for line in open(out, "rb") if line.startswith(b">"))
    emit("cli", records=n, wall_s=time.perf_counter() - t0)
    if n == 0:
        raise RuntimeError("cli: no corrected records")


# (tag, data replicas, tensor-parallel degree, int8) of the parallel phase; an
# int8 layout is held against the single device's int8 step
PARALLEL_LAYOUTS = (("dp2", 2, 1, False), ("tp2", 1, 2, False), ("tp4", 1, 4, False),
                    ("tp2_int8", 1, 2, True), ("tp4_int8", 1, 4, True))
TP_MIN_AGREE = 0.99  # the bar of tests/test_parallel.py for bf16 at tp=2
# the devices the layout phases (parallel, multihost, train_parallel) take
# here: one card, named as often as the widest layout has shards, so that one
# card runs every layout; tools/across_cards_torch.py hands the same phases
# distinct cards
SMOKE_MESH_DEVICES = 4


def one_card(torch, n: int = SMOKE_MESH_DEVICES) -> list:
    """``cuda:0`` n times: the device list of the layout phases in this run."""
    return [torch.device("cuda", 0)] * n


def block_kernels(int8: bool, tp: int) -> tuple:
    """The kernels a block of the correct step launches on each shard: K1,
    K2 and K3; under int8 K10, K2 and K11 (over a mesh row its two modes)."""
    if not int8:
        return ("ln_qkv_rope", "flash_outproj", "ln_ffn")
    return ("ln_qkv_rope_q", "flash_outproj",
            *(("ln_ffn_q_rowmax", "ln_ffn_q_rowscale") if tp > 1 else ("ln_ffn_q",)))


def want_by_card(devices: list, tp: int, int8: bool, n_layers: int, n_batches: int,
                 counting: bool = True) -> dict:
    """card index -> kernel -> launches of ``n_batches`` forwards over the
    mesh rows of ``devices`` (``tp`` shards each): every shard's K4 once and
    its block kernels n_layers times each on its own card, and with
    ``counting`` (the correct step's counting rule) K5 once each on each
    replica's first."""
    out, block = {}, block_kernels(int8, tp)
    for pos, d in enumerate(devices):
        mine = out.setdefault(d.index, {})
        k5 = ("count_decisions",) if counting and pos % tp == 0 else ()
        for k in ("entry_embed", *block, *k5):
            mine[k] = mine.get(k, 0) + (n_layers if k in block else 1) * n_batches
    return out


def _step_batch(seed: int = 4321, S: int = 1152, batch: int = B):
    """A batch at the main-path shape (``batch`` windows, B=32 by default, of
    L=9216) for the step times: pileups as the kernels phase draws them, S
    supported columns."""
    import numpy as np

    from herro_tpu_torch.constants import N_ROWS, TOKEN_PAD
    from herro_tpu_torch.pipeline.batching import Batch, pack_tokens

    rng = np.random.default_rng(seed)
    lengths = rng.integers(int(0.7 * L), L + 1, size=batch)
    n_alns = rng.integers(2, N_ROWS, size=batch).astype(np.int32)
    tok = rng.integers(0, 11, size=(batch, L, N_ROWS), dtype=np.uint8)
    tok[:, :, 0] = rng.integers(0, 5, size=(batch, L), dtype=np.uint8)
    for b in range(batch):
        tok[b, :, n_alns[b] + 1:] = TOKEN_PAD
        tok[b, lengths[b]:] = TOKEN_PAD
    sidx = np.sort(rng.integers(0, int(0.7 * L), size=(batch, S)), axis=1).astype(np.int32)
    return Batch(np.ascontiguousarray(pack_tokens(tok).transpose(0, 2, 1)),
                 rng.integers(33, 127, size=(batch, N_ROWS, L), dtype=np.uint8), sidx,
                 np.ones((batch, S), dtype=bool), n_alns, windows=[])


def _agreement(got, ref, smask) -> tuple[float, bool]:
    """(share of supported columns whose class agrees, decisions equal) of
    two packed step results, decisions‖classes [B, L+S]."""
    S = smask.shape[1]
    agree = float((got[:, -S:] == ref[:, -S:])[smask].mean()) if smask.any() else 1.0
    return agree, bool((got[:, :-S] == ref[:, :-S]).all())


def _layout_step_ms(torch, runner, batches, iters: int = 5) -> dict:
    """The layout's step on resident batches by the port's step timer
    (``pipeline/steptime.py``: every replica's step on the current streams
    in turn, its rows of each batch on its own device, the batches cycled,
    every output folded into one scalar on the first replica's device, which
    waits for every card's), and dispatch to fetched result (the copies both
    ways included) by the host clock."""
    import numpy as np

    from herro_tpu_torch.pipeline.steptime import time_step

    n = len(runner.replicas)

    def parts(batch):
        arrays = runner._inputs(batch)
        return [torch.from_numpy(np.split(a, n)[i]).to(r.device)
                for i, r in enumerate(runner.replicas) for a in arrays]

    k = len(runner._inputs(batches[0]))

    def steps(*flat):
        return [r.step(*flat[i * k:(i + 1) * k]) for i, r in enumerate(runner.replicas)]

    step_ms = time_step(steps, [parts(b) for b in batches], len(batches[0].n_alns),
                        iters=iters)["ms"]
    runner._fetch(runner.dispatch(batches[0]))
    t0 = time.perf_counter()
    for _ in range(iters):
        runner._fetch(runner.dispatch(batches[0]))
    return dict(step_ms=step_ms, round_trip_ms=(time.perf_counter() - t0) * 1e3 / iters)


def phase_parallel(torch, tmp: str, e2e: dict, devices: list) -> dict:
    """Data and tensor parallelism through ``CorrectionRunner(mesh=...)``, a
    layout of n devices over the first n of ``devices`` (this run:
    :func:`one_card`, ``cuda:0`` repeated): a 2 x 1 mesh must write the
    single-device run's FASTA records byte for byte; tp=2 and tp=4 on the
    golden batch and the e2e dataset must agree with the single-device step
    on at least ``TP_MIN_AGREE`` of the supported columns with equal
    decisions, and launch, a batch, K4 x tp, K1-K3 x n_layers x tp and K5
    once (a data replica each); int8 at tp=2 and tp=4 the same against the
    single device's int8 step, launching K4 x tp, K10, K2 and each of K11's
    two modes x n_layers x tp, K5 once, and no K1, K3 or whole K11; by
    card, each shard's launches on its own card (K5 on each replica's
    first), and each card's peak of allocated memory. Then the step's time
    at B=32, L=9216 under each layout beside the single device's (bf16 and
    int8). Returns the int8 layouts' launches."""
    import numpy as np

    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel import make_mesh_2d
    from herro_tpu_torch.pipeline.batching import Batch
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    cfg, params = load_model(CKPT)
    singles = {False: e2e["runner"]}
    dev = singles[False].device
    singles[True] = CorrectionRunner(cfg, params, int8=True, device=dev)
    cards = sorted({d.index for d in devices})
    fx = np.load(GOLDEN)
    golden = Batch(fx["tokens_packed"], fx["quals"], fx["support_idx"], fx["support_mask"],
                   fx["n_alns"], windows=[])
    golden_refs = {k: r._fetch(r.dispatch(golden))[1] for k, r in singles.items()}
    step_batches = [_step_batch(seed) for seed in (4321, 4322)]
    times = {"single": _layout_step_ms(torch, singles[False], step_batches),
             "single_int8": _layout_step_ms(torch, singles[True], step_batches)}
    want_records = _fasta_records(e2e["fasta"])
    failed, int8_launches = [], {}
    for tag, n_data, tp, int8 in PARALLEL_LAYOUTS:
        single = singles[int8]
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        runner = CorrectionRunner(cfg, params, device=dev, int8=int8,
                                  mesh=make_mesh_2d(n_data, tp, devices))
        g_agree, g_dec = _agreement(runner._fetch(runner.dispatch(golden))[1],
                                    golden_refs[int8], fx["support_mask"])
        recorded = []  # (batch, packed) of every batch the e2e run fetched
        fetch = runner._fetch

        def recording_fetch(inflight, fetch=fetch, recorded=recorded):
            info, packed = fetch(inflight)
            recorded.append((inflight.batch, packed))
            return info, packed

        runner._fetch = recording_fetch
        out = os.path.join(tmp, f"corrected_{tag}.fasta")
        res = _counted_run(torch, e2e["reads"], e2e["grouped"], runner, out)
        by_card = kernels.launch_counts.by_device()
        del runner._fetch
        n_sup = n_agree = 0
        dec_equal = True
        for batch, packed in recorded:
            ref = single._fetch(single.dispatch(batch))[1]
            agree, dec = _agreement(packed, ref, batch.support_mask)
            k = int(batch.support_mask.sum())
            n_sup, n_agree = n_sup + k, n_agree + agree * k
            dec_equal = dec_equal and dec
        e2e_agree = n_agree / max(n_sup, 1)
        n_b = len(recorded)
        launches = res["launches"]
        per_batch = {"entry_embed": n_data * tp, "count_decisions": n_data,
                     **{k: cfg.n_layers * n_data * tp for k in block_kernels(int8, tp)}}
        want_launches = {k: per_batch.get(k, 0) * n_b for k in launches}
        want_cards = want_by_card(devices[:n_data * tp], tp, int8, cfg.n_layers, n_b)
        if int8:
            for k, n in launches.items():
                int8_launches[k] = int8_launches.get(k, 0) + n
        records_equal = _fasta_records(out) == want_records
        times[tag] = _layout_step_ms(torch, runner, step_batches)
        emit("parallel", layout=tag, data=n_data, tp=tp, int8=int8,
             tp_fast_path=runner.tp_fast_path,
             golden_class_agreement=g_agree, golden_decisions_equal=g_dec,
             e2e_class_agreement=e2e_agree, e2e_supported_columns=n_sup,
             e2e_decisions_equal=dec_equal, batches=n_b, launches=launches,
             records_identical=_share_identical(out, e2e["fasta"]),
             records_equal=records_equal,
             file_bytes_identical=open(out, "rb").read() == open(e2e["fasta"], "rb").read(),
             reads_written=res["reads_written"], windows_per_s=res["windows_per_s"],
             launches_by_card=by_card,
             peak_gib_by_card={i: torch.cuda.max_memory_allocated(i) / 2 ** 30
                               for i in cards}, **times[tag])
        ok = (n_b > 0 and launches == want_launches and by_card == want_cards and g_dec
              and dec_equal and res["reads_written"] == e2e["reads_written"])
        if tp == 1:
            ok = ok and records_equal
        else:
            ok = ok and runner.tp_fast_path and min(g_agree, e2e_agree) >= TP_MIN_AGREE
        if not ok:
            failed.append(f"{tag} (launches {launches}, want {want_launches}; by card "
                          f"{by_card}, want {want_cards})")
        del runner, recorded
        torch.cuda.empty_cache()
    del singles[True]
    emit("parallel", run="step at B=32, L=9216", card=nvidia_smi(), **{
        f"{tag}_{k}": v for tag, t in times.items() for k, v in t.items()})
    if failed:
        raise RuntimeError("parallel: " + "; ".join(failed))
    return int8_launches


# A stand-in for zstandard that stores the batch files' bytes as they are, so
# that the phase runs where zstandard is not installed; --read-alns is where
# the reference partitions alignment batches by target (overlaps/batches.py)
ZSTD_STUB = """class _Writer:
    def __init__(self, fh):
        self._fh = fh

    def write(self, data):
        return self._fh.write(data)

    def close(self):
        self._fh.close()


class ZstdCompressor:
    def stream_writer(self, fh):
        return _Writer(fh)


class ZstdDecompressor:
    def stream_reader(self, fh):
        return fh
"""


def zstd_stand_in(where: str) -> str:
    """``where``, made to hold ``ZSTD_STUB`` as ``zstandard.py``: first on the
    path, alignment batches are written and read as their raw bytes."""
    os.makedirs(where, exist_ok=True)
    with open(os.path.join(where, "zstandard.py"), "w") as fh:
        fh.write(ZSTD_STUB)
    return where


def _multihost_cli(env, fastq, alns, out, extra):
    cmd = [sys.executable, "-m", "herro_tpu_torch.cli", "inference", "--read-alns", alns,
           "-m", CKPT, "-w", "4096", "-b", "32", *extra, fastq, out]
    return cmd, subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def phase_multihost(tmp: str, e2e: dict, devices: list) -> None:
    """Two ``inference`` CLI processes under one coordinator on 127.0.0.1,
    process i on ``--device devices[i]`` (this run: ``cuda:0`` both), over
    the e2e reads' alignments in two target-partitioned batches
    (tests/test_multihost.py's layout): their ``.shard000`` and
    ``.shard001`` must not overlap and together must equal the records that
    one process wrote from the same alignments (the e2e phase's FASTA)."""
    import socket

    stub = zstd_stand_in(os.path.join(tmp, "zstd_stub"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([stub, ROOT]))
    rows = [r if r.endswith(b"\n") else r + b"\n" for r in e2e["rows"]]
    targets = sorted({r.split(b"\t")[5] for r in rows})
    halves = (set(targets[: len(targets) // 2]), set(targets[len(targets) // 2:]))
    alns = os.path.join(tmp, "alns_mh")
    os.makedirs(alns)
    for k, ids in enumerate(halves):
        with open(os.path.join(alns, f"{k}.oec.zst"), "wb") as fh:
            fh.write(b"%d\n" % len(ids) + b"".join(i + b"\n" for i in sorted(ids)))
            fh.writelines(r for r in rows if r.split(b"\t")[5] in ids)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    sharded = os.path.join(tmp, "mh.fasta")
    t0 = time.perf_counter()
    procs = [_multihost_cli(env, e2e["fastq"], alns, sharded,
                            ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                             "--process-id", str(i), "--device", str(devices[i])])
             for i in range(2)]
    try:
        errs = [proc.communicate(timeout=600)[1] for _, proc in procs]
    finally:
        for _, proc in procs:
            proc.kill()
    shards_s = time.perf_counter() - t0
    for (cmd, proc), err in zip(procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"multihost: {' '.join(cmd)} failed:\n{err[-4000:]}")
    shards = [_fasta_records(f"{sharded}.shard{i:03d}") for i in range(2)]
    names = [{r.split(b"\n")[0] for r in shard} for shard in shards]
    overlap = len(names[0] & names[1])
    want = _fasta_records(e2e["fasta"])
    emit("multihost", processes=2, devices=[str(d) for d in devices[:2]],
         two_processes_s=shards_s,
         records=[len(x) for x in shards], single_records=len(want), overlap=overlap,
         combined_equal=sorted(shards[0] + shards[1]) == want,
         summaries=[SUMMARY_RE.search(e).group(0) if SUMMARY_RE.search(e) else None
                    for e in errs])
    if (overlap or not all(shards) or sorted(shards[0] + shards[1]) != want
            or os.path.exists(sharded)):
        raise RuntimeError(
            f"multihost: shards of {[len(x) for x in shards]} records overlap on {overlap} "
            f"or differ from the single process's {len(want)}"
        )


EVAL_ARGS = ["--with-baseline", "-w", "4096", "-b", "32", "--sub-rate", "0.02",
             "--indel-rate", "0.04", "--het-rate", "0.005", "--seed", "777"]
DEMO_SIZE = ["--genome-len", "150000", "--n-reads", "160"]
SMALL_SIZE = ["--genome-len", "60000", "--n-reads", "60"]
ATTENTION_KERNELS = ("flash_outproj", "flash_outproj_full", "flash_outproj_band")
# simulate's arguments -> the dataset ("ds"), its PAF rows by paf_rows's
# arguments ("paf"), its reads' feature tensors by (read name, window)
# ("features") and the truth scores of the FASTAs scored on it by their
# bytes' sha256 ("scores"), shared by the eval runs of one seed and size
_SIMULATIONS: dict = {}


@contextlib.contextmanager
def _one_simulation():
    """``eval`` runs of one seed and size on one simulation: the flagship
    under its three masks and r9 (60 reads), the tiny checkpoints, and
    ``--int8`` beside bf16 at the demo size. The first run of a size
    simulates and builds each read's feature tensors on the host; later
    runs take the same dataset and tensors (both are functions of the seed
    and size alone) and run only their own model on the card, so every
    run's launches and corrected identity are what they are on its own,
    and its wall time holds no simulation and no featgen. Inside the block
    ``evaluate``'s simulate, its ``paf_rows`` (the simulated overlaps, a
    function of the dataset alone) and the engine's serial featgen
    (``extract_read_tensors``, which ``eval`` takes: one featgen thread, no
    worker process) are memoized; each run gets a list of its own, and the
    windows are only read. So is ``evaluate``'s truth scoring
    (``score_fragments``) of a FASTA whose bytes an earlier run of the
    simulation scored: ``--with-baseline``'s counting decode is a function of
    the features alone, the same bytes at every model and mask, and its
    scores are the first run's (a model's own output is scored anew unless
    it is those bytes too). Yields the run's counts: ``reused`` (the dataset
    came from an earlier run), ``featgen_calls``, ``featgen_reused``,
    ``scores_reused`` and ``paf_reused``; raises after the block when the
    engine read no memoized featgen."""
    from herro_tpu_torch.features import extract
    from herro_tpu_torch.training import eval as evaluation

    simulate, featgen = evaluation.simulate, extract.extract_read_tensors
    score, rows_of = evaluation.score_fragments, evaluation.paf_rows
    current: dict = {}
    stats = dict(reused=False, featgen_calls=0, featgen_reused=0, scores_reused=0,
                 paf_reused=False)

    def shared_simulate(**kw):
        key = repr(sorted(kw.items()))
        stats["reused"] = key in _SIMULATIONS
        if key not in _SIMULATIONS:
            _SIMULATIONS[key] = dict(ds=simulate(**kw), paf={}, features={}, scores={})
        current.update(_SIMULATIONS[key])
        return current["ds"]

    def shared_paf_rows(ds, **kw):  # evaluate's ds: shared_simulate's
        key = repr(sorted(kw.items()))
        stats["paf_reused"] = key in current["paf"]
        if key not in current["paf"]:
            current["paf"][key] = rows_of(ds, **kw)
        return list(current["paf"][key])

    def shared_score(ds, reads, fasta_path, acc):  # evaluate's acc: a fresh one
        with open(fasta_path, "rb") as fh:
            key = hashlib.sha256(fh.read()).hexdigest()
        scored = current["scores"]
        if key in scored:
            stats["scores_reused"] += 1
            vars(acc).update(copy.deepcopy(vars(scored[key])))
        else:
            score(ds, reads, fasta_path, acc)
            scored[key] = copy.deepcopy(acc)

    def shared_featgen(rid, reads, alns, window_size):
        key = (reads.ids[rid], window_size)
        features = current["features"]
        stats["featgen_calls"] += 1
        stats["featgen_reused"] += key in features
        if key not in features:
            features[key] = list(featgen(rid, reads, alns, window_size))
        return list(features[key])

    evaluation.simulate, extract.extract_read_tensors = shared_simulate, shared_featgen
    evaluation.score_fragments, evaluation.paf_rows = shared_score, shared_paf_rows
    try:
        yield stats
    finally:
        evaluation.simulate, extract.extract_read_tensors = simulate, featgen
        evaluation.score_fragments, evaluation.paf_rows = score, rows_of
    if not stats["featgen_calls"]:
        raise RuntimeError("eval read no memoized featgen: the engine no longer takes "
                           "extract.extract_read_tensors at call time")


def phase_eval(torch, tmp: str) -> dict:
    """The ``eval`` subcommand for the flagship weights under three attention
    masks (the band the checkpoint ships with at the demo size, the other two
    on 60 reads to keep the run short), and for the r9 checkpoint on 60 reads;
    the 60-read runs on one simulation (``_one_simulation``). Returns each
    run's result document with its launches."""
    with open(os.path.join(CKPT, "config.json")) as fh:
        base_cfg = json.load(fh)
    runs = []
    for tag, window in (("w512", 512), ("full", None), ("w384", 384)):
        ckpt = os.path.join(tmp, f"ckpt_{tag}")
        os.makedirs(ckpt)
        shutil.copy(os.path.join(CKPT, "params.msgpack"), ckpt)
        with open(os.path.join(ckpt, "config.json"), "w") as fh:
            json.dump(dict(base_cfg, local_window=window), fh)
        runs.append((f"model_r10_sim[local_window={window}]", ckpt,
                     DEMO_SIZE if window == 512 else SMALL_SIZE))
    runs.append(R9_EVAL)

    by_run = {}
    for label, ckpt, size in runs:
        by_run[label] = _run_eval(torch, "eval", label, ckpt, size)
        if label in EVAL_IDENTITY:
            got, want = by_run[label]["corrected_identity"], EVAL_IDENTITY[label]
            emit("eval", model=label, corrected_identity=got, reference_identity=want,
                 gap=got - want)
            if abs(got - want) > 1e-4:
                raise RuntimeError(f"eval {label}: corrected identity {got} is more than "
                                   f"1e-4 from {want}")
    return by_run


# The corrected identity of the flagship eval runs under each attention mask
# as the mma.sync attention kernels gave it on an H100 80GB HBM3 (this
# script's eval phase); a redesigned kernel may move it by rounding, not by
# more than 1e-4.
EVAL_IDENTITY = {
    "model_r10_sim[local_window=512]": 0.9979452709128583,
    "model_r10_sim[local_window=None]": 0.9931004191383141,
    "model_r10_sim[local_window=384]": 0.9931058617997821,
}


# the kernels of a transformer block: table-fed bf16, or int8
BLOCK_KERNELS = {False: ("ln_qkv_rope", "ln_ffn"), True: ("ln_qkv_rope_q", "ln_ffn_q")}
R9_EVAL = ("model_r9_sim", os.path.join(ROOT, "resources", "model_r9_sim"), SMALL_SIZE)


def _check_block_launches(what: str, launches: dict, n_layers: int, attention: str,
                          int8: bool) -> None:
    """Every batch ran ``n_layers`` of its own qkv, attention and FFN kernel
    and none of the other route's."""
    want = n_layers * launches["entry_embed"]
    on = (*BLOCK_KERNELS[int8], attention)
    off = (*BLOCK_KERNELS[not int8], *(k for k in ATTENTION_KERNELS if k != attention))
    if want == 0 or any(launches[k] != want for k in on) or any(launches[k] for k in off):
        raise RuntimeError(
            f"{what}: expected {want} launches of each of {on} and none of {off}, "
            f"got {launches}"
        )


def _run_eval(torch, phase: str, label: str, ckpt: str, size, int8: bool = False) -> dict:
    """One ``eval`` through the CLI; checks its launches and that it corrects.
    Returns the result document with the run's launches."""
    from herro_tpu_torch import cli
    from herro_tpu_torch.models.model import ModelConfig
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.ops.fused import flash_kernel_name

    with open(os.path.join(ckpt, "config.json")) as fh:
        cfg = ModelConfig(**json.load(fh))
    expected = flash_kernel_name(cfg.local_window)
    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), _one_simulation() as shared:
        cli.main(["eval", ckpt, *EVAL_ARGS, *size, *(["--int8"] if int8 else [])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts.snapshot()
    res = json.loads(buf.getvalue())
    base = res["counting_baseline"]
    emit(phase, model=label, int8=int8, attention_kernel=expected, wall_s=wall,
         shared_simulation=shared,
         n_reads=res["n_reads"], raw_identity=res["raw_identity"],
         corrected_identity=res["corrected_identity"], raw_q=res["raw_q"],
         corrected_q=res["corrected_q"], corrected_infix_q=res["corrected_infix_q"],
         counting_infix_q=base["corrected_infix_q"],
         model_gain_db=res["model_gain_db"], launches=launches)
    _check_block_launches(f"{phase} {label}", launches, cfg.n_layers, expected, int8)
    if res["n_reads"] == 0 or not res["corrected_identity"] > res["raw_identity"]:
        raise RuntimeError(
            f"{phase} {label}: corrected identity {res['corrected_identity']} is not "
            f"above raw identity {res['raw_identity']}"
        )
    return dict(res, launches=launches)


def _share_identical(fasta: str, other: str) -> float:
    """The share of ``fasta``'s records that ``other`` holds byte for byte."""
    mine, theirs = _fasta_records(fasta), set(_fasta_records(other))
    return sum(r in theirs for r in mine) / max(len(mine), 1)


def phase_int8(torch, tmp: str, e2e: dict, evals: dict, bf16_logits) -> dict:
    """int8 through the normal entry points: the golden forward, the e2e run
    with ``CorrectionRunner(int8=True)``, ``eval --int8``. Returns the e2e
    run's launches."""
    import numpy as np

    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    # the reference's own bar for the int8 forward (tests/test_model.py)
    logits = phase_golden(torch, "int8", int8=True, min_agree=0.95)
    emit("int8", run="golden vs the bf16 forward",
         max_dlogit=float(np.abs(logits - bf16_logits).max()),
         argmax_agreement=float((logits.argmax(-1) == bf16_logits.argmax(-1)).mean()))

    cfg, params = load_model(CKPT)
    runner = CorrectionRunner(cfg, params, int8=True, device="cuda")
    out = os.path.join(tmp, "corrected_int8.fasta")
    res = _counted_run(torch, e2e["reads"], e2e["grouped"], runner, out)
    gain = _median_kmer_gain(e2e["ds"], e2e["reads"], out)
    emit("int8", run="e2e", **res, kmer_validity_gain_median=gain,
         bf16_windows_per_s=e2e["windows_per_s"],
         bf16_kmer_validity_gain_median=e2e["kmer_validity_gain_median"],
         records_identical_to_bf16=_share_identical(out, e2e["fasta"]))
    _check_block_launches("int8 e2e", res["launches"], cfg.n_layers, "flash_outproj", True)
    if res["reads_written"] != e2e["reads_written"] or gain <= 0:
        raise RuntimeError(
            f"int8 e2e: {res['reads_written']} reads, median 15-mer validity gain {gain}"
        )
    phase_trace(torch, tmp, e2e, runner, run="int8 e2e")

    label = "model_r10_sim[local_window=512]"
    ev = _run_eval(torch, "int8", label, os.path.join(tmp, "ckpt_w512"), DEMO_SIZE,
                   int8=True)
    emit("int8", run="eval vs bf16", corrected_identity=ev["corrected_identity"],
         bf16_corrected_identity=evals[label]["corrected_identity"],
         model_gain_db=ev["model_gain_db"], bf16_model_gain_db=evals[label]["model_gain_db"])
    r9 = _run_eval(torch, "int8", *R9_EVAL, int8=True)
    emit("int8", run="eval vs bf16", model=R9_EVAL[0],
         corrected_identity=r9["corrected_identity"],
         bf16_corrected_identity=evals[R9_EVAL[0]]["corrected_identity"])
    for name, got in ((label, ev), (R9_EVAL[0], r9)):
        want = EVAL_IDENTITY_INT8[name]
        if abs(got["corrected_identity"] - want) > 1e-4:
            raise RuntimeError(f"int8 eval {name}: corrected identity "
                               f"{got['corrected_identity']} is more than 1e-4 from {want}")
    return res["launches"]


# The corrected identity of ``eval --int8`` as the int8 kernels before K10's
# Hopper redesign gave it on an H100 80GB HBM3 (this script's int8 phase); a
# redesigned kernel may move it by rounding, not by more than 1e-4.
EVAL_IDENTITY_INT8 = {
    "model_r10_sim[local_window=512]": 0.9979452901983017,
    "model_r9_sim": 0.9930920819443652,
}


def phase_rope_split(torch, tmp: str, e2e: dict) -> dict:
    """The golden and the e2e run with ``HERRO_TPU_ROPE=split``: the op reads
    the variable at every call, so it is set around these runs and restored.
    Returns the e2e run's launches."""
    before = os.environ.get("HERRO_TPU_ROPE")
    os.environ["HERRO_TPU_ROPE"] = "split"
    try:
        phase_golden(torch, "rope_split", min_agree=1.0)
        out = os.path.join(tmp, "corrected_split.fasta")
        res = _counted_run(torch, e2e["reads"], e2e["grouped"], e2e["runner"], out)
    finally:
        if before is None:
            del os.environ["HERRO_TPU_ROPE"]
        else:
            os.environ["HERRO_TPU_ROPE"] = before
    launches = res["launches"]
    emit("rope_split", run="e2e", **res,
         records_identical_to_table_route=_share_identical(out, e2e["fasta"]))
    want = e2e["runner"].cfg.n_layers * launches["entry_embed"]
    if (want == 0 or launches["ln_qkv_rope_split"] != want or launches["ln_qkv_rope"]
            or res["reads_written"] != e2e["reads_written"]):
        raise RuntimeError(
            f"rope_split: expected {want} launches of ln_qkv_rope_split and none of "
            f"ln_qkv_rope, got {launches}; {res['reads_written']} reads"
        )
    return launches


def phase_attention(torch) -> dict:
    """``attention(impl="auto")`` on CUDA tensors at B=32, L=9216 must take the
    flash kernel; at a small size its gradient (kernel forward, chunked
    recompute backward) against autograd through ``naive_attention``. Returns
    the launches of the L=9216 call."""
    from herro_tpu_torch.ops import attention as attn
    from herro_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    bf = torch.bfloat16

    def qkv(b, h, l):
        return [torch.randn(b, h, l, 128, generator=g, device=dev).to(bf) for _ in range(3)]

    q, k, v = qkv(B, 4, L)
    lengths = torch.randint(int(0.7 * L), L + 1, (B,), generator=g, device=dev).int()
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    t0 = time.perf_counter()
    out = attn.attention(q, k, v, lengths, 512, impl="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts.snapshot()
    finite = bool(torch.isfinite(out.float()).all())
    # one window against the plain version (the kernels phase held all of them)
    ref = attn._flash_attention_plain(q[:1], k[:1], v[:1], lengths[:1], 512)
    n = int(lengths[0])
    err = float((out[:1, :, :n].float() - ref[:, :, :n].float()).abs().max())
    tol = float(ref[:, :, :n].float().abs().max()) * 2.0 ** -6
    del q, k, v, out, ref

    # gradient of sum(out^2) over the valid rows, bf16 inputs: the two sides
    # may differ by 4 bf16 ulps of the largest gradient
    ls = torch.tensor([256, 200], dtype=torch.int32, device=dev)
    row_ok = (torch.arange(256, device=dev)[None, :] < ls[:, None])[:, None, :, None]
    base = qkv(2, 2, 256)
    grads = {}
    for impl in ("flash", "naive"):
        leaves = [t.clone().requires_grad_(True) for t in base]
        o = attn.attention(*leaves, ls, 40, impl=impl)
        (torch.where(row_ok, o.float(), torch.zeros((), device=dev)) ** 2).sum().backward()
        grads[impl] = [t.grad.float() for t in leaves]
    g_err = max(float((a - b).abs().max()) for a, b in zip(grads["flash"], grads["naive"]))
    g_tol = max(float(b.abs().max()) for b in grads["naive"]) * 2.0 ** -6
    emit("attention", shape=[B, 4, L, 128], local_window=512, impl="auto", wall_s=wall,
         launches={k_: c for k_, c in launches.items() if c}, finite=finite,
         max_abs_err=err, tol=tol, grad_max_abs_err=g_err, grad_tol=g_tol)
    if (launches["flash_attention"] != 1 or sum(launches.values()) != 1 or not finite
            or err > tol or g_err > g_tol):
        raise RuntimeError(
            f"attention: launches {launches}, finite {finite}, error {err} vs {tol}, "
            f"gradient error {g_err} vs {g_tol}"
        )
    return launches


def _grad_cases(torch):
    """(differentiable inputs, the op, its plain version, its launches) of
    the three differentiable ops and the two int8 ops at the R10 widths, B 2,
    L 1024 (the int8 weights quantized as the model quantizes them, no
    gradient; their scales and every float input take one)."""
    from herro_tpu_torch.ops import fused

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    bf, f32 = torch.bfloat16, torch.float32
    Bg, Lg, d, H, D, F = 2, 1024, 512, 4, 128, 1024

    def r(*shape, scale=1.0, dt=bf):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    bases = torch.randint(0, 13, (Bg, 31, Lg), generator=g, device=dev).to(torch.uint8)
    lengths = torch.tensor([Lg, 700], dtype=torch.int32, device=dev)

    def embed(fn):
        return lambda p: fn(bases, p["quals"], fused.col_proj_table(p["w_embT"], p["w_qT"]),
                            p["cb"], bf)

    x = r(Bg, Lg, d)
    w_qkv, w1, w2 = r(d, 3 * H * D, scale=d ** -0.5), r(d, F, scale=d ** -0.5, dt=f32), \
        r(F, d, scale=F ** -0.5, dt=f32)
    (wq_i8, sq), (w1_i8, s1), (w2_i8, s2) = (fused.quantize_weight(w) for w in (w_qkv, w1, w2))
    wq_i8, w1_i8, w2_i8 = (fused.k_major(w) for w in (wq_i8, w1_i8, w2_i8))
    return {
        "entry_embed": (
            dict(quals=torch.rand(Bg, 31, Lg, generator=g, device=dev) * 2 - 1,
                 w_embT=r(d, 31 * 12, scale=0.05), w_qT=r(d, 31, scale=0.05),
                 cb=r(d, scale=0.1, dt=f32)),
            embed(fused.entry_embed), embed(fused._entry_embed_plain), {"entry_embed": 1}),
        "ln_ffn": (
            dict(x=x, scale=1 + r(d, scale=0.1, dt=f32), bias=r(d, scale=0.1, dt=f32),
                 w1=r(d, F, scale=d ** -0.5), b1=r(F, scale=0.1),
                 w2=r(F, d, scale=F ** -0.5), b2=r(d, scale=0.1)),
            lambda p: fused.ln_ffn(*p.values()), lambda p: fused._ln_ffn_plain(*p.values()),
            {"ln_ffn": 1}),
        "attention_block": (
            dict(x=x, ln_s=1 + r(d, scale=0.1, dt=f32), ln_b=r(d, scale=0.1, dt=f32),
                 w_qkv=r(d, 3 * H * D, scale=d ** -0.5), b_qkv=r(3 * H * D, scale=0.1),
                 wo=r(H, D, d, scale=(H * D) ** -0.5), bo=r(d, scale=0.1)),
            lambda p: fused.attention_block(*p.values(), lengths, H, 512),
            lambda p: fused._attention_block_plain(*p.values(), lengths, H, 512),
            {"ln_qkv_rope": 1, "flash_outproj": 1}),
        "attention_block_q": (
            dict(x=x, ln_s=1 + r(d, scale=0.1, dt=f32), ln_b=r(d, scale=0.1, dt=f32), s_col=sq,
                 b_qkv=r(3 * H * D, scale=0.1), wo=r(H, D, d, scale=(H * D) ** -0.5),
                 bo=r(d, scale=0.1)),
            lambda p: fused.attention_block_q(p["x"], p["ln_s"], p["ln_b"], wq_i8, p["s_col"],
                                              p["b_qkv"], p["wo"], p["bo"], lengths, H, 512),
            lambda p: fused._attention_shard_q_plain(p["x"], p["x"], p["ln_s"], p["ln_b"],
                                                     wq_i8, p["s_col"], p["b_qkv"], p["wo"],
                                                     p["bo"], lengths, H, 512),
            {"ln_qkv_rope_q": 1, "flash_outproj": 1}),
        "ln_ffn_q": (
            dict(x=x, scale=1 + r(d, scale=0.1, dt=f32), bias=r(d, scale=0.1, dt=f32), s1=s1,
                 b1=r(F, scale=0.1, dt=f32), s2=s2, b2=r(d, scale=0.1, dt=f32)),
            lambda p: fused.ln_ffn_q(p["x"], p["scale"], p["bias"], w1_i8, p["s1"], p["b1"],
                                     w2_i8, p["s2"], p["b2"]),
            lambda p: fused._ln_ffn_q_plain(p["x"], p["scale"], p["bias"], w1_i8, p["s1"],
                                            p["b1"], w2_i8, p["s2"], p["b2"]),
            {"ln_ffn_q": 1}),
    }


def phase_grad(torch) -> None:
    """Each differentiable op's autograd Function on the card, int8 ones
    included: the forward equals the op's direct output bit for bit and
    launches each of its kernels once; every gradient equals autograd's
    through the plain version on the same inputs exactly (the Function's
    backward is the plain version), finite and nonzero."""
    from herro_tpu_torch.ops import cuda as kernels

    report, failed = {}, []
    for op, (inputs, fn, plain, want_launches) in _grad_cases(torch).items():
        leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
        with torch.no_grad():
            direct = fn(leaves)
        torch.cuda.synchronize()
        kernels.launch_counts.reset()
        out = fn(leaves)
        torch.cuda.synchronize()
        launched = {k: n for k, n in kernels.launch_counts.snapshot().items() if n}
        cot = torch.randn(out.shape, device=out.device).to(out.dtype)
        grads = torch.autograd.grad(out, list(leaves.values()), cot)
        ref_leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
        ref = torch.autograd.grad(plain(ref_leaves), list(ref_leaves.values()), cot)
        errs, ok = {}, torch.equal(out.detach(), direct) and launched == want_launches
        for name, a, b in zip(inputs, grads, ref):
            err = float((a.float() - b.float()).abs().max())
            good = bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0 and err == 0
            errs[name] = dict(max_abs_err=err, finite_nonzero=good)
            ok = ok and good
        report[op] = dict(forward_bit_equal=torch.equal(out.detach(), direct),
                          launches=launched, grads=errs)
        if not ok:
            failed.append(op)
    emit("grad", shape=[2, 1024, 512], ops=report)
    if failed:
        raise RuntimeError(f"grad: {failed} failed: {report}")


# the kernels of a training step's forward: K4 once, K1-K3 in every block
TRAIN_KERNELS = ("entry_embed", "ln_qkv_rope", "flash_outproj", "ln_ffn")
TRAIN_ARGS = ["--config", "r10", "--batch-size", "32", "--steps", "8", "-w", "4096",
              "--genome-len", "100000", "--n-reads", "100", "--seed", "777"]


def _want_step_launches(cfg) -> dict:
    """One train step's launches: K4 once; K1, K2 and K3 n_layers times in the
    forward and, under remat, as often again when the backward recomputes
    each block."""
    per_block = cfg.n_layers * (2 if cfg.remat else 1)
    return {"entry_embed": 1, "ln_qkv_rope": per_block, "flash_outproj": per_block,
            "ln_ffn": per_block}


@contextlib.contextmanager
def _timed_steps(torch, steps: list):
    """Record each ``Trainer.train_step`` into ``steps``: its bucket, CUDA
    events at its start, between the forward and the backward (at the call
    of ``gradients``; one replica's step calls it once), and at its end, its
    peak of allocated memory (with what was allocated before it: the model,
    the optimiser state, and what earlier phases still hold) and its
    launches."""
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.training import train as train_mod

    step_fn, grad_fn = train_mod.Trainer.train_step, train_mod.gradients

    def gradients(*args, **kwargs):  # the backward of a replica's loss
        steps[-1]["events"][1].record()
        return grad_fn(*args, **kwargs)

    def train_step(self, batch):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        rec = dict(L=int(batch.tokens.shape[2]), S=int(batch.labels.shape[1]),
                   events=events)
        steps.append(rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["start_bytes"] = torch.cuda.memory_allocated()
        before = kernels.launch_counts.snapshot()
        events[0].record()
        out = step_fn(self, batch)
        events[2].record()
        torch.cuda.synchronize()
        after = kernels.launch_counts.snapshot()
        rec.update(metrics=out, peak_bytes=torch.cuda.max_memory_allocated(),
                   launches={k: after[k] - before[k] for k in after if after[k] != before[k]})
        return out

    train_mod.Trainer.train_step, train_mod.gradients = train_step, gradients
    try:
        yield
    finally:
        train_mod.Trainer.train_step, train_mod.gradients = step_fn, grad_fn


def _step_times(steps: list) -> list:
    out = []
    for i, rec in enumerate(steps):
        e0, e1, e2 = rec["events"]
        out.append(dict(step=i + 1, L=rec["L"], S=rec["S"], ms=e0.elapsed_time(e2),
                        forward_ms=e0.elapsed_time(e1), backward_update_ms=e1.elapsed_time(e2),
                        peak_gib=rec["peak_bytes"] / 2 ** 30,
                        held_before_gib=rec["start_bytes"] / 2 ** 30, launches=rec["launches"],
                        ce=rec["metrics"]["ce"]))
    return out


def _profile_step(torch, trainer, batch) -> dict:
    """One train step under torch.profiler: its device time, and that of the
    operators and the kernels that took the most of it (an operator's own
    kernels; the port's kernels appear under their own names only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_op, by_kernel = {}, {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0:
            into = by_kernel if str(ev.device_type).endswith("CUDA") else by_op
            into[ev.key] = into.get(ev.key, 0) + us
    top = lambda d, n: {k[:60]: v / 1e3 for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]}
    return dict(L=int(batch.tokens.shape[2]), wall_ms=wall * 1e3,
                device_ms=sum(by_kernel.values()) / 1e3,
                device_ms_by_operator=top(by_op, 15), device_ms_by_kernel=top(by_kernel, 10))


def phase_train(torch, tmp: str) -> dict:
    """``train --config r10`` through the CLI, then a seeded R10 trainer in
    process, then the same trainer under int8 at L=9216. Returns the CLI
    run's launches."""
    import pickle

    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_model, load_or_init
    from herro_tpu_torch.models.model import R10_CONFIG
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.training.data import TRAIN_BUCKETS, collate_train
    from herro_tpu_torch.training.train import (TrainState, Trainer, loss_fn,
                                                make_optimizer, make_train_step)

    want = _want_step_launches(R10_CONFIG)
    cache = os.path.join(tmp, "train_windows.pkl")
    out = os.path.join(tmp, "trained_r10")
    steps: list = []
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    t0 = time.perf_counter()
    with _timed_steps(torch, steps):
        cli.main(["train", *TRAIN_ARGS, "--data-cache", cache, out])
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts.snapshot()
    per_step = _step_times(steps)
    timed = per_step[2:]  # from step 3 on
    by_bucket = {}
    for st in timed:
        by_bucket.setdefault(st["L"], []).append(st)
    buckets = {L: dict(steps=len(v), ms=sum(s["ms"] for s in v) / len(v),
                       forward_ms=sum(s["forward_ms"] for s in v) / len(v),
                       backward_update_ms=sum(s["backward_update_ms"] for s in v) / len(v),
                       peak_gib=max(s["peak_gib"] for s in v))
               for L, v in sorted(by_bucket.items())}
    emit("train", run="cli", wall_s=wall, steps=len(steps), buckets=buckets,
         per_step=per_step, want_step_launches=want, launches=launches)
    bad = [st["step"] for st in per_step if st["launches"] != want]
    cfg_out, _ = load_model(out)
    if len(steps) < 6 or bad or cfg_out != R10_CONFIG:
        raise RuntimeError(f"train cli: {len(steps)} steps, steps {bad} launched other "
                           f"than {want}, saved config {cfg_out}")

    # in process: the hazard (every parameter trains), every bucket, learning
    with open(cache, "rb") as fh:
        windows = pickle.load(fh)
    cfg, params = load_or_init("r10")
    trainer = Trainer(cfg, params, lr=1e-3, total_steps=40, device="cuda")
    fixed = collate_train(windows[:32], *TRAIN_BUCKETS[0])
    loss, _ = loss_fn(trainer.model, *trainer.tensors(fixed), 0.1, 0.0)
    grads = torch.autograd.grad(loss, list(trainer.state.params.values()))
    bad_grads = [name for name, g in zip(trainer.state.params, grads)
                 if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    del loss, grads
    sweep: list = []
    with _timed_steps(torch, sweep):
        for L, S in TRAIN_BUCKETS:  # windows padded out to each bucket
            batch = collate_train(windows[:32], L, S)
            for _ in range(3):
                trainer.train_step(batch)
    sweep_times = _step_times(sweep)
    ladder = {st["L"]: st for st in sweep_times[2::3]}  # the third step of each
    profile = _profile_step(torch, trainer, collate_train(windows[:32], *TRAIN_BUCKETS[2]))
    # learning: a fresh trainer whose optimiser warms up over 2 steps, not 100
    trainer = Trainer(cfg, params, device="cuda")
    opt = make_optimizer(1e-3, warmup=2, total_steps=40)
    replicas = trainer.state.replicas
    trainer.state = TrainState(replicas, [opt.init(list(r.parameters())) for r in replicas])
    step = make_train_step(replicas, opt)
    tensors = trainer.tensors(fixed)
    history = [float(step(trainer.state, *tensors)["ce"]) for _ in range(20)]
    ckpt = os.path.join(tmp, "trainer_save")
    trainer.save(ckpt)
    cfg_saved, sd = load_model(ckpt)
    step_txt = open(os.path.join(ckpt, "step.txt")).read()
    same = all(torch.equal(sd[k], v.detach().cpu()) for k, v in trainer.state.params.items())
    emit("train", run="in process", n_params=len(trainer.state.params),
         params_without_finite_nonzero_grad=bad_grads, bucket_ladder=ladder,
         profiled_step=profile,
         ce_first=history[0], ce_last=history[-1], ce_history=history,
         saved_step=step_txt, saved_params_equal=same)
    if bad_grads or not history[-1] < 0.7 * history[0] or step_txt != "20" or not same \
            or cfg_saved != cfg:
        raise RuntimeError(
            f"train: parameters without a finite nonzero gradient {bad_grads}; CE "
            f"{history[0]} -> {history[-1]}; saved step {step_txt!r}, params equal {same}"
        )
    phase_train_int8(torch, windows, cfg, params)
    return launches


def phase_train_int8(torch, windows, cfg, params) -> None:
    """The seeded R10 trainer under int8 (K10, K2 and K11 forward, their plain
    versions backward) on one batch at B=32, L=9216, 20 steps of an
    optimiser warmed up over 2: ms a step by CUDA events from step 3 on, the
    forward/backward split, the peak of allocated memory; every step
    launches K4 once and K10, K2, K11 n_layers x 2 (remat) and nothing
    else; CE below 0.7 x its first value after the 20 steps, the bf16
    trainer's bar."""
    from herro_tpu_torch.training.data import TRAIN_BUCKETS, collate_train
    from herro_tpu_torch.training.train import TrainState, Trainer, make_optimizer, \
        make_train_step

    icfg = dataclasses.replace(cfg, int8=True)
    trainer = Trainer(icfg, params, device="cuda")
    opt = make_optimizer(1e-3, warmup=2, total_steps=40)
    replicas = trainer.state.replicas
    trainer.state = TrainState(replicas, [opt.init(list(r.parameters())) for r in replicas])
    trainer._step = make_train_step(replicas, opt)
    batch = collate_train(windows[:B], *TRAIN_BUCKETS[2])  # L 9216, S 1152
    per_block = 2 * icfg.n_layers
    want = {"entry_embed": 1, "ln_qkv_rope_q": per_block, "flash_outproj": per_block,
            "ln_ffn_q": per_block}
    steps: list = []
    with _timed_steps(torch, steps):
        for _ in range(20):
            trainer.train_step(batch)
    per_step = _step_times(steps)
    timed = per_step[2:]
    ce = [st["ce"] for st in per_step]
    bad = [st["step"] for st in per_step if st["launches"] != want]
    emit("train", run="int8 in process", card=nvidia_smi(), L=per_step[0]["L"],
         S=per_step[0]["S"], ms=sum(st["ms"] for st in timed) / len(timed),
         forward_ms=sum(st["forward_ms"] for st in timed) / len(timed),
         backward_update_ms=sum(st["backward_update_ms"] for st in timed) / len(timed),
         peak_gib=max(st["peak_gib"] for st in timed), ms_each=[st["ms"] for st in per_step],
         want_step_launches=want, ce_first=ce[0], ce_last=ce[-1], ce_history=ce)
    if bad or not ce[-1] < 0.7 * ce[0]:
        raise RuntimeError(f"train int8: steps {bad} launched other than {want}; CE "
                           f"{ce[0]} -> {ce[-1]}")


# (tag, data replicas, tensor-parallel degree, the layout it is held against,
# the mesh axis it adds to that one), a layout of n devices on the first n of
# the phase's devices; "single" is the trainer on one device
TRAIN_LAYOUTS = (("single", 1, 1, None, None), ("dp2", 2, 1, "single", "data"),
                 ("tp2", 1, 2, "single", "model"), ("dp2_tp2", 2, 2, "tp2", "data"),
                 ("single_int8", 1, 1, None, None), ("tp2_int8", 1, 2, "single_int8", "model"))
TRAIN_INT8_LAYOUTS = tuple(t for t in TRAIN_LAYOUTS if t[0].endswith("_int8"))
# a layout's first step against its base's on the same seeded weights and
# batch (bf16): loss, ce and info_bce within TRAIN_PARALLEL_LOSS_RTOL of the
# axis, relative; along a data axis acc and hard_acc within it too,
# absolute, while along a model axis they may move by the share of the
# (hard) supported columns whose class flips; the summed gradient, read
# through Adam's first moment after the step (learning rate 0), within
# dryrun.GRAD_RTOL of the axis. A data axis reorders float32 sums only; a
# model axis rounds each shard's partial to bf16 before the sum.
TRAIN_PARALLEL_LOSS_RTOL = {"data": 1e-6, "model": 1e-4}
# every step's CE within this of the base's, relative: a coarse bound on the
# trajectory (the first step's gradient is the sharp check)
TRAIN_PARALLEL_CE_RTOL = 1e-2
# each layout's classes against its base's on the trained model_r10_sim
TRAIN_PARALLEL_MIN_AGREE = 0.999
TRAIN_PARALLEL_STEPS = 6
TRAIN_PARALLEL_INT8_STEPS = 3  # the int8 layouts' (the plain backward's float64 products)
# faults planted in the dp2 step, each of which the bars must reject
TRAIN_PARALLEL_FAULTS = ("replica 1's gradient dropped", "mean of per-replica means")


def _mesh_logits(torch, replicas, tensors):
    """The bases logits [B, S, 5] of the train forward under no_grad, each
    data replica on its rows of the batch, joined in batch order."""
    from herro_tpu_torch.constants import QUAL_OFFSET, QUAL_SCALE

    tok, quals, sidx, smask = tensors[:4]
    n = len(replicas)
    out = []
    with torch.no_grad():
        for r, replica in enumerate(replicas):
            dev = next(iter(replica.parameters())).device  # its (first) card
            part = [t.chunk(n)[r].to(dev) for t in (tok, quals, sidx, smask)]
            q = QUAL_SCALE * part[1].float() - QUAL_OFFSET
            out.append(replica(part[0], q, part[2], part[3])[1].float().to(tok.device))
    return torch.cat(out)


def _flips(torch, logits, base, smask, hard) -> dict:
    """Where the classes of ``logits`` differ from ``base``'s on the
    supported columns: the share of them and of the hard ones, and the
    witness that they are near-ties: the largest logit gap, and the base's
    top-two margins at the flipped columns beside the share of all columns
    whose margin is within twice that gap."""
    flip = (logits.argmax(-1) != base.argmax(-1)) & smask
    gap = float((logits - base).abs().amax(-1)[smask].max())
    top2 = base.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])[smask]
    at_flips = (top2[..., 0] - top2[..., 1])[flip]
    return dict(share=float(flip.sum() / smask.sum()),
                hard_share=float((flip & hard).sum() / (smask & hard).sum().clamp_min(1)),
                max_logit_gap=gap, max_abs_logit=float(base.abs().amax(-1)[smask].max()),
                max_margin_at_flips=float(at_flips.max()) if flip.any() else 0.0,
                median_margin=float(margin.median()),
                near_tie_share=float((margin <= 2 * gap).float().mean()))


def _first_step_check(first, base_first, grad_gap, axis, flips) -> tuple[dict, bool]:
    """A layout's first step against its base's, by the axis's bars."""
    from herro_tpu_torch.parallel.dryrun import GRAD_RTOL

    rtol = TRAIN_PARALLEL_LOSS_RTOL[axis]
    dev = {k: abs(first[k] - base_first[k]) / (abs(base_first[k]) if k in
                                                ("loss", "ce", "info_bce") else 1.0)
           for k in first}
    bars = {k: rtol for k in ("loss", "ce", "info_bce")}
    if axis == "data":
        bars.update(acc=rtol, hard_acc=rtol)
    else:  # only columns whose class flips can move them
        bars.update(acc=flips["share"] + 1e-6, hard_acc=flips["hard_share"] + 1e-6)
    dev["grad"], bars["grad"] = grad_gap, GRAD_RTOL[axis]
    return dev, all(dev[k] <= bars[k] for k in bars)


@contextlib.contextmanager
def _planted_fault(fault: str, n_data: int):
    """One of ``TRAIN_PARALLEL_FAULTS`` planted in ``make_train_step``'s
    step over ``n_data`` replicas: every replica after the first hands back
    a zero gradient, or each replica's loss and metrics take its own rows'
    denominators and 1 / n_data of them is summed (DDP's mean of means)."""
    from herro_tpu_torch.training import train as train_mod

    gradients, loss_fn = train_mod.gradients, train_mod.loss_fn
    calls = []

    def dropped(loss, params):
        grads = gradients(loss, params)
        calls.append(1)
        return grads if len(calls) % n_data == 1 else [g * 0 for g in grads]

    def mean_of_means(model, *args):
        loss, metrics = loss_fn(model, *args[:-1])  # its own denominators
        return loss / n_data, {k: v / n_data for k, v in metrics.items()}

    if fault == TRAIN_PARALLEL_FAULTS[0]:
        train_mod.gradients = dropped
    else:
        train_mod.loss_fn = mean_of_means
    try:
        yield
    finally:
        train_mod.gradients, train_mod.loss_fn = gradients, loss_fn


def _join_cards(torch, cards) -> None:
    """The first card's current stream waits for every other card's: an event
    recorded on it after this follows the work of every card."""
    first = torch.cuda.current_stream(cards[0])
    for c in cards[1:]:
        first.wait_stream(torch.cuda.current_stream(c))


def _sync_cards(torch, cards) -> None:
    for c in cards:
        torch.cuda.synchronize(c)


def _fresh_trainer(torch, tag: str, cfg, params, devices: list):
    """A seeded trainer of layout ``tag`` of ``TRAIN_LAYOUTS`` over the first
    of ``devices`` (the int8 config for an ``_int8`` layout), with an
    optimiser warmed up over 2 steps, and its step."""
    from herro_tpu_torch.parallel import make_mesh_2d
    from herro_tpu_torch.training.train import (TrainState, Trainer, make_optimizer,
                                                make_train_step)

    n_data, tp = next((n, t) for name, n, t, *_ in TRAIN_LAYOUTS if name == tag)
    where = dict(device=devices[0]) if n_data * tp == 1 else dict(
        mesh=make_mesh_2d(n_data, tp, devices))
    trainer = Trainer(dataclasses.replace(cfg, int8=tag.endswith("_int8")), params, **where)
    replicas = trainer.state.replicas
    opt = make_optimizer(1e-3, warmup=2, total_steps=40)
    trainer.state = TrainState(replicas, [opt.init(list(r.parameters())) for r in replicas])
    return trainer, make_train_step(replicas, opt)


def train_layouts(torch, tmp: str, batch, layouts, devices: list, phase: str = "train_parallel"):
    """``layouts`` (rows of ``TRAIN_LAYOUTS``, each after its base) of a seeded
    ``r10`` trainer on ``batch``, a layout of n devices over the first n of
    ``devices``: the bars of :func:`phase_train_parallel`, one JSON line a
    layout. Returns (refs, the meshes' launches, the failures)."""
    import numpy as np

    from herro_tpu_torch.models.checkpoint import load_model, load_or_init
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel.dryrun import first_moments, relative_gap, replicas_equal
    from herro_tpu_torch.training.train import Trainer

    cfg, params = load_or_init("r10", rng_seed=13)
    ckpt_cfg, ckpt_params = load_model(CKPT)
    failed, rows, refs, launches = [], {}, {}, {}
    for tag, n_data, tp, base, axis in layouts:
        int8 = tag.endswith("_int8")
        cards = sorted({d.index for d in devices[:n_data * tp]})
        trainer, step = _fresh_trainer(torch, tag, cfg, params, devices)
        state, tensors = trainer.state, trainer.tensors(batch)
        smask, hard = tensors[3], tensors[3] & (tensors[5] > 0)
        trained = Trainer(dataclasses.replace(ckpt_cfg, int8=int8), ckpt_params, **(
            dict(device=devices[0]) if trainer.mesh is None else dict(mesh=trainer.mesh)))
        logits = (_mesh_logits(torch, trained.state.replicas, tensors),
                  _mesh_logits(torch, state.replicas, tensors))
        del trained
        want = {"entry_embed": n_data * tp,
                **{k: 2 * cfg.n_layers * tp * n_data for k in block_kernels(int8, tp)}}
        # every shard's own: K4 once, the block's kernels 2 x n_layers a step
        # (remat)
        want_cards = want_by_card(devices[:n_data * tp], tp, int8, 2 * cfg.n_layers, 1,
                                  counting=False)
        history, ms, bad_launches, same_after_3 = [], [], [], True
        _sync_cards(torch, cards)
        for i in range(TRAIN_PARALLEL_INT8_STEPS if int8 else TRAIN_PARALLEL_STEPS):
            if i == 2:
                for c in cards:
                    torch.cuda.reset_peak_memory_stats(c)
                held = {c: torch.cuda.memory_allocated(c) for c in cards}
            before = kernels.launch_counts.snapshot()
            before_by_card = kernels.launch_counts.by_device()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record(torch.cuda.current_stream(cards[0]))
            metrics = step(state, *tensors)
            _join_cards(torch, cards)
            e1.record(torch.cuda.current_stream(cards[0]))
            _sync_cards(torch, cards)
            after = kernels.launch_counts.snapshot()
            launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            by_card = {c: {k: n - before_by_card.get(c, {}).get(k, 0) for k, n in per.items()
                           if n != before_by_card.get(c, {}).get(k, 0)}
                       for c, per in kernels.launch_counts.by_device().items()}
            by_card = {c: per for c, per in by_card.items() if per}
            if launched != want or by_card != want_cards:
                bad_launches.append((i + 1, launched, by_card))
            for k, n in launched.items():  # the meshes' steps, not the forward checks'
                launches[k] = launches.get(k, 0) + n * (base is not None)
            history.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                mu = {k: v.clone() for k, v in first_moments(state).items()}
            if i >= 2:
                ms.append(e0.elapsed_time(e1))
            if i == 2:
                same_after_3 = replicas_equal(state)
        peak = {c: torch.cuda.max_memory_allocated(c) / 2 ** 30 for c in cards}
        same_end = replicas_equal(state)
        ce = [h["ce"] for h in history]
        refs[tag] = dict(first=history[0], mu=mu, ce=ce, logits=logits)
        # CE falls over the bf16 layouts' 6 steps; the int8 layouts' 3 end
        # where a warmed-up step has just raised it (the train phase's int8
        # trainer shows it falling over 20)
        ok = (not bad_launches and same_after_3 and same_end and (int8 or ce[-1] < ce[0])
              and all(np.isfinite(v) for h in history for v in h.values()))
        dev_first = agree = flips = ce_dev = None
        if base is not None:
            ref = refs[base]
            flips = _flips(torch, logits[1], ref["logits"][1], smask, hard)
            agree = float((logits[0].argmax(-1) == ref["logits"][0].argmax(-1))[smask]
                          .float().mean())
            dev_first, first_ok = _first_step_check(history[0], ref["first"],
                                                    relative_gap(mu, ref["mu"]), axis, flips)
            ce_dev = max(abs(a - b) / b for a, b in zip(ce, ref["ce"]))
            ok = (ok and first_ok and ce_dev <= TRAIN_PARALLEL_CE_RTOL
                  and agree >= TRAIN_PARALLEL_MIN_AGREE)
        saved = None
        if tag == "tp2":
            ckpt = os.path.join(tmp, "train_parallel_tp2")
            trainer.save(ckpt)
            cfg_saved, sd = load_model(ckpt)
            logical = state.params
            saved = cfg_saved == cfg and list(sd) == list(logical) and all(
                torch.equal(sd[k], v.cpu()) for k, v in logical.items())
            ok = ok and saved
        rows[tag] = dict(data=n_data, tp=tp, base=base, axis=axis,
                         devices=[str(d) for d in devices[:n_data * tp]],
                         ms=sum(ms) / len(ms), ms_each=ms, peak_gib=max(peak.values()),
                         peak_gib_by_card=peak, held_before_gib=held[cards[0]] / 2 ** 30,
                         first_step=history[0], deviation_from_base=dev_first,
                         ce_deviation_from_base=ce_dev, trained_class_agreement=agree,
                         seeded_flips=flips, replicas_equal_after_3=same_after_3,
                         replicas_equal_at_end=same_end, ce_history=ce,
                         want_step_launches=want, want_step_launches_by_card=want_cards,
                         saved_equal=saved)
        emit(phase, layout=tag, card=nvidia_smi(), **rows[tag], bad_launches=bad_launches)
        if not ok:
            failed.append(f"{tag}: {rows[tag]}, launches {bad_launches}")
        del trainer, state, step, logits
        torch.cuda.empty_cache()
    return refs, launches, failed


def phase_train_parallel(torch, tmp: str, devices: list) -> dict:
    """A seeded ``r10`` trainer at B=32 on a bucket-9216 batch of the
    ``train`` phase's windows, a layout of n devices over the first n of
    ``devices`` (this run: :func:`one_card`, ``cuda:0`` repeated): one
    device, then ``TRAIN_LAYOUTS``' meshes, ``TRAIN_PARALLEL_STEPS`` steps
    each (an optimiser warmed up over 2 steps, as the ``train`` phase's).
    Each mesh's first step, its loss, metrics and summed gradient, is held
    against its base layout's by the bars of the axis it adds; every step's
    CE within ``TRAIN_PARALLEL_CE_RTOL`` of the base's, and falling over the
    steps (bf16); launches a step K4 n_data x tp and K1-K3 2 x n_layers x tp
    x n_data (remat), no other kernel, every shard's share on its own card;
    the data replicas' parameters and moments bit-identical after 3 steps
    and at the end; ms a step by CUDA events from step 3 on (the first
    card's, after it has waited for every other card's) and each card's peak
    of allocated memory. The forward's classes on the trained
    ``model_r10_sim`` agree with the base's on at least
    ``TRAIN_PARALLEL_MIN_AGREE`` of the supported columns; on the seeded
    weights the flipped columns are reported with their logit margins.
    ``Trainer.save`` of the TP 2 run loads back equal to the gathered
    parameters. Each of ``TRAIN_PARALLEL_FAULTS``, planted in a DP 2 step,
    must fail the bars. The ``_int8`` layouts (``TRAIN_INT8_LAYOUTS``)
    train the int8 config the same way, ``TRAIN_PARALLEL_INT8_STEPS`` steps
    each, TP 1 x 2 held against one device's int8 trainer, launching K4 x
    tp, K10 and K2 2 x n_layers x tp and K11 2 x n_layers a step on one
    device, each of its two modes 2 x n_layers x tp over the mesh. Then
    ``dryrun_multichip(4)`` over ``cuda:0`` four times. Returns the launches
    of the meshes' steps, counted from 0 (the counters are reset at the
    start)."""
    import pickle

    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel.dryrun import dryrun_multichip, first_moments, relative_gap
    from herro_tpu_torch.training.data import TRAIN_BUCKETS, collate_train

    with open(os.path.join(tmp, "train_windows.pkl"), "rb") as fh:
        windows = pickle.load(fh)
    batch = collate_train(windows[:B], *TRAIN_BUCKETS[2])  # L 9216, S 1152
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    refs, launches, failed = train_layouts(torch, tmp, batch, TRAIN_LAYOUTS, devices)

    # the bars' power: each planted fault in the dp2 step must fail them
    cfg, params = load_or_init("r10", rng_seed=13)
    for fault in TRAIN_PARALLEL_FAULTS:
        trainer, step = _fresh_trainer(torch, "dp2", cfg, params, devices)
        with _planted_fault(fault, 2):
            first = {k: float(v) for k, v in step(trainer.state, *trainer.tensors(batch)).items()}
        dev_first, first_ok = _first_step_check(
            first, refs["single"]["first"],
            relative_gap(first_moments(trainer.state), refs["single"]["mu"]), "data", None)
        emit("train_parallel", planted_fault=fault, deviation_from_base=dev_first,
             rejected=not first_ok)
        if first_ok:
            failed.append(f"the bars passed a step with {fault}: {dev_first}")
        del trainer, step
    refs.clear()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device="cuda:0")
    emit("train_parallel", run="dryrun_multichip(4) over cuda:0", wall_s=time.perf_counter() - t0,
         **dry)
    missing = [k for k in TRAIN_KERNELS if not launches.get(k)]
    if failed or missing:
        raise RuntimeError(f"train_parallel: {failed}; kernels never launched {missing}")
    return launches


def _distill_run(torch, tmp: str, student: str | None, n_steps: int = 4) -> dict:
    """``distill`` through the CLI over the ``features`` phase's tree, teacher
    ``model_r10_sim``, batch 8, ``--student`` as given (None: the CLI's
    default): the wall time, the teacher's labelling's launches, the
    student's steps' launches, the saved config and the CLI's last line."""
    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.training import distill as distill_mod

    label_fn = distill_mod.teacher_label_windows
    teacher = {}

    def teacher_label_windows(*args, **kwargs):
        before = kernels.launch_counts.snapshot()
        res = label_fn(*args, **kwargs)
        after = kernels.launch_counts.snapshot()
        teacher.update({k: after[k] - before[k] for k in after if after[k] != before[k]})
        return res

    out = os.path.join(tmp, f"student_{student or 'default'}")
    err = io.StringIO()
    torch.cuda.synchronize()
    before = kernels.launch_counts.snapshot()
    t0 = time.perf_counter()
    distill_mod.teacher_label_windows = teacher_label_windows
    try:
        with contextlib.redirect_stderr(err):
            cli.main(["distill", os.path.join(tmp, "features"), out, "--teacher", CKPT,
                      *(["--student", student] if student else []), "--steps", str(n_steps),
                      "--batch-size", "8"])
    finally:
        distill_mod.teacher_label_windows = label_fn
    wall = time.perf_counter() - t0
    after = kernels.launch_counts.snapshot()
    total = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    cfg, sd = load_model(out)
    CorrectionModel(cfg).load_state_dict(sd, strict=True)  # the checkpoint loads
    return dict(wall_s=wall, teacher=teacher, out=out, cfg=cfg,
                student={k: total[k] - teacher.get(k, 0) for k in total
                         if total[k] != teacher.get(k, 0)},
                summary=err.getvalue().strip().splitlines()[-1])


def phase_distill(torch, tmp: str) -> None:
    """``distill`` through the CLI over the ``features`` phase's tree: teacher
    ``model_r10_sim``, student ``r9``, batch 8. The teacher's labelling
    launches K1-K5, the student's steps K1-K4 at d 256."""
    from herro_tpu_torch.models.model import R9_CONFIG

    n_steps = 4
    run = _distill_run(torch, tmp, "r9", n_steps)
    teacher, student, cfg = run["teacher"], run["student"], run["cfg"]
    want = {k: n * n_steps for k, n in _want_step_launches(R9_CONFIG).items()}
    emit("distill", wall_s=run["wall_s"], teacher_launches=teacher, student_launches=student,
         want_student_launches=want, student_config=cfg.__dict__, summary=run["summary"])
    missing = [k for k in E2E_KERNELS if not teacher.get(k)]
    if missing or student != want or cfg != R9_CONFIG:
        raise RuntimeError(f"distill: teacher kernels never launched {missing}; student "
                           f"launches {student}, expected {want}; student config {cfg}")


# the float32 kernels' absolute bars, the CPU tests' (tests/test_torch_kernels.py)
F32_ATOL = 1e-4
F32_ATOL_PROJ = 2e-4  # after the out projection's extra contraction
# the share of a bf16 SIMT row's outputs that may differ from the plain
# version's at all. Sums in another order move a bf16 rounding only where a
# value lies within float32's error of a rounding boundary: at most 0.17% of
# the outputs on an H100. A rounding missed or added moves one at a large
# share of them: 4-42% (tools/bf16_rounding_faults.py; PERF.md section 6).
# The attention rows (K9, and K2/K6/K7's projection) hold the kernel against
# the plain version that rounds P as its online softmax does, tile by tile
# against the running maximum (attention._flash_attention_tiled,
# fused._flash_outproj_tiled, at the kernel's 64-key tile): against the whole
# row's maximum 6-13% of K9's outputs were an ulp apart without a fault.
BF16_SIMT_MAX_SHARE = 2.0 ** -6
# (d, H, D, d_ff, band) of the SIMT rows: TINY_CONFIG (no band),
# model_r10_sim (in float32), the flagship at head dim 64 (r10h64, bf16) and
# the tp 2 shards of tiny and r10h64
SIMT_WIDTHS = {"tiny": (32, 2, 16, 64, None), "r10": (512, 4, 128, 1024, 512),
               "r10h64": (512, 8, 64, 1024, 512), "tiny-tp2": (32, 1, 16, 32, None),
               "r10h64-tp2": (512, 4, 64, 512, 512),
               # the widths phase: w768h96 (tests/torch_data/w768h96.py), d 1024 at
               # H 8 x 128, and head dims 48, 80 and 112 at H 8 (K1 and K9 alone)
               "w768h96": (768, 8, 96, 3072, 512), "d1024": (1024, 8, 128, 4096, 512),
               "D48": (384, 8, 48, 1536, 512), "D80": (640, 8, 80, 2560, 512),
               "D112": (896, 8, 112, 3584, 512)}
# the tags of the widths phase whose rows are K1 (table route) and K9 alone
HEAD_DIM_TAGS = ("D48", "D80", "D112")
# the (tag, L) of each dtype's SIMT rows, in order (simt_cases)
SIMT_PLANS = {"float32": (("r10", L), ("tiny", L), ("tiny", 1024)),
              "bfloat16": (("r10h64", L), ("tiny", L), ("tiny", 1024), ("tiny-tp2", L),
                           ("r10h64-tp2", L))}
# the (tag, L) of the widths phase's rows, each dtype
WIDTHS_PLANS = (("w768h96", L), ("d1024", L), ("D48", L), ("D80", L), ("D112", L))
F32_REPLACES = {
    "entry_embed_f32": "herro_tpu/ops/fused.py:89",
    "ln_qkv_rope_f32": "herro_tpu/ops/fused.py:572",
    "ln_qkv_rope_f32_split": "herro_tpu/ops/fused.py:541",
    "flash_f32": "herro_tpu/ops/fused.py:993",
    "flash_f32[K6]": "herro_tpu/ops/fused.py:902",
    "flash_f32_full": "herro_tpu/ops/fused.py:821",
    "flash_f32_attention": "herro_tpu/ops/attention.py:36",
    "ln_ffn_f32": "herro_tpu/ops/fused.py:286",
}
F32_KERNELS = {  # kernel -> its entry points (launch counters)
    "entry_embed_f32": ("entry_embed_f32",),
    "ln_qkv_rope_f32": ("ln_qkv_rope_f32", "ln_qkv_rope_f32_split"),
    "flash_f32": ("flash_f32", "flash_f32_full", "flash_f32_attention"),
    "ln_ffn_f32": ("ln_ffn_f32",),
}


def simt_cases(torch, dtype: str = "float32", plans=None, labelled: bool = False) -> dict:
    """The SIMT kernels of ``dtype`` against their plain versions at B=32,
    each (tag, L) of ``plans`` (by default ``SIMT_PLANS[dtype]``) at the
    widths of ``SIMT_WIDTHS``.
    float32 (``csrc/*_f32.cu``): model_r10_sim's widths in float32 at L=9216,
    TINY_CONFIG's at L=9216 and 1024, within 1e-4 (2e-4 after the out
    projection). bfloat16 (``csrc/*_bf16.cu``, the widths no Hopper instance
    takes): the flagship at head dim 64 (r10h64: K1/K8, K2 and K9; its K4
    and K3 at d 512 are the Hopper instances') at L=9216, TINY_CONFIG's at
    L=9216 and 1024, and the tp 2 shards of both (K1, K2/K7, K3), at the
    bf16 bars of ``compare``; every row also with at most
    ``BF16_SIMT_MAX_SHARE`` of its outputs differing at all, the attention
    rows (K9, K2/K6/K7) against the plain version that rounds P per 64-key
    tile against the running maximum, as the kernel does and as herro_tpu's
    Pallas kernels round it (``attention._flash_attention_tiled``,
    ``fused._flash_outproj_tiled``).
    tiny's K1/K8, K3 and K4, whose sums run over 16-64 terms and which have
    come out bit-equal with their plain versions in every run on the card,
    are held exact. So one missed bf16 rounding fails the rows it reaches
    (``tools/bf16_rounding_faults.py``). K9's mode runs at
    each band of a tag that is no shard (band 512, 40 and none for tiny at
    L=9216). The first row of a kernel is its main row. Each row's bound is
    the larger of its bytes over the card's memory rate and its operations
    over the card's peak for the operands' type (float32 or bf16); the rows
    on the tensor cores (K1/K8, K2/K6/K7/K9, K3) take ``tc_bound``'s (bf16
    products at the bf16 peak, float32 as three TF32 products; the
    attention's exponentials at the SFU's rate), with the operations at the
    float32 FFMA or bf16 peak beside it (``bound_simt_ms``) and its two
    terms, the products and the exponentials; K4 stays on the FFMA (float32)
    or bf16 peak, its operations at the FFMA rate beside it
    (``bound_ffma_ms``). The widest tags (r10, r10h64) also hold K2/K6/K7's out
    projection alone (``outproj_tc``, mode ``flash_*_outproj``: the tile
    product the attention entry points launch after their attention, bf16
    on the tensor cores, float32 on FFMA and bounded so) against
    ``fused._outproj_plain``, its library call one torch.addmm. A row's library call is SDPA in ``dtype``
    with the mask (the attention rows) or one torch.matmul in ``dtype`` of
    the dominant product, TF32 off. The widths phase's tags (``WIDTHS_PLANS``,
    ``labelled``: every row under its tag, none a kernel's main row): w768h96
    and d 1024 hold K4, K1, K8, K2 (band 512), K7 and K9 (band 512 and none)
    and K3; the head dims of ``HEAD_DIM_TAGS`` K1 and K9 (band 512) alone."""
    import numpy as np
    import torch.nn.functional as F

    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE, TOKEN_PAD, VOCAB_SIZE
    from herro_tpu_torch.ops import attention, fused

    dev = torch.device("cuda")
    R, V = N_ROWS, VOCAB_SIZE
    rng = np.random.default_rng(4242)
    g = torch.Generator(device=dev).manual_seed(4242)
    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    sfx, es = ("f32", 4) if f32 else ("bf16", 2)  # the instances' suffix, the bytes a value
    lib_dt = "float32 (TF32 off)" if f32 else "bf16"
    peak = PEAK_F32 if f32 else PEAK_BF16
    tol = dict(atol=F32_ATOL) if f32 else dict(share_differing=True,
                                                max_share=BF16_SIMT_MAX_SHARE)
    tol_proj = dict(atol=F32_ATOL_PROJ) if f32 else tol
    # K9's plain version: float32 keeps P unrounded, so the whole row's
    # maximum serves; bf16 rounds P per key tile against the running maximum
    k9_plain = attention._flash_attention_plain if f32 else attention._flash_attention_tiled
    # K2/K6/K7's: float32 as the CPU forward; bf16 rounds P as K9's (and as
    # herro_tpu's Pallas kernels)
    proj_plain = fused._flash_outproj_plain if f32 else fused._flash_outproj_tiled

    def replaces(name):  # the TPU kernel a row's instance replaces, by its float32 name
        return F32_REPLACES[name.replace(sfx, "f32")]

    def randn(*shape, std=1.0, dtype=dt):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def pileup(n):
        lengths = rng.integers(int(0.7 * n), n + 1, size=B).astype(np.int32)
        n_alns = rng.integers(2, R, size=B)
        tok = rng.integers(0, 11, size=(B, R, n), dtype=np.uint8)
        for b in range(B):
            tok[b, n_alns[b] + 1 :] = TOKEN_PAD
            tok[b, :, lengths[b] :] = TOKEN_PAD
        quals = QUAL_SCALE * torch.from_numpy(
            rng.integers(33, 127, size=(B, R, n), dtype=np.uint8)).to(dev).float() - QUAL_OFFSET
        return torch.from_numpy(tok).to(dev), quals, lengths

    def simt_bounds(nbytes, ops, exps=0):
        """A tensor-core row's bound as the SIMT instances stated it (its
        operations at the peak of the operands' type: FFMA for float32),
        and the two terms of the tensor cores' (tc_bound)."""
        ms, by = bound(nbytes, ops, peak)
        return dict(bound_simt_ms=ms, bound_simt_by=by, bound_exp2_ms=exps / PEAK_EXP2 * 1e3,
                    bound_products_ms=ops / (PEAK_TF32 / 3 if f32 else PEAK_BF16) * 1e3)

    def band_pairs(band, lens, n):
        i = np.arange(n)
        if band is None:
            return int((lens.astype(np.int64) ** 2).sum())
        return sum(int((np.minimum(i[:lb] + band, lb - 1) - np.maximum(i[:lb] - band, 0) + 1)
                       .clip(0).sum()) for lb in lens)

    def sdpa(qkv, bias):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(*qkv, attn_mask=bias)

    def sdpa_bias(lens, band, n):
        """The mask as SDPA's additive bias [B, 1, n, n] in ``dtype``."""
        pos = torch.arange(n, device=dev)
        ok = (pos[None, :] < lens[:, None])[:, None, None, :]
        if band is not None:
            ok = ok & ((pos[:, None] - pos[None, :]).abs() <= band)[None, None]
        return torch.zeros(B, 1, n, n, device=dev, dtype=dt).masked_fill_(~ok, float("-inf"))

    cases = {}
    for tag, n in plans or SIMT_PLANS[dtype]:
        d, H, D, f, band = SIMT_WIDTHS[tag]
        T = B * n

        def add(name, c, *labels, tag=tag, n=n):
            """The first row of a kernel under its own name (its main row),
            later ones under their entry point's, labelled."""
            if c.get("mode") is None and not labels and name not in cases and not labelled:
                cases[name] = dict(c, name=name)
                return
            labels = [tag, *labels] + ([] if n == L else [f"L={n}"])
            cases[f"{c.get('mode') or name}[{', '.join(labels)}]"] = dict(c, name=name)

        wide = tag.startswith("r10")  # the widest rows, whose times PERF.md keeps
        new = tag in ("w768h96", "d1024")  # the widths phase's model widths
        heads_only = tag in HEAD_DIM_TAGS  # K1 and K9 alone
        shard = tag.endswith("tp2")
        hopper_d = not f32 and d in fused.EMBED_WIDTHS  # bf16 K4 and K3 take Hopper here
        # tiny bf16's K1/K8, K3 and K4: bit-equal with the plain version on the card
        short = tol if f32 or not tag.startswith("tiny") else dict(tol, exact=True)
        iters = 5 if wide or new or heads_only else 10

        tok, quals, lens_np = pileup(n)
        lens = torch.from_numpy(lens_np).to(dev)
        wc = fused.col_proj_table(randn(d, R * V, std=(R * (V + 1)) ** -0.5),
                                  randn(d, R, std=(R * (V + 1)) ** -0.5))
        cb = randn(d, std=0.25, dtype=torch.float32)
        x = randn(B, n, d)
        ln_s = 1.0 + randn(d, std=0.1, dtype=torch.float32)
        ln_b = randn(d, std=0.1, dtype=torch.float32)
        w_qkv, b_qkv = randn(d, 3 * H * D, std=d ** -0.5), randn(3 * H * D, std=0.25)
        wo, bo = randn(H, D, d, std=(H * D) ** -0.5), randn(d, std=0.25)
        w1, b1 = randn(d, f, std=d ** -0.5), randn(f, std=0.25)
        w2, b2 = randn(f, d, std=f ** -0.5), randn(d, std=0.25)
        qkv_name = f"ln_qkv_rope_{sfx}"
        q, k, v = fused._ln_qkv_rope_cuda(x, ln_s, ln_b, w_qkv, b_qkv, H, kernel=qkv_name)
        qkv_bytes = 3 * B * H * n * D * es
        if not (hopper_d or shard or heads_only):
            nnz = int((tok < V).sum()) + int((quals != 0).sum())
            idx = (tok.long() + torch.arange(R, device=dev)[None, :, None] * V
                   ).permute(0, 2, 1).reshape(-1, R)
            emb = wc[: R * fused.COL_SLOT].view(R, fused.COL_SLOT, d)[:, :V].reshape(R * V, d)
            a_embed = (tok, quals, wc, cb, dt)
            embed_work = (tok.numel() * 5 + T * d * es + wc.numel() * es + d * 4, 2 * d * nnz)
            name = f"entry_embed_{sfx}"
            add(name, dict(
                replaces=replaces(name),
                kernel=lambda a=a_embed, k_=name: fused._entry_embed_cuda(*a, kernel=k_),
                plain=lambda a=a_embed: fused._entry_embed_plain(*a),
                library=(f"F.embedding_bag(mode=sum) of the token rows, {lib_dt}, no qual "
                         f"term", lambda idx=idx, emb=emb: F.embedding_bag(idx, emb, mode="sum")),
                bound=bound(*embed_work, peak),
                extra=lambda w_=embed_work: dict(bound_ffma_ms=w_[1] / PEAK_F32 * 1e3),
                iters=iters, **short))
        a_qkv = (x, ln_s, ln_b, w_qkv, b_qkv, H)
        qkv_work = (T * d * es + qkv_bytes + d * 3 * H * D * es, 2 * T * d * 3 * H * D)
        for route in (qkv_name, f"{qkv_name}_split")[
                : 2 if n == L and not (shard or heads_only) else 1]:
            c = dict(
                mode=None if route == qkv_name else route, replaces=replaces(route),
                kernel=lambda a=a_qkv, r=route: fused._ln_qkv_rope_cuda(*a, kernel=r),
                plain=lambda a=a_qkv: fused._ln_qkv_rope_plain(*a),
                library=(f"torch.matmul LN(x)[T,d] @ W_qkv[d,3HD] {lib_dt}, the dominant "
                         f"product", lambda x=x, w=w_qkv, T=T, d=d: torch.matmul(x.view(T, d), w)),
                bound=tc_bound(*qkv_work, 0, f32), extra=lambda w_=qkv_work: simt_bounds(*w_),
                iters=iters, **short,
            )
            if route != qkv_name:  # the same bits as the table route
                c["twin"] = lambda a=a_qkv: fused._ln_qkv_rope_cuda(*a, kernel=qkv_name)
            add(qkv_name, c)
        bands = [band] if wide or shard or heads_only else \
            [band, None] if new else ([None, 512, 40] if n == L else [None])
        for w in bands:
            route = f"flash_{sfx}" if w is not None else f"flash_{sfx}_full"
            w_labels = [] if w is None or wide or new else [f"w={w}"]
            a_att = (q, k, v, x, wo, bo, lens, w)
            pairs = band_pairs(w, lens_np, n)
            att_work = (qkv_bytes + 2 * T * d * es + H * D * d * es,
                        4 * H * D * pairs + 2 * int(lens_np.sum()) * H * D * d, H * pairs)
            if not heads_only:
                add(f"flash_{sfx}", dict(
                    mode=None if w is not None else route,
                    replaces=F32_REPLACES["flash_f32_full" if w is None
                                          else "flash_f32" if w % 256 == 0 else "flash_f32[K6]"],
                    kernel=lambda a=a_att, r=route: fused._flash_outproj_cuda(*a, kernel=r),
                    plain=lambda a=a_att: proj_plain(*a),
                    library=(f"F.scaled_dot_product_attention (memory-efficient backend) {lib_dt} "
                             f"with the mask (band {w}) as an additive bias: attention only, no "
                             f"out projection",
                             lambda bias, qkv=(q, k, v): sdpa(qkv, bias),
                             lambda lens=lens, w=w, n=n: sdpa_bias(lens, w, n)),
                    bound=tc_bound(*att_work, f32), extra=lambda w_=att_work: simt_bounds(*w_),
                    rows=lens_np, residual=x, iters=iters, **tol_proj), *w_labels)
            if shard:
                continue
            k9_np = lens_np
            if w is None:  # mixed lengths, one window empty (it must come out 0)
                k9_np = lens_np.copy()
                k9_np[::4] = rng.integers(n // 4, n // 2, size=len(k9_np[::4]))
                k9_np[3] = 0
            k9_lens = torch.from_numpy(k9_np).to(dev)
            a_k9 = (q, k, v, k9_lens, w)
            k9_pairs = band_pairs(w, k9_np, n)
            k9_work = (4 * B * H * n * D * es, 4 * H * D * k9_pairs, H * k9_pairs)
            k9 = f"flash_{sfx}_attention"
            add(f"flash_{sfx}", dict(
                mode=k9, replaces=replaces(k9),
                kernel=lambda a=a_k9, k_=k9: attention._flash_attention_cuda(*a, kernel=k_),
                plain=lambda a=a_k9: k9_plain(*a),
                library=(f"F.scaled_dot_product_attention (memory-efficient backend) {lib_dt} "
                         f"with the mask (band {w}) as an additive bias: the same function",
                         lambda bias, qkv=(q, k, v): sdpa(qkv, bias),
                         lambda lens=k9_lens, w=w, n=n: sdpa_bias(lens, w, n)),
                bound=tc_bound(*k9_work, f32), extra=lambda w_=k9_work: simt_bounds(*w_),
                rows=k9_np, iters=iters, **tol), f"w={w}" if w is not None else "no band")
        if wide:  # K2/K6/K7's out projection alone, through its own entry point
            o = randn(B, n, H, D)
            a_proj = (o, x, wo, bo)
            proj_work = ((T * H * D + 2 * T * d + H * D * d + d) * es, 2 * T * H * D * d)
            cases[f"outproj_tc[{tag}]"] = dict(
                name=f"flash_{sfx}", mode=f"flash_{sfx}_outproj",
                replaces=F32_REPLACES["flash_f32"],
                kernel=lambda a=a_proj, m=f"flash_{sfx}_outproj": fused._outproj_cuda(*a, m),
                plain=lambda a=a_proj: fused._outproj_plain(*a),
                library=(f"torch.addmm x[T,d] + o[T,HD] @ Wo[HD,d] {lib_dt}: the same product "
                         f"and residual, bo not added",
                         lambda x=x, o=o, wo=wo, T=T, d=d, K=H * D: torch.addmm(
                             x.view(T, d), o.view(T, K), wo.view(K, d))),
                # float32 keeps the FFMA product (csrc/flash_tc.cuh outproj_on_tc)
                bound=bound(*proj_work, PEAK_F32) if f32 else tc_bound(*proj_work, 0, False),
                extra=lambda w_=proj_work: simt_bounds(*w_), residual=x, iters=iters,
                **tol_proj)
        if hopper_d or heads_only:
            continue
        a_ffn = (x, ln_s, ln_b, w1, b1, w2, b2)
        ffn_work = (2 * T * d * es + 2 * d * f * es, 4 * T * d * f)
        name = f"ln_ffn_{sfx}"
        add(name, dict(
            replaces=replaces(name),
            kernel=lambda a=a_ffn, k_=name: fused._ln_ffn_cuda(*a, kernel=k_),
            plain=lambda a=a_ffn: fused._ln_ffn_plain(*a),
            library=(f"torch.matmul LN(x)[T,d] @ W1[d,f] {lib_dt}, half the operations",
                     lambda x=x, w=w1, T=T, d=d: torch.matmul(x.view(T, d), w)),
            bound=tc_bound(*ffn_work, 0, f32), extra=lambda w_=ffn_work: simt_bounds(*w_),
            residual=x, iters=iters, **short))
    return cases


def _golden_forward(torch, ckpt: str, fx, dtype: str | None = None,
                    int8: bool = False) -> dict:
    """A checkpoint's forward on a golden batch's inputs (``fx``, the layout
    of ``tests/golden/logits_r10.npz``) on the card, with its launches;
    ``int8`` forces the int8 config."""
    import numpy as np

    from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.pipeline.batching import unpack_tokens_torch

    cfg, sd = load_model(ckpt)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if int8:
        cfg = dataclasses.replace(cfg, int8=True)
    model = CorrectionModel(cfg)
    model.load_state_dict(sd)
    model = model.cuda().eval()
    dev = torch.device("cuda")
    with torch.inference_mode():
        tok = unpack_tokens_torch(torch.from_numpy(fx["tokens_packed"]).to(dev), N_ROWS)
        quals = QUAL_SCALE * torch.from_numpy(fx["quals"]).to(dev).float() - QUAL_OFFSET
        sidx = torch.from_numpy(fx["support_idx"]).to(dev)
        smask = torch.from_numpy(fx["support_mask"]).to(dev)
        torch.cuda.synchronize()
        before = kernels.launch_counts.snapshot()
        info, logits = model(tok, quals, sidx, smask)
        torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    return dict(cfg=cfg, info=info.cpu().numpy(), logits=logits.cpu().numpy(),
                launches={k: after[k] - before[k] for k in after if after[k] != before[k]})


F32_DATA = os.path.join(ROOT, "tests", "torch_data")
# name -> (checkpoint, the frozen JAX outputs, the inputs, the dtype forced)
F32_GOLDENS = {
    "tiny": (os.path.join(F32_DATA, "tiny_seed5"), "golden_tiny_f32.npz", None, None),
    "r10_f32": (CKPT, "golden_r10_f32.npz", GOLDEN, "float32"),
}


def _f32_golden_runs(torch) -> None:
    """The tiny and float32-r10 forwards on the frozen inputs against the JAX
    float32 logits of ``tests/torch_data`` (2e-4, the CPU bar, argmax equal
    at every supported column), launching the float32 kernels and no bf16
    instance."""
    import numpy as np

    out = {}
    for name, (ckpt, frozen, inputs, dtype) in F32_GOLDENS.items():
        want = np.load(os.path.join(F32_DATA, frozen))
        fx = np.load(inputs) if inputs else want
        run = _golden_forward(torch, ckpt, fx, dtype)
        mask = fx["support_mask"]
        d_log = float(np.abs(run["logits"] - want["logits"])[mask].max())
        d_info = float(np.abs(run["info"] - want["info"])[mask].max())
        argmax_equal = bool((run["logits"].argmax(-1) == want["logits"].argmax(-1))[mask].all())
        cfg = run["cfg"]
        attn = "flash_f32_full" if cfg.local_window is None else "flash_f32"
        want_launches = {"entry_embed_f32": 1, "ln_qkv_rope_f32": cfg.n_layers,
                         attn: cfg.n_layers, "ln_ffn_f32": cfg.n_layers}
        emit("float32", run="golden", model=name, max_dlogit=d_log, max_dinfo=d_info,
             tol=2e-4, argmax_equal=argmax_equal, n_supported=int(mask.sum()),
             launches=run["launches"], want_launches=want_launches)
        if d_log > 2e-4 or d_info > 2e-4 or not argmax_equal \
                or run["launches"] != want_launches:
            raise RuntimeError(f"float32 golden {name}: max |dlogit| {d_log}, |dinfo| "
                               f"{d_info}, argmax equal {argmax_equal}, launches "
                               f"{run['launches']} (want {want_launches})")
        out[name] = dict(run, fx=fx, want=want)
    # the split rope route (HERRO_TPU_ROPE=split): the tables built in the
    # kernel, the same bits as the table route's
    with _env(HERRO_TPU_ROPE="split"):
        split = _golden_forward(torch, F32_GOLDENS["tiny"][0], out["tiny"]["fx"])
    n_layers = split["cfg"].n_layers
    same = bool(np.array_equal(split["logits"], out["tiny"]["logits"])
                and np.array_equal(split["info"], out["tiny"]["info"]))
    emit("float32", run="golden", model="tiny", rope="split", launches=split["launches"],
         bit_identical_to_table_route=same)
    if not same or split["launches"].get("ln_qkv_rope_f32_split") != n_layers \
            or "ln_qkv_rope_f32" in split["launches"]:
        raise RuntimeError(f"float32 golden tiny under HERRO_TPU_ROPE=split: launches "
                           f"{split['launches']}, bit-identical {same}")


@contextlib.contextmanager
def _env(**values):
    """os.environ with ``values`` set (None: unset) inside the block."""
    kept = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in kept.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _f32_knob_runs(torch) -> None:
    """``HERRO_TPU_PALLAS=0`` on the card: the tiny golden (float32) and the
    bf16 one each raise a ValueError naming the setting, and launch nothing;
    the port runs no plain version on a CUDA tensor."""
    import numpy as np

    from herro_tpu_torch.ops import cuda as kernels

    report, bad = {}, []
    runs = {"tiny": (F32_GOLDENS["tiny"][0], np.load(os.path.join(F32_DATA,
                                                                  F32_GOLDENS["tiny"][1]))),
            "r10_bf16": (CKPT, np.load(GOLDEN))}
    for name, (ckpt, fx) in runs.items():
        before = kernels.launch_counts.snapshot()
        try:
            with _env(HERRO_TPU_PALLAS="0"):
                _golden_forward(torch, ckpt, fx)
            refused = None
        except ValueError as e:  # the refusal asserted here, not swallowed
            refused = str(e)
        after = kernels.launch_counts.snapshot()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        report[name] = dict(refused=refused, launches=launched)
        if refused is None or "HERRO_TPU_PALLAS=0" not in refused or launched:
            bad.append(f"{name} {report[name]}")
    emit("float32", run="knobs", pallas_0=report)
    if bad:
        raise RuntimeError("HERRO_TPU_PALLAS=0 on the card was not refused: " + "; ".join(bad))


def _f32_want_step(cfg) -> dict:
    """A float32 train step's launches: ``_want_step_launches`` on the
    float32 kernels (the attention's route by the band)."""
    names = {"entry_embed": "entry_embed_f32", "ln_qkv_rope": "ln_qkv_rope_f32",
             "flash_outproj": "flash_f32_full" if cfg.local_window is None else "flash_f32",
             "ln_ffn": "ln_ffn_f32"}
    return {names[k]: n for k, n in _want_step_launches(cfg).items()}


def _tiny_entry(cfg) -> str:
    """The SIMT K4 instance of a tiny config's dtype (float32 or bf16)."""
    return "entry_embed_f32" if cfg.dtype == "float32" else "entry_embed_bf16"


def _tiny_block_launches(cfg, tp: int = 1, int8: bool = False) -> dict:
    """A batch's launches of the SIMT block kernels of a tiny config's dtype
    (float32 or bf16; int8: the SIMT int8 K10 and K11, K11's two modes on a
    shard, beside that dtype's attention), every layer on each of ``tp``
    shards."""
    sfx = "f32" if cfg.dtype == "float32" else "bf16"
    attn = f"flash_{sfx}_full" if cfg.local_window is None else f"flash_{sfx}"
    if not int8:
        names = (f"ln_qkv_rope_{sfx}", attn, f"ln_ffn_{sfx}")
    elif tp == 1:
        names = ("ln_qkv_rope_q_simt", attn, "ln_ffn_q_simt")
    else:
        names = ("ln_qkv_rope_q_simt", attn, "ln_ffn_q_simt_rowmax", "ln_ffn_q_simt_rowscale")
    return {k: cfg.n_layers * tp for k in names}


def _f32_only(launches: dict) -> bool:
    """Some float32 kernel launched, and no other kernel."""
    f32 = {m for modes in F32_KERNELS.values() for m in modes}
    return bool(launches) and set(launches) <= f32


def _f32_train(torch, tmp: str) -> tuple[dict, str]:
    """``train --config tiny`` through the CLI on the ``train`` phase's
    windows, 6 steps at batch 8: each step launches the float32 kernels
    (K4's once, the rest n_layers x 2 under remat) and nothing else; then a
    seeded tiny trainer in process: every parameter a finite nonzero
    gradient, and 20 steps on one batch bringing CE below 0.7 x its first
    value. Returns the CLI run's summary and its checkpoint."""
    import pickle

    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_model, load_or_init
    from herro_tpu_torch.models.model import TINY_CONFIG
    from herro_tpu_torch.training.data import TRAIN_BUCKETS, collate_train
    from herro_tpu_torch.training.train import (TrainState, Trainer, loss_fn,
                                                make_optimizer, make_train_step)

    want = _f32_want_step(TINY_CONFIG)
    cache = os.path.join(tmp, "train_windows.pkl")  # the train phase's windows
    out = os.path.join(tmp, "trained_tiny")
    args = dict(zip(TRAIN_ARGS[::2], TRAIN_ARGS[1::2]))
    args.update({"--config": "tiny", "--batch-size": "8", "--steps": "6"})
    steps: list = []
    t0 = time.perf_counter()
    with _timed_steps(torch, steps):
        cli.main(["train", *(a for kv in args.items() for a in kv), "--data-cache", cache,
                  out])
    wall = time.perf_counter() - t0
    per_step = _step_times(steps)
    bad = [st["step"] for st in per_step if st["launches"] != want]
    cfg_out, _ = load_model(out)
    with open(cache, "rb") as fh:
        windows = pickle.load(fh)
    cfg, params = load_or_init("tiny", rng_seed=3)
    trainer = Trainer(cfg, params, device="cuda")
    fixed = collate_train(windows[:8], *TRAIN_BUCKETS[0])
    loss, _ = loss_fn(trainer.model, *trainer.tensors(fixed), 0.1, 0.0)
    grads = torch.autograd.grad(loss, list(trainer.state.params.values()))
    bad_grads = [name for name, g in zip(trainer.state.params, grads)
                 if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    opt = make_optimizer(1e-3, warmup=2, total_steps=40)
    replicas = trainer.state.replicas
    trainer.state = TrainState(replicas, [opt.init(list(r.parameters())) for r in replicas])
    step = make_train_step(replicas, opt)
    tensors = trainer.tensors(fixed)
    history = [float(step(trainer.state, *tensors)["ce"]) for _ in range(20)]
    report = dict(wall_s=wall, steps=len(steps), per_step=per_step, want_step_launches=want,
                  n_params=len(grads), params_without_finite_nonzero_grad=bad_grads,
                  ce_first=history[0], ce_last=history[-1], ce_history=history)
    emit("float32", run="train --config tiny", **report)
    if len(steps) != 6 or bad or cfg_out != TINY_CONFIG or bad_grads \
            or not history[-1] < 0.7 * history[0]:
        raise RuntimeError(f"float32 train: {len(steps)} steps, steps {bad} launched other "
                           f"than {want}, config {cfg_out}, parameters without a finite "
                           f"nonzero gradient {bad_grads}, CE {history[0]} -> {history[-1]}")
    return report, out


def _tiny_eval(torch, ckpt: str, int8: bool = False, phase: str = "float32") -> dict:
    """``eval`` of a tiny checkpoint on 60 reads through the CLI (``int8``:
    with ``--int8``): every batch runs the SIMT K4 of its dtype once and the
    block's n_layers times (the SIMT int8 K10 and K11 under int8), K5 once,
    no Hopper kernel; the result is finite. A tiny model trained for 6 steps
    is no corrector: its identity is reported, not held to a bar."""
    import math

    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.ops import cuda as kernels

    cfg, _ = load_model(ckpt)
    buf = io.StringIO()
    torch.cuda.synchronize()
    before = kernels.launch_counts.snapshot()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), _one_simulation() as shared:
        cli.main(["eval", ckpt, *EVAL_ARGS, *SMALL_SIZE, *(["--int8"] if int8 else [])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = kernels.launch_counts.snapshot()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    res = json.loads(buf.getvalue())
    n_b = launches.get(_tiny_entry(cfg), 0)
    want = {_tiny_entry(cfg): n_b, "count_decisions": n_b,
            **{k: n * n_b for k, n in _tiny_block_launches(cfg, int8=int8).items()}}
    emit(phase, run="eval tiny" + (" --int8" if int8 else ""),
         wall_s=wall, shared_simulation=shared, n_reads=res["n_reads"],
         raw_identity=res["raw_identity"], corrected_identity=res["corrected_identity"],
         launches=launches, want_launches=want)
    if n_b == 0 or launches != want or res["n_reads"] == 0 \
            or not math.isfinite(res["corrected_identity"]):
        raise RuntimeError(f"{phase} eval: launches {launches} (want {want}), reads "
                           f"{res['n_reads']}, identity {res['corrected_identity']}")
    return dict(res, launches=launches)


def _tiny_inference_tp(torch, tmp: str, e2e: dict, ckpt: str, int8: bool = False,
                      phase: str = "float32") -> dict:
    """``inference -m <tiny checkpoint>`` through the CLI on the e2e reads
    (alignments of 16 targets from the stub aligner), on one device and with
    ``--devices 2 --tp 2``, both shards on ``cuda:0``: the SIMT kernels of
    the checkpoint's dtype launched (K4's once a shard and batch, the
    block's n_layers times a shard and batch, K5 once a batch) and no Hopper
    kernel; in float32 the same records. ``int8``: with ``--int8``, the SIMT
    int8 K10 and K11 (its two modes on a shard) in the block. Under int8 or
    bf16 the share of records the two write alike is reported
    (``phase_int8_any`` and ``phase_bf16_any`` hold the classes to their
    bars)."""
    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel import mesh as mesh_mod

    cfg, _ = load_model(ckpt)
    tag8 = f"{cfg.dtype}{'_int8' if int8 else ''}"
    env = _stub_minimap2(os.path.join(tmp, f"{tag8}_stub"), e2e["rows"])
    runs = {}
    local_devices = mesh_mod.local_devices
    flag = ["--int8"] if int8 else []
    for tag, extra in (("single", []), ("tp2", ["--devices", "2", "--tp", "2"])):
        out = os.path.join(tmp, f"tiny_{tag}_{tag8}.fasta")
        err = io.StringIO()
        torch.cuda.synchronize()
        before = kernels.launch_counts.snapshot()
        t0 = time.perf_counter()
        # one card: the count names cuda:0 as often, as the parallel phase's meshes do
        mesh_mod.local_devices = lambda spec, device="cuda": [torch.device("cuda", 0)] * max(
            int(spec), 1)
        try:
            with _env(PATH=env["PATH"], STUB_MAX_TARGETS="16"), \
                    contextlib.redirect_stderr(err):
                cli.main(["inference", "-m", ckpt, "-w", "4096", "-b", "32", *extra, *flag,
                          e2e["fastq"], out])
        finally:
            mesh_mod.local_devices = local_devices
        torch.cuda.synchronize()
        after = kernels.launch_counts.snapshot()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        tp = 2 if extra else 1
        n_b = launches.get("count_decisions", 0)
        want = {_tiny_entry(cfg): tp * n_b, "count_decisions": n_b,
                **{k: n * n_b for k, n in _tiny_block_launches(cfg, tp, int8).items()}}
        runs[tag] = dict(wall_s=time.perf_counter() - t0, launches=launches,
                         want_launches=want, records=_fasta_records(out),
                         summary=err.getvalue().strip().splitlines()[-1])
    same = runs["tp2"]["records"] == runs["single"]["records"]
    alike = len(set(runs["tp2"]["records"]) & set(runs["single"]["records"])) / max(
        len(runs["single"]["records"]), 1)
    emit(phase, run=f"inference tiny {cfg.dtype} --tp 2" + (" --int8" if int8 else ""),
         records_equal=same,
         share_of_records_alike=alike, n_records=len(runs["single"]["records"]),
         **{tag: {k: v for k, v in r.items() if k != "records"} for tag, r in runs.items()})
    bad = [tag for tag, r in runs.items() if r["launches"] != r["want_launches"]
           or not r["launches"].get("count_decisions")]
    if bad or not (same or int8 or cfg.dtype != "float32") or not runs["single"]["records"]:
        raise RuntimeError(f"{phase} inference (int8 {int8}): launches off in {bad}, records "
                           f"equal {same}, {len(runs['single']['records'])} records")
    return runs


def _f32_attention(torch) -> dict:
    """``attention(impl="auto")`` on float32 CUDA tensors at TINY_CONFIG's
    head dim, B=32, L=9216, no band: the float32 kernel's K9 mode, once."""
    from herro_tpu_torch.ops import attention as attn
    from herro_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(98)
    q, k, v = (torch.randn(B, 2, L, 16, generator=g, device=dev) for _ in range(3))
    lengths = torch.randint(int(0.7 * L), L + 1, (B,), generator=g, device=dev).int()
    torch.cuda.synchronize()
    before = kernels.launch_counts.snapshot()
    out = attn.attention(q, k, v, lengths, None, impl="auto")
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    launches = {k_: after[k_] - before[k_] for k_ in after if after[k_] != before[k_]}
    ref = attn._flash_attention_plain(q[:1], k[:1], v[:1], lengths[:1])
    n = int(lengths[0])
    err = float((out[:1, :, :n] - ref[:, :, :n]).abs().max())
    emit("float32", run="attention", shape=[B, 2, L, 16], local_window=None,
         launches=launches, max_abs_err=err, tol=F32_ATOL)
    if launches != {"flash_f32_attention": 1} or not err <= F32_ATOL:
        raise RuntimeError(f"float32 attention: launches {launches}, error {err}")
    return launches


# the lengths at which the distilled student's step is timed beside its
# teacher's at L (student_steps)
STUDENT_LENGTHS = (1024, 4608, 9216)


def student_steps(torch, student: str, phase: str = "float32") -> dict:
    """The correct step (``make_correct_step_packed``, S=256) at B=32 of a
    float32 tiny checkpoint, distill's default student, at each of
    ``STUDENT_LENGTHS``, beside its teacher's (``model_r10_sim``, bf16 on the
    Hopper kernels) at L=9216, by the port's step timer
    (``pipeline/steptime.py:time_step``): ms a step, windows/s and one step's
    launches (the student's the float32 kernels alone, the teacher's the
    e2e run's kernels). One JSON line; raises on other launches or
    non-finite outputs."""
    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.pipeline.infer import make_correct_step_packed
    from herro_tpu_torch.pipeline.steptime import example_batch, time_step

    dev = torch.device("cuda", 0)
    report, bad = {}, []
    runs = [("student", student, n) for n in STUDENT_LENGTHS] + [("teacher", CKPT, L)]
    for role, ckpt, n in runs:
        cfg, sd = load_model(ckpt)
        model = CorrectionModel(cfg)
        model.load_state_dict(sd)
        step = make_correct_step_packed(model.to(dev).eval())
        sets = [[torch.from_numpy(a).to(dev) for a in example_batch(B, n, 256, seed=s)]
                for s in (5, 6)]
        with torch.inference_mode():
            torch.cuda.synchronize()
            before = kernels.launch_counts.snapshot()
            info, _ = step(*sets[0])
            torch.cuda.synchronize()
            after = kernels.launch_counts.snapshot()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = ({_tiny_entry(cfg): 1, **_tiny_block_launches(cfg), "count_decisions": 1}
                if role == "student" else
                {k: (1 if k in ("entry_embed", "count_decisions") else cfg.n_layers)
                 for k in E2E_KERNELS})
        timed = time_step(step, sets, B, iters=5)
        report[f"{role} L={n}"] = dict(dtype=cfg.dtype, ms=timed["ms"],
                                       windows_per_s=timed["windows_per_s"], launches=launches)
        if launches != want or not bool(torch.isfinite(info).all()):
            bad.append((role, n, launches, want))
        del model, step, sets
        torch.cuda.empty_cache()
    emit(phase, run="student and teacher steps", card=nvidia_smi(), B=B, S=256,
         student=student, teacher=CKPT, **report)
    if bad:
        raise RuntimeError(f"student/teacher steps: launches or outputs wrong: {bad}")
    return report


def phase_float32(torch, tmp: str, e2e: dict, results: dict) -> dict:
    """float32 and head dim 16 on the card: the four float32 kernels against
    their plain versions (``simt_cases``; the rows join the kernels
    phase's report), then the path, counted from 0: the tiny and float32-r10
    goldens against the frozen JAX logits, ``distill`` with no
    ``--student`` (the default tiny), ``train --config tiny``, ``eval`` of
    the tiny checkpoint it wrote, ``inference`` of it on one device and
    over TP 2, and ``attention()`` in float32; then that checkpoint's step
    beside its teacher's (``student_steps``) and ``HERRO_TPU_PALLAS=0``
    refused on the card. Returns the path's launches and the tiny
    checkpoint ``train`` wrote."""
    from herro_tpu_torch.models.model import TINY_CONFIG
    from herro_tpu_torch.ops import cuda as kernels

    t0 = time.perf_counter()
    results["kernels"] += run_cases(torch, simt_cases(torch, "float32"), "float32")
    torch.cuda.empty_cache()
    rows_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    _f32_golden_runs(torch)
    distill = _distill_run(torch, tmp, None)
    want = {k: n * 4 for k, n in _f32_want_step(TINY_CONFIG).items()}
    emit("float32", run="distill, default student", wall_s=distill["wall_s"],
         teacher_launches=distill["teacher"], student_launches=distill["student"],
         want_student_launches=want, student_config=distill["cfg"].__dict__,
         summary=distill["summary"])
    missing = [k for k in E2E_KERNELS if not distill["teacher"].get(k)]
    if missing or distill["student"] != want or distill["cfg"] != TINY_CONFIG:
        raise RuntimeError(f"float32 distill: teacher kernels never launched {missing}; "
                           f"student launches {distill['student']}, expected {want}; "
                           f"student config {distill['cfg']}")
    _, tiny_ckpt = _f32_train(torch, tmp)
    _tiny_eval(torch, tiny_ckpt)
    _tiny_inference_tp(torch, tmp, e2e, tiny_ckpt)
    _f32_attention(torch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts.snapshot()
    student_steps(torch, tiny_ckpt)  # off the counted path: the teacher's kernels too
    _f32_knob_runs(torch)
    emit("float32", run="phase", seconds=time.perf_counter() - t0, kernel_rows_s=rows_s,
         path_launches={k: n for k, n in launches.items() if n})
    return launches, tiny_ckpt


# the SIMT int8 kernels (K10 and K11 for float32, or bf16 at widths the
# Hopper instances lack; csrc/*_q_simt.cu) and their entry points
SIMT8_KERNELS = {"ln_qkv_rope_q_simt": ("ln_qkv_rope_q_simt",),
                 "ln_ffn_q_simt": ("ln_ffn_q_simt", "ln_ffn_q_simt_rowmax",
                                   "ln_ffn_q_simt_rowscale")}
# tag -> (d, H, D, d_ff, dtype): model_r10_sim's widths in float32,
# TINY_CONFIG, and the d384x5L probe shape in bf16
SIMT8_WIDTHS = {"r10": (512, 4, 128, 1024, "float32"), "tiny": (32, 2, 16, 64, "float32"),
                "d384": (384, 3, 128, 1280, "bfloat16")}
# The int8 forwards against herro_tpu's frozen int8 logits (tests/torch_data/
# golden_*_int8.npz), over the supported columns: the largest |dlogit| and
# |dinfo|, and the share of columns whose class differs. The port's plain
# version on the CPU reads 0.0149 / 0.0145 and 0 of 417 (tiny), 0.0174 /
# 0.0253 and 0 of 22 (r10 in float32); a column one int8 step apart moves by
# about 0.02. Room for the card's own LayerNorm order: 0.05, and 1 column in
# 40 (MAX_FLIPPED of tests/test_torch_int8_parallel.py).
INT8_GOLDEN_BARS = dict(max_dlogit=0.05, max_dinfo=0.05, flipped_share=1 / 40)
INT8_GOLDENS = {  # name -> (checkpoint, frozen int8 outputs, inputs, dtype forced)
    "tiny": (F32_GOLDENS["tiny"][0], "golden_tiny_int8.npz",
             os.path.join(F32_DATA, "golden_tiny_f32.npz"), None),
    "r10_f32": (CKPT, "golden_r10_int8.npz", GOLDEN, "float32"),
}
TP_INT8_MIN_AGREE = 0.9999  # int8 at tp 2 against one device, classes


def int8_simt_cases(torch) -> dict:
    """The SIMT int8 kernels against their plain versions at B=32: K10 and
    K11 at model_r10_sim's widths in float32 (L=9216), TINY_CONFIG's (L=9216
    and 1024) and d384x5L's in bf16 (L=9216), K10 at the head count and K11's
    two modes at the d_ff of a tp 2 shard (r10 and tiny, L=9216, the shard 0
    weights quantized as ``TensorParallelModel`` quantizes them). Each is held
    to the int8 rule: within 2^-6 of the largest output, and its share of
    differing outputs at most twice the plain version's own when LayerNorm
    sums in float64. Bound: bytes, or int8 operations on the int8 tensor
    cores, the __dp4a rate's bound beside it; the library call is
    torch._int_mm of quant(LN(x)) @ W alone."""
    from herro_tpu_torch.ops import fused

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4343)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def ln_rows_i8(xs, s, b):
        return fused._quant_rows(fused.layernorm(xs, s, b).float().view(-1, xs.shape[-1]))[0]

    def qkv_case(xs, s, b, wq, sc, bq, heads):
        ts, dd, n = xs.shape[0] * xs.shape[1], xs.shape[-1], wq.shape[1]
        args = (xs, s, b, wq, sc, bq, heads)
        return dict(
            name="ln_qkv_rope_q_simt", replaces=QKV_REPLACES["ln_qkv_rope_q"],
            kernel=lambda: fused._ln_qkv_rope_q_simt_cuda(*args),
            plain=lambda: fused._ln_qkv_rope_q_plain(*args),
            floor=lambda: float64_layernorm_sums(fused, fused._ln_qkv_rope_q_plain, *args),
            library=("torch._int_mm quant(LN(x))[T,d] @ W_qkv[d,3HD] int8 -> int32, the "
                     "dominant product only (partial: no LN, quantization, scales, rope)",
                     lambda y_i8: torch._int_mm(y_i8, wq), lambda: ln_rows_i8(xs, s, b)),
            bound=bound((ts * dd + ts * n) * xs.element_size() + dd * n + n * 8,
                        2 * ts * dd * n, PEAK_INT8),
            extra=lambda: dp4a_bound((ts * dd + ts * n) * xs.element_size() + dd * n + n * 8,
                                     2 * ts * dd * n),
            share_differing=True, iters=10,
        )

    def ffn_case(xs, s, b, w1q, s1q, b1q, w2q, s2q, b2q):
        ts, dd, ff = xs.shape[0] * xs.shape[1], xs.shape[-1], w1q.shape[1]
        args = (xs, s, b, w1q, s1q, b1q, w2q, s2q, b2q)
        return dict(
            name="ln_ffn_q_simt", replaces="herro_tpu/ops/fused.py:420",
            kernel=lambda: fused._ln_ffn_q_simt_cuda(*args),
            plain=lambda: fused._ln_ffn_q_plain(*args),
            floor=lambda: float64_layernorm_sums(fused, fused._ln_ffn_q_plain, *args),
            library=("torch._int_mm quant(LN(x))[T,d] @ W1[d,f] int8 -> int32, half the "
                     "operations (partial: no LN, quantization, gelu, second product)",
                     lambda y_i8: torch._int_mm(y_i8, w1q), lambda: ln_rows_i8(xs, s, b)),
            bound=bound(2 * ts * dd * xs.element_size() + 2 * dd * ff + (dd + ff) * 8,
                        4 * ts * dd * ff, PEAK_INT8),
            extra=lambda: dp4a_bound(2 * ts * dd * xs.element_size() + 2 * dd * ff
                                     + (dd + ff) * 8, 4 * ts * dd * ff),
            residual=xs, share_differing=True, iters=10,
        )

    cases = {}
    for tag, n in (("r10", L), ("tiny", L), ("tiny", 1024), ("d384", L)):
        d, H, D, f, dt = SIMT8_WIDTHS[tag]
        dt = getattr(torch, dt)
        main = tag == "r10"  # the rows PERF.md keeps as each kernel's own

        def key(name, *labels):
            labels = [tag, *labels] + ([] if n == L else [f"L={n}"])
            return f"{name}[{', '.join(labels)}]"

        x = randn(B, n, d, dtype=dt)
        ln_s, ln_b = 1.0 + randn(d, std=0.1), randn(d, std=0.1)
        w_qkv, b_qkv = randn(d, 3 * H * D, std=d ** -0.5, dtype=dt), randn(3 * H * D, std=0.25,
                                                                          dtype=dt)
        w1, b1 = randn(d, f, std=d ** -0.5), randn(f, std=0.25)
        w2, b2 = randn(f, d, std=f ** -0.5), randn(d, std=0.25)
        wq, sq = fused.quantize_weight(w_qkv)
        (q1, s1), (q2, s2) = fused.quantize_weight(w1), fused.quantize_weight(w2)
        cases["ln_qkv_rope_q_simt" if main else key("ln_qkv_rope_q_simt")] = qkv_case(
            x, ln_s, ln_b, fused.k_major(wq), sq, b_qkv, H)
        cases["ln_ffn_q_simt" if main else key("ln_ffn_q_simt")] = ffn_case(
            x, ln_s, ln_b, fused.k_major(q1), s1, b1, fused.k_major(q2), s2, b2)
        if tag == "d384" or n != L:
            continue
        # a tp 2 shard: H / 2 heads of qkv, d_ff / 2 of W1's columns and W2's
        # rows (W2's column scales over the whole width), b2 / 2, x / 2, the
        # row maxima of the whole width's hidden
        h, fl = H // 2, f // 2
        wq_h, sq_h = fused.quantize_weight(
            w_qkv.reshape(d, 3, H, D)[:, :, :h].reshape(d, 3 * h * D))
        cases[key("ln_qkv_rope_q_simt", f"H={h}")] = qkv_case(
            x, ln_s, ln_b, fused.k_major(wq_h), sq_h,
            b_qkv.reshape(3, H, D)[:, :h].reshape(-1).contiguous(), h)
        hmax = fused._ffn_q_hidden(x, ln_s, ln_b, q1, s1, b1).abs().amax(dim=-1).view(
            x.shape[:-1])
        head = (x, ln_s, ln_b, fused.k_major(q1[:, :fl]), s1[:fl].contiguous(),
                b1[:fl].contiguous())
        tail = (fused.k_major(q2[:fl]), s2, b2 / 2, hmax, 0.5)
        for name, c in ffn_q_mode_cases(torch, f"{tag}, f={fl}", head, tail, ln_rows_i8,
                                        simt=True).items():
            cases[name] = dict(c, iters=10)
    return cases


def _int8_golden_runs(torch) -> dict:
    """The tiny and float32-r10 int8 forwards on the frozen inputs against
    herro_tpu's frozen int8 logits, within ``INT8_GOLDEN_BARS``, launching
    the float32 entry and attention and the SIMT int8 K10 and K11, n_layers
    times each, and nothing else."""
    import numpy as np

    out = {}
    for name, (ckpt, frozen, inputs, dtype) in INT8_GOLDENS.items():
        want = np.load(os.path.join(F32_DATA, frozen))
        fx = np.load(inputs)
        run = _golden_forward(torch, ckpt, fx, dtype, int8=True)
        cfg, mask = run["cfg"], fx["support_mask"]
        gap = dict(n=int(mask.sum()),
                   flipped=int(((run["logits"].argmax(-1) != want["logits"].argmax(-1))
                                & mask).sum()),
                   max_dlogit=float(np.abs(run["logits"] - want["logits"])[mask].max()),
                   max_dinfo=float(np.abs(run["info"] - want["info"])[mask].max()))
        want_launches = {"entry_embed_f32": 1, **_tiny_block_launches(cfg, int8=True)}
        emit("int8_any", run="golden", model=name, bars=INT8_GOLDEN_BARS, **gap,
             launches=run["launches"], want_launches=want_launches)
        bars = INT8_GOLDEN_BARS
        if not (gap["max_dlogit"] <= bars["max_dlogit"] and gap["max_dinfo"] <= bars["max_dinfo"]
                and gap["flipped"] <= bars["flipped_share"] * gap["n"]
                and np.isfinite(run["logits"][mask]).all()) \
                or run["launches"] != want_launches:
            raise RuntimeError(f"int8 golden {name}: {gap} against {bars}, launches "
                               f"{run['launches']} (want {want_launches})")
        out[name] = gap
    return out


def _int8_tp_agreement(torch, e2e: dict, tiny_ckpt: str) -> dict:
    """int8 at tp 2 (``CorrectionRunner(mesh=...)``, both shards on
    ``cuda:0``) against one device's int8 step: the tiny checkpoint on its
    golden batch and on every batch of the e2e run, float32 r10 on its
    golden batch. Classes agree on at least ``TP_INT8_MIN_AGREE`` of the
    supported columns, decisions are equal, and each shard runs the SIMT
    K10 and K11's two modes n_layers times a batch."""
    import numpy as np

    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel import make_mesh_2d
    from herro_tpu_torch.pipeline.batching import Batch
    from herro_tpu_torch.pipeline.infer import CorrectionRunner

    dev = torch.device("cuda", 0)
    report, failed = {}, []
    for name, ckpt, inputs, dtype in (
            ("tiny", tiny_ckpt, INT8_GOLDENS["tiny"][2], None),
            ("r10_f32", CKPT, GOLDEN, "float32")):
        cfg, params = load_model(ckpt)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        single = CorrectionRunner(cfg, params, int8=True, device=dev)
        tp = CorrectionRunner(cfg, params, int8=True, device=dev,
                              mesh=make_mesh_2d(1, 2, [dev, dev]))
        fx = np.load(inputs)
        golden = Batch(fx["tokens_packed"], fx["quals"], fx["support_idx"], fx["support_mask"],
                       fx["n_alns"], windows=[])
        ref = single._fetch(single.dispatch(golden))[1]
        torch.cuda.synchronize()
        before = kernels.launch_counts.snapshot()
        got = tp._fetch(tp.dispatch(golden))[1]
        torch.cuda.synchronize()
        after = kernels.launch_counts.snapshot()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = {"entry_embed_f32": 2, "count_decisions": 1, **_tiny_block_launches(cfg, 2, True)}
        agree, dec = _agreement(got, ref, fx["support_mask"])
        n_sup = int(fx["support_mask"].sum())
        rep = dict(golden_class_agreement=agree, golden_decisions_equal=dec,
                   golden_supported_columns=n_sup, launches=launches, want_launches=want,
                   tp_fast_path=tp.tp_fast_path)
        if name == "tiny":  # every batch of the e2e run, against one device
            recorded = []
            fetch = tp._fetch

            def recording_fetch(inflight, fetch=fetch, recorded=recorded):
                info, packed = fetch(inflight)
                recorded.append((inflight.batch, packed))
                return info, packed

            tp._fetch = recording_fetch
            _counted_run(torch, e2e["reads"], e2e["grouped"], tp,
                         os.path.join(os.path.dirname(e2e["fasta"]), "tiny_int8_tp2.fasta"))
            del tp._fetch
            n_e2e = n_agree = 0
            for batch, packed in recorded:
                a, d_eq = _agreement(packed, single._fetch(single.dispatch(batch))[1],
                                     batch.support_mask)
                k = int(batch.support_mask.sum())
                n_e2e, n_agree = n_e2e + k, n_agree + a * k
                dec = dec and d_eq
            agree = min(agree, n_agree / max(n_e2e, 1))
            rep.update(e2e_class_agreement=n_agree / max(n_e2e, 1), e2e_supported_columns=n_e2e,
                       e2e_batches=len(recorded), decisions_equal=dec)
        emit("int8_any", run="tp 2 against one device", model=name, **rep)
        if agree < TP_INT8_MIN_AGREE or not dec or launches != want or not tp.tp_fast_path:
            failed.append(f"{name} {rep}")
        report[name] = rep
        del single, tp
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError("int8 tp 2: " + "; ".join(failed))
    return report


def _int8_d384_step(torch) -> dict:
    """One correct step of a seeded d384x5L config (d 384, H 3 x D 128, d_ff
    1280, 5 layers, band 512; tools/variant_step_time_torch.py) in bf16 under
    int8 at B=32, L=9216, S=256: the bf16 entry and attention (K4, K2 at
    (3, 384)) and the SIMT int8 K10 and K11, 5 times each, K5 once; finite
    outputs; then its ms by the port's step timer."""
    from herro_tpu_torch.models.model import R10_CONFIG, CorrectionModel
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.ops.fused import flash_kernel_name
    from herro_tpu_torch.pipeline.infer import make_correct_step
    from herro_tpu_torch.pipeline.steptime import example_batch, time_step

    cfg = dataclasses.replace(R10_CONFIG, d_model=384, n_layers=5, n_heads=3, d_ff=1280,
                              int8=True)
    model = CorrectionModel(cfg, generator=torch.Generator().manual_seed(0)).cuda().eval()
    step = make_correct_step(model)
    sets = [[torch.from_numpy(a).cuda() for a in example_batch(B, L, 256, seed=s)]
            for s in (3, 4)]
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = kernels.launch_counts.snapshot()
        info, classes, _ = step(*sets[0])
        torch.cuda.synchronize()
        after = kernels.launch_counts.snapshot()
        timed = time_step(step, sets, B, iters=5)
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    want = {"entry_embed": 1, "ln_qkv_rope_q_simt": 5, flash_kernel_name(cfg.local_window): 5,
            "ln_ffn_q_simt": 5, "count_decisions": 1}
    finite = bool(torch.isfinite(info).all())
    emit("int8_any", run="d384x5L int8 step", card=nvidia_smi(), B=B, L=L, S=256,
         ms=timed["ms"], windows_per_s=timed["windows_per_s"], launches=launches,
         want_launches=want, finite=finite)
    if launches != want or not finite:
        raise RuntimeError(f"d384 int8 step: launches {launches} (want {want}), finite {finite}")
    return timed


def _int8_train_step(torch, tmp: str, tiny_ckpt: str) -> dict:
    """One int8 train step of the tiny checkpoint under autograd on the
    ``train`` phase's windows (batch 8): the forward through the SIMT int8
    kernels, K4's float32 kernel once and the block's n_layers x 2 (remat),
    nothing else; a finite loss and every parameter a finite gradient."""
    import pickle

    from herro_tpu_torch.models.checkpoint import load_or_init
    from herro_tpu_torch.training.data import TRAIN_BUCKETS, collate_train
    from herro_tpu_torch.training.train import Trainer, loss_fn

    cfg, params = load_or_init(tiny_ckpt)
    cfg = dataclasses.replace(cfg, int8=True)
    with open(os.path.join(tmp, "train_windows.pkl"), "rb") as fh:
        windows = pickle.load(fh)
    trainer = Trainer(cfg, params, device="cuda")
    batch = collate_train(windows[:8], *TRAIN_BUCKETS[0])
    loss, _ = loss_fn(trainer.model, *trainer.tensors(batch), 0.1, 0.0)
    grads = torch.autograd.grad(loss, list(trainer.state.params.values()))
    bad_grads = [n for n, g_ in zip(trainer.state.params, grads)
                 if not bool(torch.isfinite(g_).all())]
    steps: list = []
    with _timed_steps(torch, steps):
        trainer.train_step(batch)
    per_step = _step_times(steps)
    want = {"entry_embed_f32": 1,
            **{k: 2 * n for k, n in _tiny_block_launches(cfg, int8=True).items()}}
    emit("int8_any", run="tiny int8 train step", L=per_step[0]["L"], ms=per_step[0]["ms"],
         ce=per_step[0]["ce"], launches=per_step[0]["launches"], want_launches=want,
         params_without_finite_grad=bad_grads, loss=float(loss.detach()))
    if per_step[0]["launches"] != want or bad_grads or not torch.isfinite(loss):
        raise RuntimeError(f"tiny int8 train step: launches {per_step[0]['launches']} (want "
                           f"{want}), parameters without a finite gradient {bad_grads}")
    return per_step[0]


def phase_int8_any(torch, tmp: str, e2e: dict, tiny_ckpt: str, results: dict) -> dict:
    """int8 at float32 and at every width, through the SIMT int8 kernels: each
    against its plain version (``int8_simt_cases``; the rows join the
    kernels phase's report); int8 at tp 2 against one device (classes; its
    e2e run counts its launches from 0 on its own); then the path, counted
    from 0: the tiny and float32-r10 int8 goldens, ``inference --int8`` of
    the ``float32`` phase's tiny checkpoint on one device and with
    ``--devices 2 --tp 2``, ``eval --int8`` of it, one d384x5L int8 step and
    one tiny int8 train step. Returns the path's launches."""
    from herro_tpu_torch.ops import cuda as kernels

    t0 = time.perf_counter()
    results["kernels"] += run_cases(torch, int8_simt_cases(torch), "int8_any")
    torch.cuda.empty_cache()
    rows_s = time.perf_counter() - t0
    _int8_tp_agreement(torch, e2e, tiny_ckpt)  # its own launches, from its own run
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    _int8_golden_runs(torch)
    _tiny_inference_tp(torch, tmp, e2e, tiny_ckpt, int8=True, phase="int8_any")
    _tiny_eval(torch, tiny_ckpt, int8=True, phase="int8_any")
    _int8_d384_step(torch)
    _int8_train_step(torch, tmp, tiny_ckpt)
    torch.cuda.synchronize()
    launches = kernels.launch_counts.snapshot()
    emit("int8_any", run="phase", seconds=time.perf_counter() - t0, kernel_rows_s=rows_s,
         path_launches={k: n for k, n in launches.items() if n})
    return launches


# the bf16 SIMT instances (bf16 at the widths and head dims no Hopper
# instance takes; csrc/*_bf16.cu) and their entry points
BF16_KERNELS = {"entry_embed_bf16": ("entry_embed_bf16",),
                "ln_qkv_rope_bf16": ("ln_qkv_rope_bf16", "ln_qkv_rope_bf16_split"),
                "flash_bf16": ("flash_bf16", "flash_bf16_full", "flash_bf16_attention"),
                "ln_ffn_bf16": ("ln_ffn_bf16",)}


def _bf16_maker():
    """``tests/torch_data/make_bf16_golden.py``: the frozen bf16 goldens'
    inputs and the port's r10h64 (it imports JAX only inside the functions
    that build the files)."""
    spec = importlib.util.spec_from_file_location(
        "make_bf16_golden", os.path.join(F32_DATA, "make_bf16_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_block_launches(name: str, n_layers: int, tp: int = 1) -> dict:
    """A forward's launches of tiny (every kernel its bf16 SIMT instance) or
    r10h64 (K1 and K2 SIMT, K4 and K3 the Hopper ones at d 512) in bf16, on
    each of ``tp`` shards."""
    if name == "tiny":
        return {"entry_embed_bf16": tp, "ln_qkv_rope_bf16": n_layers * tp,
                "flash_bf16_full": n_layers * tp, "ln_ffn_bf16": n_layers * tp}
    return {"entry_embed": tp, "ln_qkv_rope_bf16": n_layers * tp,
            "flash_bf16": n_layers * tp, "ln_ffn": n_layers * tp}


def _bf16_golden_runs(torch) -> None:
    """tiny in bf16 and r10h64 on the frozen inputs against herro_tpu's bf16
    logits of ``tests/torch_data`` (``make_bf16_golden.py``): the class on
    every supported column, max |dlogit| and |dinfo| at most twice the CPU
    plain route's gap the file records; tiny also under
    ``HERRO_TPU_ROPE=split`` (the table route's gap, to the bit). Then both at
    tp 2 (``TensorParallelModel`` over ``cuda:0`` twice): the classes agree
    with the file's on at least ``TP_MIN_AGREE`` of the supported columns,
    the gap reported. Each run launches what ``_bf16_block_launches``
    says and nothing else."""
    import numpy as np

    mk = _bf16_maker()
    dev = torch.device("cuda", 0)
    bad, runs = [], {}
    for name, frozen in (("tiny", mk.TINY_GOLDEN), ("r10h64", mk.R10H64_GOLDEN)):
        want = np.load(frozen)
        recorded = {k: float(want[k]) for k in ("cpu_max_dlogit", "cpu_max_dinfo")}
        for tp in (1, 2):
            gap = mk.port_gap(name, want, device=dev, tp=tp)
            cfg = gap.pop("cfg")
            want_launches = _bf16_block_launches(name, cfg.n_layers, tp)
            agree = 1 - gap["flipped"] / gap["n"]
            if tp == 1:
                ok = (gap["flipped"] == 0 and gap["max_dlogit"] <= 2 * recorded["cpu_max_dlogit"]
                      and gap["max_dinfo"] <= 2 * recorded["cpu_max_dinfo"])
            else:
                ok = agree >= TP_MIN_AGREE
            ok = ok and gap["finite"] and gap["launches"] == want_launches
            emit("bf16_any", run="golden", model=name, tp=tp, class_agreement=agree,
                 cpu_gap=recorded, bar="2 x cpu_gap, every class" if tp == 1 else
                 f"classes >= {TP_MIN_AGREE}", ok=ok, want_launches=want_launches, **gap)
            runs[(name, tp)] = gap
            if not ok:
                bad.append(f"{name} tp {tp}: {gap}")
    with _env(HERRO_TPU_ROPE="split"):
        split = mk.port_gap("tiny", np.load(mk.TINY_GOLDEN), device=dev)
    same = all(split[k] == runs[("tiny", 1)][k] for k in ("max_dlogit", "max_dinfo", "flipped"))
    want_split = {("ln_qkv_rope_bf16_split" if k == "ln_qkv_rope_bf16" else k): n
                  for k, n in _bf16_block_launches("tiny", split["cfg"].n_layers).items()}
    emit("bf16_any", run="golden", model="tiny", rope="split", launches=split["launches"],
         want_launches=want_split, same_gap_as_table_route=same)
    if not same or split["launches"] != want_split:
        bad.append(f"tiny under HERRO_TPU_ROPE=split: launches {split['launches']}, same {same}")
    if bad:
        raise RuntimeError("bf16 goldens: " + "; ".join(bad))


def _bf16_tiny_checkpoint(tmp: str) -> str:
    """``tests/torch_data/tiny_seed5`` with ``"dtype": "bfloat16"`` in a
    copied ``config.json``."""
    src, out = os.path.join(F32_DATA, "tiny_seed5"), os.path.join(tmp, "tiny_bf16")
    os.makedirs(out)
    shutil.copy(os.path.join(src, "params.msgpack"), out)
    with open(os.path.join(src, "config.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(out, "config.json"), "w") as fh:
        json.dump(dict(cfg, dtype="bfloat16"), fh)
    return out


def _bf16_r10h64_step(torch) -> dict:
    """The r10h64 forward at B=32, L=9216 (S=256) through the correct step,
    on one device and over its tp 2 shards (H 4 x 64, d_ff 512 a shard; both
    on ``cuda:0``): launches (K1 and K2 on the bf16 SIMT instances, K4 and
    K3 on the Hopper ones, K5 once), finite outputs, the TP classes against
    one device's (at least ``TP_MIN_AGREE``, decisions equal), and each
    step's ms by the port's step timer."""
    from herro_tpu_torch.models.model import CorrectionModel
    from herro_tpu_torch.ops import cuda as kernels
    from herro_tpu_torch.parallel.tensor import TensorParallelModel, make_tp_correct_step
    from herro_tpu_torch.pipeline.infer import make_correct_step_packed
    from herro_tpu_torch.pipeline.steptime import example_batch, time_step

    cfg, sd = _bf16_maker().port_r10h64()
    dev = torch.device("cuda", 0)
    model = CorrectionModel(cfg)
    model.load_state_dict(sd)
    steps = {"single": make_correct_step_packed(model.to(dev).eval()),
             "tp2": make_tp_correct_step(TensorParallelModel(cfg, sd, [dev, dev]))}
    sets = [[torch.from_numpy(a).to(dev) for a in example_batch(B, L, 256, seed=s)]
            for s in (5, 6)]
    smask = sets[0][3]
    out, report = {}, {}
    for tag, step in steps.items():
        with torch.inference_mode():
            torch.cuda.synchronize()
            before = kernels.launch_counts.snapshot()
            info, packed = step(*sets[0])
            torch.cuda.synchronize()
            after = kernels.launch_counts.snapshot()
            timed = time_step(step, sets, B, iters=5)
        tp = 2 if tag == "tp2" else 1
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = {**_bf16_block_launches("r10h64", cfg.n_layers, tp), "count_decisions": 1}
        out[tag] = packed.cpu().numpy()
        report[tag] = dict(ms=timed["ms"], windows_per_s=timed["windows_per_s"],
                           launches=launches, want_launches=want,
                           finite=bool(torch.isfinite(info).all()))
    agree, dec = _agreement(out["tp2"], out["single"], smask.cpu().numpy())
    emit("bf16_any", run="r10h64 step", card=nvidia_smi(), B=B, L=L, S=256,
         tp2_class_agreement=agree, tp2_decisions_equal=dec, **report)
    if any(r["launches"] != r["want_launches"] or not r["finite"] for r in report.values()) \
            or agree < TP_MIN_AGREE or not dec:
        raise RuntimeError(f"r10h64 step: {report}, tp 2 agreement {agree}, decisions {dec}")
    return report


def _bf16_attention(torch) -> dict:
    """``attention(impl="auto")`` on bf16 q/k/v at head dims 16, 32 and 64
    (B=8, H=2, L=4096; one example of length 0) under a band of 512, of 40
    and none: one launch of the bf16 SIMT K9 each, within ``compare``'s bf16
    bar of its plain version that rounds P per key tile against the running
    maximum, with at most ``BF16_SIMT_MAX_SHARE`` of the outputs differing,
    on the rows below each length, and 0 on the empty example."""
    from herro_tpu_torch.ops import attention as attn
    from herro_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    n, nb = 4096, 8
    lengths = torch.randint(n // 2, n + 1, (nb,), generator=g, device=dev).int()
    lengths[1] = 0
    keep = (torch.arange(n, device=dev)[None, :] < lengths[:, None])[:, None, :].expand(nb, 2, n)
    total, report, bad = {}, {}, []
    for D in (16, 32, 64):
        q, k, v = (torch.randn(nb, 2, n, D, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        for band in (512, 40, None):
            torch.cuda.synchronize()
            before = kernels.launch_counts.snapshot()
            out = attn.attention(q, k, v, lengths, band, impl="auto")
            torch.cuda.synchronize()
            after = kernels.launch_counts.snapshot()
            launches = {k_: after[k_] - before[k_] for k_ in after if after[k_] != before[k_]}
            want = attn._flash_attention_tiled(q, k, v, lengths, band)
            err, tol, _, _ = compare(torch, out, want, keep)
            share = share_differing(out, want, keep)
            report[f"D={D}, band {band}"] = dict(launches=launches, max_abs_err=err, tol=tol,
                                                 share_differing=share)
            for k_, c in launches.items():
                total[k_] = total.get(k_, 0) + c
            if (launches != {"flash_bf16_attention": 1} or err > tol
                    or share > BF16_SIMT_MAX_SHARE or bool(out[1].any())):
                bad.append(f"D {D} band {band}: {report[f'D={D}, band {band}']}")
    emit("bf16_any", run="attention", shape=[nb, 2, n, "D"], cases=report)
    if bad:
        raise RuntimeError("bf16 attention(): " + "; ".join(bad))
    return total


def _bf16_train(torch, tmp: str, ckpt: str) -> dict:
    """``train --config <tiny bf16 checkpoint>`` through the CLI on the
    ``train`` phase's windows, 2 steps at batch 8 under autograd (the kernel
    forward, the plain backward): each step launches the bf16 SIMT K4 once
    and K1, K7 and K3 n_layers x 2 (remat), nothing else, with a finite CE;
    the checkpoint it writes loads as bf16."""
    import math

    from herro_tpu_torch import cli
    from herro_tpu_torch.models.checkpoint import load_model

    cfg, _ = load_model(ckpt)
    want = {k: (1 if k == "entry_embed_bf16" else 2 * n)
            for k, n in _bf16_block_launches("tiny", cfg.n_layers).items()}
    out = os.path.join(tmp, "trained_tiny_bf16")
    args = dict(zip(TRAIN_ARGS[::2], TRAIN_ARGS[1::2]))
    args.update({"--config": ckpt, "--batch-size": "8", "--steps": "2"})
    steps: list = []
    t0 = time.perf_counter()
    with _timed_steps(torch, steps):
        cli.main(["train", *(a for kv in args.items() for a in kv), "--data-cache",
                  os.path.join(tmp, "train_windows.pkl"), out])
    wall = time.perf_counter() - t0
    per_step = _step_times(steps)
    cfg_out, _ = load_model(out)
    emit("bf16_any", run="train --config tiny bf16", wall_s=wall, per_step=per_step,
         want_step_launches=want, config=cfg_out.__dict__)
    if len(steps) != 2 or any(st["launches"] != want or not math.isfinite(st["ce"])
                              for st in per_step) or cfg_out.dtype != "bfloat16":
        raise RuntimeError(f"bf16 train: {per_step} (want launches {want}), config {cfg_out}")
    return per_step


def _bf16_e2e_unchanged(e2e: dict) -> dict:
    """The bf16 flagship's ``e2e`` run launched only the Hopper instances:
    K4 and K5 34 times, K1-K3 102 (its 34 batches of 3 layers), and no SIMT
    kernel."""
    want = {"entry_embed": 34, "ln_qkv_rope": 102, "flash_outproj": 102, "ln_ffn": 102,
            "count_decisions": 34}
    got = {k: n for k, n in e2e["launches"].items() if n}
    emit("bf16_any", run="e2e launches (bf16 flagship)", launches=got, want_launches=want)
    if got != want:
        raise RuntimeError(f"the bf16 flagship's e2e run launched {got}, not {want}")
    return got


def phase_bf16_any(torch, tmp: str, e2e: dict, results: dict) -> dict:
    """bf16 at every width and head dim, through the bf16 SIMT instances
    (``csrc/*_bf16.cu``): each against its plain version
    (``simt_cases(torch, "bfloat16")``; the rows join the kernels phase's
    report); the bf16 flagship's ``e2e`` launches unchanged; then the path,
    counted from 0: the tiny and r10h64 goldens (one device and tp 2),
    ``inference`` of the tiny checkpoint in bf16 on one device and with
    ``--devices 2 --tp 2``, the same with ``--int8``, the r10h64 step at
    B=32, L=9216 on one device and at tp 2, ``attention()`` at head dims
    16-64, and two ``train`` steps of the tiny bf16 checkpoint. Returns the
    path's launches."""
    from herro_tpu_torch.ops import cuda as kernels

    t0 = time.perf_counter()
    results["kernels"] += run_cases(torch, simt_cases(torch, "bfloat16"), "bf16_any")
    torch.cuda.empty_cache()
    rows_s = time.perf_counter() - t0
    _bf16_e2e_unchanged(e2e)
    ckpt = _bf16_tiny_checkpoint(tmp)
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    _bf16_golden_runs(torch)
    _tiny_inference_tp(torch, tmp, e2e, ckpt, phase="bf16_any")
    _tiny_inference_tp(torch, tmp, e2e, ckpt, int8=True, phase="bf16_any")
    _bf16_r10h64_step(torch)
    _bf16_attention(torch)
    _bf16_train(torch, tmp, ckpt)
    torch.cuda.synchronize()
    launches = kernels.launch_counts.snapshot()
    emit("bf16_any", run="phase", seconds=time.perf_counter() - t0, kernel_rows_s=rows_s,
         path_launches={k: n for k, n in launches.items() if n})
    return launches


# the widths phase's forward goldens: the float32 bar of F32_GOLDENS; the
# kernels of a w768h96 forward in each dtype (every one its SIMT instance),
# one forward: K4 once, the block's n_layers times (band 512: K2's entry)
WIDTHS_F32_BAR = 2e-4


def _widths_maker():
    """``tests/torch_data/make_widths_golden.py``: the w768h96 recipe, the
    frozen golden's inputs and the port's forward against it (it imports
    JAX only inside the functions that build the file)."""
    spec = importlib.util.spec_from_file_location(
        "make_widths_golden", os.path.join(F32_DATA, "make_widths_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _widths_launches(sfx: str, n_layers: int, n_batches: int = 1) -> dict:
    """A w768h96 run's launches in the dtype of ``sfx`` ("f32", "bf16") over
    ``n_batches`` forwards: every kernel its SIMT instance, no Hopper one."""
    return {f"entry_embed_{sfx}": n_batches, f"ln_qkv_rope_{sfx}": n_layers * n_batches,
            f"flash_{sfx}": n_layers * n_batches, f"ln_ffn_{sfx}": n_layers * n_batches}


def _widths_goldens(torch) -> dict:
    """The w768h96 forward on the card against ``golden_w768h96.npz``:
    float32 within ``WIDTHS_F32_BAR`` and every class; bf16 within twice the
    CPU plain route's gap the file records, and the class on every supported
    column but near-ties, columns whose two highest frozen logits lie within
    twice that bar (there a flip is within the bar; herro_tpu's CPU forward
    and the port's differ on one such column, which the file records). Each
    launches its SIMT instances and nothing else."""
    import numpy as np

    mk = _widths_maker()
    want = np.load(mk.GOLDEN)
    cfg = mk.recipe().CONFIG
    if str(want["params_sha256"]) != mk.recipe().digest(mk.recipe().params()):
        raise RuntimeError("widths: the w768h96 recipe no longer gives the golden's parameters")
    mask = mk.inputs()[3]
    out, bad = {}, []
    for dtype, sfx in (("float32", "f32"), ("bfloat16", "bf16")):
        model = mk.port_model("cuda", dtype)
        gap = mk.port_gap(want, dtype, device="cuda", model=model)
        del model
        torch.cuda.empty_cache()
        want_launches = _widths_launches(sfx, cfg["n_layers"])
        if dtype == "float32":
            bars = dict(max_dlogit=WIDTHS_F32_BAR, max_dinfo=WIDTHS_F32_BAR)
            ok = gap["flipped"] == 0
        else:
            bars = dict(max_dlogit=2 * float(want["cpu_max_dlogit"]),
                        max_dinfo=2 * float(want["cpu_max_dinfo"]))
            top = np.sort(want["logits_bf16"], axis=-1)
            near = (top[..., -1] - top[..., -2] <= 2 * bars["max_dlogit"]) & mask
            gap["near_ties"] = int(near.sum())
            gap["flipped_off_near_ties"] = sum(not near[b, c] for b, c in gap["flipped_at"])
            ok = gap["flipped_off_near_ties"] == 0
        ok = ok and gap["finite"] and gap["launches"] == want_launches and all(
            gap[k] <= bar for k, bar in bars.items())
        emit("widths", run="golden", model="w768h96", dtype=dtype, bars=bars,
             cpu_gap={k: float(want[k]) for k in ("cpu_max_dlogit", "cpu_max_dinfo",
                                                    "cpu_flipped")},
             want_launches=want_launches, ok=ok, **gap)
        out[dtype] = gap
        if not ok:
            bad.append(f"{dtype}: {gap}")
    if bad:
        raise RuntimeError("widths goldens: " + "; ".join(bad))
    return out


def _widths_cli(torch, tmp: str, e2e: dict) -> dict:
    """``herro_tpu_torch inference -m <w768h96 checkpoint, bf16>`` in
    process on the e2e reads, every target's alignments from the stub
    aligner: a record for every read the e2e run wrote, the bf16 SIMT
    instances launched (K4 once a batch, the block's n_layers times a batch,
    K5 once a batch) and no Hopper kernel of those ops."""
    from herro_tpu_torch import cli
    from herro_tpu_torch.ops import cuda as kernels

    mk = _widths_maker()
    ckpt = mk.recipe().write_checkpoint(os.path.join(tmp, "w768h96"))
    env = _stub_minimap2(os.path.join(tmp, "w768h96_stub"), e2e["rows"])
    out = os.path.join(tmp, "w768h96.fasta")
    err = io.StringIO()
    torch.cuda.synchronize()
    before = kernels.launch_counts.snapshot()
    t0 = time.perf_counter()
    with _env(PATH=env["PATH"]), contextlib.redirect_stderr(err):
        cli.main(["inference", "-m", ckpt, "-w", "4096", "-b", "32", e2e["fastq"], out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = kernels.launch_counts.snapshot()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    n_b = launches.get("count_decisions", 0)
    want = {"count_decisions": n_b, **_widths_launches("bf16", mk.recipe().CONFIG["n_layers"],
                                                       n_b)}
    names = sorted(r.split(b"\n")[0] for r in _fasta_records(out))
    e2e_names = sorted(r.split(b"\n")[0] for r in _fasta_records(e2e["fasta"]))
    ok = n_b > 0 and launches == want and names == e2e_names
    emit("widths", run="inference w768h96 bf16", wall_s=wall, launches=launches,
         want_launches=want, n_records=len(names), n_e2e_records=len(e2e_names),
         records_for_every_read=names == e2e_names, ok=ok,
         summary=err.getvalue().strip().splitlines()[-1])
    if not ok:
        raise RuntimeError(f"widths inference: launches {launches} (want {want}), "
                           f"{len(names)} records against the e2e run's {len(e2e_names)}")
    return launches


def phase_widths(torch, tmp: str, e2e: dict, results: dict) -> dict:
    """Every width a herro_tpu config.json can ask for up to d_model 1024,
    d_ff 4096 and any head dim a multiple of 16: the SIMT kernels in float32
    and bf16 against their plain versions at B=32, L=9216 (``simt_cases`` at
    ``WIDTHS_PLANS``, one tag at a time; float32 within 1e-4, 2e-4 after a
    projection, bf16 at the 2^-6 share bar; the rows join the kernels
    report under their tags); then the path, counted from 0: the w768h96
    forwards against their golden in float32 and bf16, and one ``inference``
    run of its bf16 checkpoint on the e2e reads. Returns the path's
    launches."""
    from herro_tpu_torch.ops import cuda as kernels

    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for plan in WIDTHS_PLANS:
            results["kernels"] += run_cases(
                torch, simt_cases(torch, dtype, plans=(plan,), labelled=True), "widths",
                quick=True)
            torch.cuda.empty_cache()
    rows_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    _widths_goldens(torch)
    _widths_cli(torch, tmp, e2e)
    torch.cuda.synchronize()
    launches = kernels.launch_counts.snapshot()
    emit("widths", run="phase", seconds=time.perf_counter() - t0, kernel_rows_s=rows_s,
         path_launches={k: n for k, n in launches.items() if n})
    return launches


STUB_MM2 = """#!{python}
import os, sys
# a stand-in for minimap2: replays the simulated PAF rows whose target is in
# the FASTA batch on stdin (at most STUB_MAX_TARGETS of them when set)
names = [l[1:].split()[0] for l in sys.stdin.buffer.read().split(b"\\n") if l[:1] == b">"]
limit = int(os.environ.get("STUB_MAX_TARGETS", "0"))
targets = set(sorted(names)[:limit] if limit else names)
with open({paf!r}, "rb") as fh:
    for row in fh:
        if row.split(b"\\t")[5] in targets:
            sys.stdout.buffer.write(row)
"""


# the committed battery of the JAX package and its key for the flagship; the
# port's standard-regime run joins it under its own key for the gate
BATTERY = os.path.join(ROOT, "resources", "eval_battery.json")
BATTERY_INCUMBENT = "resources/model_r10_sim"
BATTERY_CANDIDATE = "herro_tpu_torch:resources/model_r10_sim"


def _tools_on_path() -> None:
    """The tools directory on ``sys.path``: the ported tools import as modules."""
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)


@contextlib.contextmanager
def _counted(torch, into: dict):
    """Every kernel's launches over the block, counted from 0, into ``into``."""
    from herro_tpu_torch.ops import cuda as kernels

    torch.cuda.synchronize()
    kernels.launch_counts.reset()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        into.update(kernels.launch_counts.snapshot())


def phase_battery(torch) -> dict:
    """The ``standard`` regime of tools/eval_battery_torch.py for the flagship
    (no oracle), at the battery's own size and seed (120 kb, 120 reads,
    batch 16), through tools/merge_battery.py's gate against the committed
    battery's ``model_r10_sim`` entry: Q within 0.2 dB, het accuracy >= 0.99.
    Its counting baseline is compared with the committed one field for
    field. Returns the run's launches."""
    _tools_on_path()
    import eval_battery_torch
    from merge_battery import gate_table

    from herro_tpu_torch.models.checkpoint import load_model

    launches: dict = {}
    t0 = time.perf_counter()
    with _counted(torch, launches):
        res = eval_battery_torch.run_battery([CKPT], ["standard"], with_oracle=False,
                                             device="cuda")
    wall = time.perf_counter() - t0
    with open(BATTERY) as fh:
        bat = json.load(fh)
    entry = bat["regimes"]["standard"]
    got, ref = res["regimes"]["standard"][CKPT], entry[BATTERY_INCUMBENT]
    entry[BATTERY_CANDIDATE] = got
    lines = gate_table(bat, BATTERY_INCUMBENT, BATTERY_CANDIDATE)
    same_params = res["regimes"]["standard"]["params"] == entry["params"]
    counting = got["counting_baseline"]
    counting_equal = counting == ref["counting_baseline"]
    emit("battery", regime="standard", card=nvidia_smi(), wall_s=wall,
         corrected_infix_q=got["corrected_infix_q"],
         reference_corrected_infix_q=ref["corrected_infix_q"],
         delta_db=got["corrected_infix_q"] - ref["corrected_infix_q"],
         het_accuracy=(got.get("het") or {}).get("accuracy"),
         reference_het_accuracy=(ref.get("het") or {}).get("accuracy"),
         model_gain_db=got["model_gain_db"], counting_infix_q=counting["corrected_infix_q"],
         reference_counting_infix_q=ref["counting_baseline"]["corrected_infix_q"],
         counting_baseline_equal=counting_equal, params_equal=same_params, gate=lines,
         launches=launches, result=got)
    cfg, _ = load_model(CKPT)
    _check_block_launches("battery", launches, cfg.n_layers, "flash_outproj", False)
    if not same_params or not lines[-1].startswith("gate: PASS"):
        raise RuntimeError(f"battery: params equal {same_params}; {lines}")
    return launches


def phase_demo(torch) -> dict:
    """tools/demo_record_torch.py: the demo run (seed 777, 150 kb, 160 reads,
    window 4096, batch 16) on the card, every corrected record held by name
    and sha256 against the JAX package's record
    (``tests/torch_data/demo_seed777_herro_tpu.json``): the share of
    byte-identical records and both corrected Qs; the port's may be at most
    0.2 dB below the reference's. Returns the run's launches."""
    _tools_on_path()
    import demo_record_torch

    launches: dict = {}
    with _counted(torch, launches):
        r = demo_record_torch.compare(CKPT, device="cuda")
    emit("demo", card=nvidia_smi(), **r, launches=launches)
    missing = [k for k in E2E_KERNELS if not launches[k]]
    if missing or r["records"] == 0 or r["corrected_q_gap_db"] < -0.2:
        raise RuntimeError(f"demo: kernels never launched {missing}, {r['records']} "
                           f"records, corrected Q {r['corrected_q_gap_db']:+.3f} dB "
                           f"against the reference")
    return launches


def phase_tools(torch, tmp: str) -> dict:
    """Each ported tool once at a reduced size on the card, its launches
    counted from 0: the soup (host only), 4 fine-tune steps at batch 8 on the
    ``train`` phase's windows (K4 once and K1-K3 2 x n_layers a step), the
    systematic audit on 24 reads, the e2e profile on 24 reads, the step-time
    probe at B=32, L=9216 for both shapes (d 384 runs K1-K4's new instances),
    and the ablation's seven variants and three standalone ops at B=8,
    L=2048. Returns the launches summed over the tools."""
    import pickle

    import numpy as np

    _tools_on_path()
    import ablate_fused_torch
    import diag_systematic_torch
    import finetune_sys_torch
    import profile_e2e_torch
    import soup_ckpt_torch
    import variant_step_time_torch

    from herro_tpu_torch.models.checkpoint import load_model
    from herro_tpu_torch.ops import cuda as kernels

    total = {k: 0 for k in kernels.launch_counts.snapshot()}
    failed = []

    def run(tool, fn, want=None, **report):
        launches: dict = {}
        t0 = time.perf_counter()
        with _counted(torch, launches):
            out = fn()
        wall = time.perf_counter() - t0
        for k, v in launches.items():
            total[k] += v
        ok = want is None or all(launches[k] == v for k, v in want.items())
        emit("tools", tool=tool, wall_s=wall, launches={k: v for k, v in launches.items() if v},
             **report, **(out if isinstance(out, dict) else {}))
        if not ok:
            failed.append(f"{tool}: launches {launches}, want {want}")
        return out

    cfg, params = load_model(CKPT)
    soup_dir = os.path.join(tmp, "soup")
    other = os.path.join(ROOT, "resources", "model_r10_sys")

    def soup():
        soup_ckpt_torch.soup(CKPT, other, soup_dir, 0.3)
        cfg_s, got = load_model(soup_dir)
        _, po = load_model(other)
        exact = cfg_s == cfg and all(torch.equal(got[k], 0.7 * v + 0.3 * po[k])
                                     for k, v in params.items())
        if not exact:
            failed.append("soup: the written checkpoint is not 0.7 base + 0.3 other")
        return dict(leaves=len(got), equal_to_mix=exact)

    run("soup_ckpt_torch", soup, want={k: 0 for k in total})

    with open(os.path.join(tmp, "train_windows.pkl"), "rb") as fh:
        windows = pickle.load(fh)
    steps = 4
    want_ft = {k: v * steps for k, v in _want_step_launches(cfg).items()}

    def finetune():
        trainer = finetune_sys_torch.finetune(
            windows[:256], cfg, params, os.path.join(tmp, "finetuned"), steps=steps,
            lr=1e-4, batch_size=8, device="cuda", log_every=1, save_every=2)
        load_model(os.path.join(tmp, "finetuned"))
        return dict(steps=trainer.state.step)

    run("finetune_sys_torch", finetune, want=want_ft)

    def diag():
        rep = diag_systematic_torch.diagnose(
            CKPT, "cuda", dict(diag_systematic_torch.SIM_KW, genome_len=40_000, n_reads=24))
        if not rep["model"]["normal"]["covered"]:
            failed.append("diag_systematic_torch: no column covered")
        return dict(n_hotspots=rep["n_hotspots"], model=rep["model"]["normal"],
                    counting=rep["counting"]["normal"])

    run("diag_systematic_torch", diag)

    def prof():
        r = profile_e2e_torch.profile(24, 40_000, device="cuda")
        return dict({k: r[k] for k in ("windows", "windows_per_s", "batches", "stages",
                                       "featgen_s", "device_stall_s")}, run_s=r["wall_s"])

    run("profile_e2e_torch", prof)

    def variants():
        out = {}
        for name, c in variant_step_time_torch.SHAPES.items():
            r = variant_step_time_torch.step_time(c, B, L, 256, iters=5)
            out[name] = dict(r, n_params=variant_step_time_torch.n_params(c))
            if not np.isfinite(r["checksum"]):
                failed.append(f"variant_step_time_torch {name}: non-finite outputs")
        return dict(card=nvidia_smi(), B=B, L=L, S=256, shapes=out)

    # each shape's step 2 + 5 times (warm-up, then timed): K4 and K5 once a
    # step, K1-K3 once a layer
    n_steps = 7
    layers = sum(c.n_layers for c in variant_step_time_torch.SHAPES.values())
    run("variant_step_time_torch", variants, want={
        "entry_embed": 2 * n_steps, "count_decisions": 2 * n_steps,
        **{k: n_steps * layers for k in ("ln_qkv_rope", "flash_outproj", "ln_ffn")}})

    def ablate():
        with contextlib.redirect_stdout(sys.stderr):  # the tool prints its own table
            v = ablate_fused_torch.ablate(8, 2048, 128)
            ops = {op: ablate_fused_torch.op_standalone(op, 8, 2048, n=5)
                   for op in ("attention_block", "ln_ffn", "counting")}
        return dict(B=8, L=2048, S=128, variants_s=v, ops_s=ops)

    run("ablate_fused_torch", ablate)
    missing = [k for k in E2E_KERNELS if not total[k]]
    if missing or failed:
        raise RuntimeError(f"tools: kernels never launched {missing}; {failed}")
    return total


def _stub_minimap2(tmp: str, rows) -> dict:
    """An environment whose PATH holds the stub aligner; neither minimap2
    nor zstandard is needed to drive the CLI then."""
    bin_dir = os.path.join(tmp, "bin")
    os.makedirs(bin_dir)
    paf = os.path.join(tmp, "all.paf")
    with open(paf, "wb") as fh:
        for r in rows:
            fh.write(r if r.endswith(b"\n") else r + b"\n")
    exe = os.path.join(bin_dir, "minimap2")
    with open(exe, "w") as fh:
        fh.write(STUB_MM2.format(python=sys.executable, paf=paf))
    os.chmod(exe, os.stat(exe).st_mode | stat.S_IEXEC)
    return dict(os.environ, PATH=bin_dir + os.pathsep + os.environ["PATH"],
                PYTHONPATH=ROOT)


def _fasta_records(path: str) -> list[bytes]:
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return sorted(b"\n".join(lines[i : i + 2]) for i in range(0, len(lines) - 1, 2))


SUMMARY_RE = re.compile(
    r"Corrected (\d+) reads in ([\d.]+)s \(featgen ([\d.]+)s, device ([\d.]+)s, "
    r"alignments ([\d.]+)s-([\d.]+)s \((\d+) batches, (\d+) windows\)\)"
)
POOL_RE = re.compile(r"featgen pool: (\d+) of (\d+) workers ran")


def _device_busy_s(profile_dir: str) -> tuple[float, float]:
    """(summed device time of kernels and copies, seconds from the first
    device event's start to the last one's end) of a torch.profiler trace."""
    traces = glob.glob(os.path.join(profile_dir, "*.json"))
    if len(traces) != 1:
        raise RuntimeError(f"expected one trace in {profile_dir}, found {traces}")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        raise RuntimeError(f"no device event in {traces[0]}")
    span = max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)
    return sum(e["dur"] for e in dev) / 1e6, span / 1e6


def _run_inference_cli(env, tmp, tag, fastq, extra) -> dict:
    out = os.path.join(tmp, f"cli_{tag}.fasta")
    cmd = [sys.executable, "-m", "herro_tpu_torch.cli", "inference", "-m", CKPT, "-w",
           "4096", "-b", "32", *extra, fastq, out]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"procpool: {' '.join(cmd)} failed:\n{res.stderr[-4000:]}")
    m = SUMMARY_RE.search(res.stderr)
    if m is None:
        raise RuntimeError(f"procpool: no run summary in:\n{res.stderr[-2000:]}")
    n, wall, featgen, device_wait, first_alns, last_alns, batches, windows = m.groups()
    pool = POOL_RE.search(res.stderr)
    return dict(
        fasta=out, reads_written=int(n), run_s=float(wall), featgen_s=float(featgen),
        device_wait_s=float(device_wait), batches=int(batches), windows=int(windows),
        # when the aligner and the PAF parser gave the first and the last
        # read's alignments, in seconds into the run
        first_alns_s=float(first_alns), last_alns_s=float(last_alns),
        windows_per_s=int(windows) / float(wall), process_s=time.perf_counter() - t0,
        workers_ran=int(pool.group(1)) if pool else 0,
    )


def phase_procpool(tmp: str, e2e: dict) -> int:
    """``inference`` through the CLI in subprocesses: serial featgen against
    ``--feat-gen-procs N``, each once: the serial run plain, the pool's with
    ``--profile-dir`` (its times, and the device's busy share; the serial
    path's share is the ``trace`` phase's; the trace's cost is in the pool's
    times). Returns N."""
    from herro_tpu_torch.pipeline.procpool import can_fork

    cores = os.cpu_count() or 1
    n_procs = min(8, cores - 1)
    if not can_fork() or n_procs < 2:
        raise RuntimeError(f"procpool: fork {can_fork()}, {cores} cores: no pool to run")
    env = _stub_minimap2(tmp, e2e["rows"])
    want = _fasta_records(e2e["fasta"])
    report = {}
    for tag, extra in (("serial", []), ("pool", ["--feat-gen-procs", str(n_procs)])):
        traced_report = {}
        if tag == "pool":
            prof_dir = os.path.join(tmp, f"prof_{tag}")
            plain = _run_inference_cli(env, tmp, tag, e2e["fastq"],
                                       [*extra, "--profile-dir", prof_dir])
            device_s, span_s = _device_busy_s(prof_dir)
            traced_report = dict(
                traced=True, traced_device_s=device_s,
                device_busy_share=device_s / plain["run_s"],
                # from the first batch on the card to the last: leaves out what a
                # short run spends before it (the aligner, CUDA start-up)
                traced_device_span_s=span_s, device_busy_share_in_span=device_s / span_s)
        else:
            plain = _run_inference_cli(env, tmp, tag, e2e["fastq"], extra)
        got = _fasta_records(plain["fasta"])
        if got != want or plain["windows"] != e2e["windows_produced"]:
            raise RuntimeError(
                f"procpool {tag}: {len(got)} records, {plain['windows']} windows; the "
                f"in-process serial run wrote {len(want)} records from "
                f"{e2e['windows_produced']} windows, or their bytes differ"
            )
        same_order = open(plain["fasta"], "rb").read() == open(e2e["fasta"], "rb").read()
        report[tag] = dict(
            {k: plain[k] for k in ("run_s", "windows", "windows_per_s", "featgen_s",
                                   "device_wait_s", "first_alns_s", "last_alns_s",
                                   "batches", "process_s", "workers_ran")},
            **traced_report, records_identical=True, file_bytes_identical=same_order,
        )
    emit("procpool", cores=cores, n_procs=n_procs, **report)
    if report["pool"]["workers_ran"] < n_procs:
        raise RuntimeError(
            f"procpool: {report['pool']['workers_ran']} of {n_procs} workers ran"
        )
    return n_procs


def phase_features(tmp: str, e2e: dict, n_procs: int, n_targets: int = 16) -> None:
    """The ``features`` subcommand with the pool on the first targets of the
    e2e reads; every window loads back to what direct extraction gives."""
    import numpy as np

    from herro_tpu_torch.features.extract import extract_read_features
    from herro_tpu_torch.features.npy import load_window_features

    env = _stub_minimap2(os.path.join(tmp, "features_stub"), e2e["rows"])
    env["STUB_MAX_TARGETS"] = str(n_targets)
    out = os.path.join(tmp, "features")
    cmd = [sys.executable, "-m", "herro_tpu_torch.cli", "features", "-w", "4096",
           "--feat-gen-procs", str(n_procs), e2e["fastq"], out]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"features: {' '.join(cmd)} failed:\n{res.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    reads, grouped = e2e["reads"], e2e["grouped"]
    targets = sorted(reads.ids[rid] for rid in grouped)[:n_targets]
    n_windows = 0
    for name in targets:
        rid = reads.name_to_id[name]
        for wf in extract_read_features(rid, reads, grouped[rid], 4096):
            bases, quals, sup = load_window_features(os.path.join(out, name.decode()),
                                                     wf.wid)
            if not (np.array_equal(bases, wf.bases) and np.array_equal(quals, wf.quals)
                    and np.array_equal(sup, wf.supported)):
                raise RuntimeError(f"features: window {wf.wid} of {name!r} differs")
            n_windows += 1
    n_dirs = len(os.listdir(out))
    emit("features", reads=n_dirs, windows=n_windows, n_procs=n_procs, process_s=wall)
    if n_windows == 0 or n_dirs != len(targets):
        raise RuntimeError(f"features: {n_dirs} read directories, {n_windows} windows")


# the int8 kernels and the counters of their launches over a mesh (K11 under
# tensor parallelism launches its two modes, each counted under its own name)
INT8_KERNELS = {"ln_qkv_rope_q": ("ln_qkv_rope_q",),
                "ln_ffn_q": ("ln_ffn_q_rowmax", "ln_ffn_q_rowscale")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from herro_tpu_torch import native
    from herro_tpu_torch.ops import cuda as kernels

    from herro_tpu_torch.pipeline.infer import keep_float32_exact

    keep_float32_exact(torch.device("cuda"))
    smi = nvidia_smi()
    t0 = time.perf_counter()
    build_s = kernels.build_all()
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), kernels_built=True,
         build_s=build_s, build_and_load_s=time.perf_counter() - t0,
         native_featgen=native.available())

    results: dict = {}
    timed("kernels", phase_kernels, torch, results)
    bf16_logits = timed("golden", phase_golden, torch)
    timed("golden", phase_golden_r10deep, torch)
    with tempfile.TemporaryDirectory() as tmp:
        e2e = timed("e2e", phase_e2e, torch, tmp)
        timed("trace", phase_trace, torch, tmp, e2e)
        timed("cli", phase_cli, torch, tmp, e2e["ds"], e2e["rows"])
        tp_int8_launches = timed("parallel", phase_parallel, torch, tmp, e2e, one_card(torch))
        timed("multihost", phase_multihost, tmp, e2e, one_card(torch, 2))
        evals = timed("eval", phase_eval, torch, tmp)
        battery_launches = timed("battery", phase_battery, torch)
        demo_launches = timed("demo", phase_demo, torch)
        n_procs = timed("procpool", phase_procpool, tmp, e2e)
        timed("features", phase_features, tmp, e2e, n_procs)
        int8_launches = timed("int8", phase_int8, torch, tmp, e2e, evals, bf16_logits)
        split_launches = timed("rope_split", phase_rope_split, torch, tmp, e2e)
        timed("grad", phase_grad, torch)
        timed("train", phase_train, torch, tmp)
        train_parallel_launches = timed("train_parallel", phase_train_parallel, torch, tmp,
                                        one_card(torch))
        timed("distill", phase_distill, torch, tmp)
        f32_launches, tiny_ckpt = timed("float32", phase_float32, torch, tmp, e2e, results)
        simt8_launches = timed("int8_any", phase_int8_any, torch, tmp, e2e, tiny_ckpt, results)
        bf16_launches = timed("bf16_any", phase_bf16_any, torch, tmp, e2e, results)
        widths_launches = timed("widths", phase_widths, torch, tmp, e2e, results)
        tools_launches = timed("tools", phase_tools, torch, tmp)
    attention_launches = timed("attention", phase_attention, torch)

    # launches, each counted from 0 over the run that drives the kernel: K1-K5
    # from the inference run; K7 and K6 from the eval run whose checkpoint
    # takes them; K10 and K11 from the int8 inference run; K8 from the run
    # under HERRO_TPU_ROPE=split; K9 from attention()
    launches = {k: e2e["launches"][k] for k in E2E_KERNELS}
    launches["flash_outproj_full"] = \
        evals["model_r10_sim[local_window=None]"]["launches"]["flash_outproj_full"]
    launches["flash_outproj_band"] = \
        evals["model_r10_sim[local_window=384]"]["launches"]["flash_outproj_band"]
    launches["ln_qkv_rope_q"] = int8_launches["ln_qkv_rope_q"]
    launches["ln_ffn_q"] = int8_launches["ln_ffn_q"]
    launches["ln_qkv_rope_split"] = split_launches["ln_qkv_rope_split"]
    launches["flash_attention"] = attention_launches["flash_attention"]
    # the float32 kernels from the float32 phase's path (its goldens, CLI runs
    # and attention()), each the sum of its entry points
    for name, modes in F32_KERNELS.items():
        launches[name] = sum(f32_launches[m] for m in modes)
    # the SIMT int8 kernels from the int8_any phase's path, the same way
    for name, modes in SIMT8_KERNELS.items():
        launches[name] = sum(simt8_launches[m] for m in modes)
    # the bf16 SIMT instances from the bf16_any phase's path
    for name, modes in BF16_KERNELS.items():
        launches[name] = sum(bf16_launches[m] for m in modes)
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "bound_share", "library_ms")
    summary = []
    for k in results["kernels"]:
        if k["case"] != k["name"]:  # a second shape of a kernel listed already
            main_entry = next(e for e in summary if e["name"] == k["name"])
            main_entry.setdefault("other_cases", []).append(
                {key: k[key] for key in ("case", *keys[4:])}
            )
            continue
        summary.append({key: k[key] for key in keys} | {"launches": launches[k["name"]]})
        if k["name"] in TRAIN_KERNELS:  # and on this slice's path, a train step over a mesh
            summary[-1]["train_parallel_launches"] = train_parallel_launches[k["name"]]
        if k["name"] in INT8_KERNELS:  # int8 over a mesh: K10, K11's modes by name
            names = INT8_KERNELS[k["name"]]
            summary[-1]["tp_int8_launches"] = {n: tp_int8_launches.get(n, 0) for n in names}
            summary[-1]["train_parallel_launches"] = {
                n: train_parallel_launches.get(n, 0) for n in names}
        if k["name"] in F32_KERNELS:  # each entry point's launches on the float32 path
            summary[-1]["mode_launches"] = {m: f32_launches[m] for m in F32_KERNELS[k["name"]]}
        if k["name"] in SIMT8_KERNELS:  # and on the int8_any path
            summary[-1]["mode_launches"] = {m: simt8_launches[m]
                                            for m in SIMT8_KERNELS[k["name"]]}
        if k["name"] in BF16_KERNELS:  # and on the bf16_any path
            summary[-1]["mode_launches"] = {m: bf16_launches[m]
                                            for m in BF16_KERNELS[k["name"]]}
        for modes in (F32_KERNELS, BF16_KERNELS):  # and on the widths path
            if k["name"] in modes:
                summary[-1]["widths_launches"] = {m: widths_launches[m]
                                                  for m in modes[k["name"]]}
        if k["name"] in E2E_KERNELS:  # and on the paths of the tools that drive the model
            summary[-1]["battery_launches"] = battery_launches[k["name"]]
            summary[-1]["demo_launches"] = demo_launches[k["name"]]
            summary[-1]["tools_launches"] = tools_launches[k["name"]]
    missing = [e["name"] for e in summary if not e["launches"]]
    missing += [m for modes in F32_KERNELS.values() for m in modes if not f32_launches[m]]
    missing += [m for modes in SIMT8_KERNELS.values() for m in modes if not simt8_launches[m]]
    missing += [m for modes in BF16_KERNELS.values() for m in modes if not bf16_launches[m]]
    # the widths path: each SIMT kernel's main entry point, float32 and bf16
    missing += [f"{modes[0]} (widths)" for table in (F32_KERNELS, BF16_KERNELS)
                for modes in table.values() if not widths_launches[modes[0]]]
    if missing or len(summary) != len(launches) or len(summary) != len(kernels.KERNELS):
        raise RuntimeError(f"kernels never launched on their path: {missing}")
    emit("phase_seconds", **PHASE_S, total=time.perf_counter() - START)
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
