"""Device time of the correction step on the card: one recipe for every tool
that times a step.

The reference times its step with a chained on-device loop
(bench.py:_chip_only_cfg); on the card the same rules read:

* warm up outside the timed region (the first call builds the kernels and
  the weights' cache);
* distinct inputs per iteration: the input sets are made up front and
  cycled, so no iteration reads another's data out of L2 alone;
* every output (info logits, classes, decisions) is folded into what is
  timed: each iteration sums them into one device scalar, read after the
  loop, so a step whose outputs nobody reads is not what is measured;
* CUDA events around the timed loop, one ``synchronize`` at its end; the
  result is ms a step and windows per second.

On the CPU there is nothing to time: :func:`time_step` raises.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..constants import N_ROWS, TOKEN_PAD
from .batching import pack_tokens


def example_batch(B: int, L: int, S: int, seed: int = 0) -> tuple[np.ndarray, ...]:
    """Inputs of the correction step at (B, L, S), as production batches lay
    them out (``batching.collate``): tokens 4-bit packed [B, 16, L], quals
    u8 [B, 31, L], sorted support indices [B, S], support mask, n_alns. The
    same draws as the reference's example batch (``__graft_entry__.py``):
    the second half of the batch ends in L / 8 columns of padding."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 11, size=(B, L, N_ROWS)).astype(np.uint8)
    tokens[:, :, 0] = rng.integers(0, 5, size=(B, L))
    tokens[B // 2 :, L - L // 8 :, :] = TOKEN_PAD
    tokens[B // 2 :, L - L // 8 :, 0] = TOKEN_PAD
    quals = rng.integers(33, 127, size=(B, N_ROWS, L)).astype(np.uint8)
    sidx = np.sort(rng.integers(0, L - L // 8, size=(B, S)), axis=1).astype(np.int32)
    smask = np.ones((B, S), dtype=bool)
    n_alns = rng.integers(2, 31, size=B).astype(np.int32)
    packed = np.ascontiguousarray(pack_tokens(tokens).transpose(0, 2, 1))
    return packed, quals, sidx, smask, n_alns


def _fold(outputs) -> torch.Tensor:
    """Every output tensor summed into one float32 scalar on its device."""
    if isinstance(outputs, torch.Tensor):
        outputs = (outputs,)
    total = None
    for o in outputs:
        if isinstance(o, (tuple, list)):
            s = _fold(o)
        else:
            s = o.float().sum() if o.is_floating_point() else o.sum(dtype=torch.float32)
        total = s if total is None else total + s.to(total.device)
    return total


def time_step(step: Callable, input_sets: Sequence[Sequence[torch.Tensor]],
              windows: int, iters: int = 20, warmup: int = 2) -> dict:
    """ms a step of ``step(*inputs)`` on the card, cycling ``input_sets``
    (tensors already on the card) and folding every output it returns into
    one scalar; ``windows`` is the windows one step corrects (B).

    Returns ``ms`` (a step), ``windows_per_s``, ``iters`` and ``checksum``
    (the folded outputs of the timed loop, finite for a sound step)."""
    if iters < 1 or not input_sets:
        raise ValueError("time_step needs at least one iteration and one input set")
    first = input_sets[0][0]
    if not first.is_cuda:
        raise RuntimeError(f"time_step times a step on the card; its inputs are on "
                           f"{first.device}")
    with torch.inference_mode():
        for i in range(warmup):
            _fold(step(*input_sets[i % len(input_sets)]))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        acc = torch.zeros((), dtype=torch.float32, device=first.device)
        start.record()
        for i in range(iters):
            acc += _fold(step(*input_sets[i % len(input_sets)]))
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end) / iters
    return dict(ms=ms, windows_per_s=windows * 1e3 / ms, iters=iters,
                checksum=float(acc))


def card() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them: every time a tool
    reports stands beside this line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]
