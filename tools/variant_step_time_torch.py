"""Step-time probe for model-shape variants, on the card, with the PyTorch/CUDA
port.

The counterpart of tools/variant_step_time.py: the fused correct step
(``pipeline/infer.py:make_correct_step``: unpack, forward, argmax, counting
rule) timed by the port's step timer (``pipeline/steptime.py``: warm-up
outside the timed region, distinct inputs per iteration, every output folded
into what is timed, CUDA events) at the reference's two (B, L, S) shapes,
for each distinct config of the reference's list, labelled by its real
widths: the flagship ``R10_CONFIG`` (d512x3L ff1024; the reference's first
label, "flagship d256x8L", names an older flagship, and its second entry is
the same config) and the same-budget d384x5L ff1280 candidate (H 3 x D 128).
Weights are random, from a seeded generator: the time does not depend on
them. Needs a CUDA card; imports nothing of JAX.

Usage: python tools/variant_step_time_torch.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from herro_tpu_torch.models.model import R10_CONFIG, CorrectionModel, ModelConfig  # noqa: E402

SHAPES = {
    "r10 d512x3L ff1024": R10_CONFIG,
    "d384x5L ff1280": dataclasses.replace(
        R10_CONFIG, d_model=384, n_layers=5, n_heads=3, d_ff=1280
    ),
}
# (B, L, S) of tools/variant_step_time.py:46
STEPS = ((64, 4608, 128), (32, 9216, 256))


def n_params(cfg: ModelConfig) -> int:
    return sum(p.numel() for p in CorrectionModel(cfg).parameters())


def step_time(cfg: ModelConfig, B: int, L: int, S: int, iters: int = 20) -> dict:
    """ms a correct step of ``cfg`` (seeded random weights) at (B, L, S) on
    the card, over three distinct input sets."""
    import torch

    from herro_tpu_torch.pipeline.infer import make_correct_step, resolve_device
    from herro_tpu_torch.pipeline.steptime import example_batch, time_step

    dev = resolve_device(None)
    model = CorrectionModel(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    step = make_correct_step(model)
    sets = [[torch.from_numpy(a).to(dev) for a in example_batch(B, L, S, seed=s)]
            for s in (3, 4, 5)]
    return time_step(step, sets, B, iters=iters)


def main() -> None:
    from herro_tpu_torch.pipeline.steptime import card

    print(card(), flush=True)
    for name, cfg in SHAPES.items():
        print(f"{name}: {n_params(cfg)/1e6:.2f}M params", flush=True)
        for B, L, S in STEPS:
            r = step_time(cfg, B, L, S)
            print(f"  B={B} L={L}: {r['windows_per_s']:.0f} windows/s "
                  f"({r['ms']:.1f} ms/step)", flush=True)


if __name__ == "__main__":
    main()
