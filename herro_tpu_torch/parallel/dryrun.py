"""Two full train steps of the flagship model over an n-device mesh beside
one device's, then sharded inference against one device.

The port's counterpart of ``dryrun_multichip`` in the reference's
entry module: a 2-D ``(n/2, 2)`` (data, model) mesh when n >= 4 is even,
else a 1-D data mesh; two ``Trainer(mesh=...)`` steps of ``r10`` at B=2n,
L=256, S=32 (the batch split over the data axis, the heads and the FFN
hidden over the model axis, one summed gradient) beside the single-device
trainer on the same weights and batch: the first step's loss and summed
gradient held against one device's, the data replicas' parameters and
moments bit-identical after each step, every parameter moved by the
second (the first step's learning rate is the warmup's 0); then the mesh's
``CorrectionRunner`` against the single-device runner on the same inputs:
equal counting decisions and more than 0.98 of the classes equal, and for
n >= 4 the same on an odd 1-D mesh of n - 1 devices.

    python -m herro_tpu_torch.parallel.dryrun N [--device cpu]

On the card the mesh takes n distinct cards when the host has them, else
the one card n times (a mesh may repeat a device); on the CPU the CPU
device n times stands in for the reference's virtual CPU devices. The
sharded/single wall-clock ratio is printed, not asserted: the reference
bounds it at 2.5 on virtual CPU devices, but on one card holding every
shard tensor parallelism costs what the split adds (TP 4 read 2.79 x the
single device's step on an H100) and buys nothing.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..constants import N_ROWS, TOKEN_PAD
from ..models.checkpoint import load_or_init
from ..pipeline.batching import Batch, pack_tokens, unpack_tokens_np
from ..pipeline.infer import CorrectionRunner, resolve_device
from ..training.train import TrainBatch, Trainer
from .mesh import Mesh, make_mesh, make_mesh_2d

L, S = 256, 32


def example_batch(B: int, L: int, S: int, seed: int = 0):
    """Correction-step inputs of B windows of L columns: packed tokens
    [B, 16, L], quals [B, 31, L], S sorted supported columns, n_alns; the
    second half of the batch padded over its last L/8 columns."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 11, size=(B, L, N_ROWS)).astype(np.uint8)
    tokens[:, :, 0] = rng.integers(0, 5, size=(B, L))
    tokens[B // 2:, L - L // 8:, :] = TOKEN_PAD
    quals = rng.integers(33, 127, size=(B, N_ROWS, L)).astype(np.uint8)
    sidx = np.sort(rng.integers(0, L - L // 8, size=(B, S)), axis=1).astype(np.int32)
    smask = np.ones((B, S), dtype=bool)
    n_alns = rng.integers(2, 31, size=B).astype(np.int32)
    packed = np.ascontiguousarray(pack_tokens(tokens).transpose(0, 2, 1))
    return packed, quals, sidx, smask, n_alns


def mesh_devices(n: int, device) -> list[torch.device]:
    """n distinct cards when ``device`` is the card (no index) and the host
    has n, else ``device`` n times."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None \
            and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def _parity_leg(cfg, params, single: CorrectionRunner, mesh: Mesh, label: str,
                n_devices: int) -> dict:
    """The mesh's runner against the single device's on one batch: decisions
    equal, classes agreeing on more than 0.98; and the wall-clock ratio of
    the two (three runs each, results fetched)."""
    b = 2 * mesh.n_data  # divisible by the data axis
    packed, quals, sidx, smask, _ = example_batch(b, L, S)
    batch = Batch(packed, quals, sidx, smask, np.full(b, 12, dtype=np.int32), windows=[])
    sharded = CorrectionRunner(cfg, params, mesh=mesh)
    if mesh.tp > 1 and not sharded.tp_fast_path:
        raise RuntimeError(f"{label}: tp={mesh.tp} is not on the tensor-parallel path")
    got = sharded._fetch(sharded.dispatch(batch))[1]
    want = single._fetch(single.dispatch(batch))[1]
    if not np.array_equal(got[:, :-S], want[:, :-S]):
        raise RuntimeError(f"{label}: counting decisions diverged")
    agree = float((got[:, -S:] == want[:, -S:]).mean())
    if not agree > 0.98:
        raise RuntimeError(f"{label}: sharded argmax agreement {agree:.4f}")
    print(f"dryrun_multichip({n_devices}): {label} inference ok, argmax agreement {agree:.4f}")

    def timed(runner):
        t0 = time.perf_counter()
        for _ in range(3):
            runner._fetch(runner.dispatch(batch))
        return (time.perf_counter() - t0) / 3

    return dict(agreement=agree, ratio=timed(sharded) / max(timed(single), 1e-9))


def first_moments(state) -> dict:
    """Replica 0's Adam first moments of a ``TrainState`` under the
    single-device names (a sharded replica's put back together)."""
    return state.replicas[0].gather(state.opt_state.mu)


def relative_gap(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of two dicts with the same
    names, in float64 on the host."""
    num = den = 0.0
    for k, w in want.items():
        w = w.detach().double().cpu()
        num += float(((got[k].detach().double().cpu() - w) ** 2).sum())
        den += float((w ** 2).sum())
    return (num / den) ** 0.5


def replicas_equal(state) -> bool:
    """Every data replica of a ``TrainState`` holds replica 0's bits:
    parameters and both Adam moments (each replica on its own devices)."""
    first = [list(state.replicas[0].parameters()), state.opt_states[0].mu,
             state.opt_states[0].nu]
    return all(
        all(torch.equal(a, b.to(a.device))
            for xs, ys in zip(first, (list(r.parameters()), o.mu, o.nu))
            for a, b in zip(xs, ys))
        for r, o in zip(state.replicas[1:], state.opt_states[1:])
    )


# the mesh's first step against one device's on the same weights and batch,
# bf16: its loss (relative) and its summed gradient, read through Adam's first
# moment after it (relative over all parameters). A data axis only reorders
# float32 sums; a model axis also rounds each shard's partial to bf16, which
# over this batch's 8 x 32 supported columns moves the loss by about 4e-4
# (CPU). Dropping one replica's gradient moves the gradient by 0.36 and more,
# a mean of per-replica means by 0.05 (and the data-only loss by 1e-4).
LOSS_RTOL = {"data": 1e-6, "model": 2e-3}
GRAD_RTOL = {"data": 1e-2, "model": 2e-2}
LR = 1e-3  # the warmup's second step moves every parameter by about LR / 100


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Two full train steps over an n-device mesh beside one device's, then
    the inference parity legs. Raises on a first-step loss or a summed
    gradient (Adam's first moment after step 1, whose learning rate is 0)
    off one device's by more than ``LOSS_RTOL``/``GRAD_RTOL``, data replicas
    whose parameters or moments differ after either step, a parameter that
    the second step did not move, diverged decisions or an agreement at or
    below 0.98. Returns the loss, the two gaps, each leg's agreement and
    the main leg's sharded/single wall-clock ratio."""
    devices = mesh_devices(n_devices, device)
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh_2d(n_devices // 2, 2, devices)
    else:
        mesh = make_mesh(devices)
    cfg, params = load_or_init("r10", rng_seed=0)
    one = Trainer(cfg, params, lr=LR, total_steps=10, device=devices[0])
    trainer = Trainer(cfg, params, lr=LR, total_steps=10, mesh=mesh)

    B = 2 * n_devices
    packed, quals, sidx, smask, _ = example_batch(B, L, S)
    rng = np.random.default_rng(1)
    batch = TrainBatch(
        tokens=unpack_tokens_np(packed, N_ROWS), quals=quals, support_idx=sidx,
        support_mask=smask, labels=rng.integers(0, 5, size=(B, S)).astype(np.int32),
        info_labels=rng.integers(0, 2, size=(B, S)).astype(np.float32),
    )
    label = f"dryrun_multichip({n_devices})"
    axis = "model" if mesh.tp > 1 else "data"
    start = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    want, metrics = one.train_step(batch), trainer.train_step(batch)
    loss_gap = abs(metrics["loss"] - want["loss"]) / abs(want["loss"])
    grad_gap = relative_gap(first_moments(trainer.state), first_moments(one.state))
    if not (np.isfinite(metrics["loss"]) and loss_gap <= LOSS_RTOL[axis]
            and grad_gap <= GRAD_RTOL[axis]):
        raise RuntimeError(f"{label}: loss {metrics['loss']} against one device's "
                           f"{want['loss']}, gradient gap {grad_gap}")
    same = [replicas_equal(trainer.state)]
    trainer.train_step(batch)
    same.append(replicas_equal(trainer.state))
    still = [k for k, v in trainer.state.params.items() if torch.equal(v, start[k])]
    if not all(same) or still:
        raise RuntimeError(f"{label}: data replicas equal after each step {same}, "
                           f"parameters the second step left unmoved {still}")
    shape = (mesh.n_data, mesh.tp)
    print(f"{label}: train ok over {shape}, loss={metrics['loss']:.4f} "
          f"(one device's within {loss_gap:.2e}, gradient within {grad_gap:.2e})")
    del trainer, one

    single = CorrectionRunner(cfg, params, device=devices[0])
    main = _parity_leg(cfg, params, single, mesh, f"main mesh {shape}", n_devices)
    out = dict(mesh=list(shape), loss=metrics["loss"], loss_gap=loss_gap, grad_gap=grad_gap,
               agreement=main["agreement"], ratio=main["ratio"])
    if mesh.tp > 1 and n_devices >= 4:
        odd = n_devices - 1 if n_devices % 2 == 0 else n_devices
        leg = _parity_leg(cfg, params, single, make_mesh(devices[:odd]),
                          f"odd 1-D mesh ({odd},)", n_devices)
        out["odd_agreement"] = leg["agreement"]
    print(f"{label}: sharded/single step wall-clock ratio {main['ratio']:.2f} (not asserted)")
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m herro_tpu_torch.parallel.dryrun")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: n cards, or the one card n times), cuda:N, or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
