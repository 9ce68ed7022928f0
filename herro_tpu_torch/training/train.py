"""Training loop, on one device or over a device mesh.

The port of ``herro_tpu/training/train.py``. The loss is masked
cross-entropy over supported columns (the model's only scored outputs),
weighted up where the truth differs from the target read, plus a
small-weight BCE on the info head. The optimiser is optax's
``chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(...),
weight_decay=1e-4))`` written out in torch with optax's semantics, which
``torch.optim`` and ``clip_grad_norm_`` do not share: no epsilon in the clip,
eps outside the square root after the bias correction, weight decay on every
parameter (LayerNorm and biases too), and the first update at the schedule's
value for a count of 0.

On the card the forward runs the entry, qkv, attention and FFN kernels; the
backward is plain PyTorch, as the reference's backward is plain XLA.

Over a :class:`~herro_tpu_torch.parallel.mesh.Mesh` each row is a data
replica (the model on its device, or sharded over its row by Megatron
tensor parallelism, ``parallel/tensor.py``) and takes its contiguous rows of
the batch, as ``P("data")`` splits it. The loss's denominators are the whole
batch's, so the replicas' gradients sum to the single-device gradient; the
sum is taken once, in float32 in replica order, and every replica applies
the same clipped update to its own copy of the parameters and moments, which
therefore stay bit-identical: the reference's jitted step, whose gradient
all-reduce XLA inserts. One device is one replica of the same step.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import QUAL_OFFSET, QUAL_SCALE
from ..models.model import CorrectionModel, ModelConfig
from ..parallel.mesh import Mesh
from ..parallel.tensor import TensorParallelModel
from ..pipeline.infer import keep_float32_exact, resolve_device


@dataclass
class TrainBatch:
    tokens: np.ndarray  # uint8 [B, 31, L] (row-major: column axis minor)
    quals: np.ndarray  # uint8 [B, 31, L]
    support_idx: np.ndarray  # int32 [B, S]
    support_mask: np.ndarray  # bool [B, S]
    labels: np.ndarray  # int32 [B, S]
    info_labels: np.ndarray  # float32 [B, S]


@dataclass
class AdamState:
    count: int  # updates made so far
    mu: list  # first and second moments, one tensor a parameter
    nu: list


@dataclass
class TrainState:
    """The data replicas (one model on one device, or one a row of a mesh)
    and an optimiser state beside each, bit-identical across replicas.
    ``params`` are replica 0's logical parameters under the single-device
    names, what a checkpoint holds (``gather``: one device's live leaves, a
    sharded replica's put back together and detached); ``opt_state`` is
    replica 0's."""

    replicas: list  # one model a data replica
    opt_states: list  # one AdamState a data replica
    step: int = 0

    @property
    def params(self) -> dict:
        return self.replicas[0].gather()

    @property
    def opt_state(self) -> AdamState:
        return self.opt_states[0]


class Optimizer:
    """Global-norm clip, then AdamW at a warmup-cosine learning rate, with
    optax's arithmetic (``optax.clip_by_global_norm``, ``scale_by_adam``,
    ``add_decayed_weights``, ``scale_by_learning_rate``)."""

    def __init__(self, lr: float, warmup: int, decay_steps: int, max_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.lr, self.warmup, self.decay_steps = lr, warmup, decay_steps
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.weight_decay = weight_decay

    def learning_rate(self, count: int) -> float:
        """``warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)`` at
        ``count`` earlier updates: linear from 0 over the warmup, then a
        cosine to 0 over the rest."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        span = self.decay_steps - self.warmup
        t = min(count - self.warmup, span)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, params: list[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: AdamState) -> None:
        """One step, in place on ``params`` and ``state``. Parameters may lie
        on several devices (a tensor-parallel replica's shards): the norm is
        summed on the first gradient's device."""
        dev = grads[0].device
        norm = torch.sqrt(sum((g.float() ** 2).sum().to(dev) for g in grads))
        # optax rescales only from norm >= max_norm on, by t / norm * max_norm
        clip = norm >= self.max_norm
        lr = self.learning_rate(state.count)
        state.count += 1
        one = torch.ones((), dtype=torch.float32, device=dev)
        c1 = one - torch.tensor(self.b1, device=dev) ** state.count
        c2 = one - torch.tensor(self.b2, device=dev) ** state.count
        step = torch.tensor(-lr, dtype=torch.float32, device=dev)
        scalars = {dev: (norm, clip, c1, c2, step)}
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            if p.device not in scalars:
                scalars[p.device] = tuple(t.to(p.device) for t in scalars[dev])
            norm, clip, c1, c2, step = scalars[p.device]
            g = torch.where(clip, g / norm * self.max_norm, g)
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
            p.add_(step * upd)


def make_optimizer(lr: float = 3e-4, warmup: int = 100, total_steps: int = 10_000) -> Optimizer:
    return Optimizer(lr, warmup, max(total_steps, warmup + 1))


def loss_denominators(smask, info_labels, hard_weight: float = 0.0):
    """The loss's and metrics' denominators, which depend on the inputs
    alone: the supported columns, their cross-entropy weights and the hard
    columns, each at least 1 (``train.py:67-83`` of the reference)."""
    m = smask.float()
    w = m * (1.0 + hard_weight * info_labels)
    return m.sum().clamp_min(1.0), w.sum().clamp_min(1.0), (m * info_labels).sum().clamp_min(1.0)


def loss_fn(model: CorrectionModel, tokens, quals_u8, sidx, smask, labels, info_labels,
            info_weight: float = 0.1, hard_weight: float = 0.0, denominators=None):
    """(loss, metrics) of one batch on its device (``train.py:54-91`` of the
    reference). ``hard_weight`` > 0 up-weights the cross-entropy at columns
    whose truth differs from the target read's symbol (the info label).
    ``denominators`` (``loss_denominators`` of a whole batch) make this the
    share of that batch's loss and metrics from these rows of it: the shares
    of a batch's parts sum to the whole batch's."""
    quals = QUAL_SCALE * quals_u8.float() - QUAL_OFFSET
    info, logits = model(tokens, quals, sidx, smask)
    m = smask.float()
    if denominators is None:
        denominators = loss_denominators(smask, info_labels, hard_weight)
    denom, w_sum, hard_sum = denominators

    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
                         reduction="none").view_as(m)
    w = m * (1.0 + hard_weight * info_labels)
    ce = (ce * w).sum() / w_sum

    # optax.sigmoid_binary_cross_entropy
    bce = -info_labels * F.logsigmoid(info) - (1.0 - info_labels) * F.logsigmoid(-info)
    bce = (bce * m).sum() / denom

    with torch.no_grad():
        hit = (logits.argmax(dim=-1) == labels).float()
        acc = (hit * m).sum() / denom
        hard_acc = (hit * (m * info_labels)).sum() / hard_sum
    loss = ce + info_weight * bce
    return loss, {"loss": loss.detach(), "ce": ce.detach(), "info_bce": bce.detach(),
                  "acc": acc, "hard_acc": hard_acc}


def gradients(loss: torch.Tensor, params: list) -> list:
    """d loss / d params; a parameter the loss does not reach gets a zero
    gradient, as under jax.grad."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_train_step(replicas: list, optimizer: Optimizer, info_weight: float = 0.1,
                    hard_weight: float = 0.0):
    """``step(state, tokens, quals_u8, sidx, smask, labels, info_labels)`` on
    replica 0's device -> the whole batch's metrics (device scalars), for
    ``state`` a :class:`TrainState` over ``replicas`` (the data replicas'
    models), updated in place. The reference's jitted step takes and
    returns params and opt_state.

    The batch splits over the replicas in contiguous rows. Each replica's
    forward (:func:`loss_fn` over the whole batch's denominators) and
    backward run in turn, so one replica's activations live at a time. The
    gradients are summed once, in float32 in replica order on replica 0's
    devices, and every replica applies the same update from those bits. One
    replica is the single-device step: its rows are the batch and its
    gradient the sum. Every device's work goes to its current stream, and
    PyTorch orders each copy between cards after the work queued on both
    cards' current streams, so the sum reads finished gradients and every
    update reads the finished sum without events of the step's own."""

    def step(state: TrainState, *tensors) -> dict[str, torch.Tensor]:
        n = len(replicas)
        if tensors[0].shape[0] % n:
            raise ValueError(
                f"batch size {tensors[0].shape[0]} is not divisible by the data axis ({n})"
            )
        denominators = loss_denominators(tensors[3], tensors[5], hard_weight)
        parts = [t.chunk(n) for t in tensors]
        total, metrics = None, None
        for r, replica in enumerate(replicas):
            params = list(replica.parameters())
            dev = params[0].device  # the replica's first (or only) device
            loss, m = loss_fn(replica, *(p[r].to(dev) for p in parts), info_weight,
                              hard_weight, tuple(d.to(dev) for d in denominators))
            grads = gradients(loss, params)
            del loss
            if total is None:
                total, metrics = grads, m
            else:  # float32, in replica order, on replica 0's devices
                total = [a + g.to(a.device) for a, g in zip(total, grads)]
                metrics = {k: v + m[k].to(v.device) for k, v in metrics.items()}
        # every replica takes the same bits and applies the same update
        for replica, opt_state in zip(replicas, state.opt_states):
            params = list(replica.parameters())
            optimizer.update(params, [g.to(p.device) for g, p in zip(total, params)],
                             opt_state)
        state.step += 1
        return metrics

    return step


class Trainer:
    """The model, its optimiser state and the step, on ``device`` (the card
    unless the caller asks for the CPU) or over ``mesh``. The trainer draws
    no random numbers: the weights come in as ``params`` (``load_or_init``
    draws them from a seeded ``torch.Generator``) and the batches' order is
    the iterator's.

    Over a mesh each row holds a data replica: the model on the row's
    device, or with ``mesh.tp`` > 1 a ``TensorParallelModel`` over the row,
    whose forward runs the same kernels at each shard's widths. The batch
    size must divide by ``mesh.n_data``. ``state.params`` and :meth:`save`
    give the logical parameters, under the single-device names."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        lr: float = 3e-4,
        total_steps: int = 10_000,
        info_weight: float = 0.1,
        hard_weight: float = 0.0,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        if device is not None and mesh is not None:
            raise ValueError("Trainer takes a device or a mesh, not both")
        self.cfg = cfg
        self.mesh = mesh
        self.optimizer = make_optimizer(lr, total_steps=total_steps)
        rows = mesh.devices if mesh is not None else ((device,),)
        rows = [tuple(resolve_device(d) for d in row) for row in rows]
        replicas = []
        for row in rows:
            for dev in row:
                keep_float32_exact(dev)
            if len(row) > 1:
                replicas.append(TensorParallelModel(cfg, params, row))
                continue
            model = CorrectionModel(cfg)
            model.load_state_dict(params)
            replicas.append(model.to(row[0]))
        self.device = rows[0][0]
        self.model = replicas[0]
        self.state = TrainState(
            replicas, [self.optimizer.init(list(r.parameters())) for r in replicas]
        )
        self._step = make_train_step(replicas, self.optimizer, info_weight, hard_weight)

    def tensors(self, batch: TrainBatch) -> tuple[torch.Tensor, ...]:
        """The batch's arrays on the device, in the step's order."""
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return (t(batch.tokens), t(batch.quals), t(batch.support_idx),
                t(batch.support_mask), t(batch.labels),
                t(batch.info_labels.astype(np.float32)))

    def train_step(self, batch: TrainBatch) -> dict[str, float]:
        metrics = self._step(self.state, *self.tensors(batch))
        return {k: float(v) for k, v in metrics.items()}

    def fit(
        self,
        batches: Iterator[TrainBatch],
        log_every: int = 50,
        save_every: int = 0,
        save_dir: str | None = None,
    ) -> list[dict]:
        history = []
        for batch in batches:
            metrics = self.train_step(batch)
            history.append(metrics)
            if self.state.step % log_every == 0:
                print(
                    f"step {self.state.step}: "
                    + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                )
            if save_every and save_dir and self.state.step % save_every == 0:
                self.save(save_dir)
        return history

    def save(self, path: str) -> None:
        """Durable mid-run checkpoint (params + step marker): the logical
        parameters, as one device holds them."""
        from ..models.checkpoint import save_model

        save_model(path, self.cfg, self.state.params)
        with open(os.path.join(path, "step.txt"), "w") as fh:
            fh.write(str(self.state.step))
