"""Training loop on one device.

The port of ``herro_tpu/training/train.py`` without the mesh. The loss is
masked cross-entropy over supported columns (the model's only scored
outputs), weighted up where the truth differs from the target read, plus a
small-weight BCE on the info head. The optimiser is optax's
``chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(...),
weight_decay=1e-4))`` written out in torch with optax's semantics, which
``torch.optim`` and ``clip_grad_norm_`` do not share: no epsilon in the clip,
eps outside the square root after the bias correction, weight decay on every
parameter (LayerNorm and biases too), and the first update at the schedule's
value for a count of 0.

On the card the forward runs the entry, qkv, attention and FFN kernels; the
backward is plain PyTorch, as the reference's backward is plain XLA.
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
    params: dict  # name -> the model's live float32 Parameter
    opt_state: AdamState
    step: int = 0


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
        """One step, in place on ``params`` and ``state``."""
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        # optax rescales only from norm >= max_norm on, by t / norm * max_norm
        clip = norm >= self.max_norm
        lr = self.learning_rate(state.count)
        state.count += 1
        dev = norm.device
        one = torch.ones((), dtype=torch.float32, device=dev)
        c1 = one - torch.tensor(self.b1, device=dev) ** state.count
        c2 = one - torch.tensor(self.b2, device=dev) ** state.count
        step = torch.tensor(-lr, dtype=torch.float32, device=dev)
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = torch.where(clip, g / norm * self.max_norm, g)
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
            p.add_(step * upd)


def make_optimizer(lr: float = 3e-4, warmup: int = 100, total_steps: int = 10_000) -> Optimizer:
    return Optimizer(lr, warmup, max(total_steps, warmup + 1))


def loss_fn(model: CorrectionModel, tokens, quals_u8, sidx, smask, labels, info_labels,
            info_weight: float = 0.1, hard_weight: float = 0.0):
    """(loss, metrics) of one batch on its device (``train.py:54-91`` of the
    reference). ``hard_weight`` > 0 up-weights the cross-entropy at columns
    whose truth differs from the target read's symbol (the info label)."""
    quals = QUAL_SCALE * quals_u8.float() - QUAL_OFFSET
    info, logits = model(tokens, quals, sidx, smask)
    m = smask.float()
    denom = m.sum().clamp_min(1.0)

    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
                         reduction="none").view_as(m)
    w = m * (1.0 + hard_weight * info_labels)
    ce = (ce * w).sum() / w.sum().clamp_min(1.0)

    # optax.sigmoid_binary_cross_entropy
    bce = -info_labels * F.logsigmoid(info) - (1.0 - info_labels) * F.logsigmoid(-info)
    bce = (bce * m).sum() / denom

    with torch.no_grad():
        hit = (logits.argmax(dim=-1) == labels).float()
        acc = (hit * m).sum() / denom
        hm = m * info_labels
        hard_acc = (hit * hm).sum() / hm.sum().clamp_min(1.0)
    loss = ce + info_weight * bce
    return loss, {"loss": loss.detach(), "ce": ce.detach(), "info_bce": bce.detach(),
                  "acc": acc, "hard_acc": hard_acc}


def apply_gradients(optimizer: Optimizer, state: TrainState, loss: torch.Tensor) -> None:
    """The backward of ``loss`` and one optimiser update of ``state``'s
    parameters, in place; a parameter the loss does not reach gets a zero
    gradient, as under jax.grad."""
    params = list(state.params.values())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    optimizer.update(params, grads, state.opt_state)
    state.step += 1


def make_train_step(model: CorrectionModel, optimizer: Optimizer, info_weight: float = 0.1,
                    hard_weight: float = 0.0):
    """``step(state, tokens, quals_u8, sidx, smask, labels, info_labels)`` on
    device tensors -> metrics (device scalars): the forward through
    :func:`loss_fn`, then :func:`apply_gradients`. The reference's jitted
    step takes and returns params and opt_state; here ``state`` holds the
    model's own parameters and is updated in place."""

    def step(state: TrainState, *tensors) -> dict[str, torch.Tensor]:
        loss, metrics = loss_fn(model, *tensors, info_weight, hard_weight)
        apply_gradients(optimizer, state, loss)
        return metrics

    return step


class Trainer:
    """The model on ``device`` (the card unless the caller asks for the CPU),
    its optimiser state, and the step. The trainer draws no random numbers:
    the weights come in as ``params`` (``load_or_init`` draws them from a
    seeded ``torch.Generator``) and the batches' order is the iterator's."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        lr: float = 3e-4,
        total_steps: int = 10_000,
        info_weight: float = 0.1,
        hard_weight: float = 0.0,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        keep_float32_exact(self.device)
        model = CorrectionModel(cfg)
        model.load_state_dict(params)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(lr, total_steps=total_steps)
        named = dict(self.model.named_parameters())
        self.state = TrainState(named, self.optimizer.init(list(named.values())))
        self._step = make_train_step(self.model, self.optimizer, info_weight, hard_weight)

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
        """Durable mid-run checkpoint (params + step marker)."""
        from ..models.checkpoint import save_model

        save_model(path, self.cfg, self.state.params)
        with open(os.path.join(path, "step.txt"), "w") as fh:
            fh.write(str(self.state.step))
