"""The correction step and its runner.

One ``correct_step`` runs, per batch:

* token unpack and qual normalisation to [-1, 1] (the reference does this on
  device too, src/inference.rs:152-153);
* the transformer forward over the pileup;
* argmax over the 5-way logits at supported columns;
* the counting-rule consensus decision for every column
  (src/consensus.rs:177-218) — so the host only stitches bytes.

On the card the runner owns one CUDA stream. ``dispatch`` copies a batch from
pinned host buffers with ``non_blocking=True`` on that stream, enqueues the
step, copies the packed result back into a pinned buffer and records an
event; it returns without waiting. ``finalize`` waits on that batch's event.
The engine calls ``dispatch`` from two uploader threads and ``finalize`` from
two fetcher threads: every stream and event is explicit, and each batch's
pinned buffers stay referenced by its ``InFlight`` until its event completes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
from ..models.model import CorrectionModel, ModelConfig
from ..ops.consensus import count_decisions
from .batching import Batch, unpack_tokens_torch


@dataclass
class InFlight:
    """A dispatched-but-unfetched batch: host-side results (pinned on the
    card's path) that are valid once ``event`` has completed, and the pinned
    input buffers kept alive until then."""

    batch: Batch
    outputs: tuple
    event: torch.cuda.Event | None = None
    inputs: tuple = ()


@dataclass
class WindowResult:
    rid: int
    wid: int
    n_alns: int
    n_total_wins: int
    decisions: np.ndarray  # uint8 [L_true] final per-column classes
    info: np.ndarray | None = None  # f32 [n_sup] info logits (parity/debug)
    # pure counting-rule decisions (no model override); populated when the
    # runner's collect_counting flag is set.
    counting: np.ndarray | None = None


def make_correct_step(model: CorrectionModel):
    """The step takes the *packed* token nibble rows ([B, 16, L], see
    batching.collate) and unpacks them on the device."""

    def step(tokens_packed, quals_u8, support_idx, support_mask, n_alns):
        tokens = unpack_tokens_torch(tokens_packed, N_ROWS)  # [B, 31, L] uint8
        quals = QUAL_SCALE * quals_u8.float() - QUAL_OFFSET
        info, logits = model(tokens, quals, support_idx, support_mask)
        classes = torch.argmax(logits, dim=-1).to(torch.uint8)
        decisions = count_decisions(tokens, n_alns)
        return info, classes, decisions

    return step


def make_correct_step_packed(model: CorrectionModel):
    """The runner's transport variant: (info, decisions‖classes [B, L+S]),
    so one device-to-host copy carries both uint8 result planes."""
    step = make_correct_step(model)

    def packed_step(tokens_packed, quals_u8, support_idx, support_mask, n_alns):
        info, classes, decisions = step(
            tokens_packed, quals_u8, support_idx, support_mask, n_alns
        )
        return info, torch.cat([decisions, classes], dim=1)

    return packed_step


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The runner's device: the card unless the caller asks for the CPU. With
    no card present and none asked for, raise rather than fall back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def keep_float32_exact(device: torch.device) -> None:
    """On the card, keep TF32 out of every float32 product (the heads, the
    plain backward). The flags are process-wide, so the runner, the trainer
    and ``chip_smoke.py`` all set them here."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class CorrectionRunner:
    """Owns the model on its device, the device stream and the step."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        collect_info: bool = False,
        counting_only: bool = False,
        collect_counting: bool = False,
        int8: bool | None = None,
        device: str | torch.device | None = None,
    ):
        if int8 is not None and int8 != cfg.int8:
            cfg = dataclasses.replace(cfg, int8=int8)  # overrides the checkpoint's
        self.cfg = cfg
        self.device = resolve_device(device)
        self.collect_info = collect_info
        # Also surface the pure counting decode per window.
        self.collect_counting = collect_counting
        # Diagnostic: skip the model override at supported columns.
        self.counting_only = counting_only
        model = CorrectionModel(cfg)
        model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self._step = make_correct_step_packed(self.model)
        self.stream = None
        keep_float32_exact(self.device)
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(device=self.device)

    def _inputs(self, batch: Batch) -> tuple[np.ndarray, ...]:
        return (
            batch.tokens_packed,
            batch.quals,
            batch.support_idx,
            batch.support_mask,
            batch.n_alns,
        )

    def dispatch(self, batch: Batch) -> InFlight:
        """Enqueue the step without waiting and return at once. Pair with
        ``finalize``; keeping several batches in flight overlaps the
        host<->device copies and featgen with compute (the reference gets the
        same overlap from its inference thread, src/lib.rs:189-196)."""
        arrays = self._inputs(batch)
        if self.stream is None:
            with torch.inference_mode():
                info, packed = self._step(*(torch.from_numpy(a) for a in arrays))
            return InFlight(batch, (info if self.collect_info else None, packed))
        with torch.inference_mode(), torch.cuda.device(self.device), \
                torch.cuda.stream(self.stream):
            pinned = tuple(torch.from_numpy(a).pin_memory() for a in arrays)
            dev_in = [p.to(self.device, non_blocking=True) for p in pinned]
            info, packed = self._step(*dev_in)
            packed_host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            packed_host.copy_(packed, non_blocking=True)
            info_host = None
            if self.collect_info:
                info_host = torch.empty(info.shape, dtype=info.dtype, pin_memory=True)
                info_host.copy_(info, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return InFlight(batch, (info_host, packed_host), event, pinned)

    def finalize(self, inflight: InFlight) -> list[WindowResult]:
        """Wait for a dispatched batch's results and unpack them."""
        if inflight.event is not None:
            inflight.event.synchronize()
        info, packed = inflight.outputs
        return self._unpack(
            inflight.batch, None if info is None else info.numpy(), packed.numpy()
        )

    def run_batch(self, batch: Batch) -> list[WindowResult]:
        return self.finalize(self.dispatch(batch))

    def _unpack(self, batch: Batch, info, packed) -> list[WindowResult]:
        # one copy for both result planes: [B, L + S] = decisions || classes
        S = batch.support_idx.shape[1]
        decisions = packed[:, :-S]
        classes = packed[:, -S:]

        out = []
        for i, w in enumerate(batch.windows):
            l, s = w.length, w.n_supported
            counting = decisions[i, :l].copy()
            if self.counting_only:
                dec = counting
            else:
                # Model verdicts override counting at supported columns.
                dec = counting.copy() if self.collect_counting else counting
                dec[w.support_flat] = classes[i, :s]
            out.append(
                WindowResult(
                    rid=w.rid,
                    wid=w.wid,
                    n_alns=w.n_alns,
                    n_total_wins=w.n_total_wins,
                    decisions=dec,
                    info=info[i, :s].copy() if info is not None else None,
                    counting=counting if self.collect_counting else None,
                )
            )
        return out
