"""The correction step and its runner.

One ``correct_step`` runs, per batch:

* token unpack and qual normalisation to [-1, 1] (the reference does this on
  device too, src/inference.rs:152-153);
* the transformer forward over the pileup;
* argmax over the 5-way logits at supported columns;
* the counting-rule consensus decision for every column
  (src/consensus.rs:177-218) — so the host only stitches bytes.

On the card the runner owns one CUDA stream per device of each data replica
(one replica, one device, one stream without a mesh). ``dispatch`` copies
each replica's rows of a batch from pinned host buffers with
``non_blocking=True`` on its stream, enqueues the step, copies the packed
result back into a pinned buffer and records an event; it returns without
waiting. ``finalize`` waits on that batch's events and joins the parts in
batch order. The engine calls ``dispatch`` from two uploader threads and
``finalize`` from two fetcher threads: every stream and event is explicit,
and each batch's pinned buffers stay referenced by its ``InFlight`` until its
events complete.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE
from ..models.model import CorrectionModel, ModelConfig
from ..ops.consensus import count_decisions
from ..parallel.mesh import Mesh
from ..parallel.tensor import TensorParallelModel
from .batching import Batch, unpack_tokens_torch


@dataclass
class InFlight:
    """A dispatched-but-unfetched batch: per data replica, its host-side
    results (info, packed), pinned on the card's path and valid once its
    event has completed, and its pinned input buffers, kept alive until
    then."""

    batch: Batch
    outputs: tuple
    events: tuple = ()
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


class _Replica:
    """One data replica: a step on its device (a model, or a model sharded
    over a mesh row), and on the card a stream on each device it runs on."""

    def __init__(self, step, device: torch.device, devices=()):
        self.step = step
        self.device = device
        self.streams = []
        if device.type == "cuda":
            for dev in dict.fromkeys((device, *devices)):  # the first is the step's
                self.streams.append(torch.cuda.Stream(device=dev))

    def dispatch(self, arrays, collect_info: bool):
        """Enqueue the step on these host arrays; returns ((info, packed),
        event, pinned inputs) with the results on the host once the event
        has completed (no event on the CPU)."""
        if not self.streams:
            with torch.inference_mode():
                info, packed = self.step(*(torch.from_numpy(a) for a in arrays))
            return (info if collect_info else None, packed), None, ()
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(torch.inference_mode())
            for stream in reversed(self.streams):  # the step's device current last
                ctx.enter_context(torch.cuda.stream(stream))
            pinned = tuple(torch.from_numpy(a).pin_memory() for a in arrays)
            dev_in = [p.to(self.device, non_blocking=True) for p in pinned]
            info, packed = self.step(*dev_in)
            packed_host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            packed_host.copy_(packed, non_blocking=True)
            info_host = None
            if collect_info:
                info_host = torch.empty(info.shape, dtype=info.dtype, pin_memory=True)
                info_host.copy_(info, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.streams[0])
        return (info_host, packed_host), event, pinned


class CorrectionRunner:
    """Owns the model on its devices, their streams and the step.

    With no ``mesh`` the model runs on ``device``. With a :class:`Mesh` each
    row is a data replica and each batch splits over the rows in batch order,
    as the reference's ``shard_map`` over ``P("data")`` splits it
    (herro_tpu/pipeline/infer.py:135-152): with one column every replica is
    the whole model on its device (data parallelism); with ``tp`` columns
    each replica is the model sharded over its row (Megatron tensor
    parallelism, ``parallel/tensor.py``), and ``tp_fast_path`` is True. The
    port keeps the flag's meaning "each shard runs the fused kernels at its
    own widths", which holds for int8 too; the reference's flag is False for
    int8, whose tensor parallelism partitions the jnp twins by GSPMD
    (herro_tpu/pipeline/infer.py:153-163). The parts are joined on the host
    in batch order."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        collect_info: bool = False,
        counting_only: bool = False,
        collect_counting: bool = False,
        int8: bool | None = None,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        if int8 is not None and int8 != cfg.int8:
            cfg = dataclasses.replace(cfg, int8=int8)  # overrides the checkpoint's
        self.cfg = cfg
        self.mesh = mesh
        self.collect_info = collect_info
        # Also surface the pure counting decode per window.
        self.collect_counting = collect_counting
        # Diagnostic: skip the model override at supported columns.
        self.counting_only = counting_only
        self.tp_fast_path = mesh is not None and mesh.tp > 1
        rows = mesh.devices if mesh is not None else ((device,),)
        rows = [tuple(resolve_device(d) for d in row) for row in rows]
        self.replicas, models = [], []
        for row in rows:
            keep_float32_exact(row[0])
            if len(row) == 1:
                model = CorrectionModel(cfg)
                model.load_state_dict(params)
                model = model.to(row[0]).eval()
            else:
                model = TensorParallelModel(cfg, params, row)
            models.append(model)
            self.replicas.append(_Replica(make_correct_step_packed(model), row[0], row))
        # the first replica's, as the single-device runner has them
        self.model = models[0]
        self.device = rows[0][0]
        self.stream = self.replicas[0].streams[0] if self.replicas[0].streams else None

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
        same overlap from its inference thread, src/lib.rs:189-196). Under a
        mesh each replica takes its rows of the batch."""
        arrays = self._inputs(batch)
        n = len(self.replicas)
        if arrays[0].shape[0] % n:
            raise ValueError(
                f"batch size {arrays[0].shape[0]} is not divisible by the data axis ({n})"
            )
        splits = [np.split(a, n) for a in arrays]
        parts = [r.dispatch([s[i] for s in splits], self.collect_info)
                 for i, r in enumerate(self.replicas)]
        outputs, events, pinned = zip(*parts)
        return InFlight(batch, outputs, events, pinned)

    def finalize(self, inflight: InFlight) -> list[WindowResult]:
        """Wait for a dispatched batch's results and unpack them."""
        return self._unpack(inflight.batch, *self._fetch(inflight))

    def _fetch(self, inflight: InFlight) -> tuple[np.ndarray | None, np.ndarray]:
        """Wait for a dispatched batch; (info or None, decisions‖classes), the
        replicas' parts joined in batch order."""
        for event in inflight.events:
            if event is not None:
                event.synchronize()
        infos, packed = zip(*inflight.outputs)
        info = None
        if self.collect_info:
            info = np.concatenate([i.numpy() for i in infos])
        return info, np.concatenate([p.numpy() for p in packed])

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
