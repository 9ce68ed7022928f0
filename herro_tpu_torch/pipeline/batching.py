"""Window tensorization and static-shape bucketed batching.

The reference pads every batch to its longest window (src/inference.rs:73-145)
— the reference JAX package pads to a small ladder of static (L, S) buckets
instead, so its jitted step compiles a handful of programs. The port keeps the
same ladder: batch bytes stay identical to the reference's, and the device
step sees few distinct shapes:

* ``L`` (pileup columns) is rounded up to the next bucket length;
* ``S`` (supported positions) is rounded up to a per-``L`` ladder of
  fractions, since typical windows have supported counts far below L;
* batches are padded to the configured batch size with empty windows.

Token / qual padding values (11 / 126) match the reference collate
(src/inference.rs:85-97).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    BASES_MAP,
    GAP_FWD,
    N_ROWS,
    QUAL_PAD,
    TOKEN_PAD,
)
from ..features.extract import WindowFeatures


@dataclass
class WindowTensors:
    """Model-ready representation of one window.

    Two equivalent storage layouts:

    * column-major (``tokens``/``quals`` [L, 31]) — what :func:`tensorize`
      builds from a :class:`WindowFeatures`;
    * device layout (``tokens_packed`` [16, L] nibble rows + ``quals_rm``
      [31, L]) — what the native tensor emit produces directly
      (ht_read_emit_tensors); :func:`collate` then reduces to row memcpys.

    Exactly one layout is populated; both collate to identical batch bytes
    (tests/test_extract_parity.py).
    """

    rid: int
    wid: int
    n_alns: int
    n_total_wins: int
    tokens: np.ndarray | None  # uint8 [L, 31] vocab ids
    quals: np.ndarray | None  # uint8 [L, 31] phred+33 bytes
    support_flat: np.ndarray  # int32 [n_sup] flat column index per supported pos
    supported: np.ndarray | None  # structured (pos, ins) — training dumps only
    tokens_packed: np.ndarray | None = None  # uint8 [16, L] packed nibble rows
    quals_rm: np.ndarray | None = None  # uint8 [31, L]

    @property
    def length(self) -> int:
        if self.tokens is not None:
            return self.tokens.shape[0]
        return self.tokens_packed.shape[1]

    @property
    def n_supported(self) -> int:
        return self.support_flat.shape[0]

    def tokens_lc(self) -> np.ndarray:
        """[L, 31] vocab ids regardless of storage layout (host-side
        counting decode of no-supported windows)."""
        if self.tokens is not None:
            return self.tokens
        return np.ascontiguousarray(
            unpack_tokens_np(self.tokens_packed, N_ROWS).T
        )


def encode_window(
    bases: np.ndarray, supported: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(vocab tokens, flat supported column indices) of a pileup byte matrix
    (reference: src/inference.rs:214-268). The single definition of the
    bit-compatibility-critical encoding — used by the inference batcher and
    the distillation dump loader alike."""
    tokens = BASES_MAP[bases]
    anchors = np.nonzero(bases[:, 0] != GAP_FWD)[0]
    support_flat = (
        anchors[supported["pos"].astype(np.int64)]
        + supported["ins"].astype(np.int64)
    ).astype(np.int32)
    return tokens, support_flat


def tensorize(wf: WindowFeatures) -> WindowTensors:
    """Encode pileup bytes to vocab ids and flatten supported (pos, ins) to
    column indices (reference: src/inference.rs:214-268)."""
    tokens, support_flat = encode_window(wf.bases, wf.supported)
    return WindowTensors(
        rid=wf.rid,
        wid=wf.wid,
        n_alns=wf.n_alns,
        n_total_wins=wf.n_total_wins,
        tokens=tokens,
        quals=wf.quals,
        support_flat=support_flat,
        supported=wf.supported,
    )


@dataclass(frozen=True)
class BucketSpec:
    """Ladder of static shapes for the jitted step.

    The top rungs are first-class production widths: a W=4096 window plus
    its reserved insertion columns runs ~7-10k pileup columns at realistic
    coverage/error profiles (R10 ~9k, R9 ~10.2k), so those shapes must hit a
    pre-compiled program, not the ad-hoc fallback."""

    lengths: tuple[int, ...] = (
        1024, 2048, 3072, 4096, 5120, 6144, 8192, 9216, 10240,
    )
    # supported-count ladder, as fractions of the L bucket
    sup_fractions: tuple[float, ...] = (0.125, 0.375, 1.0)

    def bucket_for(self, length: int, n_sup: int) -> tuple[int, int]:
        i = bisect.bisect_left(self.lengths, length)
        if i == len(self.lengths):
            # Extremely inserted window: fall back to the next multiple of
            # 1024 (a fresh compile, but correctness over ladder purity).
            L = -(-length // 1024) * 1024
        else:
            L = self.lengths[i]
        for f in self.sup_fractions:
            S = max(8, int(L * f))
            if n_sup <= S:
                return L, S
        return L, L


def pack_tokens(tokens: np.ndarray) -> np.ndarray:
    """Pack 4-bit vocab ids pairwise: ``[..., R]`` uint8 -> ``[..., (R+1)//2]``.

    The vocab is 12 ids (< 16), and host->device bytes are the throughput
    limit of the inference engine on bandwidth-constrained links (and half
    of H2D traffic everywhere): tokens ship as nibbles and unpack on device
    (``unpack_tokens_torch``) in the fused step.
    """
    r = tokens.shape[-1]
    if r % 2:
        pad = np.full(tokens.shape[:-1] + (1,), TOKEN_PAD, dtype=np.uint8)
        tokens = np.concatenate([tokens, pad], axis=-1)
    return (tokens[..., 0::2] | (tokens[..., 1::2] << 4)).astype(np.uint8)


def unpack_tokens_np(packed: np.ndarray, n_rows: int) -> np.ndarray:
    """Unpack ``[..., P, L]`` row-major packed nibbles -> ``[..., n_rows, L]``
    uint8 (numpy twin of :func:`unpack_tokens_torch`). Packed row p holds rows
    2p (low nibble) and 2p+1 (high nibble)."""
    lo = packed & 0xF
    hi = packed >> 4
    p, L = packed.shape[-2:]
    full = np.stack([lo, hi], axis=-2).reshape(packed.shape[:-2] + (2 * p, L))
    return full[..., :n_rows, :].astype(np.uint8)


def unpack_tokens_torch(packed, n_rows: int):
    """torch twin: ``[..., P, L]`` packed nibble rows -> ``[..., n_rows, L]``
    uint8, on the device of ``packed``. Packed row p holds rows 2p (low
    nibble) and 2p+1 (high nibble)."""
    import torch

    lo = packed & 0xF
    hi = packed >> 4
    p, L = packed.shape[-2], packed.shape[-1]
    full = torch.stack([lo, hi], dim=-2).reshape(packed.shape[:-2] + (2 * p, L))
    return full[..., :n_rows, :].contiguous()


@dataclass
class Batch:
    """One padded, static-shape batch, **row-major** on the device axis
    order: the long column axis L is minor (TPU 128-lane aligned — a
    [B, L, 31] layout lane-pads the 31-row axis 4x). Token nibbles ship
    packed."""

    tokens_packed: np.ndarray  # uint8 [B, 16, L] packed 4-bit vocab id rows
    quals: np.ndarray  # uint8 [B, 31, L]
    support_idx: np.ndarray  # int32 [B, S]
    support_mask: np.ndarray  # bool [B, S]
    n_alns: np.ndarray  # int32 [B]
    windows: list[WindowTensors]  # the real (unpadded) members

    @property
    def shape_key(self) -> tuple[int, int, int]:
        return (
            self.tokens_packed.shape[0],
            self.tokens_packed.shape[2],
            self.support_idx.shape[1],
        )


def collate(windows: list[WindowTensors], L: int, S: int, batch_size: int) -> Batch:
    B = batch_size
    support_idx = np.zeros((B, S), dtype=np.int32)
    support_mask = np.zeros((B, S), dtype=bool)
    n_alns = np.zeros(B, dtype=np.int32)
    for i, w in enumerate(windows):
        s = w.n_supported
        support_idx[i, :s] = w.support_flat
        support_mask[i, :s] = True
        n_alns[i] = w.n_alns

    if windows[0].tokens_packed is not None:
        # Device-layout windows (native tensor emit): pure row memcpys. The
        # packed pad byte is two TOKEN_PAD nibbles — identical to packing a
        # TOKEN_PAD-filled [B, L, R] matrix.
        P = windows[0].tokens_packed.shape[0]
        R = 2 * P - 1
        packed = np.full(
            (B, P, L), TOKEN_PAD | (TOKEN_PAD << 4), dtype=np.uint8
        )
        quals = np.full((B, R, L), QUAL_PAD, dtype=np.uint8)
        for i, w in enumerate(windows):
            l = w.length
            packed[i, :, :l] = w.tokens_packed
            quals[i, :, :l] = w.quals_rm
        return Batch(packed, quals, support_idx, support_mask, n_alns, windows)

    R = windows[0].tokens.shape[1]
    tokens = np.full((B, L, R), TOKEN_PAD, dtype=np.uint8)
    quals = np.full((B, R, L), QUAL_PAD, dtype=np.uint8)
    for i, w in enumerate(windows):
        l = w.length
        tokens[i, :l] = w.tokens
        quals[i, :, :l] = w.quals.T
    packed = np.ascontiguousarray(pack_tokens(tokens).transpose(0, 2, 1))
    return Batch(packed, quals, support_idx, support_mask, n_alns, windows)


class BucketBatcher:
    """Accumulates windows per (L, S) bucket; emits full batches.

    ``max_staged`` bounds the total number of windows staged across all
    partial buckets: when an ``add`` pushes the total past the bound, the
    *oldest* partial bucket (by arrival of its first window) is emitted as a
    padded partial batch. Unbounded staging is a real liability at assembly
    scale — a window could otherwise sit in a rare (L, S) bucket until the
    end-of-run flush while its read's finished decisions pile up in the
    consensus accumulator (the reference streams strictly and never stages
    more than one batch per device, src/inference.rs:177-211). Age-based
    (rather than biggest-first) eviction also bounds *read latency*, which is
    what caps the consensus accumulator's pending set. Output bytes are
    invariant: windows are decided independently, padding rows are discarded
    on unpack.
    """

    def __init__(
        self,
        spec: BucketSpec,
        batch_size: int,
        max_staged: int | None = None,
    ):
        self.spec = spec
        self.batch_size = batch_size
        if max_staged is None:
            max_staged = 8 * batch_size
        # always allow at least one full bucket to accumulate
        self.max_staged = max(max_staged, batch_size)
        self._pending: dict[tuple[int, int], list[WindowTensors]] = {}
        self._born: dict[tuple[int, int], int] = {}  # bucket -> first-add tick
        self._tick = 0
        self._n_staged = 0
        self.n_partial_flushes = 0  # diagnostic

    @property
    def n_staged(self) -> int:
        return self._n_staged

    def _emit(self, key: tuple[int, int]) -> Batch:
        ws = self._pending.pop(key)
        del self._born[key]
        self._n_staged -= len(ws)
        return collate(ws, key[0], key[1], self.batch_size)

    def add(self, w: WindowTensors) -> Batch | None:
        key = self.spec.bucket_for(w.length, w.n_supported)
        pend = self._pending.setdefault(key, [])
        if not pend:
            self._born[key] = self._tick
        self._tick += 1
        pend.append(w)
        self._n_staged += 1
        if len(pend) == self.batch_size:
            return self._emit(key)
        if self._n_staged > self.max_staged:
            self.n_partial_flushes += 1
            oldest = min(self._born, key=self._born.get)
            return self._emit(oldest)
        return None

    def flush(self) -> list[Batch]:
        out = [self._emit(key) for key in list(self._pending)]
        return out
