"""Consensus decoding.

The reference decodes per pileup column (src/consensus.rs:86-227): at
supported columns take the model's 5-way argmax; elsewhere apply a counting
rule over the (case-folded) column symbols:

    keep the target base if the top count < 2, or if the top two counts tie
    and either is the target base; else take the plurality base; drop '*'.

The counting rule runs over whole batches on the device — the CUDA kernel K5
(``csrc/count_decisions.cu``) for CUDA tensors, its plain PyTorch version for
CPU tensors — with a numpy twin for windows that skip the model (no supported
columns). ``stitch_read`` then assembles corrected fragments, splitting at
windows with < 2 alignments (src/consensus.rs:90-110).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CLASS_TO_BASE, TOKEN_TO_CLASS
from . import cuda as _cuda

# Decision value for "not decodable" (padding columns).
DECISION_PAD = 255
# The most pileup rows the kernel counts: it packs a column's five counts
# into 6-bit fields of one register.
COUNT_MAX_ROWS = 63


def _count_decisions_plain(tokens: torch.Tensor, n_alns: torch.Tensor) -> torch.Tensor:
    """Counting-rule class per column: tokens [B, R, L] uint8 (vocab 0-11),
    n_alns [B] -> decisions [B, L] uint8 (a port of
    ``herro_tpu/ops/consensus.py:count_decisions_jnp``)."""
    B, R, L = tokens.shape
    t = tokens.to(torch.int32)
    cls = torch.where(t < 10, t % 5, 5)
    rows = torch.arange(R, dtype=torch.int32, device=tokens.device)
    valid = (rows[None, :, None] <= n_alns.to(torch.int32)[:, None, None]) & (cls < 5)
    counts = [((cls == c) & valid).sum(dim=1, dtype=torch.int32) for c in range(5)]

    # top-2 with ties resolved to the smallest class index — matching the
    # stable descending sort of the reference (src/consensus.rs:186-193).
    def top(cs):
        best_c = torch.zeros_like(cs[0])
        best_v = cs[0]
        for c in range(1, 5):
            better = cs[c] > best_v
            best_c = torch.where(better, c, best_c)
            best_v = torch.maximum(best_v, cs[c])
        return best_c, best_v

    c0, mc0 = top(counts)
    counts2 = [torch.where(c0 == c, -1, counts[c]) for c in range(5)]
    c1, mc1 = top(counts2)
    tbase = cls[:, 0, :]
    keep = (mc0 < 2) | ((mc0 == mc1) & ((c0 == tbase) | (c1 == tbase)))
    return torch.where(keep, tbase, c0).to(torch.uint8)


def _count_decisions_cuda(tokens: torch.Tensor, n_alns: torch.Tensor) -> torch.Tensor:
    B, R, L = tokens.shape
    _cuda.check(1 <= R <= COUNT_MAX_ROWS,
                f"R {R}: the kernel counts 1 to {COUNT_MAX_ROWS} pileup rows")
    _cuda.check(tokens.dtype == torch.uint8, f"tokens are {tokens.dtype}, not uint8")
    _cuda.check(n_alns.dtype == torch.int32 and n_alns.shape == (B,),
                "n_alns must be int32 [B]")
    for name, t in (("tokens", tokens), ("n_alns", n_alns)):
        _cuda.check(t.is_cuda and t.is_contiguous(), f"{name}: contiguous CUDA tensor")
    _cuda.check(n_alns.device == tokens.device, "n_alns and tokens on one device")
    out = torch.empty(B, L, dtype=torch.uint8, device=tokens.device)
    with torch.cuda.device(tokens.device):
        _cuda.call(
            "count_decisions", tokens.data_ptr(), n_alns.data_ptr(), out.data_ptr(),
            B, R, L, _cuda.stream_of(out),
        )
    return out


def count_decisions(tokens: torch.Tensor, n_alns: torch.Tensor) -> torch.Tensor:
    """Counting-rule class per column, tokens [B, R, L] uint8 -> [B, L]
    uint8: the CUDA kernel for CUDA tensors (refused under
    ``HERRO_TPU_PALLAS=0``), the plain version on the CPU."""
    if _cuda.on_card(tokens):
        return _count_decisions_cuda(tokens, n_alns)
    return _count_decisions_plain(tokens, n_alns)


def count_decisions_np(tokens: np.ndarray, n_alns: int) -> np.ndarray:
    """Numpy twin of :func:`count_decisions` for one window [L, R]."""
    cls = TOKEN_TO_CLASS[tokens].astype(np.int32)
    cls[:, n_alns + 1 :] = 5
    counts = np.zeros((tokens.shape[0], 5), dtype=np.int32)
    for k in range(5):
        counts[:, k] = (cls == k).sum(axis=1)
    c0 = np.argmax(counts, axis=-1)
    mc0 = np.take_along_axis(counts, c0[:, None], axis=-1)[:, 0]
    counts2 = counts.copy()
    np.put_along_axis(counts2, c0[:, None], -1, axis=-1)
    c1 = np.argmax(counts2, axis=-1)
    mc1 = np.take_along_axis(counts2, c1[:, None], axis=-1)[:, 0]
    tbase = TOKEN_TO_CLASS[tokens[:, 0]].astype(np.int32)
    keep_target = (mc0 < 2) | ((mc0 == mc1) & ((c0 == tbase) | (c1 == tbase)))
    return np.where(keep_target, tbase, c0).astype(np.uint8)


_CLASS_BYTES = np.frombuffer(CLASS_TO_BASE, dtype=np.uint8)


def decode_window(decisions: np.ndarray) -> bytes:
    """Column decisions -> corrected bases ('*' columns removed)."""
    d = decisions[decisions != DECISION_PAD]
    return _CLASS_BYTES[d[d != 4]].tobytes()


def stitch_read(
    windows: list[tuple[int, np.ndarray]],
) -> list[bytes] | None:
    """Assemble a read's corrected fragments.

    ``windows`` is a list of (n_alns, decisions[L_true]) ordered by window id.
    Returns None when no window has > 1 alignment; otherwise the list of
    corrected fragments, split wherever a window has < 2 alignments
    (reference: src/consensus.rs:86-227).
    """
    covered = [i for i, (n_alns, _) in enumerate(windows) if n_alns > 1]
    if not covered:
        return None
    lo, hi = covered[0], covered[-1] + 1

    fragments: list[bytes] = []
    current: list[bytes] = []
    for n_alns, decisions in windows[lo:hi]:
        if n_alns < 2:
            frag = b"".join(current)
            if frag:
                fragments.append(frag)
            current = []
            continue
        current.append(decode_window(decisions))
    frag = b"".join(current)
    if frag:
        fragments.append(frag)
    return fragments
