"""Banded attention, plain PyTorch.

A port of ``herro_tpu/ops/attention.py:chunked_attention``: blocked over
query rows, each block scoring only the static key span its band can reach
(O(L * window) instead of O(L^2)). It is the plain version of the three CUDA
flash/out-projection kernels (K2, K6 and K7, ``csrc/flash_outproj*.cu``) and
the path the model takes on the CPU.

q/k/v are [B, H, L, D]; ``lengths`` [B] counts the valid (prefix) columns of
each example — padding is always a suffix of the pileup column axis.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BLK_Q = 512  # query rows per block: bounds the [B, H, blk, span] score tensor


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    local_window: int | None = None,
) -> torch.Tensor:
    """Softmax attention over keys with |iq - ik| <= local_window (all keys
    when None) and ik < length, in float32; returns q's dtype."""
    B, H, L, D = q.shape
    blk_q = min(BLK_Q, L)
    if L % blk_q:
        blk_q = L  # irregular length: single chunk
    scale = 1.0 / math.sqrt(D)
    span = L if local_window is None else min(L, blk_q + 2 * local_window)
    lengths = lengths.to(q.device)
    outs = []
    for i in range(L // blk_q):
        k0 = 0
        if local_window is not None:
            k0 = min(max(i * blk_q - local_window, 0), L - span)
        kb = k[:, :, k0 : k0 + span].float()
        vb = v[:, :, k0 : k0 + span].float()
        qb = q[:, :, i * blk_q : (i + 1) * blk_q].float() * scale
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kb)
        k_pos = torch.arange(k0, k0 + span, device=q.device)
        mask = (k_pos[None, :] < lengths[:, None])[:, None, None, :]
        if local_window is not None:
            q_pos = torch.arange(i * blk_q, (i + 1) * blk_q, device=q.device)
            band = (q_pos[:, None] - k_pos[None, :]).abs() <= local_window
            mask = mask & band[None, None]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vb).to(q.dtype))
    return torch.cat(outs, dim=2)
