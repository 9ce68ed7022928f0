"""Attention for the correction transformer: one interface, three routes.

A port of ``herro_tpu/ops/attention.py``:

* ``flash`` — the hand-written kernel (K9) for CUDA tensors: the Hopper
  kernel (``csrc/flash_attention.cu``) for bf16 at head dim 128, the
  instances for the other widths (``csrc/flash_f32.cu`` and
  ``csrc/flash_bf16.cu`` over ``flash_tc.cuh``'s ``mma.sync``, modes
  ``flash_f32_attention`` and ``flash_bf16_attention``) for float32 at head
  dims 16-128 and bf16 at 16-112, every multiple of 16; online-softmax
  tiling, so the [L, L] score matrix never exists in device memory; a
  suffix length mask and an optional band. For CPU tensors its plain
  PyTorch version runs. The forward is the kernel, the
  backward recomputes through ``chunked`` (the reference has no backward
  kernel either);
* ``chunked`` — plain PyTorch, blocked over query rows, each block scoring
  only the static key span its band can reach (O(L * window) instead of
  O(L^2)); differentiable. It is also the plain version of the three fused
  flash/out-projection kernels (K2, K6 and K7, ``csrc/flash_outproj*.cu``) and
  the path the model takes on the CPU;
* ``naive`` — the reference einsum over the whole [L, L] matrix, for tests.

q/k/v are [B, H, L, D]; ``lengths`` [B] counts the valid (prefix) columns of
each example — padding is always a suffix of the pileup column axis. Query
rows with no key to attend are padding: every route leaves them finite, and
no two routes agree on them (``flash`` gives 0 for an example of length 0,
``chunked`` and ``naive`` the mean of v).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import cuda as _cuda

NEG_INF = -1e30
BLK_Q = 512  # query rows per block: bounds the [B, H, blk, span] score tensor
# the head dim the bf16 Hopper flash kernel takes; the bf16 SIMT kernel
# (csrc/flash_bf16.cu) serves the other head dims of cuda.F32_HEAD_DIMS
FLASH_HEAD_DIM = 128
# keys a tile of the bf16 instances' online softmax (csrc/flash_tc.cuh kBKV):
# the tile of the bf16 instance's yardstick, _flash_attention_tiled
SIMT_KEY_TILE = 64


def _query_blocks(L: int, local_window: int | None):
    """(first query row, rows, first key, keys) of each query block: the keys
    a block's band can reach, or all of them."""
    blk_q = min(BLK_Q, L)
    if L % blk_q:
        blk_q = L  # irregular length: single chunk
    span = L if local_window is None else min(L, blk_q + 2 * local_window)
    for i in range(L // blk_q):
        k0 = 0
        if local_window is not None:
            k0 = min(max(i * blk_q - local_window, 0), L - span)
        yield i * blk_q, blk_q, k0, span


def _block_scores(q, k, lengths, local_window, q0, blk_q, k0, span):
    """Scaled float32 scores [B, H, blk_q, span] of one query block and the
    mask of the keys it may attend (ik < length, inside the band)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qb = q[:, :, q0 : q0 + blk_q].float() * scale
    s = torch.einsum("bhqd,bhkd->bhqk", qb, k[:, :, k0 : k0 + span].float())
    k_pos = torch.arange(k0, k0 + span, device=q.device)
    mask = (k_pos[None, :] < lengths[:, None])[:, None, None, :]
    if local_window is not None:
        q_pos = torch.arange(q0, q0 + blk_q, device=q.device)
        band = (q_pos[:, None] - k_pos[None, :]).abs() <= local_window
        mask = mask & band[None, None]
    return s, mask


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    local_window: int | None = None,
) -> torch.Tensor:
    """Softmax attention over keys with |iq - ik| <= local_window (all keys
    when None) and ik < length, in float32; returns q's dtype. Under autograd
    each block is rematerialised in the backward pass, so the probabilities of
    one block at a time are alive, not of all of them."""
    lengths = lengths.to(q.device)

    def block(q, k, v, q0, blk_q, k0, span):
        s, mask = _block_scores(q, k, lengths, local_window, q0, blk_q, k0, span)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        p = torch.softmax(s, dim=-1)
        vb = v[:, :, k0 : k0 + span].float()
        return torch.einsum("bhqk,bhkd->bhqd", p, vb).to(q.dtype)

    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for bounds in _query_blocks(q.shape[2], local_window):
        if remat:
            outs.append(checkpoint(block, q, k, v, *bounds, use_reentrant=False))
        else:
            outs.append(block(q, k, v, *bounds))
    return torch.cat(outs, dim=2)


def naive_attention(q, k, v, lengths, local_window=None):
    """The whole [L, L] score matrix at once (``naive_attention`` of the
    reference): for tests at small L."""
    L = q.shape[2]
    lengths = lengths.to(q.device)
    s, mask = _block_scores(q, k, lengths, local_window, 0, L, 0, L)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# K9 flash_attention: the kernel, its plain version, its autograd wrapper
# ---------------------------------------------------------------------------


def _flash_attention_plain(q, k, v, lengths, local_window=None):
    """The plain version of the flash kernel: p = exp(s - max) with masked
    keys at 0, P rounded to v's dtype for P.V, the sum divided by the row sum
    clamped at 1e-30. A row with no key to attend therefore comes out 0 (the
    kernel: every row of a length-0 example)."""
    lengths = lengths.to(q.device)
    outs = []
    for q0, blk_q, k0, span in _query_blocks(q.shape[2], local_window):
        s, mask = _block_scores(q, k, lengths, local_window, q0, blk_q, k0, span)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        vb = v[:, :, k0 : k0 + span]
        acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vb.float())
        outs.append((acc / l).to(q.dtype))
    return torch.cat(outs, dim=2)


def _flash_attention_tiled(q, k, v, lengths, local_window=None, tile: int = SIMT_KEY_TILE):
    """K9's function step by step as the online softmax takes it: the keys
    in tiles of ``tile`` (tile i holds keys i*tile .. (i+1)*tile - 1), each
    tile's p = exp(s - m) against the running maximum m of the valid keys
    so far, rounded to v's dtype for P.V, the accumulator and the unrounded
    row sum rescaled by exp(m_old - m) at each tile, the sum divided by the
    row sum clamped at 1e-30 at the end (``herro_tpu/ops/attention.py:
    _flash_kernel``, whose ``blk_k`` is the tile). The yardstick of the
    kernels that round P that way (``flash_bf16_attention``: 64-key tiles,
    ``csrc/flash_tc.cuh``): against :func:`_flash_attention_plain`, which
    rounds P against the whole row's maximum, a bf16 output may sit an ulp
    away wherever the running maximum rose. For tests and the card's
    checks only; no route of :func:`attention` takes it."""
    lengths = lengths.to(q.device)
    L = q.shape[2]
    outs = []
    for q0, blk_q, k0, span in _query_blocks(L, local_window):
        a = k0 // tile * tile  # the keys of whole tiles around the block's span
        n = min(-(-(k0 + span) // tile) * tile, L) - a
        s, mask = _block_scores(q, k, lengths, local_window, q0, blk_q, a, n)
        nt = -(-n // tile)
        pad = nt * tile - n
        s = torch.nn.functional.pad(torch.where(mask, s, NEG_INF), (0, pad), value=NEG_INF)
        mask = torch.nn.functional.pad(mask.expand_as(s[..., :n]), (0, pad))
        vb = torch.nn.functional.pad(v[:, :, a:a + n].float(), (0, 0, 0, pad))
        s, mask = s.unflatten(-1, (nt, tile)), mask.unflatten(-1, (nt, tile))
        m = s.amax(dim=-1).cummax(dim=-1).values  # [B, H, blk_q, nt] after each tile
        m_prev = torch.cat([torch.full_like(m[..., :1], NEG_INF), m[..., :-1]], dim=-1)
        alpha = torch.exp(m_prev - m)
        p = torch.exp(s - m[..., None]) * mask
        acc = torch.zeros(*q.shape[:2], blk_q, q.shape[3], device=q.device)
        l = torch.zeros(*q.shape[:2], blk_q, 1, device=q.device)
        for t in range(nt):
            pt, at = p[..., t, :], alpha[..., t, None]
            l = l * at + pt.sum(dim=-1, keepdim=True)
            acc = acc * at + torch.einsum("bhqk,bhkd->bhqd", pt.to(v.dtype).float(),
                                          vb[:, :, t * tile:(t + 1) * tile])
        outs.append((acc / l.clamp_min(1e-30)).to(q.dtype))
    return torch.cat(outs, dim=2)


def _flash_attention_cuda(q, k, v, lengths, local_window=None, kernel: str | None = None):
    """``kernel`` names the instance; None takes ``flash_f32_attention`` for
    float32 and ``fused.bf16_kernel_name``'s for bf16."""
    _cuda.check(q.dim() == 4, f"q has {q.dim()} dimensions, the kernel takes [B, H, L, D]")
    B, H, L, D = q.shape
    if kernel is None:
        from .fused import bf16_kernel_name  # fused imports this module

        kernel = "flash_f32_attention" if q.dtype == torch.float32 else \
            bf16_kernel_name("flash_attention", D=D) if q.dtype == torch.bfloat16 \
            else "flash_attention"
    if kernel != "flash_attention":
        return _flash_attention_simt_cuda(q, k, v, lengths, local_window, kernel)
    _cuda.check(D == FLASH_HEAD_DIM, f"head dim {D}: the kernel takes {FLASH_HEAD_DIM}")
    _cuda.check(local_window is None or local_window >= 0,
                f"local_window {local_window} is negative")
    _cuda.check(k.shape == q.shape and v.shape == q.shape, "q/k/v shapes")
    _cuda.check(lengths.shape == (B,), "lengths shape")
    _cuda.require_dtype(torch.bfloat16, q=q, k=k, v=v)
    _cuda.require_dtype(torch.int32, lengths=lengths)
    dev = _cuda.require_operands(q=q, k=k, v=v, lengths=lengths)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        _cuda.call(
            "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, H, L,
            -1 if local_window is None else int(local_window), 1.0 / math.sqrt(D),
            _cuda.stream_of(q),
        )
    return out


def _flash_attention_simt_cuda(q, k, v, lengths, local_window, kernel: str):
    """K9's SIMT instances, ``flash_f32_attention`` and
    ``flash_bf16_attention``: q/k/v and the output of the instance's dtype."""
    from .fused import _check_f32_widths, _simt_kind  # fused imports this module

    B, H, L, D = q.shape
    dtype = _cuda.simt_dtype(kernel)
    _cuda.check(dtype is not None, f"no attention kernel {kernel!r}")
    _check_f32_widths(None, D=D, kind=_simt_kind(kernel))
    _cuda.check(local_window is None or local_window >= 0,
                f"local_window {local_window} is negative")
    _cuda.check(k.shape == q.shape and v.shape == q.shape, "q/k/v shapes")
    _cuda.check(lengths.shape == (B,), "lengths shape")
    _cuda.require_dtype(dtype, q=q, k=k, v=v)
    _cuda.require_dtype(torch.int32, lengths=lengths)
    dev = _cuda.require_operands(q=q, k=k, v=v, lengths=lengths)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        _cuda.call(
            kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, H, L, D,
            -1 if local_window is None else int(local_window), 1.0 / math.sqrt(D),
            _cuda.stream_of(q),
        )
    return out


def flash_attention(q, k, v, lengths, local_window=None):
    """Flash attention, forward only: the kernel for CUDA tensors (it raises
    on what it does not take), its plain version for CPU tensors."""
    if q.is_cuda:
        return _flash_attention_cuda(q, k, v, lengths, local_window)
    return _flash_attention_plain(q, k, v, lengths, local_window)


class _FlashWithVjp(torch.autograd.Function):
    """Flash forward, chunked-recompute backward (``_flash_with_vjp`` of the
    reference)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, local_window):
        ctx.save_for_backward(q, k, v, lengths)
        ctx.local_window = local_window
        return flash_attention(q, k, v, lengths, local_window)

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = chunked_attention(*qkv, lengths, ctx.local_window)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def attention(q, k, v, lengths, local_window=None, impl: str = "auto"):
    """[B, H, L, D] attention with the suffix-padding mask; impl in
    auto/flash/chunked/naive. ``auto`` is ``flash`` for CUDA tensors and
    ``chunked`` for CPU tensors, decided on the device alone: on the card
    the kernel runs or its wrapper raises (bf16 and float32 at head dims
    16-128, multiples of 16; ``HERRO_TPU_PALLAS`` is not read here, as the
    reference's ``attention`` does not read it), and
    plain PyTorch runs there only when ``chunked`` or ``naive`` is asked for
    by name."""
    if impl == "auto":
        impl = "flash" if q.is_cuda else "chunked"
    if impl == "flash":
        return _FlashWithVjp.apply(q, k, v, lengths, local_window)
    if impl == "chunked":
        return chunked_attention(q, k, v, lengths, local_window)
    if impl == "naive":
        return naive_attention(q, k, v, lengths, local_window)
    raise ValueError(f"impl {impl!r}: expected auto, flash, chunked or naive")
