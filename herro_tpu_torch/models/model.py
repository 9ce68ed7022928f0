"""Correction transformer, PyTorch.

The same network as ``herro_tpu/models/model.py``, with the same parameter
tree: inputs are the window pileup ``bases`` (token ids 0-11, row-major
[B, R, L]) and normalised ``quals`` ([-1, 1]); outputs are a 5-way
{A,C,G,T,*} classification plus a scalar info logit at every supported
pileup column ([B, S, 5] / [B, S]; ``support_idx`` [B, S] with a validity
``support_mask``).

Each column's 31 (base, qual) pairs are embedded and fused into d_model (the
``entry_embed`` op: a one-hot contraction over row x vocab plus a qual
contraction over rows); a pre-norm rotary transformer encoder with a banded
attention mixes along the column axis; heads classify the gathered supported
columns. Parameters are float32; the stack computes in ``cfg.dtype``
(bfloat16 on the card) through the ops of ``ops/fused.py``, whose CUDA
kernels run on the card and whose plain versions run on the CPU. With
``cfg.int8`` the qkv projection and the FFN run their int8 variants.

Under autograd the entry, attention and FFN ops run their kernels forward
and differentiate their plain versions backward (``ops/fused.py``), and with
``cfg.remat`` each block is a ``torch.utils.checkpoint`` region, as
``nn.remat(Block)`` in the reference: its forward, so each of its kernels,
runs twice a training step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..constants import N_ROWS, TOKEN_PAD, VOCAB_SIZE
from ..ops.fused import (
    attention_block,
    attention_block_q,
    col_proj_table,
    entry_embed,
    k_major,
    ln_ffn,
    ln_ffn_q,
    quantize_weight,
)


@dataclass(frozen=True)
class ModelConfig:
    d_model: int = 256
    n_layers: int = 8
    n_heads: int = 2
    d_ff: int = 1024
    base_embed_dim: int = 16
    # Attention span along the pileup column axis; None = full attention.
    local_window: int | None = None
    # Kept for checkpoint-config compatibility with herro_tpu.
    attn_impl: str = "auto"
    dtype: str = "bfloat16"
    # Rematerialise each block in the backward pass (training only): saved
    # activations drop to one residual per layer, for a second forward of
    # every block.
    remat: bool = True
    # Inference-time int8: dynamic per-row activation and per-channel weight
    # quantization of the qkv projection and the two FFN products. Weights
    # stay float32 in the checkpoint and are quantized when the ops' weights
    # are built. Entry, attention, out projection and heads keep their types.
    # Training differentiates the quantized forward as the reference does
    # (the scales carry the gradient, the rounding none): on the card the
    # int8 kernels run forward and their plain versions backward.
    int8: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


TINY_CONFIG = ModelConfig(
    d_model=32, n_layers=2, n_heads=2, d_ff=64, base_embed_dim=4, dtype="float32"
)
# Flagship R10.4.1 configuration: d512 x 3 layers, 4 heads of 128, band +-512.
R10_CONFIG = ModelConfig(
    d_model=512, n_layers=3, n_heads=4, d_ff=1024, local_window=512
)
R10_WIDE_CONFIG = R10_CONFIG
R10_DEEP_CONFIG = ModelConfig(local_window=512)
R9_CONFIG = ModelConfig(d_ff=1536, local_window=512)

CONFIGS = {
    "tiny": TINY_CONFIG,
    "r10": R10_CONFIG,
    "r9": R9_CONFIG,
    "r10w": R10_WIDE_CONFIG,
    "r10deep": R10_DEEP_CONFIG,
}


def _param(shape, generator, fan_in: int | None):
    """A float32 parameter: truncated-normal(1/sqrt(fan_in)) when fan_in is
    given (lecun-normal, as flax's Dense init), else zeros."""
    t = torch.zeros(shape, dtype=torch.float32)
    if fan_in is not None:
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    return nn.Parameter(t)


class Dense(nn.Module):
    """``{kernel [in, out], bias [out]}`` as flax's Dense stores them."""

    def __init__(self, d_in: int, d_out: int, generator=None):
        super().__init__()
        self.kernel = _param((d_in, d_out), generator, d_in)
        self.bias = _param((d_out,), generator, None)


class LayerNormParams(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Attention(nn.Module):
    """qkv [d, 3*H*D] in the (3, H, D) c-major flattening (q of head i is
    column block i, k is H+i, v is 2H+i) and out [H, D, d]."""

    def __init__(self, cfg: ModelConfig, generator=None):
        super().__init__()
        h, dh, d = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_model
        self.qkv_kernel = _param((d, 3 * h * dh), generator, d)
        self.qkv_bias = _param((3 * h * dh,), generator, None)
        self.out_kernel = _param((h, dh, d), generator, h * dh)
        self.out_bias = _param((d,), generator, None)


class Block(nn.Module):
    """Pre-norm transformer block: the fused attention block (LN + qkv +
    rope, banded attention + out projection + residual), then the fused
    LN + FFN + residual."""

    def __init__(self, cfg: ModelConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNormParams(cfg.d_model)
        self.attn = Attention(cfg, generator)
        self.ln2 = LayerNormParams(cfg.d_model)
        self.ff1 = Dense(cfg.d_model, cfg.d_ff, generator)
        self.ff2 = Dense(cfg.d_ff, cfg.d_model, generator)

    def compute_weights(self) -> dict:
        """The matmul weights and biases as the ops take them: in the compute
        dtype, or under ``cfg.int8`` quantized (LayerNorm parameters stay
        float32). As the reference, int8 quantizes the qkv kernel after its
        cast to the compute dtype and the FFN kernels from the float32
        parameters, and hands the FFN biases over in float32; under autograd
        the scales stay in the graph, as in the reference's jitted step."""
        dt = self.cfg.compute_dtype
        a = self.attn
        w = dict(b_qkv=a.qkv_bias.to(dt), wo=a.out_kernel.to(dt), bo=a.out_bias.to(dt))
        if not self.cfg.int8:
            return dict(
                w, w_qkv=a.qkv_kernel.to(dt),
                w1=self.ff1.kernel.to(dt), b1=self.ff1.bias.to(dt),
                w2=self.ff2.kernel.to(dt), b2=self.ff2.bias.to(dt),
            )
        for name, kernel in (("qkv", a.qkv_kernel.to(dt)), ("1", self.ff1.kernel),
                             ("2", self.ff2.kernel)):
            w_i8, s = quantize_weight(kernel)
            w[f"w{name}_i8"], w[f"s{name}"] = k_major(w_i8), s
        return dict(w, b1=self.ff1.bias, b2=self.ff2.bias)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, w: dict) -> torch.Tensor:
        """``w`` is this block's ``compute_weights()``."""
        cfg = self.cfg
        if cfg.int8:
            x = attention_block_q(
                x, self.ln1.scale, self.ln1.bias, w["wqkv_i8"], w["sqkv"], w["b_qkv"],
                w["wo"], w["bo"], lengths, cfg.n_heads, cfg.local_window,
            )
            return ln_ffn_q(
                x, self.ln2.scale, self.ln2.bias, w["w1_i8"], w["s1"], w["b1"],
                w["w2_i8"], w["s2"], w["b2"],
            )
        x = attention_block(
            x, self.ln1.scale, self.ln1.bias, w["w_qkv"], w["b_qkv"], w["wo"],
            w["bo"], lengths, cfg.n_heads, cfg.local_window,
        )
        return ln_ffn(
            x, self.ln2.scale, self.ln2.bias, w["w1"], w["b1"], w["w2"], w["b2"]
        )


def flax_layernorm(x, scale, bias, dtype, eps: float = 1e-6):
    """flax.linen.LayerNorm(dtype=dtype): float32 statistics with the fast
    variance, y = (x - mu) * (rsqrt(var + eps) * scale) + bias, cast to
    dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mu) * mul + bias.float()).to(dtype)


class CorrectionModel(nn.Module):
    """bases [B,R,L] uint8 (vocab 0-11), quals [B,R,L] f32 in [-1,1],
    support_idx [B,S] int, support_mask [B,S] bool
    -> (info_logits [B,S], bases_logits [B,S,5])."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        R, V, d = N_ROWS, VOCAB_SIZE, cfg.d_model
        fan_in = R * (V + 1)  # col_proj is a dense over concat_r(onehot_r, qual_r)
        self.col_proj = nn.Module()
        self.col_proj.w_embT = _param((d, R * V), generator, fan_in)
        self.col_proj.w_qT = _param((d, R), generator, fan_in)
        self.col_proj.bias = _param((d,), generator, None)
        self.blocks = nn.ModuleList(Block(cfg, generator) for _ in range(cfg.n_layers))
        self.ln_f = LayerNormParams(d)
        self.bases_head = Dense(d, 5, generator)
        self.info_head = Dense(d, 1, generator)
        self._weights = None  # (key, parameters' storages, weights)

    def gather(self, values=None) -> dict:
        """``values`` (one tensor a parameter, in :meth:`parameters`' order;
        the parameters themselves by default) under the parameters' names:
        what ``TensorParallelModel.gather`` gives for a sharded replica, so
        the trainer reads either kind of replica's logical parameters,
        gradients or moments alike."""
        values = self.parameters() if values is None else values
        return {name: v for (name, _), v in zip(self.named_parameters(), values)}

    def _build_weights(self) -> dict:
        cp = self.col_proj
        dt = self.cfg.compute_dtype
        return dict(
            wc=col_proj_table(cp.w_embT.to(dt), cp.w_qT.to(dt)),
            blocks=[block.compute_weights() for block in self.blocks],
        )

    def compute_weights(self) -> dict:
        """The ops' weights in the compute dtype and the col_proj table,
        built once per parameter state instead of on every batch. With
        gradients on they are built afresh, so gradients reach the
        parameters. The cache holds the parameters' storages, so no address
        in its key is reused while it stands; an in-place update bumps a
        version and rebuilds."""
        if torch.is_grad_enabled():
            return self._build_weights()
        params = [p.detach() for p in self.parameters()]
        key = (
            self.cfg.compute_dtype, torch.is_inference_mode_enabled(),
            tuple((p.data_ptr(), p._version) for p in params),
        )
        if self._weights is None or self._weights[0] != key:
            self._weights = (key, params, self._build_weights())
        return self._weights[2]

    def forward(self, bases, quals, support_idx, support_mask):
        cfg = self.cfg
        dt = cfg.compute_dtype
        B, R, L = bases.shape
        if R != N_ROWS:
            raise ValueError(f"expected {N_ROWS} pileup rows, got {R}")
        w = self.compute_weights()
        x = entry_embed(bases, quals.float(), w["wc"], self.col_proj.bias, dt)  # [B, L, d]

        # Padding is always a suffix, so a per-example length suffices.
        lengths = (bases[:, 0, :] != TOKEN_PAD).sum(dim=1, dtype=torch.int32)
        remat = cfg.remat and torch.is_grad_enabled()
        for block, bw in zip(self.blocks, w["blocks"]):
            if remat:
                x = checkpoint(block, x, lengths, bw, use_reentrant=False)
            else:
                x = block(x, lengths, bw)

        return self.head(x, support_idx, support_mask)

    def head(self, x, support_idx, support_mask):
        """The tail on the stream x [B, L, d] after the last block: gather the
        supported columns, the final LayerNorm, the two heads, the mask."""
        # Gather supported columns first: the final LayerNorm is per-token,
        # so it commutes with the gather (herro_tpu/models/model.py:269-275).
        idx = support_idx.long()[..., None].expand(-1, -1, x.shape[-1])
        g = torch.gather(x, 1, idx)
        g = flax_layernorm(g, self.ln_f.scale, self.ln_f.bias, self.cfg.compute_dtype).float()

        bases_logits = g @ self.bases_head.kernel + self.bases_head.bias
        info_logits = (g @ self.info_head.kernel + self.info_head.bias)[..., 0]

        neg = torch.full((), -1e9, dtype=torch.float32, device=g.device)
        bases_logits = torch.where(support_mask[..., None], bases_logits, neg)
        info_logits = torch.where(support_mask, info_logits, neg)
        return info_logits, bases_logits
