"""Tensor parallelism: Megatron head and d_ff shards over one row of a mesh.

The counterpart of ``herro_tpu/parallel/tensor.py``. Attention heads and the
FFN hidden axis split over the ``model`` axis (the column-parallel qkv and
ff1, the row-parallel out projection and ff2); everything else replicates.
Each shard runs the same hand-written kernels as one device, at its own
widths (``h_loc = H / tp`` heads, ``d_ff / tp`` hidden columns), and one
:func:`all_reduce` per half-block recombines the stream.

Layout of shard j (the port's layouts, ``models/model.py``):

* ``w_qkv [d, 3*H*D]`` (the (3, H, D) c-major flattening) and ``b_qkv``:
  heads ``j*h_loc .. (j+1)*h_loc - 1`` of each of q, k and v;
* ``wo [H, D, d]``: the same heads;
* ``w1 [d, d_ff]``, ``b1``: columns ``j*f_loc .. (j+1)*f_loc - 1``;
  ``w2 [d_ff, d]``: the same rows;
* ``bo``, ``b2``: scaled by 1/tp.

The fused kernels add the residual (and the row-parallel bias) into their
output, so each shard is fed the stream and the bias scaled by 1/tp; the sum
over shards rebuilds ``x + sum of partials + bias`` (herro_tpu/parallel/
tensor.py:82-165). LayerNorm is scale-invariant up to its 1e-6 eps, so the
FFN shards normalise the scaled stream.
"""

from __future__ import annotations

import torch

from ..constants import TOKEN_PAD
from ..models.model import CorrectionModel, ModelConfig
from ..ops.fused import col_proj_table, entry_embed, flash_outproj, ln_ffn, ln_qkv_rope

def block_params(block) -> dict:
    """A block's float32 matmul parameters under the names the ops take."""
    a = block.attn
    return dict(
        w_qkv=a.qkv_kernel, b_qkv=a.qkv_bias, wo=a.out_kernel, bo=a.out_bias,
        w1=block.ff1.kernel, b1=block.ff1.bias, w2=block.ff2.kernel, b2=block.ff2.bias,
    )


def shard_weights(block_weights: dict, tp: int, j: int) -> dict:
    """Shard j of ``tp`` of one block's matmul weights (the keys of
    :func:`block_params`), contiguous, in their own dtype."""
    w = block_weights
    H, D, d = w["wo"].shape
    f = w["w1"].shape[1]
    # the sharded axes must divide evenly (herro_tpu/parallel/tensor.py:60-66)
    for name, n in (("n_heads", H), ("d_ff", f)):
        if n % tp:
            raise ValueError(f"{name} {n} is not divisible by tp={tp}")
    if not 0 <= j < tp:
        raise ValueError(f"shard {j} of {tp}")
    h, fl = H // tp, f // tp
    heads, cols = slice(j * h, (j + 1) * h), slice(j * fl, (j + 1) * fl)
    inv = 1.0 / tp
    return dict(
        w_qkv=w["w_qkv"].reshape(d, 3, H, D)[:, :, heads].reshape(d, 3 * h * D).contiguous(),
        b_qkv=w["b_qkv"].reshape(3, H, D)[:, heads].reshape(3 * h * D).contiguous(),
        wo=w["wo"][heads].contiguous(),
        bo=w["bo"] * inv,
        w1=w["w1"][:, cols].contiguous(),
        b1=w["b1"][cols].contiguous(),
        w2=w["w2"][cols].contiguous(),
        b2=w["b2"] * inv,
    )


def all_reduce(partials: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum over shards (``jax.lax.psum`` over the model axis), one
    tensor per shard on its device. The sum is taken once, on shard 0's
    device, in float32 in shard order and rounded to the partials' dtype
    once, then copied to the other shards' devices (peer to peer between
    cards), so every shard holds the same bits. Shards on one device share
    the one tensor."""
    if len(partials) == 1:
        return list(partials)
    dev0 = partials[0].device
    acc = partials[0].to(torch.float32, copy=True)  # the partials stay as they are
    for p in partials[1:]:
        acc.add_(p.to(dev0))
    total = acc.to(partials[0].dtype)
    return [total if p.device == dev0 else total.to(p.device) for p in partials]


class _Shard:
    """Shard j on its device: a replica of the model's parameters, of which
    it reads the entry, the LayerNorms and (shard 0) the tail, and its part
    of each block's matmul weights in the compute dtype."""

    def __init__(self, cfg: ModelConfig, params: dict, tp: int, j: int, device):
        model = CorrectionModel(cfg)
        model.load_state_dict(params)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        dt = cfg.compute_dtype
        with torch.no_grad():
            cp = self.model.col_proj
            self.wc = col_proj_table(cp.w_embT.to(dt), cp.w_qT.to(dt))
            self.blocks = [
                {k: v.to(dt) for k, v in shard_weights(block_params(b), tp, j).items()}
                for b in self.model.blocks
            ]


class TensorParallelModel:
    """One data replica of the model, sharded over ``devices`` (one row of a
    mesh; a device may repeat). Inference only, bf16 or float32; int8 has no
    kernel at the shard widths."""

    def __init__(self, cfg: ModelConfig, params: dict, devices):
        if cfg.int8:
            raise ValueError(
                "int8 with tp > 1: the int8 kernels (K10, K11) take no shard widths "
                "yet; see ROADMAP.md queue 2b. Run int8 with --tp 1, or bf16 with --tp > 1"
            )
        self.cfg = cfg
        self.tp = len(devices)
        self.shards = [_Shard(cfg, params, self.tp, j, dev) for j, dev in enumerate(devices)]
        self.device = self.shards[0].device

    def forward(self, bases, quals, support_idx, support_mask):
        """``CorrectionModel.forward`` over the shards: inputs on shard 0's
        device, (info [B, S], bases logits [B, S, 5]) there. The entry embed
        runs on every shard, as the reference recomputes it; the tail runs
        once, on shard 0, whose stream after the last sum is every shard's."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        inv = 1.0 / self.tp
        h_loc = cfg.n_heads // self.tp
        inputs = {}  # the batch on each shard's device, once per device
        for s in self.shards:
            if s.device not in inputs:
                tok = bases.to(s.device)
                lengths = (tok[:, 0, :] != TOKEN_PAD).sum(dim=1, dtype=torch.int32)
                inputs[s.device] = (tok, quals.to(s.device).float(), lengths)
        xs = [entry_embed(*inputs[s.device][:2], s.wc, s.model.col_proj.bias, dt)
              for s in self.shards]
        for i in range(cfg.n_layers):
            ys = []
            for s, x in zip(self.shards, xs):
                ln, w = s.model.blocks[i].ln1, s.blocks[i]
                q, k, v = ln_qkv_rope(x, ln.scale, ln.bias, w["w_qkv"], w["b_qkv"], h_loc)
                ys.append(flash_outproj(q, k, v, x * inv, w["wo"], w["bo"],
                                        inputs[s.device][2], cfg.local_window))
            xs = all_reduce(ys)
            ys = []
            for s, x in zip(self.shards, xs):
                ln, w = s.model.blocks[i].ln2, s.blocks[i]
                ys.append(ln_ffn(x * inv, ln.scale, ln.bias, w["w1"], w["b1"], w["w2"],
                                 w["b2"]))
            xs = all_reduce(ys)
        return self.shards[0].model.head(xs[0], support_idx, support_mask)

    __call__ = forward


def make_tp_correct_step(model: TensorParallelModel):
    """The tensor-parallel step: ``pipeline.infer.make_correct_step_packed``
    over the sharded model, so the same signature and outputs (info,
    decisions‖classes [B, L+S]), inputs and outputs on shard 0's device. The
    counting rule (K5) runs once, on shard 0."""
    from ..pipeline.infer import make_correct_step_packed

    return make_correct_step_packed(model)
