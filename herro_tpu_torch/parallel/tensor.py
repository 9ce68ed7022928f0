"""Tensor parallelism: Megatron head and d_ff shards over one row of a mesh.

The counterpart of ``herro_tpu/parallel/tensor.py``. Attention heads and the
FFN hidden axis split over the ``model`` axis (the column-parallel qkv and
ff1, the row-parallel out projection and ff2); everything else replicates.
Each shard runs the same hand-written kernels as one device, at its own
widths (``h_loc = H / tp`` heads, ``d_ff / tp`` hidden columns), and one
:func:`all_reduce` per half-block recombines the stream. The same forward
serves inference and training: under autograd the attention and FFN ops are
the ``_RecomputePlain`` Functions of ``ops/fused.py`` (kernel forward, plain
backward), and the sum hands its gradient to every shard.

Layout of shard j (the port's layouts, ``models/model.py``):

* ``w_qkv [d, 3*H*D]`` (the (3, H, D) c-major flattening) and ``b_qkv``:
  heads ``j*h_loc .. (j+1)*h_loc - 1`` of each of q, k and v;
* ``wo [H, D, d]``: the same heads;
* ``w1 [d, d_ff]``, ``b1``: columns ``j*f_loc .. (j+1)*f_loc - 1``;
  ``w2 [d_ff, d]``: the same rows;
* ``bo``, ``b2``: scaled by 1/tp (``shard_weights``; the model keeps them
  unscaled and scales them in the forward).

The fused kernels add the residual (and the row-parallel bias) into their
output, so each shard is fed the stream and the bias scaled by 1/tp; the sum
over shards rebuilds ``x + sum of partials + bias`` (herro_tpu/parallel/
tensor.py:82-165). LayerNorm is scale-invariant up to its 1e-6 eps, so the
bf16 FFN shards normalise the scaled stream.

int8 (``cfg.int8``) runs the same layout on the int8 ops, and its sum over
shards is the one-device int8 function, as the reference's GSPMD partition
of its jnp twins is (herro_tpu/pipeline/infer.py:153-163): the weights are
quantized as one device quantizes them (the per-column scales of the
column-split qkv and W1 are the shard's own; W2's, the maximum of each
column over every row, come from :func:`all_reduce_max` over the shards),
every shard normalises the stream x itself (an int8 rounding can turn the
eps of LN(x / tp) into a whole step), and the FFN's hidden, quantized per
row over all d_ff columns, takes two passes around one row maximum:
``ln_ffn_q_rowmax`` on every shard, :func:`all_reduce_max`, then
``ln_ffn_q_rowscale`` with x / tp and b2 / tp, and the sum.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..constants import TOKEN_PAD
from ..models.model import CorrectionModel, ModelConfig
from ..ops.fused import (
    attention_shard,
    attention_shard_q,
    col_proj_table,
    entry_embed,
    k_major,
    ln_ffn,
    ln_ffn_q_rowmax,
    ln_ffn_q_rowscale,
    quantize_weight,
)

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


def gather_weights(shards: list[dict]) -> dict:
    """The inverse of :func:`shard_weights` on the sharded keys (``w_qkv``,
    ``b_qkv``, ``wo``, ``w1``, ``b1``, ``w2``): the shards of one block put
    back together on shard 0's device. Differentiable."""
    dev = shards[0]["wo"].device
    h, D, d = shards[0]["wo"].shape
    cat = lambda key, dim, *shape: torch.cat(
        [s[key].to(dev).reshape(*shape) if shape else s[key].to(dev) for s in shards], dim
    )
    return dict(
        w_qkv=cat("w_qkv", 2, d, 3, h, D).reshape(d, -1),
        b_qkv=cat("b_qkv", 1, 3, h, D).reshape(-1),
        wo=cat("wo", 0),
        w1=cat("w1", 1),
        b1=cat("b1", 0),
        w2=cat("w2", 0),
    )


# the keys of block_params that shard_weights splits; bo and b2 replicate
SHARDED = ("w_qkv", "b_qkv", "wo", "w1", "b1", "w2")
# block_params key -> the parameter's name within its block
BLOCK_NAMES = {
    "w_qkv": "attn.qkv_kernel", "b_qkv": "attn.qkv_bias", "wo": "attn.out_kernel",
    "w1": "ff1.kernel", "b1": "ff1.bias", "w2": "ff2.kernel",
}


def all_reduce(partials: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum over shards (``jax.lax.psum`` over the model axis), one
    tensor per shard on its device. The sum is taken once, on shard 0's
    device, in float32 in shard order and rounded to the partials' dtype
    once, then copied to the other shards' devices (peer to peer between
    cards), so every shard holds the same bits. Shards on one device share
    the one tensor. Differentiable as it stands, through the copies and the
    in-place sum: the backward hands the sum of the outputs' gradients to
    every partial (Megatron's g operator)."""
    if len(partials) == 1:
        return list(partials)
    dev0 = partials[0].device
    acc = partials[0].to(torch.float32, copy=True)  # the partials stay as they are
    for p in partials[1:]:
        acc.add_(p.to(dev0))
    total = acc.to(partials[0].dtype)
    return [total if p.device == dev0 else total.to(p.device) for p in partials]


class _MaxOverShards(torch.autograd.Function):
    """The elementwise maximum of the shards' partials, on shard 0's device.
    Its gradient goes to the shards that hold the maximum, shard j's share
    (g / C) * c_j: c_j is the number of elements of the whole row that the
    shard's partial stands for and that reach the maximum (``counts``; 1
    each without them), C their sum over the tied shards. A shard's partial
    is itself a maximum over its part of the row, whose backward splits its
    share evenly between its own c_j (``amax``), so each tied element of the
    row gets g / C: the gradient of the reference's maximum over the whole
    row, exactly where c_j is a power of two."""

    @staticmethod
    def forward(ctx, counts, *partials):
        dev0 = partials[0].device
        stacked = torch.stack([p.to(dev0) for p in partials])
        top = stacked.amax(dim=0)
        tied = (stacked == top).to(torch.float32)
        if counts is not None:
            tied = tied * torch.stack([c.to(dev0, torch.float32) for c in counts])
        ctx.save_for_backward(tied)
        ctx.targets = [(p.device, p.dtype) for p in partials]
        return top

    @staticmethod
    def backward(ctx, g):
        (tied,) = ctx.saved_tensors
        per_element = g.float() / tied.sum(dim=0)
        return (None, *((per_element * c).to(dev, dt)
                        for c, (dev, dt) in zip(tied, ctx.targets)))


def all_reduce_max(partials: list[torch.Tensor], counts=None) -> list[torch.Tensor]:
    """The elementwise maximum over shards (``jax.lax.pmax``), as
    :func:`all_reduce` takes its sum: on shard 0's device, one result copied
    to every shard. Differentiable (:class:`_MaxOverShards`): where each
    partial is a maximum over the shard's part of a row, ``counts`` (one
    tensor of the partials' shape a shard) holds how many of the part's
    elements reach it, so that the tied elements of the whole row share the
    gradient evenly, as under the reference's maximum over the row; without
    it, each partial counts as one element."""
    if len(partials) == 1:
        return list(partials)
    top = _MaxOverShards.apply(counts, *partials)
    dev0 = partials[0].device
    return [top if p.device == dev0 else top.to(p.device) for p in partials]


def _column_ties(w: torch.Tensor) -> torch.Tensor:
    """How many rows of each column of a shard's weight reach its max |w|."""
    a = w.detach().abs()
    return (a == a.amax(dim=0)).sum(dim=0)


class TensorParallelModel:
    """One data replica of the model, sharded over ``devices`` (one row of a
    mesh; a device may repeat), for inference and for training.

    Its float32 parameters are leaves: the replicated ones (entry, the
    LayerNorms, ``bo``, ``b2``, the tail) once, in a copy of the model on
    shard 0's device from which the sharded weights are removed; shard j's
    part of each block's ``w_qkv``, ``b_qkv``, ``wo``, ``w1``, ``b1`` and
    ``w2`` on its device. Every shard reads a replicated parameter through
    ``.to(its device)``, so autograd sums the shards' parts of its gradient,
    on one card or across cards. ``bo`` and ``b2`` stay unscaled: the
    forward scales them by 1/tp. :meth:`gather` gives the parameters under
    the single-device names (the checkpoint's). bf16, float32, and either
    under ``cfg.int8``."""

    def __init__(self, cfg: ModelConfig, params: dict, devices):
        self.cfg = cfg
        self.devices = [torch.device(d) for d in devices]
        self.tp = len(self.devices)
        self.device = self.devices[0]
        model = CorrectionModel(cfg)
        model.load_state_dict(params)
        self.names = list(model.state_dict())  # the single-device order
        with torch.no_grad():
            blocks = [block_params(b) for b in model.blocks]
            self.shards = [  # float32 leaves of their own on the shard's device
                [{k: v.to(dev, torch.float32, copy=True).requires_grad_()
                  for k, v in shard_weights(w, self.tp, j).items() if k in SHARDED}
                 for w in blocks]
                for j, dev in enumerate(self.devices)
            ]
        for b in model.blocks:
            for key in SHARDED:
                module, name = BLOCK_NAMES[key].split(".")
                delattr(getattr(b, module), name)
        self.model = model.to(self.device)  # the replicated parameters
        self._weights = None  # (key, weights) built without grad

    def parameters(self) -> list[torch.Tensor]:
        """Every float32 leaf: the replicated ones, then shard by shard,
        block by block, the keys of ``SHARDED``."""
        return list(self.model.parameters()) + [
            w[k] for shard in self.shards for w in shard for k in SHARDED
        ]

    def gather(self, values=None) -> dict:
        """``values`` (one tensor a leaf, in :meth:`parameters`' order; the
        leaves themselves by default) under the single-device names, the
        shards put back together on shard 0's device, detached: the
        logical parameters, gradients or optimiser moments."""
        values = self.parameters() if values is None else list(values)
        n_rep = len(list(self.model.parameters()))
        out = dict(zip((n for n, _ in self.model.named_parameters()), values[:n_rep]))
        it = iter(values[n_rep:])
        parts = [[{k: next(it) for k in SHARDED} for _ in self.model.blocks]
                 for _ in self.devices]
        with torch.no_grad():
            for i in range(len(self.model.blocks)):
                whole = gather_weights([shard[i] for shard in parts])
                out.update({f"blocks.{i}.{BLOCK_NAMES[k]}": whole[k] for k in SHARDED})
            return {name: out[name].detach() for name in self.names}

    def _build_weights(self) -> list[dict]:
        """Shard by shard, what its ops take: the col_proj table and bias and,
        block by block, the LayerNorm parameters (float32), its matmul
        weights and 1/tp of the row-parallel biases in the compute dtype;
        under ``cfg.int8`` the matmul weights quantized as
        ``Block.compute_weights`` quantizes them and the FFN biases float32."""
        dt = self.cfg.compute_dtype
        inv = 1.0 / self.tp
        m = self.model
        quantized = [self._quantize(i) for i in range(len(m.blocks))] if self.cfg.int8 \
            else None
        out = []
        for j, (dev, shard) in enumerate(zip(self.devices, self.shards)):
            rep = lambda t: t.to(dev)
            blocks = []
            for i, (b, w) in enumerate(zip(m.blocks, shard)):
                block = dict(ln1_s=rep(b.ln1.scale), ln1_b=rep(b.ln1.bias),
                             ln2_s=rep(b.ln2.scale), ln2_b=rep(b.ln2.bias),
                             bo=(rep(b.attn.out_bias) * inv).to(dt))
                if quantized is None:
                    block.update(b2=(rep(b.ff2.bias) * inv).to(dt),
                                 **{k: w[k].to(dt) for k in SHARDED})
                else:
                    block.update(quantized[i][j], b_qkv=w["b_qkv"].to(dt), wo=w["wo"].to(dt),
                                 b1=w["b1"], b2=rep(b.ff2.bias) * inv)
                blocks.append(block)
            cp = m.col_proj
            out.append(dict(wc=col_proj_table(rep(cp.w_embT).to(dt), rep(cp.w_qT).to(dt)),
                            cb=rep(cp.bias), blocks=blocks))
        return out

    def _quantize(self, i: int) -> list[dict]:
        """Block i's int8 weights, shard by shard: the qkv weight after its
        cast to the compute dtype and W1 from float32, each column by its own
        maximum; W2 from float32, each column by its maximum over every
        shard's rows. Bit for bit the slices of one device's
        ``quantize_weight``; on the card k-major, as the kernels read them."""
        dt = self.cfg.compute_dtype
        parts = [shard[i] for shard in self.shards]
        col_max = all_reduce_max([w["w2"].abs().amax(dim=0) for w in parts],
                                 [_column_ties(w["w2"]) for w in parts])
        out = []
        for w, m2 in zip(parts, col_max):
            q = {}
            for name, kernel, absmax in (("qkv", w["w_qkv"].to(dt), None),
                                         ("1", w["w1"], None), ("2", w["w2"], m2)):
                w_i8, s = quantize_weight(kernel, absmax)
                q[f"w{name}_i8"], q[f"s{name}"] = k_major(w_i8), s
            out.append(q)
        return out

    def compute_weights(self) -> list[dict]:
        """The shards' weights, built once per parameter state without
        gradients and afresh with them (``CorrectionModel.compute_weights``)."""
        if torch.is_grad_enabled():
            return self._build_weights()
        key = (torch.is_inference_mode_enabled(),
               tuple((p.data_ptr(), p._version) for p in self.parameters()))
        if self._weights is None or self._weights[0] != key:
            self._weights = (key, self._build_weights())
        return self._weights[1]

    def forward(self, bases, quals, support_idx, support_mask):
        """``CorrectionModel.forward`` over the shards: inputs on shard 0's
        device, (info [B, S], bases logits [B, S, 5]) there. The entry embed
        runs on every shard, as the reference recomputes it; the tail runs
        once, on shard 0, whose stream after the last sum is every shard's.
        Under autograd with ``cfg.remat`` each shard's half-block is a
        ``torch.utils.checkpoint`` region, as the block is on one device;
        the int8 FFN half, whose row maximum crosses the shards, is two: each
        shard's first pass, and each shard's second."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        inv = 1.0 / self.tp
        h_loc = cfg.n_heads // self.tp
        remat = cfg.remat and torch.is_grad_enabled()
        weights = self.compute_weights()
        inputs = {}  # the batch on each shard's device, once per device
        for dev in self.devices:
            if dev not in inputs:
                tok = bases.to(dev)
                lengths = (tok[:, 0, :] != TOKEN_PAD).sum(dim=1, dtype=torch.int32)
                inputs[dev] = (tok, quals.to(dev).float(), lengths)

        def attn_half(x, lengths, w):
            if cfg.int8:
                return attention_shard_q(x, x * inv, w["ln1_s"], w["ln1_b"], w["wqkv_i8"],
                                         w["sqkv"], w["b_qkv"], w["wo"], w["bo"], lengths,
                                         h_loc, cfg.local_window)
            return attention_shard(x, x * inv, w["ln1_s"], w["ln1_b"], w["w_qkv"], w["b_qkv"],
                                   w["wo"], w["bo"], lengths, h_loc, cfg.local_window)

        def ffn_half(x, w):
            return ln_ffn(x * inv, w["ln2_s"], w["ln2_b"], w["w1"], w["b1"], w["w2"], w["b2"])

        def ffn_rowmax(x, w):
            return ln_ffn_q_rowmax(x, w["ln2_s"], w["ln2_b"], w["w1_i8"], w["s1"], w["b1"])

        def ffn_rowscale(x, hmax, w):
            return ln_ffn_q_rowscale(x, w["ln2_s"], w["ln2_b"], w["w1_i8"], w["s1"], w["b1"],
                                     w["w2_i8"], w["s2"], w["b2"], hmax, inv)

        run = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) if remat else \
            (lambda fn, *a: fn(*a))
        xs = [entry_embed(*inputs[dev][:2], w["wc"], w["cb"], dt)
              for dev, w in zip(self.devices, weights)]
        for i in range(cfg.n_layers):
            ws = [w["blocks"][i] for w in weights]
            xs = all_reduce([run(attn_half, x, inputs[dev][2], w)
                             for dev, x, w in zip(self.devices, xs, ws)])
            if cfg.int8:
                maxima, ties = zip(*(run(ffn_rowmax, x, w) for x, w in zip(xs, ws)))
                hmax = all_reduce_max(list(maxima), None if ties[0] is None else list(ties))
                xs = all_reduce([run(ffn_rowscale, x, m, w) for x, m, w in zip(xs, hmax, ws)])
            else:
                xs = all_reduce([run(ffn_half, x, w) for x, w in zip(xs, ws)])
        return self.model.head(xs[0], support_idx, support_mask)

    __call__ = forward


def make_tp_correct_step(model: TensorParallelModel):
    """The tensor-parallel step: ``pipeline.infer.make_correct_step_packed``
    over the sharded model, so the same signature and outputs (info,
    decisions‖classes [B, L+S]), inputs and outputs on shard 0's device. The
    counting rule (K5) runs once, on shard 0."""
    from ..pipeline.infer import make_correct_step_packed

    return make_correct_step_packed(model)
