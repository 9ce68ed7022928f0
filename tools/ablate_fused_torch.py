"""On-card ablation of the port's fused correct step.

The counterpart of tools/ablate_fused.py over ``herro_tpu_torch``: times (a)
the full correct step, (b) structural variants with one component removed,
and (c) each fused op standalone at layer shapes, all with the port's step
timer (``pipeline/steptime.py``: warm-up outside the timed region, distinct
inputs per iteration, every output folded into what is timed, CUDA events).
The toggles are the reference's (``step_variant``: attn, ffn, counting,
entry, layers, qkv_only, heads, final_ln) over ``CorrectionModel``'s
weights (R10, seeded random) and the port's kernels. Needs a CUDA card;
imports nothing of JAX.

    python tools/ablate_fused_torch.py [B] [L] [S] [--skeleton]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from herro_tpu_torch.constants import N_ROWS, QUAL_OFFSET, QUAL_SCALE, TOKEN_PAD  # noqa: E402
from herro_tpu_torch.models.model import R10_CONFIG, CorrectionModel  # noqa: E402
from herro_tpu_torch.ops import fused  # noqa: E402
from herro_tpu_torch.ops.consensus import count_decisions  # noqa: E402
from herro_tpu_torch.pipeline.batching import unpack_tokens_torch  # noqa: E402
from herro_tpu_torch.pipeline.steptime import example_batch, time_step  # noqa: E402


def _layernorm_f32(g, scale, bias):
    """The final LayerNorm as the reference tool writes it: float32, the
    fast variance clamped at 0, (x - mu) * rsqrt(var + 1e-6), then the
    affine."""
    xf = g.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return y * scale + bias


def toggled_forward(model: CorrectionModel, tokens, quals, sidx, *, attn=True, ffn=True,
                    entry=True, layers=None, qkv_only=False, heads=True,
                    final_ln=True):
    """``CorrectionModel.forward`` with components toggled off, as
    tools/ablate_fused.py:step_variant's ``fwd`` (no support mask applied):
    -> (info [B, S], logits [B, S, 5]) in float32."""
    cfg = model.cfg
    dt = cfg.compute_dtype
    w = model.compute_weights()
    Bb, R, Ll = tokens.shape
    if entry:
        x = fused.entry_embed(tokens, quals.float(), w["wc"], model.col_proj.bias, dt)
    else:
        x = torch.zeros(Bb, Ll, cfg.d_model, dtype=dt, device=tokens.device) \
            + quals[:, 0, :, None].to(dt)
    lengths = (tokens[:, 0, :] != TOKEN_PAD).sum(dim=1, dtype=torch.int32)
    n_layers = cfg.n_layers if layers is None else layers
    h = cfg.n_heads
    for block, bw in list(zip(model.blocks, w["blocks"]))[:n_layers]:
        if attn and qkv_only:
            # qkv projection runs, flash+outproj skipped: isolates the
            # ln_qkv_rope half of the attention stack in-step
            q_, k_, v_ = fused.ln_qkv_rope(x, block.ln1.scale, block.ln1.bias, bw["w_qkv"],
                                           bw["b_qkv"], h)
            mix = q_.sum(dim=(1, 3)) + k_.sum(dim=(1, 3)) + v_.sum(dim=(1, 3))
            x = x + (mix[:, :, None] * 1e-6).to(dt)
        elif attn:
            x = fused.attention_block(x, block.ln1.scale, block.ln1.bias, bw["w_qkv"],
                                      bw["b_qkv"], bw["wo"], bw["bo"], lengths, h,
                                      cfg.local_window)
        if ffn:
            x = fused.ln_ffn(x, block.ln2.scale, block.ln2.bias, bw["w1"], bw["b1"],
                             bw["w2"], bw["b2"])
    if not heads:
        # cheapest possible consumption of x with the right output shapes
        Sn = sidx.shape[1]
        return x[:, :Sn, 0].float(), x[:, :Sn, :5].float()
    # production order (models/model.py): gather supported columns first,
    # then LN on [B, S, d]: the final LN commutes with the per-token gather
    g = torch.gather(x, 1, sidx.long()[..., None].expand(-1, -1, x.shape[-1]))
    if final_ln:
        g = _layernorm_f32(g, model.ln_f.scale, model.ln_f.bias).to(dt)
    g = g.float()
    logits = g @ model.bases_head.kernel + model.bases_head.bias
    info = (g @ model.info_head.kernel + model.info_head.bias)[..., 0]
    return info, logits


def _model(cfg=R10_CONFIG) -> CorrectionModel:
    from herro_tpu_torch.pipeline.infer import resolve_device

    gen = torch.Generator().manual_seed(0)
    return CorrectionModel(cfg, generator=gen).to(resolve_device(None)).eval()


def _inputs(model, B, L, S):
    dev = next(model.parameters()).device
    return [[torch.from_numpy(a).to(dev) for a in example_batch(B, L, S, seed=s)]
            for s in (3, 4)]


def step_variant(B, L, S, n=10, *, counting=True, label="", model=None, **toggles):
    """ms a step of the toggled correct step (unpack, qual normalisation,
    forward, argmax, and the counting rule unless ``counting`` is False)."""
    model = model or _model()

    def step(tok, quals_u8, sidx, smask, n_alns):
        tokens = unpack_tokens_torch(tok, N_ROWS)
        q = QUAL_SCALE * quals_u8.float() - QUAL_OFFSET
        info, logits = toggled_forward(model, tokens, q, sidx, **toggles)
        out = (info, torch.argmax(logits, dim=-1).to(torch.uint8))
        return out + (count_decisions(tokens, n_alns),) if counting else out

    r = time_step(step, _inputs(model, B, L, S), B, iters=n)
    print(f"{label:34s} {r['ms']:8.2f} ms/iter", flush=True)
    return r["ms"] * 1e-3


def op_standalone(which, B, L, n=20, cfg=R10_CONFIG):
    """One fused op at layer shapes (weights drawn from a seeded generator,
    the input x distinct per iteration), ms a call."""
    from herro_tpu_torch.pipeline.infer import resolve_device

    dev = resolve_device(None)
    dt = torch.bfloat16
    d, f, h = cfg.d_model, cfg.d_ff, cfg.n_heads
    g = torch.Generator(device=dev).manual_seed(0)

    def mk(*shape, scale=0.02, dtype=dt):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    s = torch.ones(d, device=dev)
    bb = torch.zeros(d, device=dev)
    if which == "attention_block":
        w, b = mk(d, 3 * d), mk(3 * d)
        wo, bo = mk(h, d // h, d), mk(d)
        lengths = torch.full((B,), L, dtype=torch.int32, device=dev)

        def op(x):
            return fused.attention_block(x, s, bb, w, b, wo, bo, lengths, h, cfg.local_window)
    elif which == "ln_ffn":
        w1, b1, w2, b2 = mk(d, f), mk(f), mk(f, d), mk(d)

        def op(x):
            return fused.ln_ffn(x, s, bb, w1, b1, w2, b2)
    elif which == "counting":
        n_alns = torch.full((B,), 30, dtype=torch.int32, device=dev)

        def op(tok):
            return count_decisions(tok, n_alns)

        sets = [[torch.from_numpy(np.random.default_rng(seed).integers(
            0, 12, (B, N_ROWS, L), dtype=np.uint8)).to(dev)] for seed in (3, 4)]
        r = time_step(op, sets, B, iters=n)
        print(f"{which:34s} {r['ms']:8.2f} ms/iter", flush=True)
        return r["ms"] * 1e-3
    else:
        raise ValueError(f"no fused op {which!r}")
    sets = [[mk(B, L, d, scale=1.0)] for _ in (3, 4)]
    r = time_step(op, sets, B, iters=n)
    print(f"{which:34s} {r['ms']:8.2f} ms/iter", flush=True)
    return r["ms"] * 1e-3


def skeleton(B, L, S):
    """Decompose the 0-layer skeleton: final LN, gather+heads, entry, and
    the harness floor (unpack + qual normalise + the fold)."""
    model = _model()
    full0 = step_variant(B, L, S, layers=0, counting=False, model=model,
                         label="0 layers (entry+LNf+heads)")
    no_lnf = step_variant(B, L, S, layers=0, counting=False, final_ln=False, model=model,
                          label="0 layers, no final LN")
    no_heads = step_variant(B, L, S, layers=0, counting=False, heads=False, model=model,
                            label="0 layers, no LNf/heads")
    floor = step_variant(B, L, S, layers=0, counting=False, heads=False, entry=False,
                         model=model, label="harness floor (no entry)")
    print(f"\nfinal LN = {(full0 - no_lnf)*1e3:.2f} ms")
    print(f"gather+heads = {(no_lnf - no_heads)*1e3:.2f} ms")
    print(f"entry embed = {(no_heads - floor)*1e3:.2f} ms")
    print(f"harness floor (unpack+qual+fold) = {floor*1e3:.2f} ms")


def ablate(B, L, S) -> dict:
    """The reference's seven variants; returns their seconds a step."""
    model = _model()
    v = dict(
        full=step_variant(B, L, S, model=model, label="full step"),
        no_cnt=step_variant(B, L, S, counting=False, model=model, label="no counting"),
        no_attn=step_variant(B, L, S, attn=False, counting=False, model=model,
                             label="no attention(+ln_mm)"),
        qkv_o=step_variant(B, L, S, counting=False, qkv_only=True, model=model,
                           label="qkv only (no flash)"),
        no_ffn=step_variant(B, L, S, ffn=False, counting=False, model=model, label="no ffn"),
        zero_layers=step_variant(B, L, S, layers=0, counting=False, model=model,
                                 label="0 layers (entry+heads)"),
        no_entry=step_variant(B, L, S, entry=False, counting=False, model=model,
                              label="no entry embed"),
    )
    print(f"\ncounting = {(v['full'] - v['no_cnt'])*1e3:.2f} ms")
    print(f"attention stack = {(v['no_cnt'] - v['no_attn'])*1e3:.2f} ms")
    print(f"  qkv half = {(v['qkv_o'] - v['no_attn'])*1e3:.2f} ms, "
          f"flash half = {(v['no_cnt'] - v['qkv_o'])*1e3:.2f} ms")
    print(f"ffn stack = {(v['no_cnt'] - v['no_ffn'])*1e3:.2f} ms")
    print(f"entry = {(v['no_cnt'] - v['no_entry'])*1e3:.2f} ms; "
          f"entry+heads = {v['zero_layers']*1e3:.2f} ms")
    return v


def main():
    from herro_tpu_torch.pipeline.steptime import card

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    B = int(args[0]) if len(args) > 0 else 64
    L = int(args[1]) if len(args) > 1 else 4608
    S = int(args[2]) if len(args) > 2 else 128
    print(card(), flush=True)
    print(f"fused ablation B={B} L={L} S={S} device={torch.cuda.get_device_name(0)}",
          flush=True)
    if "--skeleton" in sys.argv:
        skeleton(B, L, S)
        return
    ablate(B, L, S)


if __name__ == "__main__":
    main()
