"""The correction transformer's fused ops: CUDA kernels and their plain versions.

Each op mirrors one function of ``herro_tpu/ops/fused.py`` at the same
layouts, and comes as a pair:

* a hand-written kernel (``csrc/*.cu``), reached through its wrapper
  ``_<op>_cuda``, which chooses it by the operands' dtype and widths (bf16:
  the Hopper kernel, TMA and ``wgmma``, at the widths it was built for, and
  elsewhere the bf16 SIMT kernel of ``*_bf16.cu`` (``bf16_kernel_name``);
  float32: the SIMT kernel of ``*_f32.cu``; both SIMT kernels at any head
  dim a multiple of 16 in 16-128, d_model up to 1024 and d_ff up to 4096;
  anything else raises), checks
  devices, shapes and contiguity and raises on anything the kernel does not
  take;
* a plain PyTorch version ``_<op>_plain``, which computes the same function
  with the same roundings (bf16 operands, float32 accumulation, bf16 results
  where the TPU kernel rounds).

The public op launches the kernel for CUDA tensors and runs the plain
version for CPU tensors, and does nothing else: there is no fallback. The
reference's ``HERRO_TPU_PALLAS=0``, which forces its jnp twins, makes a
public op refuse CUDA tensors (``cuda.on_card``, read at every call).

Three ops are differentiable, as their counterparts carry a ``custom_vjp`` in
the reference: ``entry_embed``, ``ln_ffn`` and ``attention_block``, and a
fourth, ``attention_shard``, is ``attention_block`` with the residual taken
apart, for a tensor-parallel shard under autograd; so are the int8 ops
below, which the reference differentiates through its jnp twins. With
grad mode on and an input that requires grad, each runs through
:class:`_RecomputePlain`: the forward is the op as above (the kernel on the
card), the backward re-runs the plain version on the saved inputs and
differentiates it. No op has a backward kernel: nor has the reference.

* ``entry_embed`` (K4) — tokens + quals -> [B, L, d] stream;
* ``ln_qkv_rope`` (K1, K8) — LN + qkv projection + rope -> per-head q, k, v,
  the rope tables handed to the kernel (K1) or built inside it (K8, chosen by
  ``HERRO_TPU_ROPE=split`` as in the reference);
* ``flash_outproj`` (K2, K6, K7) — attention over an aligned band, any
  band, or every key, + out projection + residual;
* ``ln_ffn`` (K3) — LN + FFN + residual;
* ``ln_qkv_rope_q`` (K10), ``ln_ffn_q`` (K11) — the int8 variants of K1 and
  K3: activations quantized per row, weights per output column
  (``quantize_weight``), int8 x int8 -> int32 products, float32
  dequantization. Each has a Hopper instance (int8 ``wgmma``, bf16 at the
  shipped widths) and a SIMT one (int8 ``mma.sync``, float32 or bf16 at
  the widths of ``INT8_*``); ``int8_kernel_name``
  chooses. K11 has two more modes for
  a tensor-parallel shard, whose
  hidden holds d_ff / tp columns of a row that is quantized as a whole:
  ``ln_ffn_q_rowmax`` (the row maxima of |h| over the shard's columns, and
  how many of them reach it) and
  ``ln_ffn_q_rowscale`` (the hidden quantized by a given row maximum, the
  residual scaled). ``attention_block_q``, ``attention_shard_q``,
  ``ln_ffn_q`` and both modes are differentiable as the four above are: the
  int8 roundings pass no gradient, the row and column scales do.

Positions for the rope are the absolute column index: padding is a suffix.
"""

from __future__ import annotations

import math
import os
import threading

import torch
import torch.nn.functional as F

from ..constants import VOCAB_SIZE
from . import cuda as _cuda
from .attention import SIMT_KEY_TILE, _flash_attention_tiled, chunked_attention

# the head dim the bf16 Hopper kernels take (every shipped checkpoint); the
# bf16 SIMT kernels (csrc/*_bf16.cu) serve the other head dims of
# cuda.F32_HEAD_DIMS (bf16_kernel_name)
HEAD_DIM = 128
# the widths of the SIMT kernels, float32 (csrc/*_f32.cu) and bf16
# (csrc/*_bf16.cu), their head dims in cuda.F32_HEAD_DIMS: TINY_CONFIG (d 32,
# H 2 x D 16, d_ff 64), a float32 checkpoint, head dims 48-112, a
# tensor-parallel shard (any H), and any width a herro_tpu config.json asks
# for up to these (csrc/f32.cuh d_model_ok, d_ff_ok)
F32_MAX_D_MODEL = 1024  # a multiple of 32
F32_MAX_D_FF = 4096  # a multiple of 32
F32_MAX_ROWS = 63  # pileup rows the float32 entry takes (K5's range)
# the narrower widths of the SIMT int8 kernels (csrc/*_q_simt.cu over
# int8_simt.cuh: a LayerNorm row in registers up to d 512, K10's rope spans
# laid out for head dims cuda.POW2_HEAD_DIMS)
INT8_MAX_D_MODEL = 512  # a multiple of 32
INT8_MAX_D_FF = 2048  # a multiple of 32
# the d_model at which the SIMT K1/K8 and K3 take the narrow kernels
# (csrc/narrow.cuh kWidth: one launch each, no scratch; K1/K8 at head dims
# cuda.POW2_HEAD_DIMS), above it the tensor-core product (csrc/gemm_tc.cuh)
NARROW_D_MODEL = 32


def _check_f32_widths(d: int | None, f: int | None = None, D: int | None = None,
                      R: int | None = None, kind: str = "float32",
                      hopper: str | None = None) -> None:
    """The widths the SIMT kernels take, each named in a ValueError before
    any launch: the float32 ones (``kind``) and the bf16 SIMT ones ("bf16
    SIMT") take the same; the SIMT int8 ones ("int8 SIMT") narrower
    (``INT8_*``). ``hopper`` (``bf16_kernel_name``) is the d_model the op's
    bf16 Hopper instance takes ("" where the op reads none): the message
    then names what both bf16 instances take."""
    pow2 = f"{_cuda.POW2_HEAD_DIMS}"
    if kind == "int8 SIMT":
        max_d, max_f, head_dims, dims = INT8_MAX_D_MODEL, INT8_MAX_D_FF, _cuda.POW2_HEAD_DIMS, pow2
    else:
        max_d, max_f, head_dims = F32_MAX_D_MODEL, F32_MAX_D_FF, _cuda.F32_HEAD_DIMS
        dims = "a multiple of 16 from 16 to 128"

    def need(ok: bool, width: str, simt: str, on_hopper: str, takes: str = "kernels take"):
        if hopper is None:
            _cuda.check(ok, f"{width}: the {kind} {takes} {simt}")
        else:
            _cuda.check(ok, f"{width}: the bf16 kernels take {on_hopper} on the Hopper "
                            f"instance and {simt} on the SIMT one")

    if R is not None:
        need(1 <= R <= F32_MAX_ROWS, f"R {R} pileup rows", f"1 to {F32_MAX_ROWS}", "29 to 32")
    if d is not None:
        need(d % 32 == 0 and 32 <= d <= max_d, f"d_model {d}",
             f"a multiple of 32 up to {max_d}", hopper)
    if f is not None:
        need(f % 32 == 0 and 32 <= f <= max_f, f"d_ff {f}",
             f"a multiple of 32 up to {max_f}",
             f"a multiple of 128 at d_model {FFN_WIDTHS}", takes="kernel takes")
    if D is not None:
        need(D in head_dims, f"head dim {D}", dims, f"{HEAD_DIM}")
        if d is not None and d <= NARROW_D_MODEL:  # the narrow K1/K8
            need(D in _cuda.POW2_HEAD_DIMS, f"head dim {D} at d_model {d}", pow2, f"{HEAD_DIM}")


_rope_cache: dict = {}
_rope_lock = threading.Lock()


def layernorm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm with float32 statistics and the fast variance mean(x^2) -
    mu^2 clamped at 0 (``herro_tpu/ops/fused.py:layernorm``), in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rope_tables(L: int, D: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [L, D/2] float32 at absolute positions 0..L-1 with
    freq_i = exp(-ln(10000) * i / (D/2)) (``_rope_tables_full``). The
    divisor is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which at D/2 not a power of two (D 48-112)
    moves freq_i by an ulp off the correctly rounded quotient that the CPU
    and the kernels that build the tables (K8) take."""
    half = D // 2
    pos = torch.arange(L, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    freq = torch.exp(-math.log(10000.0) * idx / torch.full_like(idx, half))
    ang = pos * freq
    return torch.cos(ang), torch.sin(ang)


def _rope_tables_cached(L: int, D: int, device):
    """The kernel's rope tables, built once per (L, D, device): the bucket
    ladder holds a few lengths. The build is waited for, so a later launch
    on any stream reads finished tables."""
    key = (L, D, device)
    with _rope_lock:
        if key not in _rope_cache:
            _rope_cache[key] = rope_tables(L, D, device)
            torch.cuda.current_stream(device).synchronize()
        return _rope_cache[key]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _RecomputePlain(torch.autograd.Function):
    """A differentiable op: the forward is ``op`` (its kernel on the card, its
    plain version on the CPU, launches counted as without autograd), the
    backward re-runs ``plain`` on the saved inputs under grad and returns its
    gradients: the reference's ``custom_vjp`` whose backward recomputes
    through the jnp twin. ``static`` holds the op's trailing arguments that
    are no tensors; integer inputs (tokens, lengths) get no gradient, and
    neither do integer outputs (``ln_ffn_q_rowmax``'s counts)."""

    @staticmethod
    def forward(ctx, op, plain, static, *tensors):
        ctx.plain, ctx.static = plain, static
        ctx.save_for_backward(*tensors)
        out = op(*tensors, *static)
        if isinstance(out, tuple):
            ctx.mark_non_differentiable(*(o for o in out if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *gs):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [
                t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)
            ]
            out = ctx.plain(*inputs, *ctx.static)
            outs, gs = zip(*((o, g) for o, g in zip(
                out if isinstance(out, tuple) else (out,), gs) if o.is_floating_point()))
            wrt = [t for t, n in zip(inputs, need) if n]
            # an input may reach the output only through an int8 rounding
            # (the second FFN pass's LayerNorm and W1 scales): no gradient
            grads = iter(torch.autograd.grad(outs, wrt, gs, allow_unused=True))
        return (None, None, None, *(next(grads) if n else None for n in need))


# ---------------------------------------------------------------------------
# the bf16 instances: Hopper where it takes the operands, SIMT elsewhere
# ---------------------------------------------------------------------------


def bf16_kernel_name(op: str, d: int | None = None, f: int | None = None,
                     H: int | None = None, D: int | None = None, R: int | None = None,
                     local_window: int | None = None) -> str:
    """The kernel a bf16 op takes on the card, on its widths alone: the
    Hopper instance (TMA and ``wgmma``) where it was built for them, and
    otherwise the bf16 SIMT instance (``csrc/*_bf16.cu``), at the float32
    kernels' widths (d_model a multiple of 32 up to 1024, d_ff a multiple of
    32 up to 4096, head dims ``cuda.F32_HEAD_DIMS``, R 1-63); outside those
    a ValueError that names the width and both ranges, before any launch.
    The reference picks its Pallas kernels by backend and length alone,
    never by width (``herro_tpu/ops/fused.py:43-48``); this is the port's
    choice of instance, as ``int8_kernel_name`` is for int8.

    ``op`` and the widths it reads: ``entry_embed`` (d, R: the Hopper K4
    takes ``EMBED_WIDTHS`` and the 512-row table of R 29-32),
    ``ln_qkv_rope`` (d, D: K1 or K8 by ``HERRO_TPU_ROPE``, as
    ``rope_kernel_name``), ``flash_outproj`` (H, d, D, local_window: K2, K6
    or K7 by the band, as ``flash_kernel_name``), ``flash_attention`` (D:
    K9), ``ln_ffn`` (d, f: K3)."""
    if op == "entry_embed":
        if d in EMBED_WIDTHS and col_proj_rows(R) == 512:
            return "entry_embed"
        _check_f32_widths(d, R=R, hopper=f"{EMBED_WIDTHS}")
        return "entry_embed_bf16"
    if op == "ln_qkv_rope":
        if D == HEAD_DIM and d in QKV_WIDTHS:
            return rope_kernel_name()
        _check_f32_widths(d, D=D, hopper=f"{QKV_WIDTHS}")
        return "ln_qkv_rope_bf16" if rope_kernel_name() == "ln_qkv_rope" \
            else "ln_qkv_rope_bf16_split"
    if op == "flash_outproj":
        if D == HEAD_DIM and (H, d) in ATTENTION_WIDTHS:
            return flash_kernel_name(local_window)
        _check_f32_widths(d, D=D, hopper=f"(n_heads, d_model) in {ATTENTION_WIDTHS}")
        return "flash_bf16_full" if local_window is None else "flash_bf16"
    if op == "flash_attention":
        if D == HEAD_DIM:
            return "flash_attention"
        _check_f32_widths(None, D=D, hopper="")
        return "flash_bf16_attention"
    if op == "ln_ffn":
        if d in FFN_WIDTHS and f >= 128 and f % 128 == 0:
            return "ln_ffn"
        _check_f32_widths(d, f, hopper=f"{FFN_WIDTHS} with d_ff a multiple of 128")
        return "ln_ffn_bf16"
    raise ValueError(f"no bf16 op {op!r}")


def _simt_kind(kernel: str) -> str:
    """How a SIMT kernel's refusals name it: "float32" or "bf16 SIMT"."""
    return "float32" if _cuda.simt_dtype(kernel) == torch.float32 else "bf16 SIMT"


# ---------------------------------------------------------------------------
# K4 entry_embed: tokens u8 [B, R, L] + quals f32 [B, R, L] -> x [B, L, d]
# ---------------------------------------------------------------------------


COL_SLOT = 16  # k rows per pileup row in the col_proj table: V one-hot, the qual, zeros


def col_proj_rows(R: int) -> int:
    """The rows of ``col_proj_table`` for R pileup rows: R slots of COL_SLOT,
    up to the next multiple of 64."""
    return -(-R * COL_SLOT // 64) * 64


def col_proj_table(w_embT, w_qT):
    """The col_proj table [kp, d] the entry op takes: pileup row r owns the
    COL_SLOT rows from 16r, row 16r+v is w_embT[:, r*V+v], row 16r+V is
    w_qT[:, r] (flax's col_proj kernel, one slot per pileup row), the rest
    zero, then zero rows up to kp, the next multiple of 64 (512 at R = 31:
    whole 64-row k-stages of the CUDA kernel, and one (row, pileup row) pair
    of its one-hot tile is 32 aligned bytes). Built once per weight state,
    not per batch."""
    d, R = w_qT.shape
    V = w_embT.shape[1] // R
    if V + 1 > COL_SLOT:
        raise ValueError(f"vocab {V} and the qual do not fit a slot of {COL_SLOT}")
    kp = col_proj_rows(R)
    wc = torch.zeros(kp, d, dtype=w_embT.dtype, device=w_embT.device)
    tab = wc[: R * COL_SLOT].view(R, COL_SLOT, d)
    tab[:, :V] = w_embT.t().reshape(R, V, d)
    tab[:, V] = w_qT.t()
    return wc


def _entry_embed_plain(bases, quals, wc, cb, out_dtype):
    B, R, L = bases.shape
    V, d = VOCAB_SIZE, wc.shape[1]
    tab = wc[: R * COL_SLOT].float().view(R, COL_SLOT, d)
    # the one-hot contraction is a gather-sum of R table rows; a token
    # outside the vocab selects the appended zero row, as its one-hot is 0
    table = torch.cat(
        [tab[:, :V].reshape(R * V, d), torch.zeros(1, d, device=wc.device)], dim=0
    )
    x = torch.zeros(B, L, d, dtype=torch.float32, device=bases.device)
    for r in range(R):
        t = bases[:, r, :].long()
        # F.embedding gathers what table[idx] gathers; its backward sums the
        # many repeats of each of the R*V+1 rows as sorted segments
        x += F.embedding(torch.where(t < V, r * V + t, R * V), table)
    q = quals.to(out_dtype).float()  # quals meet the weights as bf16
    x = x + torch.einsum("brl,rd->bld", q, tab[:, V])
    return (x + cb.float()).to(out_dtype)


# d_model of the Hopper entry kernel's instantiations (csrc/entry_embed.cu):
# every shipped checkpoint's, and 384 (tools/variant_step_time_torch.py's
# d384x5L); the bf16 SIMT kernel (csrc/entry_embed_bf16.cu) serves the rest
# of the SIMT widths
EMBED_WIDTHS = (256, 384, 512)


def _entry_embed_cuda(bases, quals, wc, cb, out_dtype, kernel: str | None = None):
    """``kernel`` names the instance; None takes wc's: ``entry_embed_f32``
    for float32, ``bf16_kernel_name``'s for bf16."""
    if kernel is None:
        kernel = "entry_embed_f32" if wc.dtype == torch.float32 else \
            bf16_kernel_name("entry_embed", wc.shape[1], R=bases.shape[1]) \
            if wc.dtype == torch.bfloat16 else "entry_embed"
    if kernel != "entry_embed":
        return _entry_embed_simt_cuda(bases, quals, wc, cb, out_dtype, kernel)
    B, R, L = bases.shape
    kp, d = wc.shape
    V = VOCAB_SIZE
    _cuda.check(out_dtype == torch.bfloat16, f"entry_embed kernel emits bf16, not {out_dtype}")
    _cuda.check(kp == 512 and R * COL_SLOT <= kp,
                f"col_proj table has {kp} rows for {R} pileup rows: the kernel takes "
                f"col_proj_table's 512 (R 29-32)")
    _cuda.check(quals.shape == bases.shape and cb.shape == (d,), "input shapes")
    _cuda.check(d in EMBED_WIDTHS, f"d_model {d}: the kernel takes {EMBED_WIDTHS}")
    _cuda.require_dtype(torch.uint8, bases=bases)
    _cuda.require_dtype(torch.float32, quals=quals, cb=cb)
    _cuda.require_dtype(torch.bfloat16, wc=wc)
    dev = _cuda.require_operands(bases=bases, quals=quals, wc=wc, cb=cb)
    out = torch.empty(B, L, d, dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _cuda.call(
            "entry_embed", bases.data_ptr(), quals.data_ptr(), wc.data_ptr(),
            cb.data_ptr(), out.data_ptr(), B, R, L, d, V, kp, _cuda.stream_of(out),
        )
    return out


# K4's SIMT kernel (csrc/entry_embed_simt.cuh): the columns of d a block
# owns, the positions of a tile, the ring's slots, the bytes of its
# mbarriers and counters, and the most shared memory one H100 block may use
# (csrc/common.cuh kMaxSmem)
EMBED_SIMT_SLICE, EMBED_SIMT_TILE, EMBED_SIMT_RING, EMBED_SIMT_HEAD = 32, 128, 2, 64
SMEM_LIMIT = 232448


def embed_simt_plan(d: int, R: int, V: int = VOCAB_SIZE) -> dict:
    """The launch plan of K4's SIMT kernel as ``entry_embed_simt.cuh:launch``
    makes it: ``slices`` blocks of ``EMBED_SIMT_SLICE`` columns share a
    tile of ``EMBED_SIMT_TILE`` positions, and a block's ``smem`` bytes hold
    its mbarriers and counters, a ring of slots of a tile's tokens (u8) and
    quals (float32), and the (V + 1) R table rows of its slice and a row of
    zeros, in float32 whatever the storage type."""
    ring = EMBED_SIMT_RING * R * EMBED_SIMT_TILE * 5
    return dict(slices=d // EMBED_SIMT_SLICE, tile=EMBED_SIMT_TILE,
                smem=EMBED_SIMT_HEAD + ring + (R * (V + 1) + 1) * EMBED_SIMT_SLICE * 4)


def _entry_embed_simt_cuda(bases, quals, wc, cb, out_dtype, kernel: str):
    """K4's SIMT instances: ``entry_embed_f32`` (float32) or
    ``entry_embed_bf16`` (bf16 table and output); quals and cb float32."""
    B, R, L = bases.shape
    kp, d = wc.shape
    dtype, kind = _cuda.simt_dtype(kernel), _simt_kind(kernel)
    _cuda.check(out_dtype == dtype, f"{kernel} kernel emits {dtype}, not {out_dtype}")
    _cuda.check(1 <= R <= F32_MAX_ROWS and R * COL_SLOT <= kp,
                f"R {R} pileup rows and a col_proj table of {kp} rows: the {kind} "
                f"kernel takes R 1 to {F32_MAX_ROWS} and col_proj_table's rows")
    _cuda.check(quals.shape == bases.shape and cb.shape == (d,), "input shapes")
    _check_f32_widths(d, kind=kind)
    smem = embed_simt_plan(d, R)["smem"]
    _cuda.check(smem <= SMEM_LIMIT, f"R {R}: {smem} bytes of shared memory a block")
    _cuda.require_dtype(torch.uint8, bases=bases)
    _cuda.require_dtype(torch.float32, quals=quals, cb=cb)
    _cuda.require_dtype(dtype, wc=wc)
    dev = _cuda.require_operands(bases=bases, quals=quals, wc=wc, cb=cb)
    out = torch.empty(B, L, d, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        _cuda.call(
            kernel, bases.data_ptr(), quals.data_ptr(), wc.data_ptr(),
            cb.data_ptr(), out.data_ptr(), B, R, L, d, VOCAB_SIZE, kp, _cuda.stream_of(out),
        )
    return out


def entry_embed(bases, quals, wc, cb, out_dtype):
    """Column embedding: tokens u8 [B, R, L] + quals f32 [B, R, L] ->
    x [B, L, d]. wc [kp, d] is ``col_proj_table(w_embT, w_qT)``: the
    one-hot rows and the qual row of each pileup row; cb [d] the bias.
    Differentiable in quals, wc and cb."""
    if _needs_grad(quals, wc, cb):
        return _RecomputePlain.apply(
            _entry_embed_op, _entry_embed_plain, (out_dtype,), bases, quals, wc, cb
        )
    return _entry_embed_op(bases, quals, wc, cb, out_dtype)


def _entry_embed_op(bases, quals, wc, cb, out_dtype):
    if _cuda.on_card(bases):
        return _entry_embed_cuda(bases, quals, wc, cb, out_dtype)
    return _entry_embed_plain(bases, quals, wc, cb, out_dtype)


# ---------------------------------------------------------------------------
# K1 ln_qkv_rope: x [B, L, d] -> q, k, v [B, H, L, D]
# ---------------------------------------------------------------------------


def _ln_qkv_rope_plain(x, scale, bias, w, b, n_heads: int):
    B, L, d = x.shape
    H = n_heads
    D = w.shape[1] // (3 * H)
    y = layernorm(x, scale, bias).reshape(-1, d)
    # bf16 operands, float32 accumulation, one rounding after the bias
    qkv = (y.float() @ w.float() + b.float()).to(x.dtype).reshape(B, L, 3, H, D)
    return _rope_split_heads(qkv)


def _rope_split_heads(qkv):
    """qkv [B, L, 3, H, D] -> q, k roped at the absolute column index and v,
    each [B, H, L, D]."""
    _, L, _, _, D = qkv.shape
    cos, sin = rope_tables(L, D, qkv.device)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]

    def rot(t):  # [B, L, H, D], rotate-half in float32
        tf = t.float()
        x1, x2 = tf[..., : D // 2], tf[..., D // 2 :]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(t.dtype)

    q = rot(qkv[:, :, 0]).permute(0, 2, 1, 3).contiguous()
    k = rot(qkv[:, :, 1]).permute(0, 2, 1, 3).contiguous()
    v = qkv[:, :, 2].permute(0, 2, 1, 3).contiguous()
    return q, k, v


def rope_kernel_name(dtype=torch.bfloat16) -> str:
    """The kernel ``ln_qkv_rope`` takes on the card for operands of ``dtype``:
    ``ln_qkv_rope`` (K1, rope tables as inputs) unless ``HERRO_TPU_ROPE`` is
    set to anything but ``tbl``, then ``ln_qkv_rope_split`` (K8, tables built
    in the kernel); for float32 the routes of ``ln_qkv_rope_f32`` under the
    same names with ``_f32``. Read at every call, where
    ``herro_tpu/ops/fused.py:_ln_qkv_rope_pallas`` reads it."""
    name = "ln_qkv_rope" if os.environ.get("HERRO_TPU_ROPE", "tbl") == "tbl" \
        else "ln_qkv_rope_split"
    if dtype == torch.float32:
        return "ln_qkv_rope_f32" if name == "ln_qkv_rope" else "ln_qkv_rope_f32_split"
    return name


# d_model of the Hopper qkv kernels' instantiations
# (csrc/ln_qkv_rope_sm90.cuh, head dim HEAD_DIM): every shipped checkpoint's,
# and for K1 and K8 also 384 (tools/variant_step_time_torch.py's d384x5L);
# K10 takes QKV_Q_WIDTHS. The bf16 SIMT kernel (csrc/ln_qkv_rope_bf16.cu)
# serves the other SIMT widths and head dims
QKV_WIDTHS = (256, 384, 512)
QKV_Q_WIDTHS = (256, 512)


def _ln_qkv_rope_cuda(x, scale, bias, w, b, n_heads: int, kernel: str | None = None):
    """``kernel`` names K1 or K8 (or a SIMT route); None takes
    ``rope_kernel_name`` for float32 and ``bf16_kernel_name``'s for bf16."""
    B, L, d = x.shape
    H = n_heads
    D = w.shape[1] // (3 * H)
    if kernel is None:
        kernel = bf16_kernel_name("ln_qkv_rope", d, D=D) if x.dtype == torch.bfloat16 \
            else rope_kernel_name(x.dtype)
    if _cuda.simt_dtype(kernel) is not None:
        return _ln_qkv_rope_simt_cuda(x, scale, bias, w, b, n_heads, kernel)
    _cuda.check(kernel in ("ln_qkv_rope", "ln_qkv_rope_split"), f"no rope kernel {kernel!r}")
    _cuda.check(D == HEAD_DIM, f"head dim {D}: the kernel takes {HEAD_DIM}")
    _cuda.check(d in QKV_WIDTHS, f"d_model {d}: the kernel takes {QKV_WIDTHS}")
    _cuda.check(w.shape == (d, 3 * H * D) and b.shape == (3 * H * D,), "qkv shapes")
    _cuda.check(scale.shape == (d,) and bias.shape == (d,), "LayerNorm shapes")
    _cuda.require_dtype(torch.bfloat16, x=x, w=w, b=b)
    _cuda.require_dtype(torch.float32, scale=scale, bias=bias)
    dev = _cuda.require_operands(x=x, scale=scale, bias=bias, w=w, b=b)
    q, k, v = (
        torch.empty(B, H, L, D, dtype=torch.bfloat16, device=dev) for _ in range(3)
    )
    head = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(), b.data_ptr())
    tail = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, d, H, _cuda.stream_of(x))
    with torch.cuda.device(dev):
        if kernel == "ln_qkv_rope":
            cos, sin = _rope_tables_cached(L, D, dev)
            _cuda.call(kernel, *head, cos.data_ptr(), sin.data_ptr(), *tail)
        else:
            _cuda.call(kernel, *head, *tail)
    return q, k, v


def _ln_qkv_rope_simt_cuda(x, scale, bias, w, b, n_heads: int, kernel: str):
    """K1/K8's SIMT instances: ``ln_qkv_rope_f32`` and ``ln_qkv_rope_bf16``
    (rope tables handed in), their ``_split`` routes (built in the kernel);
    x, w, b and q/k/v of the instance's dtype, LayerNorm's parameters
    float32, LayerNorm's output through a [B L, d] scratch allocated here
    above ``NARROW_D_MODEL`` (at it the narrow kernel keeps it on chip)."""
    B, L, d = x.shape
    H = n_heads
    D = w.shape[1] // (3 * H)
    dtype = _cuda.simt_dtype(kernel)
    _check_f32_widths(d, D=D, kind=_simt_kind(kernel))
    _cuda.check(w.shape == (d, 3 * H * D) and b.shape == (3 * H * D,), "qkv shapes")
    _cuda.check(scale.shape == (d,) and bias.shape == (d,), "LayerNorm shapes")
    _cuda.require_dtype(dtype, x=x, w=w, b=b)
    _cuda.require_dtype(torch.float32, scale=scale, bias=bias)
    dev = _cuda.require_operands(x=x, scale=scale, bias=bias, w=w, b=b)
    q, k, v = (torch.empty(B, H, L, D, dtype=dtype, device=dev) for _ in range(3))
    # LN(x), the tensor-core product's A
    y = None if d <= NARROW_D_MODEL else torch.empty(B * L, d, dtype=dtype, device=dev)
    head = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(), b.data_ptr())
    tail = (None if y is None else y.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            B, L, d, H, D, _cuda.stream_of(x))
    with torch.cuda.device(dev):
        if not kernel.endswith("_split"):
            cos, sin = _rope_tables_cached(L, D, dev)
            _cuda.call(kernel, *head, cos.data_ptr(), sin.data_ptr(), *tail)
        else:
            _cuda.call(kernel, *head, *tail)
    return q, k, v


def ln_qkv_rope(x, scale, bias, w, b, n_heads: int):
    """LN + qkv projection + rotary: x [B, L, d] -> (q, k, v) [B, H, L, D].
    w [d, 3*H*D] is the (3, H, D) c-major flattening: q of head i is column
    block i, k is H+i, v is 2H+i."""
    if _cuda.on_card(x):
        return _ln_qkv_rope_cuda(x, scale, bias, w, b, n_heads)
    return _ln_qkv_rope_plain(x, scale, bias, w, b, n_heads)


# ---------------------------------------------------------------------------
# K2, K6, K7 flash_outproj: y = x + concat_h(attn_h) @ Wo + bo
# ---------------------------------------------------------------------------


def _flash_outproj_plain(q, k, v, x, wo, bo, lengths, local_window):
    """The plain version of all three attention kernels: ``chunked_attention``
    masks |iq - ik| <= local_window for any band and nothing but the length
    for ``local_window=None``, so one function serves K2, K6 and K7. P stays
    at float32 precision, as herro_tpu's jnp twin keeps it: the CPU forward,
    whose goldens that twin made."""
    return _project(chunked_attention(q, k, v, lengths, local_window), x, wo, bo)


def _flash_outproj_tiled(q, k, v, x, wo, bo, lengths, local_window,
                         tile: int = SIMT_KEY_TILE):
    """K2/K6/K7's function with P rounded to v's dtype per key tile against
    the running maximum (``attention._flash_attention_tiled``), then the
    same projection as :func:`_flash_outproj_plain`. herro_tpu's Pallas
    kernels round P so (``p.astype(v.dtype)``: K7 over key tiles of its
    ``blk_k``, K2 and K6 against one maximum over the band), and so does the
    bf16 SIMT instance (``csrc/flash_tc.cuh``, 64-key tiles): its yardstick
    on the card. For tests and the card's checks only; no route of
    :func:`flash_outproj` takes it."""
    attn = _flash_attention_tiled(q, k, v, lengths, local_window, tile)
    return _project(attn, x, wo, bo)


def _project(attn, x, wo, bo):
    """y = x + concat_h(attn_h) @ Wo + bo in float32, rounded to x's dtype."""
    out = torch.einsum("bhld,hdo->blo", attn.float(), wo.float())
    return (x.float() + out + bo.float()).to(x.dtype)


def flash_kernel_name(local_window, dtype=torch.bfloat16) -> str:
    """The attention kernel a band takes on the card for operands of
    ``dtype``: none -> ``flash_outproj_full`` (K7); a multiple of 256 ->
    ``flash_outproj`` (K2); any other band -> ``flash_outproj_band`` (K6).
    The choice ``herro_tpu/ops/fused.py:_flash_outproj_pallas`` makes, on the
    arguments alone. The reference's ``HERRO_TPU_FLASH=tile`` (its per-head
    kernel for an aligned band) has no counterpart: K6 runs K2's instance
    there. float32: ``flash_f32_full`` without a band, ``flash_f32`` with
    any."""
    if dtype == torch.float32:
        return "flash_f32_full" if local_window is None else "flash_f32"
    if local_window is None:
        return "flash_outproj_full"
    if local_window % 256 == 0:
        return "flash_outproj"
    return "flash_outproj_band"


# (n_heads, d_model) of the Hopper attention kernels' instantiations
# (csrc/flash_outproj_sm90.cuh, head dim HEAD_DIM): every shipped
# checkpoint's, their tensor-parallel shards (r10 at tp 2 and 4, r10deep at
# tp 2), and (3, 384) (tools/variant_step_time_torch.py's d384x5L). The bf16
# SIMT kernel (csrc/flash_bf16.cu) serves the other SIMT widths and head dims
ATTENTION_WIDTHS = ((4, 512), (2, 256), (2, 512), (1, 512), (1, 256), (3, 384))


def _flash_outproj_cuda(q, k, v, x, wo, bo, lengths, local_window,
                        kernel: str | None = None):
    """``kernel`` names the instance; None takes ``flash_kernel_name`` for
    float32 and ``bf16_kernel_name``'s for bf16."""
    B, H, L, D = q.shape
    d = x.shape[-1]
    if kernel is None:
        kernel = bf16_kernel_name("flash_outproj", d, H=H, D=D, local_window=local_window) \
            if x.dtype == torch.bfloat16 else flash_kernel_name(local_window, x.dtype)
    if _cuda.simt_dtype(kernel) is not None:
        return _flash_outproj_simt_cuda(q, k, v, x, wo, bo, lengths, local_window, kernel)
    name = kernel
    _cuda.check(local_window is None or local_window >= 0,
                f"local_window {local_window} is negative")
    _cuda.check(D == HEAD_DIM, f"head dim {D}: the kernel takes {HEAD_DIM}")
    _cuda.check((H, d) in ATTENTION_WIDTHS,
                f"(n_heads, d_model) = ({H}, {d}): the kernel takes {ATTENTION_WIDTHS}")
    _cuda.check(k.shape == q.shape and v.shape == q.shape, "q/k/v shapes")
    _cuda.check(x.shape == (B, L, d) and wo.shape == (H, D, d) and bo.shape == (d,),
                "x/wo/bo shapes")
    _cuda.check(lengths.shape == (B,), "lengths shape")
    _cuda.require_dtype(torch.bfloat16, q=q, k=k, v=v, x=x, wo=wo, bo=bo)
    _cuda.require_dtype(torch.int32, lengths=lengths)
    dev = _cuda.require_operands(q=q, k=k, v=v, x=x, wo=wo, bo=bo, lengths=lengths)
    out = torch.empty_like(x)
    # the full kernel has no band and takes no window
    band = () if local_window is None else (int(local_window),)
    with torch.cuda.device(dev):
        _cuda.call(
            name, q.data_ptr(), k.data_ptr(), v.data_ptr(), x.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, L, d, *band, 1.0 / math.sqrt(D), _cuda.stream_of(x),
        )
    return out


def _flash_outproj_simt_cuda(q, k, v, x, wo, bo, lengths, local_window, kernel: str):
    """K2/K6/K7's SIMT instances: ``flash_f32`` / ``flash_bf16`` (any band)
    and their ``_full`` modes (no band), every float operand of the
    instance's dtype."""
    B, H, L, D = q.shape
    d = x.shape[-1]
    dtype = _cuda.simt_dtype(kernel)
    _cuda.check((local_window is None) == kernel.endswith("_full"),
                f"{kernel} does not take local_window {local_window}")
    _cuda.check(local_window is None or local_window >= 0,
                f"local_window {local_window} is negative")
    _check_f32_widths(d, D=D, kind=_simt_kind(kernel))
    _cuda.check(k.shape == q.shape and v.shape == q.shape, "q/k/v shapes")
    _cuda.check(x.shape == (B, L, d) and wo.shape == (H, D, d) and bo.shape == (d,),
                "x/wo/bo shapes")
    _cuda.check(lengths.shape == (B,), "lengths shape")
    _cuda.require_dtype(dtype, q=q, k=k, v=v, x=x, wo=wo, bo=bo)
    _cuda.require_dtype(torch.int32, lengths=lengths)
    dev = _cuda.require_operands(q=q, k=k, v=v, x=x, wo=wo, bo=bo, lengths=lengths)
    # the attention's output [B, L, H, D] in the instance's dtype, the out
    # projection's operand
    scratch = torch.empty(B, L, H, D, dtype=dtype, device=dev)
    out = torch.empty_like(x)
    band = () if local_window is None else (int(local_window),)
    with torch.cuda.device(dev):
        _cuda.call(
            kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), x.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), lengths.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            B, H, L, d, D, *band, 1.0 / math.sqrt(D), _cuda.stream_of(x),
        )
    return out


def _outproj_cuda(o, x, wo, bo, kernel: str):
    """K2/K6/K7's out projection alone on its SIMT instance's card route
    (``flash_f32_outproj``, ``flash_bf16_outproj``): y = (x + concat_h(o_h)
    @ Wo) + bo, o [B, L, H, D] as the attention leaves it in the scratch of
    :func:`_flash_outproj_simt_cuda`, every operand of the instance's dtype.
    The attention kernels run the same projection inside their own call;
    this entry point times and checks it on its own (its plain version:
    :func:`_outproj_plain`)."""
    B, L, H, D = o.shape
    d = x.shape[-1]
    _cuda.check(kernel in ("flash_f32_outproj", "flash_bf16_outproj"),
                f"{kernel} is no out projection")
    dtype = _cuda.simt_dtype(kernel)
    _check_f32_widths(d, D=D, kind=_simt_kind(kernel))
    _cuda.check(x.shape == (B, L, d) and wo.shape == (H, D, d) and bo.shape == (d,),
                "o/x/wo/bo shapes")
    _cuda.require_dtype(dtype, o=o, x=x, wo=wo, bo=bo)
    dev = _cuda.require_operands(o=o, x=x, wo=wo, bo=bo)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        _cuda.call(kernel, o.data_ptr(), x.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                   out.data_ptr(), B * L, H * D, d, _cuda.stream_of(x))
    return out


def _outproj_plain(o, x, wo, bo):
    """:func:`_outproj_cuda`'s function: :func:`_project` of o [B, L, H, D]."""
    return _project(o.permute(0, 2, 1, 3), x, wo, bo)


def flash_outproj(q, k, v, x, wo, bo, lengths, local_window):
    """Attention + out projection + residual: y = x + concat_h(attn_h) @ Wo
    + bo, with wo passed as [H, D, d_model] and the band |iq - ik| <=
    local_window (None: every key below the length). Rows at or past a
    batch element's length are padding: finite, and read by no later stage."""
    if _cuda.on_card(x):
        return _flash_outproj_cuda(q, k, v, x, wo, bo, lengths, local_window)
    return _flash_outproj_plain(q, k, v, x, wo, bo, lengths, local_window)


# ---------------------------------------------------------------------------
# K3 ln_ffn: y = x + gelu_tanh(LN(x) @ w1 + b1) @ w2 + b2
# ---------------------------------------------------------------------------


def _ln_ffn_plain(x, scale, bias, w1, b1, w2, b2):
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    y = layernorm(xf, scale, bias)
    h = (y.float() @ w1.float() + b1.float()).to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    o = h.float() @ w2.float() + b2.float()
    return (xf.float() + o).to(x.dtype).reshape(x.shape)


# d_model of the Hopper FFN kernel's instantiations (csrc/ln_ffn.cu, d_ff a
# multiple of 128): every shipped checkpoint's, and 384
# (tools/variant_step_time_torch.py's d384x5L). The bf16 SIMT kernel
# (csrc/ln_ffn_bf16.cu) serves the other SIMT widths
FFN_WIDTHS = (256, 384, 512)


def _ln_ffn_cuda(x, scale, bias, w1, b1, w2, b2, kernel: str | None = None):
    """``kernel`` names the instance; None takes ``ln_ffn_f32`` for float32
    and ``bf16_kernel_name``'s for bf16."""
    d = x.shape[-1]
    f = w1.shape[1]
    if kernel is None:
        kernel = "ln_ffn_f32" if x.dtype == torch.float32 else \
            bf16_kernel_name("ln_ffn", d, f) if x.dtype == torch.bfloat16 else "ln_ffn"
    if _cuda.simt_dtype(kernel) is not None:
        return _ln_ffn_simt_cuda(x, scale, bias, w1, b1, w2, b2, kernel)
    _cuda.check(d in FFN_WIDTHS, f"d_model {d}: the kernel takes {FFN_WIDTHS}")
    _cuda.check(f >= 128 and f % 128 == 0, f"d_ff {f}: the kernel takes a multiple of 128")
    _cuda.check(w1.shape == (d, f) and b1.shape == (f,), "ff1 shapes")
    _cuda.check(w2.shape == (f, d) and b2.shape == (d,), "ff2 shapes")
    _cuda.check(scale.shape == (d,) and bias.shape == (d,), "LayerNorm shapes")
    _cuda.require_dtype(torch.bfloat16, x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    _cuda.require_dtype(torch.float32, scale=scale, bias=bias)
    dev = _cuda.require_operands(
        x=x, scale=scale, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2
    )
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        _cuda.call(
            "ln_ffn", x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            x.numel() // d, d, f, _cuda.stream_of(x),
        )
    return out


def _ln_ffn_simt_cuda(x, scale, bias, w1, b1, w2, b2, kernel: str):
    """K3's SIMT instances: ``ln_ffn_f32`` and ``ln_ffn_bf16``; x, the
    weights and biases of the instance's dtype, LayerNorm's parameters
    float32, the hidden through a scratch allocated here above
    ``NARROW_D_MODEL`` (at it one launch keeps the hidden on chip)."""
    d = x.shape[-1]
    f = w1.shape[1]
    dtype = _cuda.simt_dtype(kernel)
    _check_f32_widths(d, f, kind=_simt_kind(kernel))
    _cuda.check(w1.shape == (d, f) and b1.shape == (f,), "ff1 shapes")
    _cuda.check(w2.shape == (f, d) and b2.shape == (d,), "ff2 shapes")
    _cuda.check(scale.shape == (d,) and bias.shape == (d,), "LayerNorm shapes")
    _cuda.require_dtype(dtype, x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    _cuda.require_dtype(torch.float32, scale=scale, bias=bias)
    dev = _cuda.require_operands(
        x=x, scale=scale, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2
    )
    T = x.numel() // d
    # gelu(LN(x) W1 + b1)
    hidden = None if d <= NARROW_D_MODEL else torch.empty(T, f, dtype=dtype, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        _cuda.call(
            kernel, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            None if hidden is None else hidden.data_ptr(), out.data_ptr(),
            T, d, f, _cuda.stream_of(x),
        )
    return out


def ln_ffn(x, scale, bias, w1, b1, w2, b2):
    """Pre-norm FFN block with residual: x + FF2(gelu_tanh(FF1(LN(x)))).
    Differentiable in every input."""
    args = (x, scale, bias, w1, b1, w2, b2)
    if _needs_grad(*args):
        return _RecomputePlain.apply(_ln_ffn_op, _ln_ffn_plain, (), *args)
    return _ln_ffn_op(*args)


def _ln_ffn_op(x, scale, bias, w1, b1, w2, b2):
    if _cuda.on_card(x):
        return _ln_ffn_cuda(x, scale, bias, w1, b1, w2, b2)
    return _ln_ffn_plain(x, scale, bias, w1, b1, w2, b2)


# ---------------------------------------------------------------------------
# int8: per-row activations, per-column weights, int8 x int8 -> int32
# ---------------------------------------------------------------------------


def _div127(t):
    """t / 127 as a true division on every device. On the card PyTorch turns a
    division by a Python number into a multiplication by its float32
    reciprocal, which rounds differently for some t; dividing by a tensor
    keeps the IEEE quotient that the reference and the kernels compute."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_weight(w, absmax=None):
    """Per-output-channel symmetric int8: w [d, f] -> (w_i8 [d, f], s [f]).
    ``absmax`` [f] stands in for the columns' max |w| (a row-split shard
    holds some rows of each column; ``parallel/tensor.py`` hands it the
    maximum over every shard)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0) if absmax is None else absmax
    s = _div127(absmax).clamp_min(1e-12)
    w_i8 = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return w_i8, s


def k_major(w_i8):
    """The same [in, out] int8 weight stored k-major (its transpose [out, in]
    is contiguous), as the CUDA kernels take it: their int8 tensor-core
    product wants operand B contiguous along k. Done once per weight
    state, not per call."""
    return w_i8.t().contiguous().t()


def _quant_rows(y, absmax=None):
    """Per-row symmetric int8 of f32 y [T, d] -> (y_i8, s_row [T, 1]): a true
    division, round half to even, clipped to +-127. ``absmax`` [T, 1] stands
    in for the rows' max |y| (a shard's hidden holds part of each row)."""
    absmax = y.abs().amax(dim=-1, keepdim=True) if absmax is None else absmax
    s = _div127(absmax).clamp_min(1e-12)
    y_i8 = torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)
    return y_i8, s


def _int8_mm(y_i8, s_row, w_i8, s_col):
    """(int8, int8) -> f32: exact integer accumulation, then (acc * s_row) *
    s_col. On the CPU the product runs in int32; on the card torch.matmul has
    no integer product, so it runs in float64, which holds every sum exactly
    (|acc| <= 127 * 127 * K < 2^53), and rounds to float32 once, as the
    int32 -> float32 conversion does."""
    if y_i8.is_cuda:
        acc = (y_i8.double() @ w_i8.double()).float()
    else:
        acc = (y_i8.int() @ w_i8.int()).float()
    return acc * s_row * s_col


def _require_k_major(**weights) -> dict:
    """The int8 weights as the contiguous [out, in] tensors the kernels read,
    for ``require_operands``."""
    for name, w in weights.items():
        _cuda.check(w.dim() == 2 and w.t().is_contiguous(),
                    f"{name} is not k-major: pass k_major({name})")
    _cuda.require_dtype(torch.int8, **weights)
    return {name: w.t() for name, w in weights.items()}


def _ln_qkv_rope_q_plain(x, scale, bias, w_i8, s_col, b, n_heads: int):
    B, L, d = x.shape
    H = n_heads
    D = w_i8.shape[1] // (3 * H)
    y = layernorm(x, scale, bias).float().reshape(-1, d)  # rounded to x's dtype first
    y_i8, s_row = _quant_rows(y)
    qkv = (_int8_mm(y_i8, s_row, w_i8, s_col) + b.float()).to(x.dtype)
    return _rope_split_heads(qkv.reshape(B, L, 3, H, D))


def int8_kernel_name(dtype, d: int, f: int | None = None, D: int | None = None) -> str:
    """The kernel an int8 op takes on the card for activations of ``dtype``:
    K10 for the qkv projection at head dim ``D`` (``f`` None), K11 for the
    FFN at d_ff ``f`` (a shard's, under tensor parallelism; K11's two modes
    take its instance under their own names). The Hopper instance
    (``ln_qkv_rope_q``, ``ln_ffn_q``: int8 ``wgmma``) where it takes the
    operands, bf16 at its widths; otherwise the SIMT one
    (``ln_qkv_rope_q_simt``, ``ln_ffn_q_simt``: int8 ``mma.sync``) for
    float32 or
    bf16 at d_model up to ``INT8_MAX_D_MODEL``, d_ff up to ``INT8_MAX_D_FF``
    and head dims ``cuda.POW2_HEAD_DIMS`` (narrower than the float32
    kernels'); outside those a ValueError that names int8, the dtype or
    the width and the range, before any launch. The reference picks its int8 kernels by
    backend and length alone (``herro_tpu/ops/fused.py:480-486``,
    ``:797-804``); this is the port's choice of instance, on the arguments
    alone."""
    if f is None:
        if dtype == torch.bfloat16 and D == HEAD_DIM and d in QKV_Q_WIDTHS:
            return "ln_qkv_rope_q"
    elif dtype == torch.bfloat16 and _ffn_q_hopper_takes(d, f):
        return "ln_ffn_q"
    _check_int8_simt(dtype, d, f, D)
    return "ln_qkv_rope_q_simt" if f is None else "ln_ffn_q_simt"


def _check_int8_simt(dtype, d: int, f: int | None = None, D: int | None = None) -> None:
    """The activations and widths the SIMT int8 kernels take."""
    _cuda.check(dtype in (torch.float32, torch.bfloat16),
                f"x is {dtype}: the int8 kernels take torch.float32 or torch.bfloat16")
    _check_f32_widths(d, f, D, kind="int8 SIMT")


def _ln_qkv_rope_q_cuda(x, scale, bias, w_i8, s_col, b, n_heads: int):
    """K10's Hopper instance (``int8_kernel_name``'s ``ln_qkv_rope_q``)."""
    B, L, d = x.shape
    H = n_heads
    D = w_i8.shape[1] // (3 * H)
    N = 3 * H * D
    _cuda.check(D == HEAD_DIM, f"head dim {D}: the kernel takes {HEAD_DIM}")
    _cuda.check(d in QKV_Q_WIDTHS, f"d_model {d}: the kernel takes {QKV_Q_WIDTHS}")
    _cuda.check(w_i8.shape == (d, N) and s_col.shape == (N,) and b.shape == (N,),
                "qkv shapes")
    _cuda.check(scale.shape == (d,) and bias.shape == (d,), "LayerNorm shapes")
    _cuda.require_dtype(torch.bfloat16, x=x, b=b)
    _cuda.require_dtype(torch.float32, scale=scale, bias=bias, s_col=s_col)
    dev = _cuda.require_operands(x=x, scale=scale, bias=bias, s_col=s_col, b=b,
                                 **_require_k_major(w_i8=w_i8))
    q, k, v = (
        torch.empty(B, H, L, D, dtype=torch.bfloat16, device=dev) for _ in range(3)
    )
    with torch.cuda.device(dev):
        _cuda.call(
            "ln_qkv_rope_q", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            w_i8.data_ptr(), s_col.data_ptr(), b.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), B, L, d, H, _cuda.stream_of(x),
        )
    return q, k, v


def _ln_qkv_rope_q_simt_cuda(x, scale, bias, w_i8, s_col, b, n_heads: int):
    """K10's SIMT instance (``ln_qkv_rope_q_simt``): float32 or bf16 x, b of
    x's dtype, at the float32 kernels' widths."""
    B, L, d = x.shape
    H = n_heads
    D = w_i8.shape[1] // (3 * H)
    N = 3 * H * D
    _check_int8_simt(x.dtype, d, D=D)
    _cuda.check(w_i8.shape == (d, N) and s_col.shape == (N,) and b.shape == (N,),
                "qkv shapes")
    _cuda.check(scale.shape == (d,) and bias.shape == (d,), "LayerNorm shapes")
    _cuda.require_dtype(x.dtype, b=b)
    _cuda.require_dtype(torch.float32, scale=scale, bias=bias, s_col=s_col)
    dev = _cuda.require_operands(x=x, scale=scale, bias=bias, s_col=s_col, b=b,
                                 **_require_k_major(w_i8=w_i8))
    q, k, v = (torch.empty(B, H, L, D, dtype=x.dtype, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        cos, sin = _rope_tables_cached(L, D, dev)
        _cuda.call(
            "ln_qkv_rope_q_simt", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            w_i8.data_ptr(), s_col.data_ptr(), b.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, d, H, D,
            int(x.dtype == torch.bfloat16), _cuda.stream_of(x),
        )
    return q, k, v


def ln_qkv_rope_q(x, scale, bias, w_i8, s_col, b, n_heads: int):
    """int8 LN + qkv projection + rotary: x [B, L, d] -> (q, k, v)
    [B, H, L, D], with (w_i8 [d, 3*H*D], s_col) from ``quantize_weight``. On
    the card w_i8 must be ``k_major``, and the instance is
    ``int8_kernel_name``'s. Not differentiable on its own: under autograd it
    runs inside ``attention_block_q`` or ``attention_shard_q``."""
    if _cuda.on_card(x):
        name = int8_kernel_name(x.dtype, x.shape[-1], D=w_i8.shape[1] // (3 * n_heads))
        wrapper = _ln_qkv_rope_q_cuda if name == "ln_qkv_rope_q" else _ln_qkv_rope_q_simt_cuda
        return wrapper(x, scale, bias, w_i8, s_col, b, n_heads)
    return _ln_qkv_rope_q_plain(x, scale, bias, w_i8, s_col, b, n_heads)


def _ffn_q_hidden(x, scale, bias, w1_i8, s1, b1):
    """The int8 FFN's hidden, gelu(h) [T, f] in float32 (x's dtype rounded):
    LN(x) quantized per row, the int8 product with W1, dequantized, + b1."""
    d = x.shape[-1]
    y = layernorm(x.reshape(-1, d), scale, bias).float()
    y_i8, s_row = _quant_rows(y)
    h = (_int8_mm(y_i8, s_row, w1_i8, s1) + b1.float()).to(x.dtype)
    return F.gelu(h.float(), approximate="tanh").to(x.dtype).float()


def _ffn_q_out(x, h, hmax, w2_i8, s2, b2, res_scale: float):
    """x * res_scale + the second product of the hidden h quantized per row
    by the row maxima hmax [T, 1], dequantized, + b2; in x's dtype."""
    d = x.shape[-1]
    h_i8, hs_row = _quant_rows(h, hmax)
    o = _int8_mm(h_i8, hs_row, w2_i8, s2) + b2.float()
    xf = x.reshape(-1, d).float() * res_scale  # exact: 1, or 1 / tp at tp 2 or 4
    return (xf + o).to(x.dtype).reshape(x.shape)


def _ln_ffn_q_plain(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2):
    h = _ffn_q_hidden(x, scale, bias, w1_i8, s1, b1)
    # the second quantization over the whole d_ff row
    return _ffn_q_out(x, h, h.abs().amax(dim=-1, keepdim=True), w2_i8, s2, b2, 1.0)


def _ln_ffn_q_rowmax_plain(x, scale, bias, w1_i8, s1, b1, ties: bool = False):
    a = _ffn_q_hidden(x, scale, bias, w1_i8, s1, b1).abs()
    top = a.amax(dim=-1)
    if not ties:
        return top.reshape(x.shape[:-1]), None
    count = (a == top[:, None]).sum(dim=-1, dtype=torch.int32)
    return top.reshape(x.shape[:-1]), count.reshape(x.shape[:-1])


def _ln_ffn_q_rowscale_plain(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2, hmax,
                             res_scale: float):
    h = _ffn_q_hidden(x, scale, bias, w1_i8, s1, b1)
    return _ffn_q_out(x, h, hmax.reshape(-1, 1), w2_i8, s2, b2, res_scale)


# d_model -> the d_ff range K11 takes (csrc/ln_ffn_q.cu, plan()): the hidden
# of a 64-row tile, [64, d_ff] bf16, stays in shared memory beside a ring of
# at least two weight stages; the next tile's x lands in its upper half, or
# in a buffer of its own below d_ff 2 * d_model (the tensor-parallel shards
# of r10: d_ff 512 at tp 2, 256 at tp 4)
FFN_Q_D_FF = {256: (512, 1536), 512: (256, 1280)}


def _ffn_q_hopper_takes(d: int, f: int) -> bool:
    lo, hi = FFN_Q_D_FF.get(d, (0, -1))
    return lo <= f <= hi and f % 128 == 0


def _check_ffn_q(x, scale, bias, w1_i8, s1, b1, *second, simt: bool = False):
    """The checks of K11's three modes, on the Hopper instance or (``simt``)
    the SIMT one: (w2_i8, s2, b2) as ``second`` where the mode runs the
    second product. Returns the device."""
    d = x.shape[-1]
    f = w1_i8.shape[1]
    if simt:
        _check_int8_simt(x.dtype, d, f)
    else:
        _cuda.check(_ffn_q_hopper_takes(d, f),
                    f"(d_model, d_ff) = ({d}, {f}): the kernel takes d_ff a multiple of 128 "
                    f"in {FFN_Q_D_FF} by d_model")
    _cuda.check(w1_i8.shape == (d, f) and s1.shape == (f,) and b1.shape == (f,),
                "ff1 shapes")
    _cuda.check(scale.shape == (d,) and bias.shape == (d,), "LayerNorm shapes")
    if not simt:
        _cuda.require_dtype(torch.bfloat16, x=x)
    _cuda.require_dtype(torch.float32, scale=scale, bias=bias, s1=s1, b1=b1)
    weights = dict(w1_i8=w1_i8)
    vectors = {}
    if second:
        w2_i8, s2, b2 = second
        _cuda.check(w2_i8.shape == (f, d) and s2.shape == (d,) and b2.shape == (d,),
                    "ff2 shapes")
        _cuda.require_dtype(torch.float32, s2=s2, b2=b2)
        weights["w2_i8"], vectors = w2_i8, dict(s2=s2, b2=b2)
    return _cuda.require_operands(x=x, scale=scale, bias=bias, s1=s1, b1=b1, **vectors,
                                  **_require_k_major(**weights))


def _ln_ffn_q_cuda(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2):
    dev = _check_ffn_q(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2)
    d, f = x.shape[-1], w1_i8.shape[1]
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        _cuda.call(
            "ln_ffn_q", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            w1_i8.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_i8.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), out.data_ptr(), x.numel() // d, d, f,
            _cuda.stream_of(x),
        )
    return out


def _ln_ffn_q_rowmax_cuda(x, scale, bias, w1_i8, s1, b1, ties: bool = False):
    dev = _check_ffn_q(x, scale, bias, w1_i8, s1, b1)
    d, f = x.shape[-1], w1_i8.shape[1]
    hmax = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    count = torch.empty(x.shape[:-1], dtype=torch.int32, device=dev) if ties else None
    with torch.cuda.device(dev):
        _cuda.call(
            "ln_ffn_q_rowmax", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            w1_i8.data_ptr(), s1.data_ptr(), b1.data_ptr(), hmax.data_ptr(),
            None if count is None else count.data_ptr(), x.numel() // d, d, f,
            _cuda.stream_of(x),
        )
    return hmax, count


def _ln_ffn_q_rowscale_cuda(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2, hmax,
                            res_scale: float):
    dev = _check_ffn_q(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2)
    d, f = x.shape[-1], w1_i8.shape[1]
    _cuda.check(hmax.shape == x.shape[:-1], f"hmax {tuple(hmax.shape)}: one a row of x")
    _cuda.require_dtype(torch.float32, hmax=hmax)
    _cuda.require_operands(x=x, hmax=hmax)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        _cuda.call(
            "ln_ffn_q_rowscale", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            w1_i8.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_i8.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), hmax.data_ptr(), float(res_scale),
            out.data_ptr(), x.numel() // d, d, f, _cuda.stream_of(x),
        )
    return out


def _ln_ffn_q_simt_cuda(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2):
    """K11's SIMT instance (``ln_ffn_q_simt``): float32 or bf16 x at the
    float32 kernels' widths. Its hidden, [T, d_ff] of x's dtype, and the row
    maxima pass through a scratch allocated here."""
    dev = _check_ffn_q(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2, simt=True)
    d, f = x.shape[-1], w1_i8.shape[1]
    T = x.numel() // d
    hidden = torch.empty(T, f, dtype=x.dtype, device=dev)
    hmax = torch.empty(T, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        _cuda.call(
            "ln_ffn_q_simt", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            w1_i8.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_i8.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), hidden.data_ptr(), hmax.data_ptr(), out.data_ptr(),
            T, d, f, int(x.dtype == torch.bfloat16), _cuda.stream_of(x),
        )
    return out


def _ln_ffn_q_rowmax_simt_cuda(x, scale, bias, w1_i8, s1, b1, ties: bool = False):
    dev = _check_ffn_q(x, scale, bias, w1_i8, s1, b1, simt=True)
    d, f = x.shape[-1], w1_i8.shape[1]
    hmax = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    count = torch.empty(x.shape[:-1], dtype=torch.int32, device=dev) if ties else None
    with torch.cuda.device(dev):
        _cuda.call(
            "ln_ffn_q_simt_rowmax", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            w1_i8.data_ptr(), s1.data_ptr(), b1.data_ptr(), hmax.data_ptr(),
            None if count is None else count.data_ptr(), x.numel() // d, d, f,
            int(x.dtype == torch.bfloat16), _cuda.stream_of(x),
        )
    return hmax, count


def _ln_ffn_q_rowscale_simt_cuda(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2, hmax,
                                 res_scale: float):
    dev = _check_ffn_q(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2, simt=True)
    d, f = x.shape[-1], w1_i8.shape[1]
    _cuda.check(hmax.shape == x.shape[:-1], f"hmax {tuple(hmax.shape)}: one a row of x")
    _cuda.require_dtype(torch.float32, hmax=hmax)
    _cuda.require_operands(x=x, hmax=hmax)
    T = x.numel() // d
    hidden = torch.empty(T, f, dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        _cuda.call(
            "ln_ffn_q_simt_rowscale", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            w1_i8.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_i8.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), hmax.data_ptr(), float(res_scale),
            hidden.data_ptr(), out.data_ptr(), T, d, f, int(x.dtype == torch.bfloat16),
            _cuda.stream_of(x),
        )
    return out


def _ffn_q_on_simt(x, w1_i8) -> bool:
    """Whether K11 takes its SIMT instance for x and (a shard's) W1."""
    return int8_kernel_name(x.dtype, x.shape[-1], w1_i8.shape[1]) == "ln_ffn_q_simt"


def ln_ffn_q(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2):
    """int8 pre-norm FFN block with residual: x [..., d] + FF2(quant(gelu(
    FF1(quant(LN(x)))))); (w1_i8, s1), (w2_i8, s2) from ``quantize_weight``,
    b1 and b2 float32. On the card the weights must be ``k_major``, and the
    instance is ``int8_kernel_name``'s. Differentiable in every float
    input."""
    args = (x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2)
    if _needs_grad(*args):
        return _RecomputePlain.apply(_ln_ffn_q_op, _ln_ffn_q_plain, (), *args)
    return _ln_ffn_q_op(*args)


def _ln_ffn_q_op(x, *rest):
    if _cuda.on_card(x):
        simt = _ffn_q_on_simt(x, rest[2])
        return (_ln_ffn_q_simt_cuda if simt else _ln_ffn_q_cuda)(x, *rest)
    return _ln_ffn_q_plain(x, *rest)


def ln_ffn_q_rowmax(x, scale, bias, w1_i8, s1, b1):
    """A tensor-parallel shard's first int8 FFN pass: the maximum of |gelu(h)|
    over each row's d_ff / tp hidden columns, float32 of x's leading shape,
    and, under autograd, how many of those columns reach it, int32 of the
    same shape (None otherwise), for ``all_reduce_max``; LayerNorm of the
    whole stream x. Differentiable in the maximum (its gradient split evenly
    between the tied columns)."""
    args = (x, scale, bias, w1_i8, s1, b1)
    if _needs_grad(*args):
        return _RecomputePlain.apply(_ln_ffn_q_rowmax_op, _ln_ffn_q_rowmax_plain, (True,),
                                     *args)
    return _ln_ffn_q_rowmax_op(*args, False)


def _ln_ffn_q_rowmax_op(x, *rest):
    if _cuda.on_card(x):
        simt = _ffn_q_on_simt(x, rest[2])
        return (_ln_ffn_q_rowmax_simt_cuda if simt else _ln_ffn_q_rowmax_cuda)(x, *rest)
    return _ln_ffn_q_rowmax_plain(x, *rest)


def ln_ffn_q_rowscale(x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2, hmax,
                      res_scale: float):
    """A tensor-parallel shard's second int8 FFN pass: x * res_scale + FF2 of
    the shard's hidden (recomputed as in the first pass), quantized per row
    by ``hmax``, the maxima over every shard; b2 is the shard's part (b2 /
    tp). Summed over the shards it is ``ln_ffn_q`` of x. Differentiable in
    every float input, hmax included."""
    args = (x, scale, bias, w1_i8, s1, b1, w2_i8, s2, b2, hmax)
    if _needs_grad(*args):
        return _RecomputePlain.apply(_ln_ffn_q_rowscale_op, _ln_ffn_q_rowscale_plain,
                                     (res_scale,), *args)
    return _ln_ffn_q_rowscale_op(*args, res_scale)


def _ln_ffn_q_rowscale_op(x, *rest):
    if _cuda.on_card(x):
        simt = _ffn_q_on_simt(x, rest[2])
        return (_ln_ffn_q_rowscale_simt_cuda if simt else _ln_ffn_q_rowscale_cuda)(x, *rest)
    return _ln_ffn_q_rowscale_plain(x, *rest)


def _attention_shard_q_op(x, residual, ln_s, ln_b, w_i8, s_col, b_qkv, wo, bo, lengths,
                          n_heads, local_window):
    q, k, v = ln_qkv_rope_q(x, ln_s, ln_b, w_i8, s_col, b_qkv, n_heads)
    return flash_outproj(q, k, v, residual, wo, bo, lengths, local_window)


def _attention_shard_q_plain(x, residual, ln_s, ln_b, w_i8, s_col, b_qkv, wo, bo, lengths,
                             n_heads, local_window):
    q, k, v = _ln_qkv_rope_q_plain(x, ln_s, ln_b, w_i8, s_col, b_qkv, n_heads)
    return _flash_outproj_plain(q, k, v, residual, wo, bo, lengths, local_window)


def attention_shard_q(x, residual, ln_s, ln_b, w_i8, s_col, b_qkv, wo, bo, lengths,
                      n_heads, local_window):
    """int8 ``attention_shard``: ``residual`` + MHA(rope(quant(LN(x)) Wqkv_i8))
    Wo + bo over the shard's heads; the qkv projection runs int8 (K10),
    attention and the out projection (K2, K6, K7) in the compute dtype.
    Differentiable in every float input."""
    args = (x, residual, ln_s, ln_b, w_i8, s_col, b_qkv, wo, bo, lengths)
    if _needs_grad(*args):
        return _RecomputePlain.apply(_attention_shard_q_op, _attention_shard_q_plain,
                                     (n_heads, local_window), *args)
    return _attention_shard_q_op(*args, n_heads, local_window)


def attention_block_q(x, ln_s, ln_b, w_i8, s_col, b_qkv, wo, bo, lengths, n_heads,
                      local_window):
    """int8 attention block: the qkv projection runs int8; attention itself
    and the out projection stay in the compute dtype. Takes the qkv weight
    already quantized (``quantize_weight`` of the weight in the compute
    dtype, which the reference does inside the call; the model does it once
    per parameter state). ``attention_shard_q`` with the stream as its own
    residual."""
    return attention_shard_q(x, x, ln_s, ln_b, w_i8, s_col, b_qkv, wo, bo, lengths,
                             n_heads, local_window)


def attention_block(x, ln_s, ln_b, w_qkv, b_qkv, wo, bo, lengths, n_heads,
                    local_window):
    """Pre-norm attention block: x + MHA(rope(LN(x) Wqkv)) Wo + bo.
    Differentiable in every input but lengths; one Function covers both
    kernels, as the reference's custom_vjp does."""
    args = (x, ln_s, ln_b, w_qkv, b_qkv, wo, bo, lengths)
    if _needs_grad(*args[:-1]):
        return _RecomputePlain.apply(
            _attention_block_op, _attention_block_plain, (n_heads, local_window), *args
        )
    return _attention_block_op(*args, n_heads, local_window)


def _attention_block_op(x, ln_s, ln_b, w_qkv, b_qkv, wo, bo, lengths, n_heads,
                        local_window):
    q, k, v = ln_qkv_rope(x, ln_s, ln_b, w_qkv, b_qkv, n_heads)
    return flash_outproj(q, k, v, x, wo, bo, lengths, local_window)


def _attention_block_plain(x, ln_s, ln_b, w_qkv, b_qkv, wo, bo, lengths, n_heads,
                           local_window):
    q, k, v = _ln_qkv_rope_plain(x, ln_s, ln_b, w_qkv, b_qkv, n_heads)
    return _flash_outproj_plain(q, k, v, x, wo, bo, lengths, local_window)


def attention_shard(x, residual, ln_s, ln_b, w_qkv, b_qkv, wo, bo, lengths, n_heads,
                    local_window):
    """One tensor-parallel shard's attention block: ``residual`` + MHA(rope(
    LN(x) Wqkv)) Wo + bo over the shard's heads. The stream x feeds the
    LayerNorm and ``residual`` (x / tp on a shard) the kernel's residual
    add, the inference path's two kernels (``parallel/tensor.py``).
    Differentiable in every input but lengths, through the plain versions."""
    args = (x, residual, ln_s, ln_b, w_qkv, b_qkv, wo, bo, lengths)
    if _needs_grad(*args[:-1]):
        return _RecomputePlain.apply(
            _attention_shard_op, _attention_shard_plain, (n_heads, local_window), *args
        )
    return _attention_shard_op(*args, n_heads, local_window)


def _attention_shard_op(x, residual, ln_s, ln_b, w_qkv, b_qkv, wo, bo, lengths, n_heads,
                        local_window):
    q, k, v = ln_qkv_rope(x, ln_s, ln_b, w_qkv, b_qkv, n_heads)
    return flash_outproj(q, k, v, residual, wo, bo, lengths, local_window)


def _attention_shard_plain(x, residual, ln_s, ln_b, w_qkv, b_qkv, wo, bo, lengths, n_heads,
                           local_window):
    q, k, v = _ln_qkv_rope_plain(x, ln_s, ln_b, w_qkv, b_qkv, n_heads)
    return _flash_outproj_plain(q, k, v, residual, wo, bo, lengths, local_window)
