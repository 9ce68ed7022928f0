// K10: int8 LayerNorm + qkv projection + rotary epilogue, q/k/v per head.
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_q_kernel (via
// _ln_qkv_rope_q_pallas).
// y = bf16(LN(x)) is quantized per row to int8, multiplied with the int8
// weight into int32, and qkv = bf16((float(acc) * s_row) * s_col + b); q and
// k then take the rotate-half rope at the absolute column index (tables built
// in the kernel, rope.cuh) and are rounded again; v passes through. The
// weight arrives k-major ([3*H*D, d]): int8 wgmma has no transpose.
// Bound on the H100: bytes (x read once, q/k/v written once) over the memory
// rate; the int8 tensor-core rate puts the operations (2*T*d*3*H*D) below
// that.
// Design: ln_qkv_rope_sm90.cuh under kInt8, K1's persistent TMA / wgmma /
// warp-specialised kernel with int8 operands. Shared memory: LayerNorm
// quantizes in place into the lower half of the bf16 x tile, so K1's
// 128-row tile, 64 KB weight ring and staging tile stay as they are (the
// alternative, K11's 64-row tiles, would stream each weight byte from L2
// twice as often). LayerNorm and the quantization are K11's (int8.cuh:
// ln_quant_tile), in the plain version's roundings; d 256 or 512, D 128.
#include "ln_qkv_rope_sm90.cuh"

extern "C" int herro_ln_qkv_rope_q(const void* x, const float* ln_s, const float* ln_b,
                                   const void* wt, const float* s_col, const void* b,
                                   void* q, void* k, void* v, int B, int L, int d, int H,
                                   void* stream) {
  using namespace herro::qkv;
  return launch_widths<kInt8>(x, ln_s, ln_b, wt, b, nullptr, nullptr, s_col, q, k, v, B, L,
                              d, H, stream);
}
