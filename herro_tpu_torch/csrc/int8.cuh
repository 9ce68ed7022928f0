// Shared device helpers for the int8 kernels (K10 ln_qkv_rope_q, K11
// ln_ffn_q): the quantization steps, and LayerNorm with the per-row
// quantization on a TMA-loaded tile.
//
// The int8 path of herro_tpu/ops/fused.py quantizes activations per row and
// weights per output column, multiplies int8 x int8 into int32 and
// dequantizes in float32:
//   s_row = max(max|y| / 127, 1e-12);  y_i8 = clip(rint(y / s_row), -127, 127)
//   out   = (float(acc) * s_row) * s_col + bias
// Every step is written with its own rounding (true division, round half to
// even, no fused multiply-add across the dequantization), so that the int32
// product is bit-equal to the plain version's and only LayerNorm's summation
// order and gelu can differ in their last bit. The products run on int8
// wgmma (sm90.cuh), both operands K-major.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace herro {

// the per-row scale of a row whose largest magnitude is absmax
__device__ inline float quant_scale(float absmax) {
  return fmaxf(__fdiv_rn(absmax, 127.f), 1e-12f);
}

// clip(rint(y / s), -127, 127): a true division, round half to even
__device__ inline int quant(float y, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(y, s))));
}

// (float(acc) * s_row) * s_col + bias, each step rounded on its own
__device__ inline float dequant(int acc, float s_row, float s_col, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col), bias);
}

// gelu_tanh as PyTorch's CUDA kernel computes it in float32 (the plain
// version's F.gelu on the card): the cube (exact for a bf16 input), one
// fused multiply-add, tanhf. K11's, both instances.
__device__ inline float gelu_tanh(float v) {
  const float cube = __fmul_rn(__fmul_rn(v, v), v);
  const float inner = __fmul_rn(0.7978845608028654f, __fmaf_rn(0.044715f, cube, v));
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, tanhf(inner)));
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// four int8 values, the first in the lowest byte
__device__ inline uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 | (uint32_t)(c & 0xff) << 16 |
         (uint32_t)(d & 0xff) << 24;
}

// LayerNorm (flax semantics, fused.py:layernorm) of the BM-row x tile that
// TMA left in `xt` (D/64 128-byte-swizzled bf16 blocks of [BM][64]), rounded
// to bf16, then quantized per row into `yq` (D/128 swizzled int8 blocks of
// [BM][128], the layout of int8 wgmma's A operand), each row's scale in
// srow. The 8 consumer warps take BM/8 rows each; a lane holds D/256
// 16-byte chunks (8 values) of its row. Rows past the tensor's edge arrived
// as zeros and are never stored.
// Every rounding follows the plain version as it runs on the card
// (fused.py:layernorm, _quant_rows): the variance, the normalisation and the
// affine in separate roundings and rsqrtf, as torch.rsqrt; true divisions
// in the quantization. Only the order of LayerNorm's two sums differs.
// yq may be xt (in place, K10): int8 row r lands only on bf16 row r of the
// lower blocks, and a warp has read all of its row (its warp_max depends on
// every lane's values) before any lane writes it.
template <int D, int BM>
__device__ inline void ln_quant_tile(const float* __restrict__ scale,
                                     const float* __restrict__ bias, const unsigned char* xt,
                                     unsigned char* yq, float* srow) {
  using sm90::swizzle128;
  constexpr int kCh = D / 256;
  constexpr int kBlock = BM * 128;
  constexpr int kRows = BM / 8;  // rows a warp takes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sc[kCh][8], bi[kCh][8];
#pragma unroll
  for (int i = 0; i < kCh; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[i][e] = scale[(lane + 32 * i) * 8 + e];
      bi[i][e] = bias[(lane + 32 * i) * 8 + e];
    }
#pragma unroll 2  // two rows in flight: a row alone waits on its shuffles
  for (int r = warp * kRows; r < warp * kRows + kRows; ++r) {
    float v[kCh][8];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      const int ch = lane + 32 * i;
      const uint4 xv =
          *reinterpret_cast<const uint4*>(xt + (ch >> 3) * kBlock + swizzle128(r, ch & 7));
      const bf162* p = reinterpret_cast<const bf162*>(&xv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = __bfloat1622float2(p[e]);
        v[i][2 * e] = f2.x;
        v[i][2 * e + 1] = f2.y;
        s += f2.x + f2.y;
        ss += f2.x * f2.x + f2.y * f2.y;  // squares of bf16 values are exact
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    // as the plain version: mean(x^2) - mu^2 clamped, + eps, torch.rsqrt
    const float mu = __fdiv_rn(s, (float)D);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, (float)D), __fmul_rn(mu, mu)), 0.f);
    const float rs = rsqrtf(__fadd_rn(var, 1e-6f));
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kCh; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = bf16_round(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[i][e], mu), rs), sc[i][e]), bi[i][e]));
        m = fmaxf(m, fabsf(v[i][e]));
      }
    const float sq = quant_scale(warp_max(m));
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      const int ch = lane + 32 * i;
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[h] = pack_s8(quant(v[i][4 * h], sq), quant(v[i][4 * h + 1], sq),
                       quant(v[i][4 * h + 2], sq), quant(v[i][4 * h + 3], sq));
      *reinterpret_cast<uint2*>(yq + (ch >> 4) * kBlock + swizzle128(r, (ch & 15) >> 1) +
                                (ch & 1) * 8) = make_uint2(w[0], w[1]);
    }
    if (lane == 0) srow[r] = sq;
  }
}

}  // namespace herro
