// Shared device helpers for the int8 kernels: the quantization steps (K10
// ln_qkv_rope_q and K11 ln_ffn_q), and K10's LayerNorm and mma.sync product.
//
// The int8 path of herro_tpu/ops/fused.py quantizes activations per row and
// weights per output column, multiplies int8 x int8 into int32 and
// dequantizes in float32:
//   s_row = max(max|y| / 127, 1e-12);  y_i8 = clip(rint(y / s_row), -127, 127)
//   out   = (float(acc) * s_row) * s_col + bias
// Every step is written with its own rounding (true division, round half to
// even, no fused multiply-add across the dequantization), so that the int32
// product is bit-equal to the plain version's and only LayerNorm and gelu can
// differ in their last bit.
//
// K10's products run on the tensor cores with mma.sync m16n8k32 s8 x s8 -> s32
// (K11 runs wgmma, sm90.cuh).
// That mma wants operand B with k contiguous, and ldmatrix transposes
// 16-bit elements only, so the int8 weights arrive k-major ([out, in], the
// transpose of the reference's [in, out]) and both operands load by plain
// ldmatrix: an 8 x 16-byte ldmatrix tile is 8 rows of 16 int8 along k, which
// is exactly one register of four k values per thread.
// Fragment layouts (g = lane / 4, t = lane % 4):
//   A 16x32: a0 = (g, 4t..4t+3), a1 = (g+8, 4t..), a2 = (g, 16+4t..), a3 = (g+8, 16+4t..)
//   B 32x8:  b0 = (k 4t..4t+3, n g), b1 = (k 16+4t.., n g)
//   C 16x8 (s32): c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
#pragma once

#include "common.cuh"

namespace herro {

constexpr int kQChunkK = 64;             // k bytes of a weight row staged per step
constexpr int kQLd = kQChunkK + 16;      // staged row stride (bytes): conflict-free ldmatrix
constexpr size_t kQStageBytes = 2 * (size_t)kChunkN * kQLd;  // double buffer
constexpr int kQPad = 16;                // activation row padding (bytes), same reason

// c += a @ b, int8 operands, int32 accumulators
__device__ inline void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm (as common.cuh:layernorm_rows, the result rounded to bf16) then
// per-row symmetric int8: rows [row0, row0 + n_rows) of x [T, d] go to shared
// memory yq [n_rows][ldq] with their scales in s_row. Rows at or past T are
// zero-filled with scale 0. One warp per row; a row is read three times
// (statistics, maximum, values), the later passes from L1.
__device__ inline void ln_quant_rows(const bf16* __restrict__ x,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias, long row0, int n_rows,
                                     long T, int d, int8_t* yq, int ldq, float* s_row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < n_rows; r += n_warps) {
    const long row = row0 + r;
    int8_t* yr = yq + (size_t)r * ldq;
    if (row >= T) {
      for (int c = lane; c < d; c += 32) yr[c] = 0;
      if (lane == 0) s_row[r] = 0.f;
      continue;
    }
    const bf16* xr = x + (size_t)row * d;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = __bfloat162float(xr[c]);
      s += v;
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / (float)d;
    const float var = fmaxf(ss / (float)d - mu * mu, 0.f);
    const float rs = 1.f / sqrtf(var + 1e-6f);
    auto value = [&](int c) {
      return bf16_round((__bfloat162float(xr[c]) - mu) * rs * scale[c] + bias[c]);
    };
    float m = 0.f;
    for (int c = lane; c < d; c += 32) m = fmaxf(m, fabsf(value(c)));
    const float sq = quant_scale(warp_max(m));
    for (int c = lane; c < d; c += 32) yr[c] = (int8_t)quant(value(c), sq);
    if (lane == 0) s_row[r] = sq;
  }
}

// One block pass of a warp-tiled int8 product on the tensor cores:
//   acc[NT][4] += A[a_row0 .. a_row0+15, 0..K) @ Bt[n0 + warp_n*NT*8 .., 0..K)^T
// A is row-major int8 in shared memory (row stride lda bytes, a multiple of
// 16); Bt is the k-major weight [N, K] in global memory, its [kChunkN rows,
// kQChunkK bytes] chunks staged through the double buffer `stage` by cp.async
// (every thread of the block takes part, so every thread must call this).
// K is a multiple of kQChunkK.
template <int NT>
__device__ inline void block_gemm_q(int (&acc)[NT][4], const int8_t* A, int lda, int a_row0,
                                    const int8_t* __restrict__ Bt, int n0, int K,
                                    int8_t* stage, int warp_n) {
  const int lane = threadIdx.x & 31;
  auto load_chunk = [&](int kc, int buf) {
    int8_t* dst = stage + (size_t)buf * kChunkN * kQLd;
    for (int e = threadIdx.x; e < kChunkN * (kQChunkK / 16); e += blockDim.x) {
      const int r = e / (kQChunkK / 16), c = (e % (kQChunkK / 16)) * 16;
      cp_async16(dst + r * kQLd + c, Bt + (size_t)(n0 + r) * K + kc * kQChunkK + c, true);
    }
  };
  const int nk = K / kQChunkK;
  load_chunk(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) load_chunk(kc + 1, (kc + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* Bs = stage + (size_t)(kc & 1) * kChunkN * kQLd + warp_n * NT * 8 * kQLd;
#pragma unroll
    for (int ks = 0; ks < kQChunkK / 32; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, A + (size_t)(a_row0 + (lane & 15)) * lda + kc * kQChunkK + ks * 32 +
                     (lane >> 4) * 16);
#pragma unroll
      for (int nn = 0; nn < NT; nn += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, Bs + (nn * 8 + (lane & 7) + ((lane >> 4) << 3)) * kQLd + ks * 32 +
                        ((lane >> 3) & 1) * 16);
        mma_s8(acc[nn], a, bb[0], bb[1]);
        mma_s8(acc[nn + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }
}

template <int NT>
__device__ inline void zero(int (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
}

}  // namespace herro
