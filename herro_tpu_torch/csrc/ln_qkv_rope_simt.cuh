// K1 and K8 on the CUDA cores: LayerNorm + qkv projection + rope, for
// float32 configs and for bf16 at head dims or widths the Hopper instances
// (ln_qkv_rope_sm90.cuh: D 128, d 256, 384 or 512) lack. Entry points:
// ln_qkv_rope_f32.cu (float32), ln_qkv_rope_bf16.cu (bf16), each with the
// table route (K1) and the split route (K8).
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_tbl_kernel (K1, rope tables
// handed in) and _ln_qkv_rope_kernel (K8, tables built in the kernel,
// HERRO_TPU_ROPE=split) for any head dim D in {16, 32, 64, 128}:
//   qkv = E(E(LN(x)) @ W + b)   (x [B, L, d], W [d, 3HD] in (3, H, D) c-major order)
//   q, k: E(rotate-half rope at the absolute column l); v as it is
// -> q, k, v [B, H, L, D] of the storage type E (float: every E() the identity).
//
// Bound on the H100: operations, 2 T d 3HD FFMA-operations against 67
// TFLOP/s (at r10's widths, 4.6e11: 6.9 ms at B=32, L=9216), far above the
// bytes.
// Design: the SIMT tile product of f32.cuh: a block of 256 threads a tile
// of 128 token rows x 128 columns of qkv (one head at D 128; whole heads
// below, as D divides 128; 64 columns where qkv has no more), 8 x 8 outputs
// a thread in two column groups of 4, 64 apart. The block takes its rows'
// LayerNorm statistics first (a warp a row), normalises each A stage as it
// stages it, adds the bias (rounding qkv to E), and each output takes its
// rope partner (column dd +- D/2 of its head) from the thread's other group
// at D 128 or by a shuffle D/8 lanes away below; the rope's two products
// and one sum are rounded as the plain version rounds them, and a thread
// stores 4 columns of a head row at once. The split route builds cos/sin of
// (l, i) with the full-range expf/cosf/sinf of the plain version's
// rope_tables (freq_i = exp(-ln(10000) i / (D/2)), D/2 a power of two, so
// the division is exact either way), so both routes give the same bits.
#pragma once

#include "f32.cuh"

namespace herro {
namespace qkv_simt {

using namespace f32;

template <typename E, bool kTables, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    ln_qkv_rope_kernel(const E* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const E* __restrict__ w,
                       const E* __restrict__ b, const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t, E* __restrict__ q, E* __restrict__ k,
                       E* __restrict__ v, int B, int L, int d, int H, int D) {
  __shared__ __align__(16) float smem[2 * stage_floats<BN>()];
  __shared__ float mu[kBM], rstd[kBM];
  const long T = (long)B * L;
  const int N = 3 * H * D, HD = H * D, half = D / 2;
  const long r0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  ln_stats(x, T, d, r0, mu, rstd);
  __syncthreads();
  float acc[8][BN / 16];
  gemm_mainloop<E, BN, true>(acc, x, T, d, w, N, r0, n0, smem, mu, rstd, scale, bias);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // + bias, rounded to E; then each value's rope partner (column dd +- D/2 of its head):
  // at D 128 the thread's other column group (a tile is one head), below it
  // the thread D/8 lanes away in the same group (4 columns a thread)
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const int n = n0 + tile_col(tx, j);
    const float bj = n < N ? to_f(b[n]) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = round_to<E>(__fadd_rn(acc[i][j], bj));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = r0 + tile_row(ty, i);
    const long bb = row / L;
    const int l = (int)(row % L);
    // cos/sin of the thread's 4 frequencies at column l: its second column
    // group (64 further, and D divides 64 or is 128) has the same ones
    float cs[4], sn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = (n0 + tile_col(tx, e)) % D % half;
      if (kTables) {
        cs[e] = cos_t[(long)l * half + ri];
        sn[e] = sin_t[(long)l * half + ri];
      } else {
        const float freq =
            expf(__fdiv_rn(__fmul_rn(-9.210340371976184f, (float)ri), (float)half));
        const float ang = __fmul_rn((float)l, freq);
        cs[e] = cosf(ang);
        sn[e] = sinf(ang);
      }
    }
#pragma unroll
    for (int g = 0; g < BN / 64; ++g) {
      float val[4], other[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // every lane takes part in the shuffle
        val[e] = acc[i][4 * g + e];
        other[e] = D == 128 ? acc[i][(4 * (g ^ 1) + e) % (BN / 16)]
                            : __shfl_xor_sync(0xffffffffu, val[e], D / 8);
      }
      const int n = n0 + tile_col(tx, 4 * g);
      if (row >= T || n >= N) continue;  // four columns of one head, in or out together
      const int which = n / HD, h = (n % HD) / D, dd0 = n % D;
      if (which < 2) {
        // x1 * cos - x2 * sin for the first half, x2 * cos + x1 * sin for the second
#pragma unroll
        for (int e = 0; e < 4; ++e)
          val[e] = round_to<E>(
              dd0 + e < half
                  ? __fsub_rn(__fmul_rn(val[e], cs[e]), __fmul_rn(other[e], sn[e]))
                  : __fadd_rn(__fmul_rn(val[e], cs[e]), __fmul_rn(other[e], sn[e])));
      }
      E* out = which == 0 ? q : which == 1 ? k : v;
      store4(out + ((bb * H + h) * L + l) * D + dd0, val);
    }
  }
}

template <typename E, bool kTables>
int launch(const E* x, const float* scale, const float* bias, const E* w, const E* b,
           const float* cos_t, const float* sin_t, E* q, E* k, E* v, int B, int L, int d, int H,
           int D, cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || !d_model_ok(d) || !head_dim_ok(D))
    return (int)cudaErrorInvalidValue;
  const long T = (long)B * L;
  const int N = 3 * H * D;
  if (tile_width(N) == 64)  // D <= 32: whole heads in a tile of 64
    ln_qkv_rope_kernel<E, kTables, 64><<<gemm_grid(T, N, 64), kThreads, 0, stream>>>(
        x, scale, bias, w, b, cos_t, sin_t, q, k, v, B, L, d, H, D);
  else
    ln_qkv_rope_kernel<E, kTables, 128><<<gemm_grid(T, N, 128), kThreads, 0, stream>>>(
        x, scale, bias, w, b, cos_t, sin_t, q, k, v, B, L, d, H, D);
  return (int)cudaGetLastError();
}

}  // namespace qkv_simt
}  // namespace herro
