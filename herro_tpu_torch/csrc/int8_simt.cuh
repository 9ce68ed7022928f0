// Shared pieces of the SIMT int8 kernels (ln_qkv_rope_q_simt: K10,
// ln_ffn_q_simt: K11): float32 or bf16 activations at any width the float32
// kernels take (d a multiple of 32 up to 512, d_ff a multiple of 32 up to
// 2048, head dims 16-128), where the Hopper int8 instances (int8 wgmma, bf16
// only, d 256 or 512) do not reach.
//
// The products are __dp4a: four int8 x int8 pairs summed into an int32 a
// lane, on the CUDA cores. Integer sums are exact in any order, so the int32
// product equals the plain version's bit for bit; the quantization, the
// dequantization and their roundings are int8.cuh's (quant_scale, quant,
// dequant). Only the order of LayerNorm's two sums (f32.cuh's: a lane's
// strided sums, then a butterfly) and tanhf can move a value by one int8
// step against the plain version.
//
// The tile product keeps f32.cuh's layout: a block of 256 threads computes
// an output tile of 128 rows x BN (64 or 128) columns, 8 x BN/16 outputs a
// thread at f32.cuh's tile_row/tile_col, k in stages of 32 (8 int32 words)
// through two shared buffers, the next stage's global loads in registers
// while the current one is multiplied. Operands sit in shared memory as
// int32 words of four consecutive k, k-major: word w of row r of A at
// As[w * kApad + r], of column n of W at Bs[w * (BN + 4) + n], so a thread
// reads the words of its four rows (or columns) as one int4. The weights
// arrive k-major ([N, K], K contiguous: k_major() of the plain version's
// [K, N]), so a word of W is four bytes as they lie in memory.
#pragma once

#include "f32.cuh"
#include "int8.cuh"

namespace herro {
namespace simt8 {

using f32::kBM;
using f32::kThreads;
using f32::tile_col;
using f32::tile_row;

constexpr int kBK4 = 8;         // int32 words of k per stage (32 int8)
constexpr int kApad = kBM + 4;  // word stride of A's k-rows (int4 reads, fewer conflicts)

__host__ __device__ constexpr int b_stage_words(int BN) { return kBK4 * (BN + 4); }

// an activation value of type E as float, a float rounded to E as the plain
// version's .to(x.dtype) rounds it, four values of E loaded or stored
// (f32.cuh's, shared with the float32 and bf16 SIMT kernels)
using f32::load4;
using f32::round_to;
using f32::store4;
using f32::to_f;

// LayerNorm of rows r0 .. r0 + kBM - 1 of x [rows, d] (float32 statistics
// in f32.cuh:ln_stats' order, the normalisation and affine each rounded on
// its own, the result rounded to E as fused.py:layernorm does), quantized
// per row (the largest magnitude of the rounded row, then quant) into As,
// each row's scale in srow. A warp a row; a lane holds the words lane + 32i
// (d <= 512: i < 4). Rows at or past `rows` are zeros with scale 0.
template <typename E>
__device__ inline void ln_quant_rows(const E* __restrict__ x, long rows, int d, long r0,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias, int* As, float* srow) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, words = d / 4;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const long row = r0 + r;
    if (row >= rows) {
      for (int w = lane; w < words; w += 32) As[w * kApad + r] = 0;
      if (lane == 0) srow[r] = 0.f;
      continue;
    }
    const E* xr = x + row * d;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = to_f(xr[c]);
      s = __fadd_rn(s, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {  // every lane ends with the same bits
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    const float mu = __fdiv_rn(s, (float)d);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, (float)d), __fmul_rn(mu, mu)), 0.f);
    const float rs = rsqrtf(__fadd_rn(var, 1e-6f));
    float y[4][4] = {};
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = lane + 32 * i;
      if (w >= words) continue;
      float v[4];
      load4(xr + 4 * w, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[i][e] = round_to<E>(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[e], mu), rs), scale[4 * w + e]), bias[4 * w + e]));
        m = fmaxf(m, fabsf(y[i][e]));
      }
    }
    const float sq = quant_scale(warp_max(m));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = lane + 32 * i;
      if (w < words)
        As[w * kApad + r] = (int)pack_s8(quant(y[i][0], sq), quant(y[i][1], sq),
                                         quant(y[i][2], sq), quant(y[i][3], sq));
    }
    if (lane == 0) srow[r] = sq;
  }
}

// A thread's share of one stage of W (k-major, wt [N, K] int8): column
// n0 + e / 2 of the tile, words 4 (e % 2) .. + 3 of the stage, for
// e = threadIdx.x < 2 BN; columns at or past N read 0.
template <int BN>
__device__ inline int4 load_w(const int8_t* __restrict__ wt, int K, int N, int n0, int k4) {
  const int e = threadIdx.x, n = n0 + e / 2;
  if (e >= 2 * BN || n >= N) return make_int4(0, 0, 0, 0);
  return *reinterpret_cast<const int4*>(wt + (long)n * K + 4 * (k4 + 4 * (e % 2)));
}

template <int BN>
__device__ inline void store_w(int* Bs, int4 v) {
  const int e = threadIdx.x, c = e / 2, w = 4 * (e % 2);
  if (e >= 2 * BN) return;
  Bs[(w + 0) * (BN + 4) + c] = v.x;
  Bs[(w + 1) * (BN + 4) + c] = v.y;
  Bs[(w + 2) * (BN + 4) + c] = v.z;
  Bs[(w + 3) * (BN + 4) + c] = v.w;
}

// acc[i][j] += sum over the stage's 32 k of A[tile_row(ty, i), k] *
// W[k, tile_col(tx, j)]: As the stage's first k-row of A, Bs its W
template <int BN>
__device__ inline void stage_dp4a(int (&acc)[8][BN / 16], const int* As, const int* Bs) {
  constexpr int G = BN / 64;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int kk = 0; kk < kBK4; ++kk) {
    int av[8], bv[4 * G];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int4 a = *reinterpret_cast<const int4*>(As + kk * kApad + 64 * g + 4 * ty);
      av[4 * g] = a.x, av[4 * g + 1] = a.y, av[4 * g + 2] = a.z, av[4 * g + 3] = a.w;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int4 b = *reinterpret_cast<const int4*>(Bs + kk * (BN + 4) + 64 * g + 4 * tx);
      bv[4 * g] = b.x, bv[4 * g + 1] = b.y, bv[4 * g + 2] = b.z, bv[4 * g + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * G; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
}

// acc = A @ W over all K for the tile's columns n0 .. n0 + BN - 1, with A
// the tile's K/4 words a row, resident in As (ln_quant_rows); W's stages
// through the two buffers of Bs. Ends on a barrier, so Bs may be refilled.
template <int BN>
__device__ inline void product_resident_a(int (&acc)[8][BN / 16], const int* As,
                                          const int8_t* __restrict__ wt, int K, int N, int n0,
                                          int* Bs) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0;
  int4 rb = load_w<BN>(wt, K, N, n0, 0);
  store_w<BN>(Bs, rb);
  __syncthreads();
  for (int k4 = 0, s = 0; k4 < K / 4; k4 += kBK4, s ^= 1) {
    const bool next = k4 + kBK4 < K / 4;
    if (next) rb = load_w<BN>(wt, K, N, n0, k4 + kBK4);
    stage_dp4a<BN>(acc, As + k4 * kApad, Bs + s * b_stage_words(BN));
    if (next) store_w<BN>(Bs + (s ^ 1) * b_stage_words(BN), rb);
    __syncthreads();
  }
}

// dynamic shared memory of a kernel whose A (d/4 words a row) stays resident,
// with the two W stages and `vectors` floats of per-row values
inline size_t resident_smem(int d, int BN, int vectors) {
  return ((size_t)(d / 4) * kApad + 2 * b_stage_words(BN) + (size_t)vectors * kBM) * 4;
}

}  // namespace simt8
}  // namespace herro
