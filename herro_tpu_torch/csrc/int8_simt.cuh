// Shared pieces of the SIMT int8 kernels (ln_qkv_rope_q_simt: K10,
// ln_ffn_q_simt: K11): float32 or bf16 activations at any width the float32
// kernels take (d a multiple of 32 up to 512, d_ff a multiple of 32 up to
// 2048, head dims 16-128), where the Hopper int8 instances (int8 wgmma, bf16
// only, d 256 or 512) do not reach.
//
// Both products run on the tensor cores: mma.sync m16n8k32, s8 x s8 -> s32
// (mma.cuh mma_s8). Integer sums are exact in any order, so the int32
// product is the plain version's bit for bit; the quantization, the
// dequantization and their roundings are int8.cuh's (quant_scale, quant,
// dequant). Only the order of LayerNorm's two sums (f32.cuh's: a lane's
// strided sums, then a butterfly; layernorm_rows_i8) and tanhf can move a
// value by one int8 step against the plain version.
//
// Bound: 2 T K N int8 operations a product at the int8 peak (1979e12/s), or
// the kernel's bytes, whichever is longer.
//
// Design. A block of 8 warps takes 128 token rows (kBM); a warp 32 rows x
// BN/2 columns of a 128 x BN output tile (BN 128, or 64 where the product is
// at most 64 wide): a 4 x 2 grid of warps. A warp's columns lie in spans of
// S, 2S apart (by default S = BN/2, one contiguous block; K10 at head dim
// 128 takes S 32, so that a warp holds both halves of each head, 64 apart,
// for its rope: span_col).
// Operands lie row-major with k contiguous, A by token rows and W k-major
// ([N, K]: k_major() of the plain version's [K, N]), exactly mma's .row.col;
// fragments come by ldmatrix of 16-byte rows (A: rows 0-7 / 8-15 at k 0-15 /
// 16-31; W: columns 0-7 / 8-15 the same way), every shared row padded by 16
// bytes so that those reads are free of bank conflicts. k in stages of kKB =
// 64 (two mma k-steps a barrier); W's stages stream through a ring of
// kTCStages shared buffers by cp.async (16 bytes a thread), columns past N
// and k past K zero-filled, so a product needs K only a multiple of 32.
// product_resident keeps A (the int8 LayerNorm rows, written row-major by
// layernorm_rows_i8) resident for the whole walk over N and hands each
// column tile's C fragments to the kernel's epilogue; ln_ffn_q_simt.cu's
// output pass stages A itself.
#pragma once

#include "f32.cuh"
#include "int8.cuh"
#include "mma.cuh"

namespace herro {
namespace simt8 {

using f32::kBM;
using f32::kThreads;

// an activation value of type E as float, a float rounded to E as the plain
// version's .to(x.dtype) rounds it, four values of E loaded, two stored
// (f32.cuh's, shared with the float32 and bf16 SIMT kernels)
using f32::load4;
using f32::round_to;
using f32::store2;
using f32::to_f;

// two values of E (8 bytes or 4, aligned) as floats
__device__ inline float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ inline float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

// LayerNorm of rows r0 .. r0 + kBM - 1 of x [rows, d] (float32 statistics
// in gemm_tc.cuh:row_stats' order, the normalisation and affine each rounded on
// its own, the result rounded to E as fused.py:layernorm does), quantized
// per row (the largest magnitude of the rounded row, then quant) into the
// product's row-major A: row r's int8 word w (k 4w .. 4w + 3) at As[r * as
// + 4w], its scale in srow[r]. A warp a row, two reads of it: the first
// (the values k = lane + 32i, for the sums) of the warp's next row is
// loaded while it works on this one. Rows at or past `rows` are zeros with
// scale 0.
template <typename E>
__device__ inline void layernorm_rows_i8(const E* __restrict__ x, long rows, int d, long r0,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, uint8_t* As, int as,
                                         float* srow) {
  constexpr int kCols = 512 / 32;  // values a lane holds of a row (d <= 512)
  constexpr int kStep = kThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, words = d / 4;
  auto load = [&](long row, float (&v)[kCols]) {
    const E* xr = x + row * d;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (32 * i < d) v[i] = to_f(xr[lane + 32 * i]);
  };
  float next[kCols];
  if (r0 + warp < rows) load(r0 + warp, next);
  for (int r = warp; r < kBM; r += kStep) {
    const long row = r0 + r;
    uint32_t* ar = reinterpret_cast<uint32_t*>(As + r * as);
    if (row >= rows) {
      for (int w = lane; w < words; w += 32) ar[w] = 0u;
      if (lane == 0) srow[r] = 0.f;
      continue;
    }
    float v[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) v[i] = next[i];
    if (r + kStep < kBM && row + kStep < rows) load(row + kStep, next);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      if (32 * i >= d) break;
      s = __fadd_rn(s, v[i]);
      s2 = __fadd_rn(s2, __fmul_rn(v[i], v[i]));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {  // every lane ends with the same bits
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    const float mu = __fdiv_rn(s, (float)d);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, (float)d), __fmul_rn(mu, mu)), 0.f);
    const float rs = rsqrtf(__fadd_rn(var, 1e-6f));
    const E* xr = x + row * d;
    float y[4][4] = {};
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = lane + 32 * i;
      if (w >= words) continue;
      float xv[4];
      load4(xr + 4 * w, xv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[i][e] = round_to<E>(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(xv[e], mu), rs), scale[4 * w + e]), bias[4 * w + e]));
        m = fmaxf(m, fabsf(y[i][e]));
      }
    }
    const float sq = quant_scale(warp_max(m));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = lane + 32 * i;
      if (w < words)
        ar[w] = pack_s8(quant(y[i][0], sq), quant(y[i][1], sq), quant(y[i][2], sq),
                        quant(y[i][3], sq));
    }
    if (lane == 0) srow[r] = sq;
  }
}

constexpr int kKB = 64;         // k (bytes) a stage: two m16n8k32 steps
constexpr int kSS = kKB + 16;   // byte stride of a staged row (ldmatrix free of conflicts)
constexpr int kTCStages = 4;    // the ring of W's stages
constexpr int kWarpRows = 32;   // a warp's token rows (a 4 x 2 grid of warps)

// a warp's C fragments: acc[mt][nt] of its rows 16 mt + (g, g + 8) and
// columns span_col(nt) + (2t, 2t + 1) of its BN/2
template <int BN>
using AccI = int[2][BN / 16][4];

// bytes of one W stage of a BN-column tile
template <int BN>
__host__ __device__ constexpr int w_stage_bytes() {
  return BN * kSS;
}

// the byte stride of the resident A at width d: whole stages of k, and 16
// bytes of pad (k past d is read only against W's zero-filled k)
__host__ __device__ constexpr int a_stride(int d) { return (d + kKB - 1) / kKB * kKB + 16; }

// the tile's row of a warp's first row, and of the columns its first
__device__ inline int tc_warp_row() { return threadIdx.x / 32 / 2 * kWarpRows; }
template <int BN>
__device__ inline int tc_warp_col() {
  return threadIdx.x / 32 % 2 * (BN / 2);
}

// where a warp's fragment nt (8 columns) starts among its columns when they
// lie in spans of S, 2S apart, the second warp column's first span S after
// the first's (at threadIdx.x / 32 % 2 * S): 8 nt at S = BN/2
template <int S>
__host__ __device__ constexpr int span_col(int nt) {
  static_assert(S % 16 == 0, "spans of whole fragment pairs");
  return 8 * nt % S + 8 * nt / S * 2 * S;
}

// a thread's cp.async copies of one W stage: rows n0 .. n0 + BN - 1 of wt
// [N, K] at k0 .. k0 + kKB - 1 into st (BN rows of kSS bytes); rows past N
// and k past K zero-filled
template <int BN>
__device__ inline void copy_w(const int8_t* __restrict__ wt, int K, int N, int n0, int k0,
                              uint8_t* st) {
  for (int e = threadIdx.x; e < BN * (kKB / 16); e += kThreads) {
    const int r = e / (kKB / 16), c = (e % (kKB / 16)) * 16;
    const bool ok = n0 + r < N && k0 + c < K;
    cp_async16(st + r * kSS + c, ok ? wt + (long)(n0 + r) * K + k0 + c : wt, ok);
  }
}

// acc += the stage's kKB k of A (a: the warp's first row at the stage's
// first k, rows `as` bytes apart) times W's stage ws (BN rows of kSS), the
// warp's columns in spans of S
template <int BN, int S = BN / 2>
__device__ inline void stage_mma(AccI<BN>& acc, const uint8_t* a, int as, const uint8_t* ws) {
  static_assert((BN / 2) % S == 0, "spans that tile a warp's columns");
  const int lane = threadIdx.x % 32, wc = threadIdx.x / 32 % 2 * S;
#pragma unroll
  for (int ks = 0; ks < kKB / 32; ++ks) {
    // A's matrices: rows 0-7 / 8-15 (lanes 8-15, 24-31) at k 0-15 / 16-31
    // (lanes 16-31): a0..a3 as m16n8k32 wants them
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(af[mt], a + (16 * mt + (lane & 15)) * as + 32 * ks + (lane >> 4) * 16);
#pragma unroll
    for (int np = 0; np < BN / 32; ++np) {
      // W's matrices: columns 0-7 at k 0-15 / 16-31 (lanes 8-15), then
      // columns 8-15 (lanes 16-31): b0, b1 of two 8-column fragments
      uint32_t b[4];
      ldsm_x4(b, ws + (wc + span_col<S>(2 * np) + (lane & 7) + (lane >> 4) * 8) * kSS +
                     32 * ks + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_s8(acc[mt][2 * np], af[mt], b[0], b[1]);
        mma_s8(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
      }
    }
  }
}

template <int BN>
__device__ inline void zero_acc(AccI<BN>& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
}

// A @ W over all K for every column tile n0 = 0, BN, ... of N, with A the
// tile's kBM int8 rows resident in As (K bytes each, `as` apart): calls
// epi(n0, acc) after each column tile's last stage, a warp's columns in
// spans of S. W's stages (wt [N, K] int8) stream through the kTCStages
// buffers of `ring`, the next kTCStages - 1 in flight while one is
// multiplied, running on from one column tile into the next; one barrier a
// stage. Ends with every copy landed and on a barrier.
template <int BN, int S = BN / 2, typename Epi>
__device__ inline void product_resident(const uint8_t* As, int as, const int8_t* __restrict__ wt,
                                        int K, int N, uint8_t* ring, Epi&& epi) {
  constexpr int kStage = w_stage_bytes<BN>();
  const uint8_t* a = As + tc_warp_row() * as;
  auto advance = [&](int& n0, int& k0) {
    k0 += kKB;
    if (k0 >= K) k0 = 0, n0 += BN;
  };
  int ln0 = 0, lk0 = 0;  // the next stage to copy
#pragma unroll
  for (int i = 0; i < kTCStages - 1; ++i) {
    if (ln0 < N) copy_w<BN>(wt, K, N, ln0, lk0, ring + i * kStage);
    cp_async_commit();
    advance(ln0, lk0);
  }
  AccI<BN> acc;
  zero_acc<BN>(acc);
  for (int n0 = 0, k0 = 0, s = 0; n0 < N; s = s + 1 == kTCStages ? 0 : s + 1) {
    // this stage is in, and every warp is done with the stage before, whose
    // buffer takes the next copies
    cp_async_wait<kTCStages - 2>();
    __syncthreads();
    if (ln0 < N) copy_w<BN>(wt, K, N, ln0, lk0, ring + (s == 0 ? kTCStages - 1 : s - 1) * kStage);
    cp_async_commit();  // empty past the last stage: the count of groups holds
    advance(ln0, lk0);
    stage_mma<BN, S>(acc, a + k0, as, ring + s * kStage);
    if (k0 + kKB >= K) {  // the column tile's last stage
      epi(n0, acc);
      zero_acc<BN>(acc);
    }
    advance(n0, k0);
  }
  cp_async_wait_all();
  __syncthreads();
}

}  // namespace simt8
}  // namespace herro
