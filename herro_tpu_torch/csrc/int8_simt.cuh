// Shared pieces of the SIMT int8 kernels (ln_qkv_rope_q_simt: K10,
// ln_ffn_q_simt: K11): float32 or bf16 activations at any width the float32
// kernels take (d a multiple of 32 up to 512, d_ff a multiple of 32 up to
// 2048, head dims 16-128), where the Hopper int8 instances (int8 wgmma, bf16
// only, d 256 or 512) do not reach.
//
// Integer sums are exact in any order, so either product below gives the
// plain version's int32 bit for bit; the quantization, the dequantization
// and their roundings are int8.cuh's (quant_scale, quant, dequant). Only the
// order of LayerNorm's two sums (f32.cuh's: a lane's strided sums, then a
// butterfly; ln_quant_rows and ln_quant_rows_major take them alike) and
// tanhf can move a value by one int8 step against the plain version.
//
// K11's product is on the tensor cores: mma.sync m16n8k32, s8 x s8 -> s32
// (mma.cuh mma_s8), bound by 4 T d f operations at the int8 peak (1979e12/s)
// or its bytes. A block of 8 warps takes 128 token rows (kBM), a warp 32 rows
// x BN/2 columns (a 4 x 2 grid over a 128 x BN tile, BN 128, or 64 where the
// product is at most 64 wide). Operands lie row-major with k contiguous, A
// by token rows and W k-major ([N, K]: k_major() of the plain version's [K,
// N]), exactly mma's .row.col; fragments come by ldmatrix of 16-byte rows
// (A: rows 0-7 / 8-15 at k 0-15 / 16-31; W: columns 0-7 / 8-15 the same
// way), every shared row padded by 16 bytes so that those reads are free of
// bank conflicts. k in stages of kKB = 64 (two mma k-steps a barrier); W's
// stages stream through a ring of kTCStages shared buffers by cp.async (16
// bytes a thread), columns past N and k past K zero-filled, so a product
// needs K only a multiple of 32. product_resident_a_tc keeps A (the int8
// LayerNorm rows, written row-major by ln_quant_rows_major) resident for
// the whole walk over N; ln_ffn_q_simt.cu's output pass stages A itself.
//
// K10's product stays __dp4a, four int8 x int8 pairs summed into an int32 a
// lane on the CUDA cores, in f32.cuh's tile layout: a block of 256 threads
// computes an output tile of 128 rows x BN (64 or 128) columns, 8 x BN/16
// outputs a thread at f32.cuh's tile_row/tile_col, k in stages of 32 (8
// int32 words) through two shared buffers, the next stage's global loads in
// registers while the current one is multiplied. Operands sit in shared
// memory as int32 words of four consecutive k, k-major: word w of row r of A
// at As[w * kApad + r], of column n of W at Bs[w * (BN + 4) + n], so a thread
// reads the words of its four rows (or columns) as one int4; a word of W is
// four bytes as they lie in memory.
#pragma once

#include "f32.cuh"
#include "int8.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// The int8 product on the tensor cores (K11)
// ---------------------------------------------------------------------------

// ln_quant_rows (the same sums in the same order, the same roundings, value
// for value, two reads of a row) for the tensor-core product's row-major
// A: row r's int8 word w (k 4w .. 4w + 3) at As[r * as + 4w]; and a warp's
// next row's first read (its values k = lane + 32i, for the sums) is
// loaded while it works on this one.
template <typename E>
__device__ inline void ln_quant_rows_major(const E* __restrict__ x, long rows, int d, long r0,
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
// columns 8 nt + (2t, 2t + 1) of its BN/2
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
// first k, rows `as` bytes apart) times W's stage ws (BN rows of kSS)
template <int BN>
__device__ inline void stage_mma(AccI<BN>& acc, const uint8_t* a, int as, const uint8_t* ws) {
  const int lane = threadIdx.x % 32, wc = tc_warp_col<BN>();
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
      ldsm_x4(b, ws + (wc + 16 * np + (lane & 7) + (lane >> 4) * 8) * kSS + 32 * ks +
                     ((lane >> 3) & 1) * 16);
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
// epi(n0, acc) after each column tile's last stage. W's stages (wt [N, K]
// int8) stream through the kTCStages buffers of `ring`, the next kTCStages - 1
// in flight while one is multiplied, running on from one column tile into the
// next; one barrier a stage. Ends with every copy landed and on a barrier.
template <int BN, typename Epi>
__device__ inline void product_resident_a_tc(const uint8_t* As, int as,
                                             const int8_t* __restrict__ wt, int K, int N,
                                             uint8_t* ring, Epi&& epi) {
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
    stage_mma<BN>(acc, a + k0, as, ring + s * kStage);
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
