// The tile product of K1/K8 (ln_qkv_rope_simt.cuh), K3 (ln_ffn_f32.cu,
// ln_ffn_bf16.cu) and the bf16 out projection behind K2/K6/K7 (flash_tc.cuh
// project: o [T, H D] @ Wo + the residual, kEpiResidualAfter) on the tensor
// cores (mma.sync), for float32 and for bf16 at the widths no Hopper
// instance takes: A @ W over a block's row tile of
// kRowsT = 64 token rows, column tile by column tile of BN (64 or 128), A [T,
// K] (LayerNorm(x) rounded to E as the plain versions round it, which
// layernorm() writes first; or the FFN's hidden), W [K, N] row-major, the
// sums in float32.
//
// - bf16: m16n8k16 on the operands as they are (products exact, sums
//   float32), fragments by ldmatrix (A's rows, W's k-rows transposed).
// - float32: mma reads float32 as TF32 (a 10-bit mantissa), which misses
//   the 1e-4 bar at r10's widths (tests/test_torch_gemm_tc.py). Each
//   operand is split into two TF32 parts by bit masks (split_tf32) as its
//   fragment is read, and each product taken three times, lo.hi + hi.lo +
//   hi.hi, m16n8k8; a k-step's index t maps to k 2t and t + 4 to 2t + 1, so
//   a thread's A pair is adjacent in shared memory. A k-step issues its
//   lo.hi products over every fragment, then its hi.lo, then its hi.hi, so
//   that no product waits on the one before it.
// - The tensor cores round their float32 sums toward zero, so each stage of
//   kBK = 32 k sums from zero in fresh C fragments and joins the float32
//   accumulator at round-to-nearest (flash_tc.cuh's P.V does the same).
//
// Bound on the H100: the products, 2 T K N operations at the bf16 peak (989
// TFLOP/s) or, in float32, three TF32 products at a third of the TF32 peak
// (495 / 3); at r10's widths in float32, B=32, L=9216: K1 2.81 ms, K3 3.75.
//
// Design: LayerNorm first, a launch of its own (layernorm: a warp a row,
// every load of four rows in flight at once) into a [T, d] scratch of E,
// so that the product's stages are plain copies. Then 128 threads (4
// warps) a row tile, a warp a 32 x 64 sub-tile (2 x 8 C fragments), or 16 x
// 128 where a head is 128 columns (K1/K8 at D 128: the rope's partner
// column dd +- D/2 then sits in the same thread's fragments, as it does at
// every smaller D in a 64-column sub-tile). A block walks its column tiles
// in turn, so A's rows come from L2 after their first read. k in stages of
// 32 through a ring of shared buffers filled by cp.async (16 bytes a
// thread, rows past T and columns past N zero-filled; three buffers), the
// next two stages in flight while one is multiplied, the stages running on
// from one column tile into the next;
// one barrier a stage. Rows are padded (A by 8 elements, W by 4 floats or 8
// bf16) so that every fragment read is free of bank conflicts. float32
// keeps a stage's C fragments beside the accumulator (128 floats a thread)
// and takes up to 255 registers, two blocks an SM; bf16 sums each C
// fragment of a stage from zero on its own and takes 128, four blocks an
// SM (kMinBlocks), so that other blocks' products fill one block's
// barriers, copies and epilogues. Measured (tools/gemm_tc_clocks_torch.py):
// float32 spends about 55-60% of a stage on its products, bf16 26-31%; at
// the out projection's shapes (K 512, N 512) bf16 issuing its copies 0.35
// and its epilogue 0.34 of a stage (PERF.md section 7).
//
// At d 32 (TINY_CONFIG and its shards) K1/K8 and K3 take narrow.cuh's
// FFMA kernels instead. The out projection takes this one in bf16 alone, at
// every width (flash_tc.cuh outproj_on_tc: float32 keeps f32.cuh's FFMA
// product, whose sums the int8 golden's frozen bar holds).
#pragma once

#include "f32.cuh"
#include "mma.cuh"

namespace herro {
namespace gemm_tc {

using namespace f32;

constexpr int kBK = 32;     // k a stage
constexpr int kRowsT = 64;  // token rows a tile
constexpr int kWarps = 4;   // warps a tile
constexpr int kTileThreads = 32 * kWarps;

// the warps across a tile's columns when a warp takes WM rows (32: a 2 x 2
// grid; 16: 4 x 1)
template <int WM>
__host__ __device__ constexpr int warps_n() {
  return kWarps / (kRowsT / WM);
}

// the shapes of an instance: E the storage type, BN the tile's columns, WM
// a warp's rows
template <typename E, int BN, int WM>
struct Tile {
  static constexpr bool kF32 = sizeof(E) == 4;
  static constexpr int kMT = WM / 16;                  // a warp's 16-row fragments
  static constexpr int kNT = BN / warps_n<WM>() / 8;   // its 8-column fragments
  static constexpr int kAS = kBK + 8;                  // row stride of A's stage (elements)
  static constexpr int kWS = BN + (kF32 ? 4 : 8);      // row stride of W's stage
  static constexpr int kStage = kRowsT * kAS + kBK * kWS;
  static constexpr int kStages = 3;                    // the ring of stages
  static constexpr int kSmem = kStages * kStage * (int)sizeof(E);
};

// blocks an SM: bf16 in 128 registers a thread (each C fragment summed from
// zero for its stage's two k-steps alone, so that four blocks fit), float32
// in up to 255, two blocks (every fragment's sums of a stage at once, so
// that a product never waits on the one before it)
template <typename E>
constexpr int kMinBlocks = sizeof(E) == 2 ? 4 : 2;

template <typename E, int BN, int WM>
using Acc = float[Tile<E, BN, WM>::kMT][Tile<E, BN, WM>::kNT][4];

// the tile's row of a warp's first output row, and column of its first column
template <int BN, int WM>
__device__ inline int warp_row() {
  return (threadIdx.x / 32) / warps_n<WM>() * WM;
}
template <int BN, int WM>
__device__ inline int warp_col() {
  return (threadIdx.x / 32) % warps_n<WM>() * (BN / warps_n<WM>());
}

// LayerNorm's statistics of one row: lane l holds its columns l, l + 32, ...
// (v[i] of column l + 32 i), sums them in order, the lanes' sums meet by a
// butterfly; mu = sum(x) / d and var = max(sum(x * x) / d - mu * mu, 0),
// float32
template <int kCols>
__device__ inline void row_stats(const float (&v)[kCols], int d, float& mu, float& rstd) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (32 * i >= d) break;
    s = __fadd_rn(s, v[i]);
    s2 = __fadd_rn(s2, __fmul_rn(v[i], v[i]));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
  }
  mu = __fdiv_rn(s, (float)d);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, (float)d), __fmul_rn(mu, mu)), 0.f);
  rstd = rsqrtf(__fadd_rn(var, 1e-6f));
}

// y [T, d] = LayerNorm(x) rounded to E, d <= 32 kCols: a warp a row
// (row_stats; f32.cuh's ln_apply), kLnRows rows a warp at once, every load of
// them in flight together; a lane holds kCols values of a row, 16 up to d 512
// and 32 above (to d 1024: 128 floats of registers a thread)
constexpr int kLnRows = 4;
template <typename E, int kCols>
__global__ void __launch_bounds__(kThreads)
    layernorm_kernel(const E* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, E* __restrict__ y, long T, int d) {
  const int lane = threadIdx.x % 32;
  const long r = ((long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * kLnRows;
  float v[kLnRows][kCols];
#pragma unroll
  for (int j = 0; j < kLnRows; ++j)
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      v[j][i] = r + j < T && c < d ? to_f(x[(r + j) * d + c]) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < kLnRows; ++j) {
    if (r + j >= T) break;
    float m, rs;
    row_stats(v[j], d, m, rs);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      if (c >= d) break;
      store1(y + (r + j) * d + c, ln_apply<E>(v[j][i], m, rs, scale[c], bias[c]));
    }
  }
}

template <typename E>
int layernorm(const E* x, const float* scale, const float* bias, E* y, long T, int d,
              cudaStream_t stream) {
  constexpr long kRowsABlock = kThreads / 32 * kLnRows;
  const unsigned grid = (unsigned)((T + kRowsABlock - 1) / kRowsABlock);
  if (d <= 512)
    layernorm_kernel<E, 16><<<grid, kThreads, 0, stream>>>(x, scale, bias, y, T, d);
  else
    layernorm_kernel<E, 32><<<grid, kThreads, 0, stream>>>(x, scale, bias, y, T, d);
  return (int)cudaGetLastError();
}

// The product A @ W of a row tile, column tile by column tile: for each
// column tile n0 = 0, BN, ..., it calls epi(n0, acc) with acc[mt][nt] the C
// fragment of rows r0 + warp_row + 16 mt + (g, g + 8) and columns n0 +
// warp_col + 8 nt + (2t, 2t + 1) (g = lane / 4, t = lane % 4), summed over k
// < K (a multiple of kBK); rows at or past T and columns at or past N (a
// multiple of 16 bytes of E) read 0. ``smem`` holds the ring of stages
// (Tile::kSmem bytes).
template <typename E, int BN, int WM, typename Epi>
__device__ inline void product(const E* __restrict__ A, long T, int K,
                               const E* __restrict__ W, int N, long r0, E* smem, Epi&& epi) {
  using Tl = Tile<E, BN, WM>;
  constexpr int MT = Tl::kMT, NT = Tl::kNT, kAS = Tl::kAS, kWS = Tl::kWS;
  constexpr int kStages = Tl::kStages;
  constexpr int kPer = 16 / (int)sizeof(E);  // elements a 16-byte copy
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = warp_row<BN, WM>(), wc = warp_col<BN, WM>();

  // the stage of columns n0 .. n0 + BN - 1 and k0 .. k0 + kBK - 1 into st
  auto copy = [&](int n0, int k0, E* st) {
    E* Ws = st + kRowsT * kAS;
    for (int e = tid; e < kBK * BN / kPer; e += kTileThreads) {
      const int kr = e / (BN / kPer), c = (e % (BN / kPer)) * kPer;
      const bool ok = n0 + c < N;
      cp_async16(Ws + kr * kWS + c, W + (long)(k0 + kr) * N + (ok ? n0 + c : 0), ok);
    }
    for (int e = tid; e < kRowsT * kBK / kPer; e += kTileThreads) {
      const int r = e / (kBK / kPer), c = (e % (kBK / kPer)) * kPer;
      const bool ok = r0 + r < T;
      cp_async16(st + r * kAS + c, A + (ok ? (r0 + r) * K : 0) + k0 + c, ok);
    }
  };
  // the stage after (n0, k0): k on, then the next column tile
  auto advance = [&](int& n0, int& k0) {
    k0 += kBK;
    if (k0 == K) k0 = 0, n0 += BN;
  };

  int ln0 = 0, lk0 = 0;  // the next stage to copy
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (ln0 < N) copy(ln0, lk0, smem + i * Tl::kStage);
    cp_async_commit();
    advance(ln0, lk0);
  }
  Acc<E, BN, WM> acc;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int n0 = 0, k0 = 0, s = 0; n0 < N; s = s + 1 == kStages ? 0 : s + 1) {
    // this stage is in (the thread's own copies, then everyone's), and every
    // warp is done with the stage before, whose buffer takes the next copies
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ln0 < N) copy(ln0, lk0, smem + (s == 0 ? kStages - 1 : s - 1) * Tl::kStage);
    cp_async_commit();  // empty past the last stage: the count of groups holds
    advance(ln0, lk0);
    const E* As = smem + s * Tl::kStage;
    const E* Ws = As + kRowsT * kAS;
    if constexpr (Tl::kF32) {
      // the stage's 32 k sum from zero in fresh C fragments
      float c[MT][NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks) {
        // A's fragment of k 8ks + 2t (index t) and 8ks + 2t + 1 (t + 4):
        // (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1); W's: (k 8ks
        // + 2t, column g) and (8ks + 2t + 1, g)
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* a0 = As + (wr + 16 * mt + g) * kAS + 8 * ks + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(a0);
          const float2 x1 = *reinterpret_cast<const float2*>(a0 + 8 * kAS);
          split_tf32(x0.x, ah[mt][0], al[mt][0]);
          split_tf32(x1.x, ah[mt][1], al[mt][1]);
          split_tf32(x0.y, ah[mt][2], al[mt][2]);
          split_tf32(x1.y, ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* w0 = Ws + (8 * ks + 2 * t) * kWS + wc + 8 * nt + g;
          split_tf32(w0[0], bh[nt][0], bl[nt][0]);
          split_tf32(w0[kWS], bh[nt][1], bl[nt][1]);
        }
        // lo.hi, hi.lo, then hi.hi, each over every fragment: no two
        // products in a row into one C fragment
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], c[mt][nt][e]);
    } else {
      // the stage's 32 k sum from zero in a fresh C fragment
      constexpr int KS = kBK / 16;
      uint32_t a[MT][KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          // A's matrices: rows 0..7 / 8..15 (lanes 8-15, 24-31) at k 16ks +
          // 0..7 / 8..15 (lanes 16-31)
          ldsm_x4(a[mt][ks], As + (wr + 16 * mt + (lane & 15)) * kAS + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // W's matrices: k 16ks + 0..7 / 8..15 at columns 16np + 0..7 /
        // 8..15 (lanes 16-31), transposed: a register holds k 2t, 2t + 1
        uint32_t b[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4_trans(b[ks], Ws + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kWS + wc +
                                   16 * np + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float c0[4] = {}, c1[4] = {};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            mma_bf16(c0, a[mt][ks], b[ks][0], b[ks][1]);
            mma_bf16(c1, a[mt][ks], b[ks][2], b[ks][3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][2 * np][e] = __fadd_rn(acc[mt][2 * np][e], c0[e]);
            acc[mt][2 * np + 1][e] = __fadd_rn(acc[mt][2 * np + 1][e], c1[e]);
          }
        }
      }
    }
    if (k0 + kBK == K) {  // the column tile's last stage
      epi(n0, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    advance(n0, k0);
  }
}

// y [T, N] = A @ W + b through f32.cuh's epilogue kEpi; res [T, N] the
// residual; A, W, b, res and y of type E. A block a row tile of kRowsT rows
// (grid row_tiles), its column tiles in turn.
template <typename E, int kEpi, int BN>
__global__ void __launch_bounds__(kTileThreads, kMinBlocks<E>)
    tile_kernel(const E* __restrict__ A, const E* __restrict__ W, const E* __restrict__ b,
                const E* __restrict__ res, E* __restrict__ y, long T, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int WM = 32;
  using Tl = Tile<E, BN, WM>;
  const long r0 = (long)blockIdx.x * kRowsT;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp_row<BN, WM>(), wc = warp_col<BN, WM>();
  product<E, BN, WM>(
      A, T, K, W, N, r0, reinterpret_cast<E*>(smem_raw), [&](int n0, const Acc<E, BN, WM>& acc) {
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const long row = r0 + wr + 16 * mt + g + 8 * hf;
            if (row >= T) continue;
#pragma unroll
            for (int nt = 0; nt < Tl::kNT; ++nt) {
              const int n = n0 + wc + 8 * nt + 2 * t;
              if (n >= N) continue;  // N is even: the pair is in or out together
              const long i = row * N + n;
              store2(y + i, epilogue<E, kEpi>(acc[mt][nt][2 * hf], to_f(b[n]), res, i),
                     epilogue<E, kEpi>(acc[mt][nt][2 * hf + 1], to_f(b[n + 1]), res, i + 1));
            }
          }
      });
}

// the grid of row tiles over T rows
inline dim3 row_tiles(long T) { return dim3((unsigned)((T + kRowsT - 1) / kRowsT)); }

template <typename E, int kEpi, int BN>
int launch_bn(const E* A, const E* W, const E* b, const E* res, E* y, long T, int K, int N,
              cudaStream_t stream) {
  constexpr int smem = Tile<E, BN, 32>::kSmem;
  const void* kernel = (const void*)tile_kernel<E, kEpi, BN>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  tile_kernel<E, kEpi, BN><<<row_tiles(T), kTileThreads, smem, stream>>>(A, W, b, res, y, T, K, N);
  return (int)cudaGetLastError();
}

// y = A @ W + b through epilogue kEpi, at the tile width for N
template <typename E, int kEpi>
int launch(const E* A, const E* W, const E* b, const E* res, E* y, long T, int K, int N,
           cudaStream_t stream) {
  if (tile_width(N) == 64) return launch_bn<E, kEpi, 64>(A, W, b, res, y, T, K, N, stream);
  return launch_bn<E, kEpi, 128>(A, W, b, res, y, T, K, N, stream);
}

// K3: out = E(x + ((h @ W2) + b2)), h = E(gelu(E(LN(x) @ W1 + b1))): three
// launches on one stream, LayerNorm's output in `out` until the second
// product overwrites it, the hidden in the [T, f] scratch `hidden` (the
// entry points send d 32 to narrow.cuh instead)
template <typename E>
int ffn(const E* x, const float* scale, const float* bias, const E* w1, const E* b1,
        const E* w2, const E* b2, E* hidden, E* out, long T, int d, int f, cudaStream_t s) {
  int err = layernorm<E>(x, scale, bias, out, T, d, s);
  if (!err) err = launch<E, kEpiGelu>(out, w1, b1, nullptr, hidden, T, d, f, s);
  if (!err) err = launch<E, kEpiResidual>(hidden, w2, b2, x, out, T, f, d, s);
  return err;
}

}  // namespace gemm_tc
}  // namespace herro
