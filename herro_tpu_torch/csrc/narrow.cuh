// K1/K8 and K3 at d_model 32 (kWidth: TINY_CONFIG, distill's default student,
// and its tensor-parallel shards), float32 and bf16: the narrow kernels.
// Entry points: ln_qkv_rope_{f32,bf16}.cu (qkv_rope, both rope routes) and
// ln_ffn_{f32,bf16}.cu (ffn); above d 32 those take gemm_tc.cuh's
// tensor-core product.
//
// Replace herro_tpu/ops/fused.py:_ln_qkv_rope_tbl_kernel (K1, rope tables
// handed in), _ln_qkv_rope_kernel (K8, tables built in the kernel,
// HERRO_TPU_ROPE=split) and _ln_ffn_kernel (K3) at d 32:
//   q, k, v [B, H, L, D] = rope(E(E(LN(x)) @ W + b))   (v unroped)
//   out [T, 32] = E(x + ((h @ W2) + b2)),  h = E(gelu(E(E(LN(x)) @ W1 + b1)))
//
// The arithmetic is that of the FFMA tile product that ran here before
// (f32.cuh's gemm_mainloop, with LayerNorm per stage), step for step, so
// every output keeps its bits (and tiny's bf16 rows stay bit-equal with the
// plain versions, whose cuBLAS SGEMM sums as FFMA does, k ascending, one FMA
// a product; the tensor cores missed those bits on 2e-5 to 7e-5 of
// outputs): LayerNorm's two sums take the 32-lane butterfly's pairing tree
// (layernorm_tile; gemm_tc.cuh:row_stats' at d 32), the normalisation
// f32.cuh's ln_apply, each product output one fmaf chain from 0.f with k
// ascending (K3's second product over the hidden's chunks in order), qkv's
// bias qkv_bias, the rope's products and sums rounded as before, the split
// route's cos/sin the same expf/cosf/sinf expressions (K8 equals K1 bit for
// bit), the FFN's epilogues f32.cuh's epilogue<E, kEpiGelu> and
// <E, kEpiResidual>.
//
// Bound on the H100 at tiny's widths, B=32, L=9216 (T = 294,912): the bytes,
// x read and q/k/v or out written once: K1 0.0451 ms in float32, 0.0225 in
// bf16; K3 0.0225 and 0.0113. The FFMAs (67 TFLOP/s) take K1 2 T 32 96 =
// 1.81e9 operations, 0.027 ms, K3 4 T 32 64 = 2.42e9, 0.036 ms, so bf16 K1
// and both K3 are bound by the FFMA rate.
//
// Design: a persistent grid (a few blocks an SM, each striding over tiles
// of kRows = 128 token rows), 256 threads a block.
// - x read once: a tile of x is contiguous ([128, 32]: 16 KB of float32),
//   so one thread copies it with one bulk copy (cp.async.bulk, completing
//   an mbarrier); the next tile's copy is issued as soon as LayerNorm has
//   read the current one, and flies while its products run.
// - LayerNorm from the staged tile (4 lanes a row, 8 columns a lane), its
//   output transposed into shared memory as float32 (at, [32][kAT]).
// - Weights resident: a block stages them once, as float32, in the column
//   order its threads read them (kResident chunks; wider products stage
//   each chunk in turn).
// - The products: a 32 x 8 grid of threads, thread (rg, tx) 4 rows (4 rg ..
//   4 rg + 3) by 4 or 6 columns, each k one float4 of at and one or three
//   reads of W for 16 or 24 FMAs. K1 walks qkv in chunks of 24 rope pairs
//   (48 columns; H D / 16 chunks, so exactly N columns): thread tx holds
//   the pairs tx, tx + 8, tx + 16 of the chunk, each a first-half column
//   and its partner D/2 further, so the rope is the thread's own and the
//   eight lanes of a row write eight consecutive dims of one head. K3 walks
//   the hidden in chunks of 32 columns: gelu(h) of a chunk goes through
//   shared memory (ht, transposed) into the second product, whose 4 x 4
//   outputs a thread keeps in registers over the chunks: the hidden never
//   reaches device memory, and K3 is one launch.
// - Tables: K1 stages cos/sin of its tile's rows at every frequency once
//   (copied from the tables, or built by the split route), and each row's
//   offset in q/k/v.
// - Stores: K3 16 bytes a lane, a row's 128 bytes from 8 lanes; K1 a run
//   of 8 dims of one head (32 bytes in float32) from 8 lanes, rows past a
//   batch boundary to the next example.
// Measured (tiny, B=32, L=9216, H100 at 700 W; PERF.md section 6): K1 0.085-0.092
// ms, K3 0.099-0.106, against the earlier FFMA kernels' 0.24-0.39 and
// 0.27; a warp spends 0.2-0.26 of its cycles in LayerNorm, 0.24-0.50 in
// products, 0.14-0.31 in the epilogue (tools/narrow_clocks_torch.py).
#pragma once

#include <cstring>
#include <type_traits>

#include "ln_qkv_rope_simt.cuh"
#include "sm90.cuh"

namespace herro {
namespace narrow {

using namespace f32;

constexpr int kWidth = 32;      // the d_model these kernels take
constexpr int kRows = 128;      // token rows a tile
constexpr int kThreads = 256;   // thread (rg, tx) = (tid / 8, tid % 8)
constexpr int kAT = kRows + 8;  // row stride (floats) of at: LayerNorm's writes conflict-free
constexpr int kAS = kRows + 4;  // row stride (floats) of ht: gelu's writes conflict-free
constexpr int kResident = 2;    // chunks of weights a block keeps for the whole launch
constexpr int kChunk = 32;      // K3: hidden columns a chunk
constexpr int kPairs = 24;      // K1: rope pairs a chunk
constexpr int kQkvCols = 2 * kPairs;

// the rows r0 .. of x [T, 32] that tile holds (all kRows but in the last
// tile) into xs by one bulk copy, which completes the barrier's phase;
// issued by one thread, after every thread is done with xs
template <typename E>
__device__ inline void copy_x(E* xs, const E* __restrict__ x, long T, long r0, uint64_t* bar) {
  const long rows = T - r0 < kRows ? T - r0 : kRows;
  const uint32_t bytes = (uint32_t)(rows * kWidth * sizeof(E));
  sm90::fence_proxy_async();
  sm90::mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(sm90::smem_u32(xs)), "l"(x + r0 * kWidth), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// LayerNorm of the staged tile into at (at[k * kAT + r] = LN(x)[r, k]
// rounded to E), in gemm_tc.cuh:row_stats' order at d 32: there lane c of
// a warp holds column c and the sums meet by xor 16, 8, 4, 2, 1. Here 4
// lanes a row (lane 4q + l: row 8 warp + q of each pass of 64 rows), lane
// l columns l + 4j (j < 8): xor 16, 8 and 4 pair slots j ^ 4, j ^ 2 and j ^
// 1 of one thread, xor 2 and 1 the lanes l ^ 2 and l ^ 1, so the same sums
// meet. Rows past T hold what the buffer held: their outputs are not
// stored
template <typename E>
__device__ inline void layernorm_tile(const E* xs, float* at, const float* __restrict__ scale,
                                      const float* __restrict__ bias) {
  const int warp = threadIdx.x / 32, q = threadIdx.x % 32 / 4, l = threadIdx.x % 4;
#pragma unroll 1  // a pass at a time: one pass's values in registers
  for (int p = 0; p < kRows / 64; ++p) {
    const int r = 64 * p + 8 * warp + q;
    // slot (i + q) % 8 at load i, so that a warp's eight rows fall in eight
    // bank groups; then turned back: v[j] is column l + 4j
    float w[8], t[8], u[8], v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = to_f(xs[r * kWidth + l + 4 * ((i + q) & 7)]);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = q & 1 ? w[(j + 7) & 7] : w[j];
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] = q & 2 ? t[(j + 6) & 7] : t[j];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = q & 4 ? u[(j + 4) & 7] : u[j];
    float s[8], s2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = __fadd_rn(0.f, v[j]);
      s2[j] = __fadd_rn(0.f, __fmul_rn(v[j], v[j]));
    }
#pragma unroll
    for (int o = 4; o; o >>= 1)
#pragma unroll
      for (int j = 0; j < o; ++j) {
        s[j] = __fadd_rn(s[j], s[j + o]);
        s2[j] = __fadd_rn(s2[j], s2[j + o]);
      }
    float a = s[0], a2 = s2[0];
#pragma unroll
    for (int o = 2; o; o >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
      a2 = __fadd_rn(a2, __shfl_xor_sync(0xffffffffu, a2, o));
    }
    const float mu = __fdiv_rn(a, (float)kWidth);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(a2, (float)kWidth), __fmul_rn(mu, mu)), 0.f);
    const float rstd = rsqrtf(__fadd_rn(var, 1e-6f));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      at[(l + 4 * j) * kAT + r] =
          ln_apply<E>(v[j], mu, rstd, __ldg(scale + l + 4 * j), __ldg(bias + l + 4 * j));
  }
}

// acc[i][j] += sum over k < 32, ascending, of a[k * S + i] * w[k * ldw + j]:
// one fmaf chain an output (a and w already offset to the thread's rows and
// columns; S the row stride of a; NC 4: one float4 of w a k, NC 6: three
// float2)
template <int S, int NC>
__device__ inline void product(float (&acc)[4][NC], const float* a, const float* w, int ldw) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * S);
    const float ai[4] = {av.x, av.y, av.z, av.w};
    float wv[NC];
#pragma unroll
    for (int j = 0; j < NC; j += NC == 4 ? 4 : 2) {
      if constexpr (NC == 4) {
        const float4 b = *reinterpret_cast<const float4*>(w + k * ldw);
        wv[0] = b.x, wv[1] = b.y, wv[2] = b.z, wv[3] = b.w;
      } else {
        const float2 b = *reinterpret_cast<const float2*>(w + k * ldw + j);
        wv[j] = b.x, wv[j + 1] = b.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(ai[i], wv[j], acc[i][j]);
  }
}

// four consecutive values of E as they lie, in registers: 16 bytes of
// float, 8 of bf16 (two values a register)
template <typename E>
using Raw4 = std::conditional_t<sizeof(E) == 4, float4, uint2>;
template <typename E>
__device__ inline void unpack4(const Raw4<E>& a, E (&r)[4]) {
  memcpy(r, &a, sizeof(a));
}

// the dynamic shared memory's layout, from its start: the copy's barrier
// (16 bytes), xs [kRows][32] of E, at [32][kAT] floats, then the kernel's
// own
constexpr int kXs = 16;
template <typename E>
__host__ __device__ constexpr int at_offset() {
  return kXs + kRows * kWidth * (int)sizeof(E);
}
template <typename E>
__host__ __device__ constexpr int head_bytes() {
  return at_offset<E>() + 32 * kAT * (int)sizeof(float);
}

// the blocks of a persistent grid over `tiles` row tiles: as many as fit on
// every SM at once (the kernel's shared memory set first), at most one a
// tile
inline int persistent_grid(const void* kernel, int smem, long tiles, int& grid) {
  int err = set_smem(kernel, smem);
  if (!err)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
  if (err) return err;
  grid = (int)(tiles < (long)sms * per ? tiles : (long)sms * per);
  return grid > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// --- K3 ---------------------------------------------------------------------

// a chunk of K3's weights (floats): W1's 32 columns [32 k][32] with column
// tx + 8j in slot 4 tx + j (the columns thread tx computes, one float4),
// W2's 32 rows [32][32] as they lie, b1 [32] in W1's slots
constexpr int kFfnW2 = 32 * kChunk, kFfnB1 = kFfnW2 + kChunk * kWidth;
constexpr int kFfnSlot = kFfnB1 + kChunk;

template <typename E>
__host__ __device__ constexpr int ffn_smem(int slots) {
  return head_bytes<E>() + (kChunk * kAS + kWidth + slots * kFfnSlot) * (int)sizeof(float);
}

// chunk c of the weights into slot, every load of a thread issued at once
template <typename E>
__device__ inline void stage_ffn(float* slot, const E* __restrict__ w1, const E* __restrict__ b1,
                                 const E* __restrict__ w2, int f, int c) {
  constexpr int kN = 32 * kChunk / kThreads;
  float a[kN], b[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = threadIdx.x + i * kThreads, k = e / kChunk, j = e % kChunk;
    a[i] = to_f(w1[(long)k * f + kChunk * c + j]);
    b[i] = to_f(w2[(long)kChunk * c * kWidth + e]);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = threadIdx.x + i * kThreads, k = e / kChunk, j = e % kChunk;
    slot[k * kChunk + 4 * (j % 8) + j / 8] = a[i];
    slot[kFfnW2 + e] = b[i];
  }
  if (threadIdx.x < kChunk) {
    const int j = threadIdx.x;
    slot[kFfnB1 + 4 * (j % 8) + j / 8] = to_f(b1[kChunk * c + j]);
  }
}

// K3 at d 32: out = E(x + ((h @ W2) + b2)), h = E(gelu(E(LN(x) @ W1 + b1))),
// f a multiple of 32; `slots` chunks of weights staged once (f / 32 of
// them when that is at most kResident, else one, restaged for each chunk).
// Two blocks an SM: three (80 registers a thread) spilled
template <typename E>
__global__ void __launch_bounds__(kThreads, 2)
    ffn_kernel(const E* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const E* __restrict__ w1,
               const E* __restrict__ b1, const E* __restrict__ w2, const E* __restrict__ b2,
               E* __restrict__ out, long T, int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem_raw);
  E* const xs = reinterpret_cast<E*>(smem_raw + kXs);
  float* const at = reinterpret_cast<float*>(smem_raw + at_offset<E>());
  float* const ht = at + 32 * kAT;  // gelu(h) of a chunk, [32 hidden columns][kAS]
  float* const b2s = ht + kChunk * kAS;
  float* const ws = b2s + kWidth;
  const int tid = threadIdx.x, rg = tid / 8, tx = tid % 8;
  const int chunks = f / kChunk;
  const bool resident = chunks <= kResident;
  const int tiles = (int)((T + kRows - 1) / kRows);
  int tile = blockIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
    copy_x(xs, x, T, (long)tile * kRows, bar);
  }
  if (resident)
#pragma unroll
    for (int c = 0; c < kResident; ++c)
      if (c < chunks) stage_ffn(ws + c * kFfnSlot, w1, b1, w2, f, c);
  if (tid < kWidth) b2s[tid] = to_f(b2[tid]);
  __syncthreads();  // the barrier's init
  for (uint32_t phase = 0; tile < tiles; tile += gridDim.x, phase ^= 1) {
    const long r0 = (long)tile * kRows;
    // the tile is in, and every warp is done with the last tile's at and ht
    sm90::mbar_wait(bar, phase);
    __syncthreads();
    layernorm_tile<E>(xs, at, scale, bias);
    // the residual of the thread's outputs: rows 4 rg + i, columns 4 tx + j
    Raw4<E> res[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      res[i] = *reinterpret_cast<const Raw4<E>*>(xs + (4 * rg + i) * kWidth + 4 * tx);
    __syncthreads();  // at is whole, xs free
    if (tid == 0 && tile + (int)gridDim.x < tiles)
      copy_x(xs, x, T, (long)(tile + gridDim.x) * kRows, bar);
    float o[4][4] = {};
    for (int c = 0; c < chunks; ++c) {
      const float* slot = ws + (resident ? c * kFfnSlot : 0);
      if (!resident) {
        __syncthreads();
        stage_ffn(ws, w1, b1, w2, f, c);
        __syncthreads();
      }
      // h of hidden columns 32c + tx + 8j: the first product and gelu
      float h[4][4] = {};
      product<kAT>(h, at + 4 * rg, slot + 4 * tx, kChunk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[i][j] = epilogue<E, kEpiGelu>(h[i][j], slot[kFfnB1 + 4 * tx + j], nullptr, 0);
      __syncthreads();  // every warp is done with the last chunk's ht
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(ht + (tx + 8 * j) * kAS + 4 * rg) =
            make_float4(h[0][j], h[1][j], h[2][j], h[3][j]);
      __syncthreads();
      // the second product's k over the chunk's hidden columns, in order
      product<kAS>(o, ht + 4 * rg, slot + kFfnW2 + 4 * tx, kWidth);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = r0 + 4 * rg + i;
      if (row >= T) continue;
      E r[4];
      unpack4<E>(res[i], r);
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = epilogue<E, kEpiResidual>(o[i][j], b2s[4 * tx + j], r, j);
      store4(out + row * kWidth + 4 * tx, y);
    }
  }
}

template <typename E>
int ffn(const E* x, const float* scale, const float* bias, const E* w1, const E* b1,
        const E* w2, const E* b2, E* out, long T, int d, int f, cudaStream_t stream) {
  if (T < 1 || d != kWidth || !d_ff_ok(f)) return (int)cudaErrorInvalidValue;
  const int smem = ffn_smem<E>(f / kChunk <= kResident ? f / kChunk : 1);
  int grid = 0;
  const int err = persistent_grid((const void*)ffn_kernel<E>, smem, (T + kRows - 1) / kRows, grid);
  if (err) return err;
  ffn_kernel<E><<<grid, kThreads, smem, stream>>>(x, scale, bias, w1, b1, w2, b2, out, T, f);
  return (int)cudaGetLastError();
}

// --- K1 / K8 ----------------------------------------------------------------

// pair p of qkv (p < 3 H D / 2): its first-half column (head p / half, dim
// p % half); the partner is half further
__device__ inline int pair_col(int p, int half) { return p / half * 2 * half + p % half; }

// a chunk of K1's weights (floats): the chunk's 48 columns [32 k][48],
// thread tx's pairs tx + 8e (e < 3) at slots 6 tx + 2e (the first-half
// column) and 6 tx + 2e + 1 (its partner), then the bias [48] in the same
// slots
constexpr int kQkvB = 32 * kQkvCols, kQkvSlot = kQkvB + kQkvCols;

// the row stride (floats) of the staged cos/sin: conflict-free reads
template <int D>
__host__ __device__ constexpr int table_stride() {
  return D / 2 + 2;
}

// after the head: cos and sin [kRows][table_stride], the weights' slots,
// then each row's (b, l) offset [kRows] of int
template <typename E, int D>
__host__ __device__ constexpr int qkv_smem(int slots) {
  return head_bytes<E>() + (2 * kRows * table_stride<D>() + slots * kQkvSlot) * (int)sizeof(float) +
         kRows * (int)sizeof(int);
}

// the slot's column of chunk c (slot s = 6 tx + 2e + part)
__device__ inline int qkv_col(int c, int s, int half) {
  return pair_col(kPairs * c + s / 6 + 8 * (s % 6 / 2), half) + (s % 2) * half;
}

template <typename E>
__device__ inline void stage_qkv(float* slot, const E* __restrict__ w, const E* __restrict__ b,
                                 int N, int half, int c) {
  constexpr int kN = 32 * kQkvCols / kThreads;
  float a[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = threadIdx.x + i * kThreads;
    a[i] = to_f(w[(long)(e / kQkvCols) * N + qkv_col(c, e % kQkvCols, half)]);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) slot[threadIdx.x + i * kThreads] = a[i];
  if (threadIdx.x < kQkvCols) slot[kQkvB + threadIdx.x] = to_f(b[qkv_col(c, threadIdx.x, half)]);
}

// K1 (kTables: cos/sin from the tables [L, D/2]) or K8 (built here) at d 32
// and head dim D; H D / 16 chunks of 24 pairs; B L < 2^31. Three blocks an
// SM for the split route (at most 80 registers a thread); the table route
// spilled in 80 and takes two
template <typename E, bool kTables, int D>
__global__ void __launch_bounds__(kThreads, kTables ? 2 : 3)
    qkv_kernel(const E* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const E* __restrict__ w, const E* __restrict__ b,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
               E* __restrict__ q, E* __restrict__ k, E* __restrict__ v, int B, int L, int H) {
  constexpr int half = D / 2, kTS = table_stride<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem_raw);
  E* const xs = reinterpret_cast<E*>(smem_raw + kXs);
  float* const at = reinterpret_cast<float*>(smem_raw + at_offset<E>());
  float* const cs = at + 32 * kAT;  // cos/sin of the tile's row r at frequency i: [r * kTS + i]
  float* const sn = cs + kRows * kTS;
  float* const ws = sn + kRows * kTS;
  const int tid = threadIdx.x, rg = tid / 8, tx = tid % 8;
  const int T = B * L;  // below 2^31 (qkv_rope)
  const int N = 3 * H * D, chunks = H * D / 16;
  const bool resident = chunks <= kResident;
  // each row of the tile: b H L + l, its (b, head 0, l) in q/k/v over D; -1 past T
  int* const rowbl = reinterpret_cast<int*>(ws + (resident ? chunks : 1) * kQkvSlot);
  const int tiles = (T + kRows - 1) / kRows;
  int tile = blockIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
    copy_x(xs, x, (long)T, (long)tile * kRows, bar);
  }
  if (resident)
#pragma unroll
    for (int c = 0; c < kResident; ++c)
      if (c < chunks) stage_qkv(ws + c * kQkvSlot, w, b, N, half, c);
  __syncthreads();  // the barrier's init
  for (uint32_t phase = 0; tile < tiles; tile += gridDim.x, phase ^= 1) {
    const int r0 = tile * kRows, b0 = r0 / L, l0 = r0 % L;
    sm90::mbar_wait(bar, phase);
    __syncthreads();
    layernorm_tile<E>(xs, at, scale, bias);
    // a thread stages frequency tid % half alone (half divides kThreads);
    // the split route builds it in the plain version's rope_tables
    // expression, as ln_qkv_rope_simt.cuh builds it
    const int fi = tid % half;
    const float freq = kTables ? 0.f
        : expf(__fdiv_rn(__fmul_rn(-9.210340371976184f, (float)fi), (float)half));
    // the table route copies a row at a time (more loads in flight spill
    // their addresses), the split route builds two at once
    if constexpr (kTables) {
#pragma unroll 1
      for (int i = 0; i < kRows * half / kThreads; ++i) {
        const int e = tid + i * kThreads, r = e / half;
        const int l = l0 + r < L ? l0 + r : (l0 + r) % L;
        cs[r * kTS + fi] = cos_t[(long)l * half + fi];
        sn[r * kTS + fi] = sin_t[(long)l * half + fi];
      }
    } else {
#pragma unroll 2
      for (int i = 0; i < kRows * half / kThreads; ++i) {
        const int e = tid + i * kThreads, r = e / half;
        const int l = l0 + r < L ? l0 + r : (l0 + r) % L;
        const float ang = __fmul_rn((float)l, freq);
        cs[r * kTS + fi] = cosf(ang);
        sn[r * kTS + fi] = sinf(ang);
      }
    }
    if (tid < kRows) {
      const int l = l0 + tid, wrap = l < L ? 0 : l / L;
      rowbl[tid] = r0 + tid < T ? (b0 + wrap) * H * L + l - wrap * L : -1;
    }
    __syncthreads();  // at, the tables and the row offsets are whole, xs free
    if (tid == 0 && tile + (int)gridDim.x < tiles)
      copy_x(xs, x, T, (long)(tile + gridDim.x) * kRows, bar);
    for (int c = 0; c < chunks; ++c) {
      const float* slot = ws + (resident ? c * kQkvSlot : 0);
      if (!resident) {
        __syncthreads();
        stage_qkv(ws, w, b, N, half, c);
        __syncthreads();
      }
      float acc[4][6] = {};
      product<kAT>(acc, at + 4 * rg, slot + 6 * tx, kQkvCols);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        // pair p: dims ri and ri + half of head `head` (q, k or v of head h);
        // the eight lanes of a row hold eight consecutive pairs of one head
        const int p = kPairs * c + tx + 8 * e, head = p / half, ri = p % half;
        const int which = (head >= H) + (head >= 2 * H);
        E* const out = (which == 0 ? q : which == 1 ? k : v) + (long)(head - which * H) * L * D;
        const float bf = slot[kQkvB + 6 * tx + 2 * e], bs = slot[kQkvB + 6 * tx + 2 * e + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bl = rowbl[4 * rg + i];
          if (bl < 0) continue;  // a row past T
          const long base = (long)bl * D;
          float x1 = qkv_simt::qkv_bias<E>(acc[i][2 * e], bf);
          float x2 = qkv_simt::qkv_bias<E>(acc[i][2 * e + 1], bs);
          if (which < 2) {
            const float c_ = cs[(4 * rg + i) * kTS + ri], s_ = sn[(4 * rg + i) * kTS + ri];
            // x1 * cos - x2 * sin for the first half, x2 * cos + x1 * sin for the second
            const float y1 = round_to<E>(__fsub_rn(__fmul_rn(x1, c_), __fmul_rn(x2, s_)));
            x2 = round_to<E>(__fadd_rn(__fmul_rn(x2, c_), __fmul_rn(x1, s_)));
            x1 = y1;
          }
          store1(out + base + ri, x1);
          store1(out + base + ri + half, x2);
        }
      }
    }
  }
}

template <typename E, bool kTables, int D>
int qkv_d(const E* x, const float* scale, const float* bias, const E* w, const E* b,
          const float* cos_t, const float* sin_t, E* q, E* k, E* v, int B, int L, int H,
          cudaStream_t stream) {
  const int chunks = H * D / 16;
  const int smem = qkv_smem<E, D>(chunks <= kResident ? chunks : 1);
  int grid = 0;
  const int err = persistent_grid((const void*)qkv_kernel<E, kTables, D>, smem,
                                  ((long)B * L + kRows - 1) / kRows, grid);
  if (err) return err;
  qkv_kernel<E, kTables, D><<<grid, kThreads, smem, stream>>>(x, scale, bias, w, b, cos_t, sin_t,
                                                              q, k, v, B, L, H);
  return (int)cudaGetLastError();
}

// K1/K8 at d 32, head dim 16, 32, 64 or 128 (f32.cuh head_dim_pow2) and any
// H; B L and B H L below 2^31 (q/k/v then hold at most 2^31 D values each)
template <typename E, bool kTables>
int qkv_rope(const E* x, const float* scale, const float* bias, const E* w, const E* b,
             const float* cos_t, const float* sin_t, E* q, E* k, E* v, int B, int L, int d,
             int H, int D, cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || d != kWidth || !head_dim_pow2(D) ||
      (long)B * H * L > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return qkv_d<E, kTables, 16>(x, scale, bias, w, b, cos_t, sin_t, q, k, v, B, L, H, stream);
    case 32:
      return qkv_d<E, kTables, 32>(x, scale, bias, w, b, cos_t, sin_t, q, k, v, B, L, H, stream);
    case 64:
      return qkv_d<E, kTables, 64>(x, scale, bias, w, b, cos_t, sin_t, q, k, v, B, L, H, stream);
    default:  // 128
      return qkv_d<E, kTables, 128>(x, scale, bias, w, b, cos_t, sin_t, q, k, v, B, L, H, stream);
  }
}

}  // namespace narrow
}  // namespace herro
