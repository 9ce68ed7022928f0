// Shared pieces of the SIMT and tensor-core kernels for float32 and for bf16
// at the widths the Hopper instances lack: loads, stores and roundings of the
// storage type, LayerNorm, gelu and the epilogues (gemm_tc.cuh's tile
// product of K1/K8 and K3, narrow.cuh's K1/K8 and K3 at d 32,
// entry_embed_simt.cuh, flash_tc.cuh, int8_simt.cuh), and the FFMA tile
// product that flash_tc.cuh's out projection runs in float32 (K2/K6/K7's
// second launch; the int8 kernels of int8_simt.cuh keep its tile layout).
//
// The FFMA tile product (gemm_mainloop) has SGEMM's usual shape: a block of
// 256 threads an output tile of 128 x 128, 8 x 8 outputs a thread (four
// float4 reads of shared memory feed 64 FFMAs), k in stages of 16 through
// two shared buffers, the next stage's global loads in registers while the
// current one is multiplied; float32 FFMAs on the CUDA cores (67 TFLOP/s on
// an H100 SXM), accumulated in float32.
//
// Every kernel is templated on the storage type E of its activations and
// weights: float, or bf16 (__nv_bfloat16) for the bf16 configs whose widths
// or head dims no Hopper instance was built for (TINY_CONFIG in bf16, head
// dim 64, their tensor-parallel shards). Loads convert to float32 and the
// FFMA stages hold float32: a product of two bf16 values is exact in
// float32, and only the order of the sums differs from the Hopper kernels'
// float32 accumulation. Where the bf16 plain version rounds to bf16 (the
// LayerNorm output before the product, qkv after the bias and again after
// the rope, the FFN hidden after the bias and after gelu, P before P.V, the
// attention output before the out projection, every output), the kernels
// round through round_to<E>, the identity for float.
//
// The roundings the plain versions (ops/fused.py) make outside a product
// are made in the same order with the _rn intrinsics, so that nvcc
// contracts no a * b + c of theirs into one FMA: LayerNorm's statistics
// (flax's fast variance mean(x^2) - mean(x)^2, clamped at 0), the
// normalisation, the bias and residual adds, and the rope's rotations. The
// sums of the products run in another order than cuBLAS's: that and
// rsqrtf/tanhf/expf against the host's are the difference the tests bound.
#pragma once

#include "common.cuh"

namespace herro {
namespace f32 {

// a value of storage type E as float, a float rounded to E as the plain
// version's .to(dtype) rounds it, and four consecutive values of E (16-byte
// aligned for float, 8 for bf16) loaded as float32 or stored from it
__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(bf16 v) { return __bfloat162float(v); }
template <typename E>
__device__ inline float round_to(float v) {
  return sizeof(E) == 2 ? bf16_round(v) : v;
}
__device__ inline void store1(float* p, float v) { *p = v; }
__device__ inline void store1(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ inline float4 load_f4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float4 load_f4(const bf16* p) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const bf162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const bf162*>(&a.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
template <typename E>
__device__ inline void load4(const E* p, float (&v)[4]) {
  const float4 a = load_f4(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
// two (four) values already rounded to E
__device__ inline void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ inline void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ inline void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

constexpr int kThreads = 256;  // a 16 x 16 grid of threads over the output tile
constexpr int kBM = 128;       // token rows per tile: 8 per thread
constexpr int kBK = 16;        // k per shared-memory stage
constexpr int kPad = kBM + 4;  // row stride of a stage's A part (float4 reads, fewer conflicts)

// floats of one stage of a tile BN columns wide: A transposed, then W
template <int BN>
__host__ __device__ constexpr int stage_floats() {
  return kBK * kPad + kBK * (BN + 4);
}

// the tile width for N output columns: 64 for the narrow products of
// TINY_CONFIG (d 32, d_ff 64), 128 for the rest
inline int tile_width(int N) { return N <= 64 ? 64 : 128; }

// the tile's row of a thread's output i (i < 8) and column j (j < BN / 16):
// groups of 4 a side, 64 apart, so a warp's float4 reads of a stage fall on
// two addresses (A) or 256 consecutive bytes (W)
__device__ inline int tile_row(int ty, int i) { return (i & 4) * 16 + 4 * ty + (i & 3); }
__device__ inline int tile_col(int tx, int j) { return (j & 4) * 16 + 4 * tx + (j & 3); }

// LayerNorm's output of one value, rounded to E as the plain version rounds it
template <typename E>
__device__ inline float ln_apply(float v, float mu, float rstd, float scale, float bias) {
  return round_to<E>(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), scale), bias));
}

// acc[i][j] = sum_k A[r0 + tile_row(ty, i), k] * W[k, n0 + tile_col(tx, j)]
// over k < K, with (ty, tx) = (tid / 16, tid % 16), for a tile of kBM rows
// and BN (64 or 128) columns. A [T, K] and W [K, N] are row-major, of
// storage type E; K is a multiple of kBK, N of 4 (columns at or past N read
// 0, rows at or past T read 0). Two stages in ``smem`` (2
// stage_floats<BN>()): while one is multiplied, the next one's global loads
// are in registers, stored to the other stage after the products; one
// barrier a stage.
template <typename E, int BN>
__device__ inline void gemm_mainloop(float (&acc)[8][BN / 16], const E* __restrict__ A,
                                     long T, int K, const E* __restrict__ W, int N,
                                     long r0, int n0, float* smem) {
  constexpr int G = BN / 64;  // column groups of 4 a thread
  constexpr int kStage = stage_floats<BN>();
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;
  float4 ra[2], rb[G];
  // a thread's share of a stage: rows tid / 4 and tid / 4 + 64 of A at k
  // (tid % 4) * 4, and G float4s of W
  auto load = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tid / 4 + 64 * h, kk = (tid % 4) * 4;
      const long row = r0 + r;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < T) a = load_f4(A + row * K + k0 + kk);
      ra[h] = a;
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int e = tid + kThreads * h, kb = e / (BN / 4), c = (e % (BN / 4)) * 4;
      rb[h] = n0 + c < N ? load_f4(W + (long)(k0 + kb) * N + n0 + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](float* st) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tid / 4 + 64 * h, kk = (tid % 4) * 4;
      st[(kk + 0) * kPad + r] = ra[h].x;
      st[(kk + 1) * kPad + r] = ra[h].y;
      st[(kk + 2) * kPad + r] = ra[h].z;
      st[(kk + 3) * kPad + r] = ra[h].w;
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int e = tid + kThreads * h, kb = e / (BN / 4), c = (e % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(st + kBK * kPad + kb * (BN + 4) + c) = rb[h];
    }
  };
  load(0);
  store(smem);
  __syncthreads();
  for (int k0 = 0, s = 0; k0 < K; k0 += kBK, s ^= 1) {
    const bool next = k0 + kBK < K;
    if (next) load(k0 + kBK);
    const float* As = smem + s * kStage;
    const float* Bs = As + kBK * kPad;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], bv[4 * G];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(As + kk * kPad + 64 * g + 4 * ty);
        av[4 * g] = a.x, av[4 * g + 1] = a.y, av[4 * g + 2] = a.z, av[4 * g + 3] = a.w;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(Bs + kk * (BN + 4) + 64 * g + 4 * tx);
        bv[4 * g] = b.x, bv[4 * g + 1] = b.y, bv[4 * g + 2] = b.z, bv[4 * g + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * G; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) store(smem + (s ^ 1) * kStage);
    __syncthreads();
  }
}

// gelu(tanh) as PyTorch's CUDA kernel writes it (GeluCUDAKernelImpl)
__device__ inline float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2) * 2/sqrt(pi) * 0.5
  const float kKappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fadd_rn(x, __fmul_rn(kKappa, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

// the epilogues of a tile product, each rounded to E where the plain version
// rounds (E: the storage type; float rounds nowhere)
constexpr int kEpiGelu = 0;      // y = E(gelu(E(A @ W + b)))
constexpr int kEpiResidual = 1;  // y = E(res + ((A @ W) + b))
constexpr int kEpiResidualAfter = 2;  // y = E((res + A @ W) + b)

// one output of epilogue kEpi: a = (A @ W)[row, n], bn = b[n], res[i] the
// residual's element (unread by kEpiGelu)
template <typename E, int kEpi>
__device__ inline float epilogue(float a, float bn, const E* res, long i) {
  if constexpr (kEpi == kEpiGelu) {
    return round_to<E>(gelu_tanh(round_to<E>(__fadd_rn(a, bn))));
  } else if constexpr (kEpi == kEpiResidual) {
    return round_to<E>(__fadd_rn(to_f(res[i]), __fadd_rn(a, bn)));
  } else {
    return round_to<E>(__fadd_rn(__fadd_rn(to_f(res[i]), a), bn));
  }
}

// y [T, N] = A @ W + b through one of the epilogues above; res [T, N] the
// residual; A, W, b, res and y of type E. A tile of kBM x BN a block, grid
// gemm_grid(T, N, BN); a thread stores its 8 rows as BN/64 groups of 4
// each. Two blocks an SM: at most 128 registers a thread.
template <typename E, int kEpi, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const E* __restrict__ A, const E* __restrict__ W, const E* __restrict__ b,
                const E* __restrict__ res, E* __restrict__ y, long T, int K, int N) {
  __shared__ __align__(16) float smem[2 * stage_floats<BN>()];
  const long r0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  float acc[8][BN / 16];
  gemm_mainloop<E, BN>(acc, A, T, K, W, N, r0, n0, smem);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = r0 + tile_row(ty, i);
    if (row >= T) continue;
#pragma unroll
    for (int g = 0; g < BN / 64; ++g) {
      const int n = n0 + tile_col(tx, 4 * g);
      if (n >= N) continue;  // N is a multiple of 4: the four columns are in or out
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = epilogue<E, kEpi>(acc[i][4 * g + e], to_f(b[n + e]), res, row * N + n + e);
      store4(y + row * N + n, v);
    }
  }
}

// grid of a kernel over T rows and N columns in tiles of kBM x BN
inline dim3 gemm_grid(long T, int N, int BN) {
  return dim3((unsigned)((T + kBM - 1) / kBM), (unsigned)((N + BN - 1) / BN));
}

// y = A @ W + b through epilogue kEpi, at the tile width for N
template <typename E, int kEpi>
void launch_gemm(const E* A, const E* W, const E* b, const E* res, E* y, long T, int K, int N,
                 cudaStream_t stream) {
  if (tile_width(N) == 64)
    gemm_kernel<E, kEpi, 64><<<gemm_grid(T, N, 64), kThreads, 0, stream>>>(A, W, b, res, y, T,
                                                                           K, N);
  else
    gemm_kernel<E, kEpi, 128><<<gemm_grid(T, N, 128), kThreads, 0, stream>>>(A, W, b, res, y,
                                                                             T, K, N);
}

// the widths the SIMT kernels take, float32 or bf16 (ops/fused.py: F32_*):
// every head dim a multiple of 16 from 16 to 128, d_model a multiple of 32
// up to 1024, d_ff a multiple of 32 up to 4096
inline bool head_dim_ok(int D) { return D >= 16 && D <= 128 && D % 16 == 0; }
inline bool d_model_ok(int d) { return d >= 32 && d <= 1024 && d % 32 == 0; }
inline bool d_ff_ok(int f) { return f >= 32 && f <= 4096 && f % 32 == 0; }

// the head dims of the kernels laid out by powers of two: narrow.cuh's K1/K8
// at d 32 (a frequency a thread, D/2 dividing the block) and the SIMT int8
// K10 (int8_simt.cuh's rope spans, span_col)
inline bool head_dim_pow2(int D) { return D == 16 || D == 32 || D == 64 || D == 128; }
// the SIMT int8 kernels' widths (ops/fused.py: INT8_*): int8_simt.cuh holds
// a LayerNorm row in registers up to d 512
inline bool int8_d_model_ok(int d) { return d >= 32 && d <= 512 && d % 32 == 0; }
inline bool int8_d_ff_ok(int f) { return f >= 32 && f <= 2048 && f % 32 == 0; }

}  // namespace f32
}  // namespace herro
