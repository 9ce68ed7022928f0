// Shared device helpers for the hand-written Hopper kernels of herro_tpu_torch.
//
// Every matmul kernel here takes bfloat16 activations and weights and
// accumulates in float32 on the tensor cores (mma.sync m16n8k16 with
// ldmatrix operands); every kernel is launched from a plain C entry point
// that returns cudaGetLastError(), so the ctypes wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace herro {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;  // 8 warps per block in every matmul kernel
constexpr int kMaxSmem = 232448;  // 227 KB: the most one H100 block may use

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// LayerNorm (flax semantics, as herro_tpu/ops/fused.py:layernorm): float32
// statistics, the fast variance mean(x^2) - mu^2 clamped at 0, eps 1e-6, the
// result rounded to bf16. Rows [row0, row0 + n_rows) of x [T, d] go to shared
// memory y [n_rows][ldy]; rows at or past T are zero-filled. One warp per row.
__device__ inline void layernorm_rows(const bf16* __restrict__ x,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      long row0, int n_rows, long T, int d,
                                      bf16* y, int ldy) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < n_rows; r += n_warps) {
    const long row = row0 + r;
    bf16* yr = y + (size_t)r * ldy;
    if (row >= T) {
      for (int c = lane; c < d; c += 32) yr[c] = __float2bfloat16(0.f);
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
    for (int c = lane; c < d; c += 32) {
      const float v = __bfloat162float(xr[c]);
      yr[c] = __float2bfloat16((v - mu) * rs * scale[c] + bias[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Register-level tensor-core primitives (PTX): mma.sync m16n8k16 bf16 -> f32,
// ldmatrix from shared memory, cp.async copies into shared memory.
// Fragment layouts (g = lane / 4, t = lane % 4):
//   A 16x16 (row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                        a3 = (g+8, 2t+8..)
//   B 16x8  (k x n):     b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C 16x8  (f32):       c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8x8 b16 matrices; lane l addresses row l % 8 of matrix l / 8
__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a @ b
__device__ inline void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the first in the low half
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte async copy to shared memory; zero-fills when !valid (src unread)
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kChunkK = 32;          // k rows of B staged per step
constexpr int kChunkN = 128;         // B columns per block pass
constexpr int kLdChunk = kChunkN + 8;  // staged row stride: conflict-free ldmatrix
constexpr size_t kStageBytes = 2 * (size_t)kChunkK * kLdChunk * 2;  // double buffer

// One block pass of a warp-tiled product on the tensor cores:
//   acc[NT][4] += A[a_row0 .. a_row0+15, 0..K) @ B[0..K, n0 + warp_n*NT*8 ..)
// A is row-major bf16 in shared memory (row stride lda); B is row-major bf16
// [K, ldb] in global memory, its [kChunkK, kChunkN] chunks staged through the
// double buffer `stage` by cp.async (every thread of the block takes part, so
// every thread must call this). K is a multiple of kChunkK, ldb of 8.
template <int NT>
__device__ inline void block_gemm(float (&acc)[NT][4], const bf16* A, int lda, int a_row0,
                                  const bf16* __restrict__ B, int ldb, int n0, int K,
                                  bf16* stage, int warp_n) {
  const int lane = threadIdx.x & 31;
  auto load_chunk = [&](int kc, int buf) {
    bf16* dst = stage + (size_t)buf * kChunkK * kLdChunk;
    for (int e = threadIdx.x; e < kChunkK * (kChunkN / 8); e += blockDim.x) {
      const int r = e / (kChunkN / 8), c = (e % (kChunkN / 8)) * 8;
      cp_async16(dst + r * kLdChunk + c, B + (size_t)(kc * kChunkK + r) * ldb + n0 + c, true);
    }
  };
  const int nk = K / kChunkK;
  load_chunk(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) load_chunk(kc + 1, (kc + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Bs = stage + (size_t)(kc & 1) * kChunkK * kLdChunk + warp_n * NT * 8;
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, A + (size_t)(a_row0 + (lane & 15)) * lda + kc * kChunkK + ks * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < NT; nn += 2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, Bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdChunk +
                              nn * 8 + (lane >> 4) * 8);
        mma16816(acc[nn], a, bb[0], bb[1]);
        mma16816(acc[nn + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }
}

template <int NT>
__device__ inline void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace herro
