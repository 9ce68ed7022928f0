// Shared device helpers for the hand-written Hopper kernels of herro_tpu_torch.
//
// Every kernel is launched from a plain C entry point that returns 0 or a
// CUDA error code (cudaGetLastError() after the launch), so the ctypes
// wrapper can raise on a refused launch. The TMA/wgmma kernels build on
// sm90.cuh; the register-level mma.sync primitives below serve the one
// kernel still on that form, K9 flash_attention.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace herro {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;  // 8 warps a block (K9)
constexpr int kMaxSmem = 232448;  // 227 KB: the most one H100 block may use

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
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
