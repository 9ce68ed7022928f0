// Shared device helpers for the hand-written Hopper kernels of herro_tpu_torch.
//
// Every kernel is launched from a plain C entry point that returns 0 or a
// CUDA error code (cudaGetLastError() after the launch), so the ctypes
// wrapper can raise on a refused launch. The TMA/wgmma kernels build on
// sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace herro {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kMaxSmem = 232448;  // 227 KB: the most one H100 block may use

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// two floats -> one register of two bf16, the first in the low half
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace herro
