// The tensor-core pieces the mma.sync kernels share (flash_tc.cuh's
// attention, gemm_tc.cuh's tile product, int8_simt.cuh's int8 product):
// the three products, the TF32 split of a float32 operand, ldmatrix
// fragment loads and cp.async copies.
#pragma once

#include "common.cuh"

namespace herro {

// x = hi + lo to 2^-20 of |x|, each part TF32: hi is x with the 13 low
// bits of its encoding cleared, lo = x - hi (exact), whose 13 low bits the
// tensor cores ignore as they read a TF32 operand (CUTLASS's
// round_toward_zero conversion to tfloat32_t, a plain copy, rests on the
// same). An integer and and a subtraction: cvt.rna.tf32.f32 runs on the
// conversion pipe (16 a clock an SM, beside ex2's), which set the first
// build's time
constexpr uint32_t kTF32Mask = 0xffffe000u;
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & kTF32Mask;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over 32 k of int8: a [16 x 32] row-major, b [32 x 8] column-major
// (k contiguous for each n), c in int32. Exact: |sum| <= 127^2 * 2048 <
// 2^31 over any K the kernels take, so no .satfinite. A register of a holds
// 4 k of one row (a0: row g, k 4t..4t+3; a1: row g + 8; a2, a3: k + 16),
// of b 4 k of one column (b0: column g, k 4t..4t+3; b1: k + 16), g = lane
// / 4, t = lane % 4: ldmatrix's b16 matrices of 8 rows x 16 bytes as they
// lie
__device__ inline void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, lanes 8i .. 8i + 7 naming matrix i's rows
__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// 16 bytes from device memory, or zeros where !valid
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// every copy this thread has issued has landed
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// the copies issued since the last commit form a group; at most N of this
// thread's latest groups are still in flight
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace herro
