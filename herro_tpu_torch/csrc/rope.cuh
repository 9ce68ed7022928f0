// Rotary tables built inside the kernel (the split-half route of
// herro_tpu/ops/fused.py:_rope_tables_blk and _rope_apply), shared by
// ln_qkv_rope_split.cu and ln_qkv_rope_q.cu.
//
//   freq_i = exp(-ln(10000) * i / (D/2)),  ang = float(pos) * freq_i,
// with pos the absolute column index of the token row. Angles reach 10^4
// rad, so the full-range expf/cosf/sinf are used, never the fast intrinsics;
// on the card torch.exp/cos/sin are the same functions, so the tables equal
// the plain version's bit for bit.
//
// One (row, i) pair serves q and k of every head, so a block computes its
// 128 x 64 pairs once into shared memory (32 cosf/sinf a thread, 72 KB)
// instead of once per head in registers (8 times the transcendentals at
// H = 4, and 64 registers beside the accumulators).
#pragma once

#include "common.cuh"

namespace herro {

constexpr int kRopeRows = 128;  // token rows per block
constexpr int kRopeHalf = 64;   // D / 2 at head dim 128
constexpr int kRopeLd = 72;     // table row stride (floats): conflict-free float2 reads
constexpr size_t kRopeBytes = 2 * (size_t)kRopeRows * kRopeLd * sizeof(float);

// cos_s / sin_s [kRopeRows][kRopeLd]: row r holds position (row0 + r) % L.
// blockDim.x is a multiple of kRopeHalf, so a thread keeps one frequency.
__device__ inline void build_rope_tables(long row0, int L, float* cos_s, float* sin_s) {
  const int i = threadIdx.x % kRopeHalf;
  const float freq =
      expf(__fdiv_rn(__fmul_rn(-9.210340371976184f, (float)i), (float)kRopeHalf));
  for (int r = threadIdx.x / kRopeHalf; r < kRopeRows; r += blockDim.x / kRopeHalf) {
    const float ang = __fmul_rn((float)((row0 + r) % L), freq);
    cos_s[r * kRopeLd + i] = cosf(ang);
    sin_s[r * kRopeLd + i] = sinf(ang);
  }
}

// rotate-half of the pair (x1 at column i, x2 at column i + D/2), each step
// rounded on its own (no fused multiply-add), as the reference
__device__ inline void rope_rotate(float x1, float x2, float cs, float sn, float& o1,
                                   float& o2) {
  o1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
  o2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
}

}  // namespace herro
