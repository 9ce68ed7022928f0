// Rotary tables built inside the kernel (the split-half route of
// herro_tpu/ops/fused.py:_rope_tables_blk and _rope_apply), for the
// TMA/wgmma qkv kernels that build them (K8 ln_qkv_rope_split, K10
// ln_qkv_rope_q; ln_qkv_rope_sm90.cuh).
//
//   freq_i = exp(-ln(10000) * i / (D/2)),  ang = float(pos) * freq_i,
// with pos the absolute column index of the token row. Angles reach 10^4
// rad, so the full-range expf/cosf/sinf are used, never the fast intrinsics;
// on the card torch.exp/cos/sin are the same functions, so the tables equal
// the plain version's (and the table-fed K1's inputs) bit for bit.
//
// A consumer thread of those kernels holds, in the m64n128 accumulator
// layout, two rows (g and g + 8 of its warp's 16) at the 16 first-half
// columns 8j + 2q + e (j < 8, e < 2); their pairs sit at column + 64. So it
// needs exactly the cos/sin of its two rows at its 16 frequencies: the
// frequencies once per launch, the 64 cosf/sinf once per tile position
// (the kernels walk the tiles of one position across the examples in a
// row), in the registers the table-fed K1 loads its tables into.
#pragma once

#include <cuda_runtime.h>

namespace herro {

// the frequencies of this thread's columns 8j + 2q + e, at index 2j + e
__device__ inline void rope_freqs(int q, float (&freq)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      freq[2 * j + e] = expf(
          __fdiv_rn(__fmul_rn(-9.210340371976184f, (float)(8 * j + 2 * q + e)), 64.f));
}

// cos/sin at positions l and l + 8 (clamped to L - 1: rows past L are never
// stored), at this thread's frequencies, in the index order of rope_freqs
__device__ inline void rope_rows(int l, int L, const float (&freq)[16], float (&cs)[2][16],
                                 float (&sn)[2][16]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float pos = (float)min(l + 8 * half, L - 1);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float ang = __fmul_rn(pos, freq[i]);
      cs[half][i] = cosf(ang);
      sn[half][i] = sinf(ang);
    }
  }
}

}  // namespace herro
