// K5: the counting-rule consensus class of every pileup column.
//
// Replaces herro_tpu/ops/fused.py:_count_kernel (via count_decisions_pallas).
// Per column over rows 0..n_alns: class = t % 5 for tokens t < 10 (else not
// counted); take the top two classes with ties to the smaller index; keep the
// target's class when the top count is below 2 or a top-two tie involves it,
// otherwise take the plurality. The result is exact integer logic.
// Bound on the H100: bytes, ~9.4 MB at B=32, L=9216 (31 token rows read once,
// one u8 per column written). Design: one thread per column, so each of the
// 31 row reads is a coalesced byte stream across the warp, the five counts
// live in registers and nothing is staged.
#include "common.cuh"

namespace herro {

__global__ void count_decisions_kernel(const uint8_t* __restrict__ tok,
                                       const int* __restrict__ n_alns,
                                       uint8_t* __restrict__ out, int R, int L) {
  const int b = blockIdx.y;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int na = n_alns[b];
  int n[5] = {0, 0, 0, 0, 0};
  int tbase = 5;
  for (int r = 0; r < R; ++r) {
    const int t = tok[((size_t)b * R + r) * L + l];
    const int cls = t < 10 ? t % 5 : 5;
    if (r == 0) tbase = cls;
    if (r <= na) {
#pragma unroll
      for (int c = 0; c < 5; ++c) n[c] += (cls == c);
    }
  }
  int c0 = 0, m0 = n[0];
#pragma unroll
  for (int c = 1; c < 5; ++c)
    if (n[c] > m0) { c0 = c; m0 = n[c]; }
  // second place: the same scan with c0's count set to -1, as the reference
  int c1 = 0, m1 = c0 == 0 ? -1 : n[0];
#pragma unroll
  for (int c = 1; c < 5; ++c) {
    const int v = c == c0 ? -1 : n[c];
    if (v > m1) { c1 = c; m1 = v; }
  }
  const bool keep = (m0 < 2) || ((m0 == m1) && (c0 == tbase || c1 == tbase));
  out[(size_t)b * L + l] = (uint8_t)(keep ? tbase : c0);
}

}  // namespace herro

extern "C" int herro_count_decisions(const uint8_t* tok, const int* n_alns, uint8_t* out,
                                     int B, int R, int L, void* stream) {
  using namespace herro;
  dim3 grid((L + 255) / 256, B);
  count_decisions_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(tok, n_alns, out, R, L);
  return (int)cudaGetLastError();
}
