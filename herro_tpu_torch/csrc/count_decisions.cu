// K5: the counting-rule consensus class of every pileup column.
//
// Replaces herro_tpu/ops/fused.py:_count_kernel (via count_decisions_pallas).
// Per column over rows 0..n_alns: class = t % 5 for tokens t < 10 (else not
// counted); take the top two classes with ties to the smaller index (the
// second with the first's count at -1); keep the target's class (row 0's,
// 5 for a token >= 10) when the top count is below 2 or a top-two tie
// involves it, otherwise take the plurality. The result is exact integer
// logic.
// Bound on the H100: bytes, the token rows 0..n_alns of each batch element
// read once and one u8 per column written (at most 31 rows, ~9.4 MB, at
// B=32, L=9216).
// Design: a stream at 16 bytes a thread. A thread owns 16 consecutive columns
// of one batch element, so a warp reads 512 contiguous bytes of a row in one
// 16-byte load a lane, with up to 16 rows in flight; rows past n_alns are not
// read (row 0 always is, for the target). The five counts of a column live
// packed in one register as 6-bit fields, each token adding 1 << 6 * class
// from a 256-entry table in shared memory (0 for t >= 10), so R <= 63. The
// 16 decisions leave as one 16-byte store. Where L is not a multiple of 16
// (or a pointer not 16-byte aligned) the same kernel reads and writes bytes,
// masked at L.
#include "common.cuh"

namespace herro {
namespace cd {

constexpr int kCols = 16;      // columns a thread owns
constexpr int kThreadsCd = 128;
constexpr int kGroup = 16;     // rows loaded before they are counted
constexpr int kMaxRows = 63;   // the most a 6-bit field counts

// 16 bytes of a row from column l0, or (kVec false) its bytes below L, 0xff
// past it (a token that counts nowhere)
template <bool kVec>
__device__ inline uint4 load16(const uint8_t* p, int l0, int L) {
  if constexpr (kVec) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * i + e;
        w[i] |= (uint32_t)(l0 + c < L ? p[c] : 0xffu) << (8 * e);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ inline uint32_t byte_of(const uint4& v, int c) {
  const uint32_t w = c < 4 ? v.x : c < 8 ? v.y : c < 12 ? v.z : v.w;
  return (w >> (8 * (c & 3))) & 0xffu;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreadsCd)
count_decisions_kernel(const uint8_t* __restrict__ tok, const int* __restrict__ n_alns,
                       uint8_t* __restrict__ out, int R, int L) {
  __shared__ uint32_t inc[256];
  for (int t = threadIdx.x; t < 256; t += kThreadsCd)
    inc[t] = t < 10 ? 1u << (6 * (t % 5)) : 0u;
  __syncthreads();

  const int b = blockIdx.y;
  const int l0 = (blockIdx.x * kThreadsCd + threadIdx.x) * kCols;
  if (l0 >= L) return;
  const int na = n_alns[b];
  const int n_cnt = na < 0 ? 0 : min(na, R - 1) + 1;  // rows counted
  const int n_read = max(n_cnt, 1);                   // row 0 holds the target
  const uint8_t* col = tok + (size_t)b * R * L + l0;

  uint32_t acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0;
  uint4 first;
#pragma unroll 1
  for (int r0 = 0; r0 < n_read; r0 += kGroup) {
    uint4 v[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (r0 + i < n_read) v[i] = load16<kVec>(col + (size_t)(r0 + i) * L, l0, L);
    if (r0 == 0) first = v[0];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (r0 + i < n_cnt) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] += inc[byte_of(v[i], c)];
      }
  }

  uint32_t res[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    int n[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) n[k] = (acc[c] >> (6 * k)) & 63;
    const uint32_t t0 = byte_of(first, c);
    const int tbase = t0 < 10 ? (int)(t0 % 5) : 5;
    int c0 = 0, m0 = n[0];
#pragma unroll
    for (int k = 1; k < 5; ++k)
      if (n[k] > m0) { c0 = k; m0 = n[k]; }
    // second place: the same scan with c0's count set to -1, as the reference
    int c1 = 0, m1 = c0 == 0 ? -1 : n[0];
#pragma unroll
    for (int k = 1; k < 5; ++k) {
      const int v = k == c0 ? -1 : n[k];
      if (v > m1) { c1 = k; m1 = v; }
    }
    const bool keep = (m0 < 2) || ((m0 == m1) && (c0 == tbase || c1 == tbase));
    res[c >> 2] |= (uint32_t)(keep ? tbase : c0) << (8 * (c & 3));
  }
  uint8_t* o = out + (size_t)b * L + l0;
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(o) = make_uint4(res[0], res[1], res[2], res[3]);
  } else {
    for (int c = 0; c < kCols && l0 + c < L; ++c) o[c] = (uint8_t)(res[c >> 2] >> (8 * (c & 3)));
  }
}

}  // namespace cd
}  // namespace herro

extern "C" int herro_count_decisions(const uint8_t* tok, const int* n_alns, uint8_t* out,
                                     int B, int R, int L, void* stream) {
  using namespace herro::cd;
  if (B < 1 || B > 65535 || R < 1 || R > kMaxRows || L < 1) return (int)cudaErrorInvalidValue;
  const int threads = (L + kCols - 1) / kCols;
  dim3 grid((threads + kThreadsCd - 1) / kThreadsCd, B);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = L % kCols == 0 && (uintptr_t)tok % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec)
    count_decisions_kernel<true><<<grid, kThreadsCd, 0, s>>>(tok, n_alns, out, R, L);
  else
    count_decisions_kernel<false><<<grid, kThreadsCd, 0, s>>>(tok, n_alns, out, R, L);
  return (int)cudaGetLastError();
}
