// K4 on the CUDA cores: pileup tokens + quals -> the d_model stream, for
// float32 configs and for bf16 at widths the Hopper instance (entry_embed.cu:
// d 256, 384 or 512, the 512-row table) lacks. Entry points:
// entry_embed_f32.cu (float32), entry_embed_bf16.cu (bf16).
//
// Replaces herro_tpu/ops/fused.py:_entry_embed_kernel (via _entry_embed_pallas):
//   out[t, c] = E((sum_r E_r[tok[r, t], c] + sum_r E(qual[r, t]) * wq_r[c]) + cb[c])
// with E_r[v] row 16r + v and wq_r row 16r + V of the col_proj table Wc
// [kp, d] of type E (fused.col_proj_table); a token outside the vocab adds
// nothing; the quals meet the weights in E, as the plain version's
// quals.to(out_dtype) rounds them, and the sums run in float32. The sums run
// over r in order, as the plain version's (one gather-add a pileup row, then
// the quals' contraction, then the bias); cb stays float32.
//
// Bound on the H100: bytes (tokens 1 B and quals 4 B per pileup row and
// column, the [B, L, d] output; the table stays in L1/L2).
// Design: a thread a (token row, 4 output columns), the columns of one row in
// consecutive threads, so a row's threads read its tokens and quals (a
// broadcast) and R rows of Wc along the columns, 4 values each (coalesced,
// cached), and write their outputs as one coalesced line. No tensor cores:
// the function is a gather-sum, not a product.
// Shapes: d a multiple of 32 up to 512, R 1-63, V 12, kp >= 16 R, any B, L.
#pragma once

#include "f32.cuh"

namespace herro {
namespace embed_simt {

using namespace f32;

constexpr int kSlot = 16;

template <typename E>
__global__ void __launch_bounds__(kThreads)
    entry_embed_kernel(const uint8_t* __restrict__ tok, const float* __restrict__ quals,
                       const E* __restrict__ wc, const float* __restrict__ cb,
                       E* __restrict__ out, int R, int L, int d, int V, long total) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;  // 4 values of the output
  if (idx >= total) return;
  const int dq = d / 4;
  const long t = idx / dq;
  const int c = (int)(idx % dq) * 4;
  const long b = t / L;
  const int l = (int)(t % L);
  const long base = b * R * L + l;
  float e[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < R; ++r) {
    const int v = tok[base + (long)r * L];
    if (v < V) {
      const float4 w = load_f4(wc + (long)(kSlot * r + v) * d + c);
      e[0] = __fadd_rn(e[0], w.x);
      e[1] = __fadd_rn(e[1], w.y);
      e[2] = __fadd_rn(e[2], w.z);
      e[3] = __fadd_rn(e[3], w.w);
    }
  }
  for (int r = 0; r < R; ++r) {
    const float qv = round_to<E>(quals[base + (long)r * L]);
    const float4 w = load_f4(wc + (long)(kSlot * r + V) * d + c);
    q[0] = fmaf(qv, w.x, q[0]);
    q[1] = fmaf(qv, w.y, q[1]);
    q[2] = fmaf(qv, w.z, q[2]);
    q[3] = fmaf(qv, w.w, q[3]);
  }
  const float4 cb4 = *reinterpret_cast<const float4*>(cb + c);
  const float bias[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = round_to<E>(__fadd_rn(__fadd_rn(e[i], q[i]), bias[i]));
  store4(out + t * d + c, y);
}

template <typename E>
int launch(const uint8_t* tok, const float* quals, const E* wc, const float* cb, E* out, int B,
           int R, int L, int d, int V, int kp, cudaStream_t stream) {
  if (B < 1 || L < 1 || R < 1 || R > 63 || V < 1 || V >= kSlot || kp < kSlot * R ||
      !d_model_ok(d))
    return (int)cudaErrorInvalidValue;
  const long total = (long)B * L * d / 4;
  const long blocks = (total + kThreads - 1) / kThreads;
  entry_embed_kernel<E><<<(unsigned)blocks, kThreads, 0, stream>>>(tok, quals, wc, cb, out, R,
                                                                    L, d, V, total);
  return (int)cudaGetLastError();
}

}  // namespace embed_simt
}  // namespace herro
