// K4: pileup tokens + quals -> the d_model stream, one pass.
//
// Replaces herro_tpu/ops/fused.py:_entry_embed_kernel (via _entry_embed_pallas).
// out[t, :] = bf16( sum_r onehot(tok[r, t]) . E_r + sum_r bf16(qual[r, t]) wq_r + cb )
// As on the TPU, this is one product on the matrix units: per token row the
// feature vector concat_r(onehot_r (V wide), bf16(qual_r)) of width R*(V+1)
// (403, padded to Kp = 416) times the col_proj table Wc [Kp, d] (rows
// r*(V+1)+v, zero padding rows; fused.col_proj_table, built once per weight
// state). The one-hot never reaches device memory. The sums are exact
// products of bf16 values accumulated in float32, as the Pallas kernel's are.
// Bound on the H100: bytes (tokens 1 B + quals 4 B per row and pileup
// column, the [B, L, d] bf16 output: 0.35 GB, 0.10 ms at B=32, L=9216). The
// function's own work is one multiply-add over d per nonzero of the
// one-hot|qual rows; the dense product also multiplies the zeros, 2*T*Kp*d =
// 1.3e11 tensor-core FLOPs, 0.13 ms at peak, so this formulation cannot reach
// the bytes bound. Design: a block owns 128 token rows; it
// writes their one-hot/qual rows into a shared [128, Kp] bf16 tile (each
// thread a (row, pileup row) pair, so the global reads are coalesced along
// the column axis), then runs the shared mma.sync block product against Wc
// chunks staged by cp.async, 8 warps of 16 rows, and adds the bias to the
// accumulator fragments in registers.
#include "common.cuh"

namespace herro {

constexpr int kRows = 128;  // token rows per block: 8 warps x 16

inline size_t embed_smem(int kp) { return align128((size_t)kRows * (kp + 8) * 2) + kStageBytes; }

__global__ void __launch_bounds__(kThreads)
entry_embed_kernel(const uint8_t* __restrict__ tok, const float* __restrict__ quals,
                   const bf16* __restrict__ wc,  // [Kp, d]
                   const float* __restrict__ cb, bf16* __restrict__ out, int B, int R,
                   int L, int d, int V, int kp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = kp + 8, w = V + 1;
  bf16* a = reinterpret_cast<bf16*>(smem);
  bf16* stage = reinterpret_cast<bf16*>(smem + align128((size_t)kRows * lda * 2));
  const long T = (long)B * L;
  const long row0 = (long)blockIdx.x * kRows;
  const bf16 one = __float2bfloat16(1.f), zero_bf = __float2bfloat16(0.f);

  for (int e = threadIdx.x; e < kRows * R; e += blockDim.x) {
    const int rr = e % kRows, r = e / kRows;  // consecutive threads: consecutive tokens
    const long row = row0 + rr;
    int t = V;  // out of vocab: an all-zero one-hot
    float qv = 0.f;
    if (row < T) {
      const long b = row / L, l = row % L;
      const size_t i = ((size_t)b * R + r) * L + l;
      t = tok[i];
      qv = quals[i];
    }
    bf16* dst = a + (size_t)rr * lda + r * w;
    for (int v = 0; v < V; ++v) dst[v] = v == t ? one : zero_bf;
    dst[V] = __float2bfloat16(qv);
  }
  for (int e = threadIdx.x; e < kRows * (kp - R * w); e += blockDim.x) {
    const int rr = e / (kp - R * w), c = R * w + e % (kp - R * w);
    a[(size_t)rr * lda + c] = zero_bf;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  for (int n0 = 0; n0 < d; n0 += kChunkN) {
    float acc[kChunkN / 8][4];
    zero(acc);
    block_gemm<kChunkN / 8>(acc, a, lda, warp * 16, wc, d, n0, kp, stage, 0);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long row = row0 + warp * 16 + g + 8 * rr;
      if (row >= T) continue;
#pragma unroll
      for (int nn = 0; nn < kChunkN / 8; ++nn) {
        const int c = n0 + nn * 8 + 2 * t4;
        *reinterpret_cast<bf162*>(out + (size_t)row * d + c) = __floats2bfloat162_rn(
            acc[nn][2 * rr] + cb[c], acc[nn][2 * rr + 1] + cb[c + 1]);
      }
    }
  }
}

}  // namespace herro

extern "C" int herro_entry_embed(const uint8_t* tok, const float* quals, const void* wc,
                                 const float* cb, void* out, int B, int R, int L, int d,
                                 int V, int kp, void* stream) {
  using namespace herro;
  if (kp % kChunkK || kp < R * (V + 1) || d % kChunkN) return (int)cudaErrorInvalidValue;
  const size_t smem = embed_smem(kp);
  int err = set_smem((const void*)entry_embed_kernel, smem);
  if (err) return err;
  const long T = (long)B * L;
  const unsigned grid = (unsigned)((T + kRows - 1) / kRows);
  entry_embed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      tok, quals, (const bf16*)wc, cb, (bf16*)out, B, R, L, d, V, kp);
  return (int)cudaGetLastError();
}
