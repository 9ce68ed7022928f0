// K3: LayerNorm + FFN + residual, the hidden kept on chip.
//
// Replaces herro_tpu/ops/fused.py:_ln_ffn_kernel (via _ln_ffn_pallas).
// out = bf16(x + (h @ W2 + b2)),  h = bf16(gelu_tanh(bf16(LN(x) @ W1 + b1))).
// Bound on the H100: operations (4*T*d*f, 6.2e11 at T=294,912, d=512,
// f=1024) over the bf16 tensor-core rate. Design: a block owns BM token rows;
// their LayerNorm (bf16) and their whole [BM, f] hidden live in shared memory,
// so device memory sees x once, the weights once per block (from L2), and
// the output once. Both products run on the tensor cores (mma.sync m16n8k16,
// A by ldmatrix from the resident rows, B in 32 x 128 chunks double-buffered
// by cp.async); each warp owns a 16-row strip and applies bias, gelu and the
// residual to its accumulator fragments in registers. BM is 64 when the
// hidden fits (d=512, f=1024: 216 KB), else 32.
#include "common.cuh"

namespace herro {

__device__ inline float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

// BM rows per block: warps form a (BM/16) x WN grid over a 128-column pass,
// each warp a 16 x (8*NT) tile.
template <int BM>
__global__ void __launch_bounds__(kThreads)
ln_ffn_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
              const float* __restrict__ ln_b, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ b2, bf16* __restrict__ out, long T, int d,
              int f) {
  constexpr int WM = BM / 16, WN = 8 / WM, NT = kChunkN / WN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = d + 8, ldh = f + 8;
  bf16* y = reinterpret_cast<bf16*>(smem);
  const size_t off_h = align128((size_t)BM * ldy * 2);
  const size_t off_s = off_h + align128((size_t)BM * ldh * 2);
  bf16* h = reinterpret_cast<bf16*>(smem + off_h);
  bf16* stage = reinterpret_cast<bf16*>(smem + off_s);
  const long row0 = (long)blockIdx.x * BM;

  layernorm_rows(x, ln_s, ln_b, row0, BM, T, d, y, ldy);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int r_a = wm * 16 + g, r_b = r_a + 8;  // this thread's two rows

  for (int n0 = 0; n0 < f; n0 += kChunkN) {
    float acc[NT][4];
    zero(acc);
    block_gemm<NT>(acc, y, ldy, wm * 16, w1, f, n0, d, stage, wn);
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const int c = n0 + wn * NT * 8 + nn * 8 + 2 * t;
      const float bb0 = __bfloat162float(b1[c]), bb1 = __bfloat162float(b1[c + 1]);
      *reinterpret_cast<bf162*>(h + (size_t)r_a * ldh + c) = __floats2bfloat162_rn(
          gelu_tanh(bf16_round(acc[nn][0] + bb0)), gelu_tanh(bf16_round(acc[nn][1] + bb1)));
      *reinterpret_cast<bf162*>(h + (size_t)r_b * ldh + c) = __floats2bfloat162_rn(
          gelu_tanh(bf16_round(acc[nn][2] + bb0)), gelu_tanh(bf16_round(acc[nn][3] + bb1)));
    }
  }
  __syncthreads();

  for (int n0 = 0; n0 < d; n0 += kChunkN) {
    float acc[NT][4];
    zero(acc);
    block_gemm<NT>(acc, h, ldh, wm * 16, w2, d, n0, f, stage, wn);
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const int c = n0 + wn * NT * 8 + nn * 8 + 2 * t;
      const float bb0 = __bfloat162float(b2[c]), bb1 = __bfloat162float(b2[c + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long row = row0 + (half ? r_b : r_a);
        if (row >= T) continue;
        const size_t o = (size_t)row * d + c;
        const float2 xr = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + o));
        *reinterpret_cast<bf162*>(out + o) =
            __floats2bfloat162_rn(xr.x + (acc[nn][2 * half] + bb0),
                                  xr.y + (acc[nn][2 * half + 1] + bb1));
      }
    }
  }
}

template <int BM>
size_t ffn_smem(int d, int f) {
  return align128((size_t)BM * (d + 8) * 2) + align128((size_t)BM * (f + 8) * 2) +
         kStageBytes;
}

template <int BM>
int launch_ffn(const void* x, const float* ln_s, const float* ln_b, const void* w1,
               const void* b1, const void* w2, const void* b2, void* out, long T, int d,
               int f, cudaStream_t stream) {
  const size_t smem = ffn_smem<BM>(d, f);
  int err = set_smem((const void*)ln_ffn_kernel<BM>, smem);
  if (err) return err;
  const unsigned grid = (unsigned)((T + BM - 1) / BM);
  ln_ffn_kernel<BM><<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, ln_s, ln_b, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
      (const bf16*)b2, (bf16*)out, T, d, f);
  return (int)cudaGetLastError();
}

}  // namespace herro

extern "C" int herro_ln_ffn(const void* x, const float* ln_s, const float* ln_b,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, long T, int d, int f, void* stream) {
  using namespace herro;
  if (d % kChunkN || f % kChunkN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ffn_smem<64>(d, f) <= (size_t)kMaxSmem)
    return launch_ffn<64>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, d, f, s);
  return launch_ffn<32>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, d, f, s);
}
