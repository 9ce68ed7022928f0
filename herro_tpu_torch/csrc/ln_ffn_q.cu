// K11: int8 LayerNorm + FFN + residual, the hidden kept on chip.
//
// Replaces herro_tpu/ops/fused.py:_ln_ffn_q_kernel (via _ln_ffn_q_pallas).
//   y  = bf16(LN(x)), quantized per row to int8
//   h  = gelu_tanh(bf16((float(y_i8 @ W1_i8) * s_row) * s1 + b1)), in bf16
//   h is quantized per row over the whole d_ff row
//   out = bf16(x + ((float(h_i8 @ W2_i8) * hs_row) * s2 + b2))
// Both weights arrive k-major (W1 as [f, d], W2 as [d, f]); b1, b2 are
// float32.
// Bound on the H100: operations (4*T*d*f) over the int8 tensor-core rate.
// Design: K3's (ln_ffn.cu) with int8 operands. A block owns BM token rows;
// the first product's epilogue writes the bf16 hidden [BM, f] into shared
// memory, because the second quantization needs the maximum of a whole
// hidden row, known only when all of it exists. Each row is then quantized
// in place: a warp finds the row's maximum, then walks it upwards in groups
// of 32 values, every lane reading its bf16 value before any lane writes an
// int8 one, the int8 row filling the first half of the bytes the bf16 row
// held (byte j of the int8 row overwrites bf16 value j/2, read one or more
// groups earlier). The row stride stays the bf16 one, whose odd multiple of
// 16 bytes keeps ldmatrix free of bank conflicts. So a block of 64 rows fits
// (d = 512, f = 1024: 186 KB) where an int8 copy beside the bf16 hidden
// would not; d_ff 1536 takes 32-row blocks. Both products run on mma.sync
// m16n8k32 (int8.cuh); dequantization, bias, gelu and the residual are
// applied to the accumulator fragments in registers.
#include "int8.cuh"

namespace herro {

__device__ inline float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

// per-row symmetric int8 of the bf16 rows h [n_rows][ldh], in place: row r's
// int8 values land at the start of its own bytes, its scale in hs_row[r]
__device__ inline void quant_rows_in_place(bf16* h, int ldh, int n_rows, int f,
                                           float* hs_row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n_rows; r += blockDim.x >> 5) {
    bf16* hr = h + (size_t)r * ldh;
    float m = 0.f;
    for (int c = lane; c < f; c += 32) m = fmaxf(m, fabsf(__bfloat162float(hr[c])));
    const float s = quant_scale(warp_max(m));
    int8_t* qr = reinterpret_cast<int8_t*>(hr);
    for (int c = lane; c < f; c += 32) {
      const float v = __bfloat162float(hr[c]);
      __syncwarp();  // every lane has read its value of this group
      qr[c] = (int8_t)quant(v, s);
      __syncwarp();  // and written it before the next group is read
    }
    if (lane == 0) hs_row[r] = s;
  }
}

// BM rows per block: warps form a (BM/16) x WN grid over a 128-column pass,
// each warp a 16 x (8*NT) tile.
template <int BM>
__global__ void __launch_bounds__(kThreads)
ln_ffn_q_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, const int8_t* __restrict__ w1t,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const int8_t* __restrict__ w2t, const float* __restrict__ s2,
                const float* __restrict__ b2, bf16* __restrict__ out, long T, int d,
                int f) {
  constexpr int WM = BM / 16, WN = 8 / WM, NT = kChunkN / WN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = d + kQPad, ldh = f + 8;
  const size_t off_h = align128((size_t)BM * ldq);
  const size_t off_r = off_h + align128((size_t)BM * ldh * 2);
  const size_t off_s = off_r + align128(2 * BM * sizeof(float));
  int8_t* yq = reinterpret_cast<int8_t*>(smem);
  bf16* h = reinterpret_cast<bf16*>(smem + off_h);
  float* s_row = reinterpret_cast<float*>(smem + off_r);
  float* hs_row = s_row + BM;
  int8_t* stage = reinterpret_cast<int8_t*>(smem + off_s);
  const long row0 = (long)blockIdx.x * BM;

  ln_quant_rows(x, ln_s, ln_b, row0, BM, T, d, yq, ldq, s_row);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int r_a = wm * 16 + g, r_b = r_a + 8;  // this thread's two rows
  const float sr_a = s_row[r_a], sr_b = s_row[r_b];

  for (int n0 = 0; n0 < f; n0 += kChunkN) {
    int acc[NT][4];
    zero(acc);
    block_gemm_q<NT>(acc, yq, ldq, wm * 16, w1t, n0, d, stage, wn);
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const int c = n0 + wn * NT * 8 + nn * 8 + 2 * t;
      const float sc0 = s1[c], sc1 = s1[c + 1], bb0 = b1[c], bb1 = b1[c + 1];
      *reinterpret_cast<bf162*>(h + (size_t)r_a * ldh + c) = __floats2bfloat162_rn(
          gelu_tanh(bf16_round(dequant(acc[nn][0], sr_a, sc0, bb0))),
          gelu_tanh(bf16_round(dequant(acc[nn][1], sr_a, sc1, bb1))));
      *reinterpret_cast<bf162*>(h + (size_t)r_b * ldh + c) = __floats2bfloat162_rn(
          gelu_tanh(bf16_round(dequant(acc[nn][2], sr_b, sc0, bb0))),
          gelu_tanh(bf16_round(dequant(acc[nn][3], sr_b, sc1, bb1))));
    }
  }
  __syncthreads();
  quant_rows_in_place(h, ldh, BM, f, hs_row);
  __syncthreads();

  const int8_t* hq = reinterpret_cast<const int8_t*>(h);
  const float hs_a = hs_row[r_a], hs_b = hs_row[r_b];
  for (int n0 = 0; n0 < d; n0 += kChunkN) {
    int acc[NT][4];
    zero(acc);
    block_gemm_q<NT>(acc, hq, ldh * 2, wm * 16, w2t, n0, f, stage, wn);
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const int c = n0 + wn * NT * 8 + nn * 8 + 2 * t;
      const float sc0 = s2[c], sc1 = s2[c + 1], bb0 = b2[c], bb1 = b2[c + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long row = row0 + (half ? r_b : r_a);
        if (row >= T) continue;
        const float hs = half ? hs_b : hs_a;
        const size_t o = (size_t)row * d + c;
        const float2 xr = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + o));
        *reinterpret_cast<bf162*>(out + o) = __floats2bfloat162_rn(
            __fadd_rn(xr.x, dequant(acc[nn][2 * half], hs, sc0, bb0)),
            __fadd_rn(xr.y, dequant(acc[nn][2 * half + 1], hs, sc1, bb1)));
      }
    }
  }
}

template <int BM>
size_t ffn_q_smem(int d, int f) {
  return align128((size_t)BM * (d + kQPad)) + align128((size_t)BM * (f + 8) * 2) +
         align128(2 * BM * sizeof(float)) + kQStageBytes;
}

template <int BM>
int launch_ffn_q(const void* x, const float* ln_s, const float* ln_b, const void* w1t,
                 const float* s1, const float* b1, const void* w2t, const float* s2,
                 const float* b2, void* out, long T, int d, int f, cudaStream_t stream) {
  const size_t smem = ffn_q_smem<BM>(d, f);
  int err = set_smem((const void*)ln_ffn_q_kernel<BM>, smem);
  if (err) return err;
  const unsigned grid = (unsigned)((T + BM - 1) / BM);
  ln_ffn_q_kernel<BM><<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, ln_s, ln_b, (const int8_t*)w1t, s1, b1, (const int8_t*)w2t, s2, b2,
      (bf16*)out, T, d, f);
  return (int)cudaGetLastError();
}

}  // namespace herro

extern "C" int herro_ln_ffn_q(const void* x, const float* ln_s, const float* ln_b,
                              const void* w1t, const float* s1, const float* b1,
                              const void* w2t, const float* s2, const float* b2, void* out,
                              long T, int d, int f, void* stream) {
  using namespace herro;
  if (d % kChunkN || f % kChunkN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ffn_q_smem<64>(d, f) <= (size_t)kMaxSmem)
    return launch_ffn_q<64>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, out, T, d, f, s);
  return launch_ffn_q<32>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, out, T, d, f, s);
}
