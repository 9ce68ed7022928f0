// K10: int8 LayerNorm + qkv projection + rotary epilogue, q/k/v per head.
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_q_kernel (via
// _ln_qkv_rope_q_pallas).
// y = bf16(LN(x)) is quantized per row to int8, multiplied with the int8
// weight into int32, and qkv = bf16((float(acc) * s_row) * s_col + b); q and
// k then take the rotate-half rope at the absolute column index (tables built
// in the kernel, rope.cuh) and are rounded again; v passes through. Outputs
// are [B, H, L, D] with D = 128. The weight arrives k-major ([3*H*D, d]).
// Bound on the H100: bytes (x read once, q/k/v written once: 4*T*d*2 at
// 3*H*D = 3*d) over the memory rate; the int8 tensor-core rate puts the
// operations (2*T*d*3*H*D) below that.
// Design: K1's tiling with int8 operands. A block owns 128 token rows; each
// warp normalises and quantizes rows into shared memory (int8 rows, one
// float scale a row: 67 KB at d = 512 where K1 holds 133 KB of bf16), the
// block builds its rope tables once, then walks the 3*H column blocks of 128
// on mma.sync m16n8k32 (int8.cuh), each of the 8 warps owning 16 rows across
// the whole head, so the rope pair (i, i + D/2) of a row sits in one thread's
// accumulators and the dequantization, the bias, both bf16 roundings and the
// rotation happen in registers.
#include "int8.cuh"
#include "rope.cuh"

namespace herro {

constexpr int kD = 128;           // head dim (every shipped checkpoint)
constexpr int kRows = kRopeRows;  // token rows per block: 8 warps x 16

inline size_t qkv_q_smem(int d) {
  return align128((size_t)kRows * (d + kQPad)) + align128(kRows * sizeof(float)) +
         kRopeBytes + kQStageBytes;
}

__global__ void __launch_bounds__(kThreads)
ln_qkv_rope_q_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, const int8_t* __restrict__ wt,
                     const float* __restrict__ s_col, const bf16* __restrict__ bias,
                     bf16* __restrict__ q, bf16* __restrict__ k, bf16* __restrict__ v,
                     int B, int L, int d, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = d + kQPad;
  const size_t off_s = align128((size_t)kRows * ldq);
  const size_t off_rope = off_s + align128(kRows * sizeof(float));
  int8_t* yq = reinterpret_cast<int8_t*>(smem);
  float* s_row = reinterpret_cast<float*>(smem + off_s);
  float* cos_s = reinterpret_cast<float*>(smem + off_rope);
  float* sin_s = cos_s + kRows * kRopeLd;
  int8_t* stage = reinterpret_cast<int8_t*>(smem + off_rope + kRopeBytes);
  const long T = (long)B * L;
  const long row0 = (long)blockIdx.x * kRows;

  ln_quant_rows(x, ln_s, ln_b, row0, kRows, T, d, yq, ldq, s_row);
  build_rope_tables(row0, L, cos_s, sin_s);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int half = kD / 2;
  for (int j = 0; j < 3 * H; ++j) {
    const int n0 = j * kD;
    int acc[kD / 8][4];
    zero(acc);
    block_gemm_q<kD / 8>(acc, yq, ldq, warp * 16, wt, n0, d, stage, 0);

    const int part = j / H, h = j % H;  // (3, H, D) c-major column blocks
    bf16* dst = part == 0 ? q : (part == 1 ? k : v);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // rows g and g + 8 of the warp's strip
      const int r = warp * 16 + g + 8 * rr;
      const long row = row0 + r;
      if (row >= T) continue;
      const long b = row / L, l = row % L;
      const float sr = s_row[r];
      bf16* o = dst + (((size_t)b * H + h) * L + l) * kD;
#pragma unroll
      for (int nn = 0; nn < half / 8; ++nn) {
        const int c = nn * 8 + 2 * t;  // first-half column; its pair is c + D/2
        float o1[2], o2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c1 = n0 + c + e, c2 = c1 + half;
          o1[e] = bf16_round(
              dequant(acc[nn][2 * rr + e], sr, s_col[c1], __bfloat162float(bias[c1])));
          o2[e] = bf16_round(dequant(acc[nn + half / 8][2 * rr + e], sr, s_col[c2],
                                     __bfloat162float(bias[c2])));
        }
        if (part < 2) {
          const float2 cs = *reinterpret_cast<const float2*>(cos_s + r * kRopeLd + c);
          const float2 sn = *reinterpret_cast<const float2*>(sin_s + r * kRopeLd + c);
          rope_rotate(o1[0], o2[0], cs.x, sn.x, o1[0], o2[0]);
          rope_rotate(o1[1], o2[1], cs.y, sn.y, o1[1], o2[1]);
        }
        *reinterpret_cast<bf162*>(o + c) = __floats2bfloat162_rn(o1[0], o1[1]);
        *reinterpret_cast<bf162*>(o + half + c) = __floats2bfloat162_rn(o2[0], o2[1]);
      }
    }
  }
}

}  // namespace herro

extern "C" int herro_ln_qkv_rope_q(const void* x, const float* ln_s, const float* ln_b,
                                   const void* wt, const float* s_col, const void* b,
                                   void* q, void* k, void* v, int B, int L, int d, int H,
                                   void* stream) {
  using namespace herro;
  if (d % kQChunkK) return (int)cudaErrorInvalidValue;
  const size_t smem = qkv_q_smem(d);
  int err = set_smem((const void*)ln_qkv_rope_q_kernel, smem);
  if (err) return err;
  const long T = (long)B * L;
  const unsigned grid = (unsigned)((T + kRows - 1) / kRows);
  ln_qkv_rope_q_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, ln_s, ln_b, (const int8_t*)wt, s_col, (const bf16*)b, (bf16*)q,
      (bf16*)k, (bf16*)v, B, L, d, H);
  return (int)cudaGetLastError();
}
