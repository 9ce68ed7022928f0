// K1: LayerNorm + qkv projection + rotary epilogue, q/k/v written per head.
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_tbl_kernel (via
// _ln_qkv_rope_pallas, tables from _rope_tables_full).
// qkv = bf16(LN(x) @ W + b); q and k then take the rotate-half rope at the
// absolute column index in float32 and are rounded again; v passes through.
// Outputs are [B, H, L, D] with D = 128.
// Bound on the H100: operations (2*T*d*3*H*D, 4.6e11 at B=32, L=9216, d=512)
// over the bf16 tensor-core rate. Design: a block owns 128 token rows and
// normalises them once into shared memory (bf16, the matmul operand), then
// walks the 3*H column blocks of W; each block of 128 columns is one head of
// one of q/k/v. Each of the 8 warps owns 16 rows across all 128 columns, so
// the rope pair (i, i + D/2) of a row sits in one thread's accumulator
// fragments and is rotated in registers; the products run on the tensor
// cores (mma.sync m16n8k16, W in 32 x 128 chunks double-buffered by
// cp.async), and each row leaves as contiguous bf16 pairs of a head row.
#include "common.cuh"

namespace herro {

constexpr int kD = 128;    // head dim (every shipped checkpoint)
constexpr int kRows = 128;  // token rows per block: 8 warps x 16

inline size_t qkv_smem(int d) { return align128((size_t)kRows * (d + 8) * 2) + kStageBytes; }

__global__ void __launch_bounds__(kThreads)
ln_qkv_rope_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, bf16* __restrict__ q,
                   bf16* __restrict__ k, bf16* __restrict__ v, int B, int L, int d,
                   int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = d + 8;
  bf16* y = reinterpret_cast<bf16*>(smem);
  bf16* stage = reinterpret_cast<bf16*>(smem + align128((size_t)kRows * ldy * 2));
  const long T = (long)B * L;
  const long row0 = (long)blockIdx.x * kRows;
  const int N = 3 * H * kD;

  layernorm_rows(x, ln_s, ln_b, row0, kRows, T, d, y, ldy);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int half = kD / 2;
  for (int j = 0; j < 3 * H; ++j) {
    const int n0 = j * kD;
    float acc[kD / 8][4];
    zero(acc);
    block_gemm<kD / 8>(acc, y, ldy, warp * 16, w, N, n0, d, stage, 0);

    const int part = j / H, h = j % H;  // (3, H, D) c-major column blocks
    bf16* dst = part == 0 ? q : (part == 1 ? k : v);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // rows g and g + 8 of the warp's strip
      const long row = row0 + warp * 16 + g + 8 * rr;
      if (row >= T) continue;
      const long b = row / L, l = row % L;
      bf16* o = dst + (((size_t)b * H + h) * L + l) * kD;
#pragma unroll
      for (int nn = 0; nn < half / 8; ++nn) {
        const int c = nn * 8 + 2 * t;  // first-half column; its pair is c + D/2
        float o1[2], o2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x1 =
              bf16_round(acc[nn][2 * rr + e] + __bfloat162float(bias[n0 + c + e]));
          const float x2 = bf16_round(acc[nn + half / 8][2 * rr + e] +
                                      __bfloat162float(bias[n0 + half + c + e]));
          o1[e] = x1;
          o2[e] = x2;
          if (part < 2) {
            const float cs = cos_t[l * half + c + e], sn = sin_t[l * half + c + e];
            // explicit roundings: no fused multiply-add, as the reference
            o1[e] = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
            o2[e] = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
          }
        }
        *reinterpret_cast<bf162*>(o + c) = __floats2bfloat162_rn(o1[0], o1[1]);
        *reinterpret_cast<bf162*>(o + half + c) = __floats2bfloat162_rn(o2[0], o2[1]);
      }
    }
  }
}

}  // namespace herro

extern "C" int herro_ln_qkv_rope(const void* x, const float* ln_s, const float* ln_b,
                                 const void* w, const void* b, const float* cos_t,
                                 const float* sin_t, void* q, void* k, void* v, int B,
                                 int L, int d, int H, void* stream) {
  using namespace herro;
  if (d % kChunkK) return (int)cudaErrorInvalidValue;
  const size_t smem = qkv_smem(d);
  int err = set_smem((const void*)ln_qkv_rope_kernel, smem);
  if (err) return err;
  const long T = (long)B * L;
  const unsigned grid = (unsigned)((T + kRows - 1) / kRows);
  ln_qkv_rope_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, ln_s, ln_b, (const bf16*)w, (const bf16*)b, cos_t, sin_t,
      (bf16*)q, (bf16*)k, (bf16*)v, B, L, d, H);
  return (int)cudaGetLastError();
}
