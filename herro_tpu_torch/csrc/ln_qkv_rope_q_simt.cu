// K10 on the CUDA cores: int8 LayerNorm + qkv projection + rotary, for
// float32 or bf16 activations at any width the float32 kernels take.
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_q_kernel (via
// _ln_qkv_rope_q_pallas) where the Hopper instance (ln_qkv_rope_q.cu: int8
// wgmma, bf16, d 256 or 512, D 128) does not reach: float32 checkpoints,
// TINY_CONFIG (d 32, H 2 x D 16) and its tensor-parallel shards, d 384.
//   y = E(LN(x)) quantized per row;  qkv = E((float(y_i8 @ W_i8) * s_row) * s_col + b)
//   q, k: rotate-half rope at the absolute column l, rounded to E; v as it is
// -> q, k, v [B, H, L, D] of x's type E; W k-major ([3HD, d]), b of type E.
//
// Bound on the H100: operations, 2 T d 3HD int8 operations on __dp4a,
// against the CUDA cores' integer rate (at r10's widths, 4.6e11: about 3.5
// ms at B=32, L=9216), above the bytes (x read, q/k/v written).
// Design: int8_simt.cuh's tile product with A resident. A block takes 128
// token rows: LayerNorm and the row quantization once (a warp a row), the
// int8 rows staying in shared memory (at most 64 KB at d 512), then walks
// the 3HD output columns in tiles of 128 (64 where qkv has no more),
// streaming W's stages (L2-resident: 0.8 MB at r10) past them. Each tile's
// epilogue dequantizes, adds b and rounds, then takes each value's rope
// partner (column dd +- D/2 of its head) from the thread's other column
// group at D 128 or by a shuffle D/8 lanes away below, as
// ln_qkv_rope_f32.cu does, with the rope tables handed in (the plain
// version's rope_tables, the same bits).
#include "int8_simt.cuh"

namespace herro {
namespace qkv_simt8 {

using namespace simt8;

template <typename E, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    ln_qkv_rope_q_simt_kernel(const E* __restrict__ x, const float* __restrict__ ln_s,
                              const float* __restrict__ ln_b, const int8_t* __restrict__ wt,
                              const float* __restrict__ s_col, const E* __restrict__ b,
                              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                              E* __restrict__ q, E* __restrict__ k, E* __restrict__ v, int B,
                              int L, int d, int H, int D) {
  extern __shared__ __align__(16) int smem[];
  int* As = smem;
  int* Bs = As + (d / 4) * kApad;
  float* srow = reinterpret_cast<float*>(Bs + 2 * b_stage_words(BN));
  const long rows = (long)B * L;
  const int N = 3 * H * D, HD = H * D, half = D / 2;
  const long r0 = (long)blockIdx.x * kBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  ln_quant_rows<E>(x, rows, d, r0, ln_s, ln_b, As, srow);
  __syncthreads();
  for (int n0 = 0; n0 < N; n0 += BN) {
    int acc[8][BN / 16];
    product_resident_a<BN>(acc, As, wt, d, N, n0, Bs);
    float val[8][BN / 16];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int n = n0 + tile_col(tx, j);
      const float sc = n < N ? s_col[n] : 0.f, bj = n < N ? to_f(b[n]) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        val[i][j] = round_to<E>(dequant(acc[i][j], srow[tile_row(ty, i)], sc, bj));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long row = r0 + tile_row(ty, i);
      const long bb = row / L;
      const int l = (int)(row % L);
      // cos/sin of the thread's 4 frequencies at column l; its second
      // column group (64 further, and D divides 64 or is 128) has the same
      float cs[4], sn[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = (n0 + tile_col(tx, e)) % D % half;
        cs[e] = cos_t[(long)l * half + ri];
        sn[e] = sin_t[(long)l * half + ri];
      }
#pragma unroll
      for (int g = 0; g < BN / 64; ++g) {
        float out[4], other[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // every lane takes part in the shuffle
          out[e] = val[i][4 * g + e];
          other[e] = D == 128 ? val[i][(4 * (g ^ 1) + e) % (BN / 16)]
                              : __shfl_xor_sync(0xffffffffu, out[e], D / 8);
        }
        const int n = n0 + tile_col(tx, 4 * g);
        if (row >= rows || n >= N) continue;  // four columns of one head, in or out together
        const int which = n / HD, h = (n % HD) / D, dd0 = n % D;
        if (which < 2) {
          // x1 * cos - x2 * sin for the first half, x2 * cos + x1 * sin for the second
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out[e] = round_to<E>(
                dd0 + e < half ? __fsub_rn(__fmul_rn(out[e], cs[e]), __fmul_rn(other[e], sn[e]))
                               : __fadd_rn(__fmul_rn(out[e], cs[e]), __fmul_rn(other[e], sn[e])));
        }
        E* dst = which == 0 ? q : which == 1 ? k : v;
        store4(dst + ((bb * H + h) * L + l) * D + dd0, out);
      }
    }
  }
}

template <typename E, int BN>
int launch_bn(const void* x, const float* ln_s, const float* ln_b, const void* wt,
              const float* s_col, const void* b, const float* cos_t, const float* sin_t,
              void* q, void* k, void* v, int B, int L, int d, int H, int D,
              cudaStream_t stream) {
  auto kernel = ln_qkv_rope_q_simt_kernel<E, BN>;
  const size_t smem = resident_smem(d, BN, 1);
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  const long rows = (long)B * L;
  kernel<<<(unsigned)((rows + kBM - 1) / kBM), kThreads, smem, stream>>>(
      (const E*)x, ln_s, ln_b, (const int8_t*)wt, s_col, (const E*)b, cos_t, sin_t, (E*)q,
      (E*)k, (E*)v, B, L, d, H, D);
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const void* x, const float* ln_s, const float* ln_b, const void* wt,
           const float* s_col, const void* b, const float* cos_t, const float* sin_t, void* q,
           void* k, void* v, int B, int L, int d, int H, int D, cudaStream_t stream) {
  if (f32::tile_width(3 * H * D) == 64)  // D <= 16 at H 1: whole heads in a tile of 64
    return launch_bn<E, 64>(x, ln_s, ln_b, wt, s_col, b, cos_t, sin_t, q, k, v, B, L, d, H, D,
                            stream);
  return launch_bn<E, 128>(x, ln_s, ln_b, wt, s_col, b, cos_t, sin_t, q, k, v, B, L, d, H, D,
                           stream);
}

}  // namespace qkv_simt8
}  // namespace herro

// x, b, q, k, v bf16 when `is_bf16` is set, float32 otherwise; cos/sin the
// [L, D/2] float32 rope tables
extern "C" int herro_ln_qkv_rope_q_simt(const void* x, const float* ln_s, const float* ln_b,
                                        const void* wt, const float* s_col, const void* b,
                                        const float* cos_t, const float* sin_t, void* q,
                                        void* k, void* v, int B, int L, int d, int H, int D,
                                        int is_bf16, void* stream) {
  using namespace herro;
  if (B < 1 || L < 1 || H < 1 || !f32::d_model_ok(d) || !f32::head_dim_ok(D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return qkv_simt8::launch<bf16>(x, ln_s, ln_b, wt, s_col, b, cos_t, sin_t, q, k, v, B, L, d,
                                   H, D, s);
  return qkv_simt8::launch<float>(x, ln_s, ln_b, wt, s_col, b, cos_t, sin_t, q, k, v, B, L, d,
                                  H, D, s);
}
