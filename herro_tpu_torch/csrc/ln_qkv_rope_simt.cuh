// K1 and K8 on the tensor cores (mma.sync), for float32 configs and for
// bf16 at head dims or widths the Hopper instances (ln_qkv_rope_sm90.cuh: D
// 128, d 256, 384 or 512) lack: LayerNorm + qkv projection + rope. Entry
// points: ln_qkv_rope_f32.cu (float32), ln_qkv_rope_bf16.cu (bf16), each
// with the table route (K1) and the split route (K8).
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_tbl_kernel (K1, rope tables
// handed in) and _ln_qkv_rope_kernel (K8, tables built in the kernel,
// HERRO_TPU_ROPE=split) for any head dim D a multiple of 16 from 16 to 128
// and d_model a multiple of 32 up to 1024:
//   qkv = E(E(LN(x)) @ W + b)   (x [B, L, d], W [d, 3HD] in (3, H, D) c-major order)
//   q, k: E(rotate-half rope at the absolute column l); v as it is
// -> q, k, v [B, H, L, D] of the storage type E (float: every E() the identity).
//
// Bound on the H100: the products, 2 T d 3HD operations at the bf16 peak or
// as three TF32 products in float32 (gemm_tc.cuh; at r10's widths in
// float32, 4.6e11: 2.8 ms at B=32, L=9216), above the bytes.
// Design: LayerNorm(x) into a [B L, d] scratch (gemm_tc.cuh's layernorm),
// then gemm_tc.cuh's tile product, a block 64 token rows and each tile of
// columns of qkv in turn: at D 16, 32 and 64 tiles of 128 columns (64
// where qkv has no more), a warp 32 rows x 64 columns, whole heads; at D 48,
// 80, 96, 112 and 128 tiles of one head, D columns, a warp 16 rows x the
// whole head (warp_rows). So the rope's partner of a column, D/2 away in its
// head, is always in the same thread's C fragments, at D 96 as at D 128:
// no exchange through shared memory and no barrier after the product, at
// the cost of every warp reading the whole of W's stage (4 x its bytes of
// shared memory a stage, as D 128 already did). The block first stages cos/sin of its
// rows at each frequency in shared memory beside the stages: the table
// route copies its rows of the tables, the split route builds them with the
// full-range expf/cosf/sinf of the plain version's rope_tables (freq_i =
// exp(-ln(10000) i / (D/2)), the division correctly rounded on both sides:
// rope_tables divides by a tensor, which the card does not turn into a
// product by the reciprocal): both routes give the same bits. The epilogue works on the C
// fragments in registers: + bias rounded to E, then each q/k value's rope
// partner (column dd +- D/2 of its head) is the same thread's fragment D/16
// fragments away (a warp's sub-tile holds whole heads), the rope's two
// products and one sum rounded as the plain version rounds them, two
// columns of a head row stored at once. At d 32 (TINY_CONFIG and its
// shards) K1/K8 take narrow.cuh's kernel, which calls qkv_bias below too.
#pragma once

#include "gemm_tc.cuh"

namespace herro {
namespace qkv_simt {

using namespace f32;
using gemm_tc::Acc;
using gemm_tc::Tile;

// qkv's value plus its bias, rounded to E as the plain version rounds it
template <typename E>
__device__ inline float qkv_bias(float a, float b) {
  return round_to<E>(__fadd_rn(a, b));
}

// a warp's rows: 32 where whole heads fill a warp's 64 columns (D 16, 32,
// 64), else 16, a head the whole tile (its D columns in one warp's
// fragments)
template <int D>
__host__ __device__ constexpr int warp_rows() {
  return 64 % D == 0 ? 32 : 16;
}

// the dynamic shared memory of an instance: the stages, then cos/sin of
// the block's rows at D/2 frequencies
template <typename E, int BN, int D>
constexpr int smem_bytes() {
  return Tile<E, BN, warp_rows<D>()>::kSmem +
         2 * gemm_tc::kRowsT * (D / 2) * (int)sizeof(float);
}

template <typename E, bool kTables, int BN, int D>
__global__ void __launch_bounds__(gemm_tc::kTileThreads, gemm_tc::kMinBlocks<E>)
    ln_qkv_rope_kernel(const E* __restrict__ y, const E* __restrict__ w,
                       const E* __restrict__ b, const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t, E* __restrict__ q, E* __restrict__ k,
                       E* __restrict__ v, int B, int L, int d, int H) {
  constexpr int WM = warp_rows<D>(), half = D / 2;
  using Tl = Tile<E, BN, WM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long T = (long)B * L;
  const int N = 3 * H * D;
  const long r0 = (long)blockIdx.x * gemm_tc::kRowsT;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = gemm_tc::warp_row<BN, WM>(), wc = gemm_tc::warp_col<BN, WM>();
  // cos/sin of the tile's row r at frequency i, [r * half + i]: the table
  // route's rows of its tables, or the split route's built here
  float* const cs_s = reinterpret_cast<float*>(smem_raw + Tl::kSmem);
  float* const sn_s = cs_s + gemm_tc::kRowsT * half;
  for (int e = tid; e < gemm_tc::kRowsT * half; e += gemm_tc::kTileThreads) {
    const int ri = e % half, l = (int)((r0 + e / half) % L);
    if constexpr (kTables) {
      cs_s[e] = cos_t[(long)l * half + ri];
      sn_s[e] = sin_t[(long)l * half + ri];
    } else {
      const float freq =
          expf(__fdiv_rn(__fmul_rn(-9.210340371976184f, (float)ri), (float)half));
      const float ang = __fmul_rn((float)l, freq);
      cs_s[e] = cosf(ang);
      sn_s[e] = sinf(ang);
    }
  }
  // each of the thread's rows (wr + 16 mt + g + 8 hf): the offset of (b,
  // head 0, l) in q/k/v, -1 past T
  constexpr int kRows = 2 * Tl::kMT;
  long base[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long row = r0 + wr + 16 * (i / 2) + g + 8 * (i % 2);
    base[i] = row < T ? ((row / L) * H * L + row % L) * D : -1;
  }
  __syncthreads();
  gemm_tc::product<E, BN, WM>(
      y, T, d, w, N, r0, reinterpret_cast<E*>(smem_raw), [&](int n0, Acc<E, BN, WM>& acc) {
#pragma unroll
        for (int nt = 0; nt < Tl::kNT; ++nt) {
          const int n = n0 + wc + 8 * nt + 2 * t;  // columns n, n + 1 of one head
          if (n >= N) continue;
          // + bias, rounded to E, every value (the rope's partner too)
          const float b0 = to_f(b[n]), b1 = to_f(b[n + 1]);
#pragma unroll
          for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] = qkv_bias<E>(acc[mt][nt][e], e & 1 ? b1 : b0);
        }
#pragma unroll
        for (int nt = 0; nt < Tl::kNT; ++nt) {
          const int n = n0 + wc + 8 * nt + 2 * t;
          if (n >= N) continue;
          const int head = n / D, which = head / H;  // q, k or v of head h
          E* const out =
              (which == 0 ? q : which == 1 ? k : v) + (long)(head - which * H) * L * D;
          // the head's dims dd0, dd0 + 1; the first half's partner is D/16
          // fragments on, the second half's D/16 back (the sub-tile holds
          // whole heads, so both lie in this thread's fragments; nt, and
          // with it the partner's index, is a constant of the unrolled loop)
          const int dims = 8 * nt % D;  // the fragment's first dim in its head
          const bool first = dims < half;
          const int np = first ? nt + half / 8 : nt - half / 8;
          const int dd0 = dims + 2 * t, ri = dd0 % half;
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (base[i] < 0) continue;  // a row past T
            const int mt = i / 2, hf = i % 2;
            float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
            if (which < 2) {
              const float o0 = acc[mt][np][2 * hf], o1 = acc[mt][np][2 * hf + 1];
              const int rl = wr + 16 * mt + g + 8 * hf;  // the row in the tile
              const float2 c2 = *reinterpret_cast<const float2*>(cs_s + rl * half + ri);
              const float2 s2 = *reinterpret_cast<const float2*>(sn_s + rl * half + ri);
              // x1 * cos - x2 * sin for the first half, x2 * cos + x1 * sin
              // for the second
              if (first) {
                v0 = round_to<E>(__fsub_rn(__fmul_rn(v0, c2.x), __fmul_rn(o0, s2.x)));
                v1 = round_to<E>(__fsub_rn(__fmul_rn(v1, c2.y), __fmul_rn(o1, s2.y)));
              } else {
                v0 = round_to<E>(__fadd_rn(__fmul_rn(v0, c2.x), __fmul_rn(o0, s2.x)));
                v1 = round_to<E>(__fadd_rn(__fmul_rn(v1, c2.y), __fmul_rn(o1, s2.y)));
              }
            }
            store2(out + base[i] + dd0, v0, v1);
          }
        }
      });
}

template <typename E, bool kTables, int BN, int D>
int launch_d(const E* y, const E* w, const E* b, const float* cos_t, const float* sin_t, E* q,
             E* k, E* v, int B, int L, int d, int H, cudaStream_t stream) {
  constexpr int smem = smem_bytes<E, BN, D>();
  const void* kernel = (const void*)ln_qkv_rope_kernel<E, kTables, BN, D>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  ln_qkv_rope_kernel<E, kTables, BN, D>
      <<<gemm_tc::row_tiles((long)B * L), gemm_tc::kTileThreads, smem, stream>>>(
          y, w, b, cos_t, sin_t, q, k, v, B, L, d, H);
  return (int)cudaGetLastError();
}

// the product and the rope on the tensor cores, LayerNorm(x) in y
template <typename E, bool kTables>
int launch_tc(const E* y, const E* w, const E* b, const float* cos_t, const float* sin_t, E* q,
              E* k, E* v, int B, int L, int d, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 16:  // qkv of one head at D 16 is 48 columns: whole heads in a tile of 64
      if (tile_width(3 * H * D) == 64)
        return launch_d<E, kTables, 64, 16>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
      return launch_d<E, kTables, 128, 16>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
    case 32:
      return launch_d<E, kTables, 128, 32>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
    case 64:
      return launch_d<E, kTables, 128, 64>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
    // a tile of one head
    case 48:
      return launch_d<E, kTables, 48, 48>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
    case 80:
      return launch_d<E, kTables, 80, 80>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
    case 96:
      return launch_d<E, kTables, 96, 96>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
    case 112:
      return launch_d<E, kTables, 112, 112>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
    case 128:
      return launch_d<E, kTables, 128, 128>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// LayerNorm(x) into the [B L, d] scratch y, then the product and the rope
// on the tensor cores (the entry points send d 32 to narrow.cuh instead)
template <typename E, bool kTables>
int launch(const E* x, const float* scale, const float* bias, const E* w, const E* b,
           const float* cos_t, const float* sin_t, E* y, E* q, E* k, E* v, int B, int L, int d,
           int H, int D, cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || !d_model_ok(d) || !head_dim_ok(D))
    return (int)cudaErrorInvalidValue;
  const long T = (long)B * L;
  int err = gemm_tc::layernorm<E>(x, scale, bias, y, T, d, stream);
  if (err) return err;
  return launch_tc<E, kTables>(y, w, b, cos_t, sin_t, q, k, v, B, L, d, H, D, stream);
}

}  // namespace qkv_simt
}  // namespace herro
