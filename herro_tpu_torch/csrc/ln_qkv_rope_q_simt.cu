// K10 on the int8 tensor cores (mma.sync): int8 LayerNorm + qkv projection
// + rotary, for float32 or bf16 activations at any width the float32
// kernels take.
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_q_kernel (via
// _ln_qkv_rope_q_pallas) where the Hopper instance (ln_qkv_rope_q.cu: int8
// wgmma, bf16, d 256 or 512, D 128) does not reach: float32 checkpoints,
// TINY_CONFIG (d 32, H 2 x D 16) and its tensor-parallel shards, d 384,
// head dims 16-128.
//   y = E(LN(x)) quantized per row;  qkv = E((float(y_i8 @ W_i8) * s_row) * s_col + b)
//   q, k: rotate-half rope at the absolute column l, rounded to E; v as it is
// -> q, k, v [B, H, L, D] of x's type E; W k-major ([3HD, d]), b of type E.
// The int32 product is exact, and the dequantization, the bias, the
// roundings and the rope are those of the CUDA-core int8 instance this one
// replaced, in its order, so its outputs are that instance's bit for bit.
//
// Bound on the H100: 2 T d 3HD int8 operations at the tensor cores' int8
// peak (1979e12/s), or the bytes of x read and q/k/v written, whichever is
// longer: at r10's widths in float32, B=32, L=9216, 0.23 ms of products
// beside 0.72 of bytes (q/k/v 1.81 GB of them).
// Design: int8_simt.cuh's tensor-core product with A resident. A block of 8
// warps takes 128 token rows: LayerNorm and the row quantization once (a
// warp a row, layernorm_rows_i8), the int8 rows staying in shared memory (at
// most 128 x 528 bytes at d 512), then walks the 3HD output columns in tiles
// of 128 (64 where qkv has no more), W's 64-k stages streaming past through
// a ring of four by cp.async (L2-resident: 0.8 MB at r10). Each column
// tile's epilogue works on the C fragments where they lie: dequantize, add
// b, round, then take each value's rope partner (column dd +- D/2 of its
// head) from the same thread's fragment nt ^ P. A warp's columns come in
// spans that hold both halves of every head it touches: at D 16, 32 and 64
// the partner is 8, 16 or 32 columns away in the warp's block of BN/2; at D
// 128 (64 away) the warp's columns are two spans of 32, 64 apart
// (int8_simt.cuh span_col, S 32), so no value crosses warps. The rope tables
// are handed in (the plain version's rope_tables, the same bits). Each
// store covers a row's two adjacent columns (8 bytes of float32, 4 of
// bf16); a warp's store writes 8 rows of 32 contiguous bytes (float32).
// Measured (tools/flash_rows_torch.py --against the CUDA-core instance's
// tree, two calls, H100 at 700 W, B=32, L=9216; PERF.md section 6): r10
// float32 4.77-4.82 -> 1.95-1.96 ms, d 384 bf16 3.04-3.06 -> 1.53-1.54,
// every output the same bits. A warp's cycles at r10
// (tools/qkv_q_simt_clocks_torch.py): LayerNorm 0.25, issuing W's copies
// 0.24, products 0.18, the epilogue's arithmetic 0.25, its stores 0.04.
#include "int8_simt.cuh"

namespace herro {
namespace qkv_simt8 {

using namespace simt8;

// the rows of a block and the epilogue's constants: a warp's columns in
// spans of S, a value's rope partner in fragment nt ^ P
template <int BN, int D>
struct Tile {
  static constexpr int kHalf = D / 2;
  static constexpr int S = D == 128 ? 32 : BN / 2;
  static constexpr int P = D == 128 ? 4 : D / 16;
  static_assert(D <= 64 ? D <= S : BN == 128, "a span holds whole heads, or both halves");
};

template <typename E, int BN, int D>
__global__ void __launch_bounds__(kThreads, 2)
    ln_qkv_rope_q_simt_kernel(const E* __restrict__ x, const float* __restrict__ ln_s,
                              const float* __restrict__ ln_b, const int8_t* __restrict__ wt,
                              const float* __restrict__ s_col, const E* __restrict__ b,
                              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                              E* __restrict__ q, E* __restrict__ k, E* __restrict__ v, int B,
                              int L, int d, int H) {
  using T = Tile<BN, D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int as = a_stride(d);
  uint8_t* As = smem;
  uint8_t* ring = As + kBM * as;
  float* srow = reinterpret_cast<float*>(ring + kTCStages * w_stage_bytes<BN>());
  const long rows = (long)B * L;
  const int N = 3 * H * D, HD = H * D;
  const long r0 = (long)blockIdx.x * kBM;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, wr = tc_warp_row();
  const int wc = threadIdx.x / 32 % 2 * T::S;  // the warp's first span
  // a thread's four rows (16 mt + g + 8 hf of its warp's): where each row's
  // output starts in a head's [B, L, D] plane (-1 past the last row) and
  // its row of the rope tables
  long out_row[2][2];
  int tab_row[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long row = r0 + wr + 16 * mt + g + 8 * hf;
      const long bb = row / L;
      const int l = (int)(row % L);
      out_row[mt][hf] = row < rows ? (bb * H * L + l) * D : -1;
      tab_row[mt][hf] = l * T::kHalf;
    }
  layernorm_rows_i8<E>(x, rows, d, r0, ln_s, ln_b, As, as, srow);
  __syncthreads();
  product_resident<BN, T::S>(As, as, wt, d, N, ring, [&](int n0, const AccI<BN>& acc) {
    // a pair of fragments at a time: lo in the first half of its heads, hi
    // = lo | P their partners D/2 further; the pair's outputs, then their
    // stores
#pragma unroll
    for (int lo = 0; lo < BN / 16; ++lo) {
      if (lo & T::P) continue;
      const int hi = lo | T::P;
      const int n = n0 + wc + span_col<T::S>(lo) + 2 * t, nh = n + T::kHalf;
      if (n >= N) continue;  // a head's columns are in or out together
      const int which = n / HD, h = n % HD / D, dd = n % D;  // dd < D/2: n's frequency, nh's
      const float2 sl = *reinterpret_cast<const float2*>(s_col + n);
      const float2 sh = *reinterpret_cast<const float2*>(s_col + nh);
      const float2 bl = load2(b + n), bh = load2(b + nh);
      float x1[2][2][2], x2[2][2][2];  // [mt][hf][e]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float sr = srow[wr + 16 * mt + g + 8 * hf];
          float c[2] = {}, sn[2] = {};
          if (which < 2) {
            const int ti = tab_row[mt][hf] + dd;
            const float2 c2 = *reinterpret_cast<const float2*>(cos_t + ti);
            const float2 s2 = *reinterpret_cast<const float2*>(sin_t + ti);
            c[0] = c2.x, c[1] = c2.y, sn[0] = s2.x, sn[1] = s2.y;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = round_to<E>(
                dequant(acc[mt][lo][2 * hf + e], sr, e ? sl.y : sl.x, e ? bl.y : bl.x));
            const float z = round_to<E>(
                dequant(acc[mt][hi][2 * hf + e], sr, e ? sh.y : sh.x, e ? bh.y : bh.x));
            // x1 * cos - x2 * sin for the first half, x2 * cos + x1 * sin for the second
            x1[mt][hf][e] = which < 2 ? round_to<E>(__fsub_rn(__fmul_rn(a, c[e]),
                                                              __fmul_rn(z, sn[e])))
                                      : a;
            x2[mt][hf][e] = which < 2 ? round_to<E>(__fadd_rn(__fmul_rn(z, c[e]),
                                                              __fmul_rn(a, sn[e])))
                                      : z;
          }
        }
      E* dst = (which == 0 ? q : which == 1 ? k : v) + (long)h * L * D + dd;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (out_row[mt][hf] < 0) continue;
          E* o = dst + out_row[mt][hf];
          store2(o, x1[mt][hf][0], x1[mt][hf][1]);
          store2(o + T::kHalf, x2[mt][hf][0], x2[mt][hf][1]);
        }
    }
  });
}

template <typename E>
int launch(const void* x, const float* ln_s, const float* ln_b, const void* wt,
           const float* s_col, const void* b, const float* cos_t, const float* sin_t, void* q,
           void* k, void* v, int B, int L, int d, int H, int D, cudaStream_t stream) {
  auto go = [&](auto kernel, int BN) {
    const size_t smem = (size_t)kBM * a_stride(d) + kTCStages * BN * kSS + kBM * 4;
    int err = set_smem((const void*)kernel, smem);
    if (err) return err;
    const long rows = (long)B * L;
    kernel<<<(unsigned)((rows + kBM - 1) / kBM), kThreads, smem, stream>>>(
        (const E*)x, ln_s, ln_b, (const int8_t*)wt, s_col, (const E*)b, cos_t, sin_t, (E*)q,
        (E*)k, (E*)v, B, L, d, H);
    return (int)cudaGetLastError();
  };
  switch (D) {
    case 16:  // at H 1 whole heads in a tile of 64
      if (f32::tile_width(3 * H * D) == 64) return go(ln_qkv_rope_q_simt_kernel<E, 64, 16>, 64);
      return go(ln_qkv_rope_q_simt_kernel<E, 128, 16>, 128);
    case 32:
      return go(ln_qkv_rope_q_simt_kernel<E, 128, 32>, 128);
    case 64:
      return go(ln_qkv_rope_q_simt_kernel<E, 128, 64>, 128);
    default:
      return go(ln_qkv_rope_q_simt_kernel<E, 128, 128>, 128);
  }
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
  if (B < 1 || L < 1 || H < 1 || !f32::int8_d_model_ok(d) || !f32::head_dim_pow2(D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return qkv_simt8::launch<bf16>(x, ln_s, ln_b, wt, s_col, b, cos_t, sin_t, q, k, v, B, L, d,
                                   H, D, s);
  return qkv_simt8::launch<float>(x, ln_s, ln_b, wt, s_col, b, cos_t, sin_t, q, k, v, B, L, d,
                                  H, D, s);
}
