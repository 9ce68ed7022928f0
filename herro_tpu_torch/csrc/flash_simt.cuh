// K2, K6, K7 and K9 on the CUDA cores: online-softmax attention under the
// length mask and any band or none, then (K2, K6, K7) the out projection and
// the residual; for float32 configs and for bf16 at head dims or (heads,
// width) pairs the Hopper instances (flash_outproj_sm90.cuh: D 128 and the
// shipped (H, d)) lack. Entry points: flash_f32.cu (float32), flash_bf16.cu
// (bf16), each with the banded route, the full one and K9's.
//
// Replaces, at any head dim D in {16, 32, 64, 128}:
// - herro_tpu/ops/fused.py:_banded_flash_outproj_rot_kernel (K2) and
//   _banded_flash_outproj_kernel (K6): any band;
// - herro_tpu/ops/fused.py:_flash_outproj_kernel (K7): every key below the
//   length;
// - herro_tpu/ops/attention.py:_flash_kernel (K9): attention alone, o [B, H,
//   L, D] (window -1: no band).
// y = E((x + E(concat_h(attn_h)) @ Wo) + bo), key j of query i attended
// when j < length and (no band or |i - j| <= window), E the storage type
// (float: the identity). K9 rounds P to E before P.V and divides by the
// unrounded row sum, as its plain version does (attention.py
// _flash_attention_plain); the out projection's attention keeps P in
// float32, as its plain version (chunked_attention) does. A row with no key
// to attend comes out 0 (the plain K9's sum clamped at 1e-30; every row of a
// length-0 example); under the out projection such rows are padding.
//
// Bound on the H100: operations, 4 D FFMA-operations a (query, key) pair
// the mask keeps, and 2 H D d a row for the projection, against 67 TFLOP/s
// of float32 FFMA.
// Design, SIMT: a block of 256 threads a (batch element, head, 64 query
// rows); Q (scaled by 1/sqrt(D) in float32 as the plain version scales it)
// and each 64-key tile of K transposed in shared memory as float32, V as it
// is; a thread holds 4 rows x 4 keys of S, the rows' running maximum and sum
// (reduced over the 16 threads of a row group by shuffles, all in one
// warp), and 4 rows x D/16 columns of O, rescaled by each tile's alpha
// before P.V. The key tiles run from the band's first to its last (the
// length's last without a band), so a band costs its width. The out
// projection is a second launch on the same stream: the attention writes o
// [B, L, H, D] of type E to a scratch the wrapper allocates, and the tile
// product of f32.cuh reads it as [T, H D] against Wo [H D, d] with the
// residual and the bias in its epilogue.
#pragma once

#include "common.cuh"
#include "f32.cuh"

namespace herro {
namespace flash_simt {

using namespace f32;

constexpr int kBQ = 64;    // query rows a block
constexpr int kBKV = 64;   // keys a tile
constexpr int kTilePad = 68;   // row stride of the transposed tiles (float4 reads)
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (2 * D * kTilePad + kBKV * D + kBKV * kTilePad) * 4;
}

// o [B, L, H, D] (heads_inner: the projection's A) or [B, H, L, D]; kRoundP:
// P rounded to E before P.V (K9's plain version)
template <typename E, int D, bool kRoundP>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const int* __restrict__ lengths, E* __restrict__ o, int H, int L, int window,
                 float scale, int heads_inner) {
  constexpr int TN = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                // [D][kTilePad]
  float* Kt = Qt + D * kTilePad;     // [D][kTilePad]
  float* Vs = Kt + D * kTilePad;     // [kBKV][D]
  float* Pt = Vs + kBKV * D;     // [kBKV][kTilePad]
  const int bh = blockIdx.y, bb = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int len = min(lengths[bb], L);
  const long head = (long)bh * L * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, kk = e % D, row = q0 + r;
    Qt[kk * kTilePad + r] =
        row < L ? __fmul_rn(to_f(q[head + (long)row * D + kk]), scale) : 0.f;
  }
  int lo = 0, hi = len;
  if (window >= 0) {
    lo = max(0, q0 - window);
    hi = min(len, q0 + kBQ + window);
  }
  float m[4], lsum[4], O[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    lsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) O[i][j] = 0.f;
  }
  for (int k0 = (lo / kBKV) * kBKV; k0 < hi; k0 += kBKV) {
    for (int e = tid; e < kBKV * D; e += kThreads) {
      const int r = e / D, kk = e % D, key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < L) {
        kv = to_f(k[head + (long)key * D + kk]);
        vv = to_f(v[head + (long)key * D + kk]);
      }
      Kt[kk * kTilePad + r] = kv;
      Vs[r * D + kk] = vv;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + kk * kTilePad + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Kt + kk * kTilePad + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        ok[j] = kj < len && (window < 0 || abs(qi - kj) <= window);
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      alpha[i] = expf(__fsub_rn(m[i], mn));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(__fsub_rn(s[i][j], mn)) : 0.f;
        rs = __fadd_rn(rs, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      lsum[i] = fmaf(lsum[i], alpha[i], rs);
      m[i] = mn;
    }
    // the row sums above take P unrounded; K9's P.V takes it rounded to E
    auto p = [](float x) { return kRoundP ? round_to<E>(x) : x; };
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * kTilePad + 4 * ty) =
          make_float4(p(s[0][j]), p(s[1][j]), p(s[2][j]), p(s[3][j]));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) O[i][j] = __fmul_rn(O[i][j], alpha[i]);
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kBKV; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + key * kTilePad + 4 * ty);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) vv[j] = Vs[key * D + TN * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) O[i][j] = fmaf(pv[i], vv[j], O[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
    const float l = fmaxf(lsum[i], 1e-30f);
    E* out = o + (heads_inner ? (((long)bb * L + row) * H + h) * D
                              : (((long)bh * L) + row) * D);
#pragma unroll
    for (int j = 0; j < TN; ++j) store1(out + TN * tx + j, __fdiv_rn(O[i][j], l));
  }
}

template <typename E, int D, bool kRoundP>
int attend(const E* q, const E* k, const E* v, const int* lengths, E* o, int B, int H, int L,
           int window, float scale, int heads_inner, cudaStream_t stream) {
  auto kernel = flash_kernel<E, D, kRoundP>;
  int err = set_smem((const void*)kernel, smem_bytes<D>());
  if (err) return err;
  const dim3 grid((unsigned)((L + kBQ - 1) / kBQ), (unsigned)(B * H));
  kernel<<<grid, kThreads, smem_bytes<D>(), stream>>>(q, k, v, lengths, o, H, L, window,
                                                       scale, heads_inner);
  return (int)cudaGetLastError();
}

template <typename E, bool kRoundP>
int attention(const E* q, const E* k, const E* v, const int* lengths, E* o, int B, int H,
              int L, int D, int window, float scale, int heads_inner, cudaStream_t stream) {
  if (B < 1 || H < 1 || L < 1 || B * H > 65535 || !head_dim_ok(D))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return attend<E, 16, kRoundP>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                    stream);
    case 32:
      return attend<E, 32, kRoundP>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                    stream);
    case 64:
      return attend<E, 64, kRoundP>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                    stream);
    default:
      return attend<E, 128, kRoundP>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                     stream);
  }
}

// attention into o [B, L, H, D] (P in float32), then y = (x + o @ Wo) + bo
template <typename E>
int outproj(const E* q, const E* k, const E* v, const E* x, const E* wo, const E* bo,
            const int* lengths, E* scratch, E* y, int B, int H, int L, int d, int D, int window,
            float scale, cudaStream_t stream) {
  if (!d_model_ok(d)) return (int)cudaErrorInvalidValue;
  int err = attention<E, false>(q, k, v, lengths, scratch, B, H, L, D, window, scale, 1, stream);
  if (err) return err;
  const long T = (long)B * L;
  launch_gemm<E, false, kEpiResidualAfter>(scratch, wo, bo, x, nullptr, nullptr, y, T, H * D,
                                           d, stream);
  return (int)cudaGetLastError();
}

}  // namespace flash_simt
}  // namespace herro
