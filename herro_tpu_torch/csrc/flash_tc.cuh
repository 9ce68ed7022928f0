// K2, K6, K7 and K9 on the tensor cores (mma.sync) for float32 configs and
// for bf16 at the head dims and (heads, width) pairs the Hopper instances
// (flash_outproj_sm90.cuh: D 128 and the shipped (H, d)) lack: online-softmax
// attention under the length mask and any band or none, then (K2, K6, K7) the
// out projection and the residual. Entry points: flash_f32.cu (float32),
// flash_bf16.cu (bf16), each with the banded route, the full one and K9's.
//
// Replaces, at any head dim D a multiple of 16 from 16 to 128 (and, under
// the out projection, d_model a multiple of 32 up to 1024):
// - herro_tpu/ops/fused.py:_banded_flash_outproj_rot_kernel (K2) and
//   _banded_flash_outproj_kernel (K6): any band;
// - herro_tpu/ops/fused.py:_flash_outproj_kernel (K7): every key below the
//   length;
// - herro_tpu/ops/attention.py:_flash_kernel (K9): attention alone, o [B, H,
//   L, D] (window -1: no band).
// y = E((x + E(concat_h(attn_h)) @ Wo) + bo), key j of query i attended
// when j < length and (no band or |i - j| <= window), E the storage type
// (float: the identity). In bf16 every mode rounds P to bf16 before P.V and
// divides by the unrounded row sum, as herro_tpu's Pallas kernels do (K9's
// _flash_kernel, K7's _flash_outproj_kernel, K6's and K2's banded ones:
// p.astype(v.dtype)); the yardstick on the card is P against the running
// maximum of 64-key tiles (attention.py _flash_attention_tiled, and
// fused.py _flash_outproj_tiled for K2/K6/K7). The CPU forward's plain
// version of the projection (chunked_attention) keeps P at float32
// precision, as herro_tpu's jnp twin does. A row with no key to attend comes out 0
// (the plain K9's sum clamped at 1e-30; every row of a length-0 example);
// under the out projection such rows are padding.
//
// Bound on the H100, per (query, key) pair the mask keeps: one exponential
// (the SFU: 16 a clock an SM, 4.2e12/s at 1.98 GHz) and 4 D product
// operations, on the tensor cores at the operands' peak (bf16 989 TFLOP/s;
// float32 as three TF32 products, 495 / 3); at D 16-32 the exponentials
// and the softmax's own float32 work set it, at D 128 in float32 the
// products. The out projection (2 H D d operations a row, a second
// launch) is bound by its products at the bf16 tensor-core peak or its
// bytes (o, x and y) in bf16, by its products at the FFMA rate in float32.
//
// Design: a block of 4 warps a (batch element, head, 64 query rows), 16 rows
// a warp; the keys in tiles of 64 (32 for float32 above D 64, so that two
// blocks fit an SM: at D 96 a 64-key tile's Q, K and V took 128 KB), K and
// V double-buffered into shared memory by cp.async
// (16 bytes a thread, rows past L zero-filled), the next tile's copies in
// flight while the current one is multiplied. Rows are padded (K by 8
// elements, V by 4 floats or 8 bf16), which keeps every fragment read below
// free of bank conflicts without an XOR swizzle. Q's tile sits in shared
// memory for the whole block (in registers it pushed the float32 D 128
// instance to 255 registers and spills); float32 Q is scaled by 1/sqrt(D)
// in float32 as the plain version scales it, bf16 Q goes to the tensor
// cores as it is and the scale joins log2(e) in the exponent. S and each
// tile's P.V sum from zero in float32 in mma.sync's C fragments (the tensor
// cores round those sums toward zero), then O = O alpha + P.V at
// round-to-nearest in registers; the online softmax stays in registers (the row maximum over the 4 threads that share
// a row by two shuffles, the row sum kept per thread and summed at the end),
// p = exp2(s * c - m * c) on the SFU (ex2.approx), c = log2(e) or
// log2(e) / sqrt(D). Tiles inside the length and the band skip the mask.
// - bf16, S = Q.K^T: m16n8k16, K's fragments by ldmatrix; products exact,
//   sums in float32.
// - float32: mma reads float32 as TF32 (a 10-bit mantissa, about three
//   digits, which misses the 1e-4 bar). Each operand is split into two
//   TF32 parts by bit masks (split_tf32), and each product is taken three
//   times, lo.hi + hi.lo + hi.hi, m16n8k8 (2^-19 or so of each term;
//   tests/test_torch_flash_tc.py emulates it). A k-step's index t maps to
//   dim (or key) 2t and t + 4 to 2t + 1, so a thread's A and B pairs are
//   adjacent in memory and P's A fragment is S's C fragment as it lies.
// - P.V: bf16 packs P to bf16 (the rounding herro_tpu's kernels make)
//   against V by ldmatrix.trans, one m16n8k16; float32 splits P and V,
//   three m16n8k8. The mode that keeps bf16 P at float32 precision (two
//   TF32 parts against V read the same way and widened, bf16 being exact in
//   TF32: two m16n8k8) is taken by no entry point; it stays for
//   tools/bf16_rounding_faults.py, which plants P left unrounded with it.
// Why mma.sync and not wgmma: at D 16-64, every configuration but float32
// r10, the products take a small share of a tile's time beside the
// exponentials and the softmax, and wgmma's 64-row warpgroup tile would
// leave those four warps' softmax in one another's way; tf32 wgmma takes B
// only K-major, so V would need a transpose in shared memory; and the
// TF32 splits of P are register work that mma.sync's A fragment (S's C
// fragment) takes as it lies.
// The out projection is a second launch on the same stream: the attention
// writes o [B, L, H, D] of type E to a scratch the wrapper allocates, and a
// tile product reads it as [T, H D] against Wo [H D, d] with the residual
// and the bias in its epilogue (f32.cuh kEpiResidualAfter): in bf16 on
// gemm_tc.cuh's tensor cores, in float32 on f32.cuh's FFMA tile product
// (outproj_on_tc says why).
#pragma once

#include "f32.cuh"
#include "gemm_tc.cuh"
#include "mma.cuh"

namespace herro {
namespace flash_tc {

using namespace f32;

constexpr int kBQ = 64;               // query rows a block, 16 a warp
constexpr int kTCThreads = 128;       // 4 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// how P.V takes P
constexpr int kPVRound = 0;   // rounded to bf16: one m16n8k16 against bf16 V
constexpr int kPVSplitP = 1;  // two TF32 parts against bf16 V: two m16n8k8
constexpr int kPVSplit3 = 2;  // P and float32 V as two TF32 parts each: three m16n8k8

// P.V's mode for storage E: bf16 rounds P (kRoundP; every entry point),
// float32 splits both operands
template <typename E, bool kRoundP>
constexpr int pv_mode() {
  return sizeof(E) == 4 ? kPVSplit3 : kRoundP ? kPVRound : kPVSplitP;
}

// the tile shapes of an instance (elements of E): Q [kBQ][kKS], then two
// stages of K [kBKV][kKS] and V [kBKV][kVS]
template <typename E, int D>
struct Shape {
  static constexpr bool kF32 = sizeof(E) == 4;
  static constexpr int kBKV = kF32 && D > 64 ? 32 : 64;  // keys a tile
  static constexpr int kNT = kBKV / 8;                     // 8-key column tiles of S
  static constexpr int kND = D / 8;                        // 8-dim column tiles of O
  static constexpr int kKS = D + 8;                        // row stride of Q and K
  static constexpr int kVS = kF32 ? D + 4 : D + 8;         // row stride of V
  static constexpr int kStage = kBKV * (kKS + kVS);
  static constexpr int kSmem = (kBQ * kKS + 2 * kStage) * (int)sizeof(E);
};

__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the two halves of a register of two bf16 as float (TF32: exact)
__device__ inline uint32_t bf16_lo(uint32_t x) { return x << 16; }
__device__ inline uint32_t bf16_hi(uint32_t x) { return x & 0xffff0000u; }

// o [B, L, H, D] (heads_inner: the projection's A) or [B, H, L, D]
template <typename E, int D, int kPV>
__device__ __forceinline__ void flash_tile_rows(const E* __restrict__ q, const E* __restrict__ k,
                                                const E* __restrict__ v,
                                                const int* __restrict__ lengths,
                                                E* __restrict__ o, int H, int L, int window,
                                                float scale, int heads_inner) {
  using Sh = Shape<E, D>;
  constexpr bool kF32 = Sh::kF32;
  constexpr int kBKV = Sh::kBKV, kNT = Sh::kNT, kKS = Sh::kKS, kVS = Sh::kVS, kND = Sh::kND;
  static_assert(kF32 == (kPV == kPVSplit3), "float32 splits both operands, bf16 neither");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* const Qs = reinterpret_cast<E*>(smem_raw);
  E* const sm = Qs + kBQ * kKS;
  const int bh = blockIdx.y, bb = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int len = min(lengths[bb], L);
  const long head = (long)bh * L * D;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;

  const int wr = (tid / 32) * 16;  // the warp's first row in the tile
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // this thread's two rows

  // Q's tile into shared memory (rows past L 0), float32 scaled by
  // 1/sqrt(D) as the plain version scales it, bf16 as it is; the first
  // tile's barrier publishes it
  for (int e = tid; e < kBQ * D / 4; e += kTCThreads) {
    const int r = e / (D / 4), cc = (e % (D / 4)) * 4, row = q0 + r;
    if constexpr (kF32) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < L) a = *reinterpret_cast<const float4*>(q + head + (long)row * D + cc);
      *reinterpret_cast<float4*>(Qs + r * kKS + cc) =
          make_float4(__fmul_rn(a.x, scale), __fmul_rn(a.y, scale), __fmul_rn(a.z, scale),
                      __fmul_rn(a.w, scale));
    } else {
      *reinterpret_cast<uint2*>(Qs + r * kKS + cc) =
          row < L ? *reinterpret_cast<const uint2*>(q + head + (long)row * D + cc)
                  : make_uint2(0u, 0u);
    }
  }
  const float c = kF32 ? kLog2e : __fmul_rn(scale, kLog2e);

  int lo = 0, hi = len;
  if (window >= 0) {
    lo = max(0, q0 - window);
    hi = min(len, q0 + kBQ + window);
  }
  const int first = (lo / kBKV) * kBKV;
  const int n_tiles = hi > first ? (hi - first + kBKV - 1) / kBKV : 0;

  // K and V rows k0 .. k0 + kBKV - 1 into stage st
  auto load_tile = [&](int k0, int st) {
    E* Ks = sm + st * Sh::kStage;
    E* Vs = Ks + kBKV * kKS;
    constexpr int kPer = 16 / (int)sizeof(E);  // elements a copy
    constexpr int kChunks = D / kPer;          // copies a row
    for (int e = tid; e < kBKV * kChunks; e += kTCThreads) {
      const int r = e / kChunks, cc = (e % kChunks) * kPer, key = k0 + r;
      const long src = head + (long)(key < L ? key : 0) * D + cc;
      cp_async16(Ks + r * kKS + cc, k + src, key < L);
      cp_async16(Vs + r * kVS + cc, v + src, key < L);
    }
  };

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float O[kND][4] = {};
  // tile i in stage i % 2; the next tile's copies in flight while one is
  // multiplied
  if (n_tiles) load_tile(first, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = first + it * kBKV;
    cp_async_wait_all();
    // tile it is in; every warp is done with tile it - 1, whose stage the
    // copies of tile it + 1 take next
    __syncthreads();
    if (it + 1 < n_tiles) load_tile(k0 + kBKV, (it + 1) % 2);
    const E* Ks = sm + (it % 2) * Sh::kStage;
    const E* Vs = Ks + kBKV * kKS;

    // S = Q.K^T: s[n] the C fragment of keys k0 + 8n .. k0 + 8n + 7:
    // (row0, 2t), (row0, 2t + 1), (row1, 2t), (row1, 2t + 1)
    float s[kNT][4] = {};
    if constexpr (kF32) {
      // Q's A fragment of a k-step of 8 dims: (row0, 2t), (row1, 2t),
      // (row0, 2t + 1), (row1, 2t + 1); K's B: (key g, 2t), (key g, 2t + 1)
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float2 a = *reinterpret_cast<const float2*>(Qs + (wr + g) * kKS + 8 * kk + 2 * t);
        const float2 b =
            *reinterpret_cast<const float2*>(Qs + (wr + g + 8) * kKS + 8 * kk + 2 * t);
        uint32_t qh[4], ql[4];
        split_tf32(a.x, qh[0], ql[0]);
        split_tf32(b.x, qh[1], ql[1]);
        split_tf32(a.y, qh[2], ql[2]);
        split_tf32(b.y, qh[3], ql[3]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float2 kv =
              *reinterpret_cast<const float2*>(Ks + (8 * n + g) * kKS + 8 * kk + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kv.x, bh0, bl0);
          split_tf32(kv.y, bh1, bl1);
          mma_tf32(s[n], ql, bh0, bh1);
          mma_tf32(s[n], qh, bl0, bl1);
          mma_tf32(s[n], qh, bh0, bh1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // Q's A (m16n8k16): matrices rows 0..7 / 8..15 (lanes 8-15, 24-31) at
        // dims 16kk + 0..7 / 8..15 (lanes 16-31)
        uint32_t qa[4];
        ldsm_x4(qa, Qs + (wr + (lane & 15)) * kKS + 16 * kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          // matrices: keys 16np + 0..7 / 8..15 (lanes 16-31) at dims 16kk + 0..7 / 8..15
          uint32_t b[4];
          ldsm_x4(b, Ks + (16 * np + (lane & 7) + (lane >> 4) * 8) * kKS + 16 * kk +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, b[0], b[1]);
          mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        }
      }
    }

    // the online softmax: keys past the length or outside the band at
    // kNegInf, the row maximum over the quad, p = exp2(s c - m c)
    const bool masked = k0 + kBKV > len ||
                        (window >= 0 && (q0 + kBQ - 1 - k0 > window ||
                                         k0 + kBKV - 1 - q0 > window));
    if (masked) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1), row = e < 2 ? row0 : row1;
          if (key >= len || (window >= 0 && abs(row - key) > window)) s[n][e] = kNegInf;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // both products rounded, so an unchanged maximum gives alpha 1 exactly;
    // a row with no key yet takes mc 0, so its keys at kNegInf give p 0
    const float mc0 = mx0 == kNegInf ? 0.f : __fmul_rn(mx0, c);
    const float mc1 = mx1 == kNegInf ? 0.f : __fmul_rn(mx1, c);
    const float alpha0 = ex2(__fsub_rn(__fmul_rn(m0, c), mc0));
    const float alpha1 = ex2(__fsub_rn(__fmul_rn(m1, c), mc1));
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[n][e], c, -(e < 2 ? mc0 : mc1)));
        s[n][e] = p;
        if (e < 2) rs0 = __fadd_rn(rs0, p);
        else rs1 = __fadd_rn(rs1, p);
      }
    l0 = fmaf(l0, alpha0, rs0);  // this thread's share of the row sums
    l1 = fmaf(l1, alpha1, rs1);
    // O = O alpha + P.V, this tile's P.V summed from zero in its own C
    // fragment: the tensor cores round their float32 sums toward zero, so a
    // sum carried through the mma over thousands of keys drifts low (more
    // than 2^-6 of the bf16 outputs an ulp off at tiny's widths, L=9216);
    // the tiles' sums add in float32 at round-to-nearest
    auto rescale_add = [&](float (&o4)[4], const float (&acc)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o4[e] = fmaf(o4[e], e < 2 ? alpha0 : alpha1, acc[e]);
    };
    if constexpr (kPV == kPVSplit3) {
      // P's A fragments over keys 8j + 2t (k index t) and 8j + 2t + 1 (t + 4)
      uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        split_tf32(s[j][0], ph[j][0], pl[j][0]);
        split_tf32(s[j][2], ph[j][1], pl[j][1]);
        split_tf32(s[j][1], ph[j][2], pl[j][2]);
        split_tf32(s[j][3], ph[j][3], pl[j][3]);
      }
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        float acc[4] = {};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const E* v0 = Vs + (8 * j + 2 * t) * kVS + 8 * nd + g;
          uint32_t vh0, vl0, vh1, vl1;
          split_tf32(to_f(v0[0]), vh0, vl0);
          split_tf32(to_f(v0[kVS]), vh1, vl1);
          mma_tf32(acc, pl[j], vh0, vh1);
          mma_tf32(acc, ph[j], vl0, vl1);
          mma_tf32(acc, ph[j], vh0, vh1);
        }
        rescale_add(O[nd], acc);
      }
    } else {
      // keys 16kk .. 16kk + 15 are S's tiles 2kk and 2kk + 1: packed to
      // bf16 (m16n8k16's A), or each tile split into two TF32 parts
      uint32_t pb[kPV == kPVRound ? kNT / 2 : 1][4];
      uint32_t ph[kPV == kPVRound ? 1 : kNT][4], pl[kPV == kPVRound ? 1 : kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if constexpr (kPV == kPVRound) {
          pb[j / 2][2 * (j & 1)] = pack_bf16(s[j][0], s[j][1]);
          pb[j / 2][2 * (j & 1) + 1] = pack_bf16(s[j][2], s[j][3]);
        } else {
          split_tf32(s[j][0], ph[j][0], pl[j][0]);
          split_tf32(s[j][2], ph[j][1], pl[j][1]);
          split_tf32(s[j][1], ph[j][2], pl[j][2]);
          split_tf32(s[j][3], ph[j][3], pl[j][3]);
        }
      }
#pragma unroll
      for (int np = 0; np < kND / 2; ++np) {
        float acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kNT / 2; ++kk) {
          // matrices: keys 16kk + 0..7 / 8..15 at dims 16np + 0..7 / 8..15
          // (lanes 16-31), transposed: a register holds V at keys 2t, 2t + 1
          uint32_t b[4];
          ldsm_x4_trans(b, Vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kVS +
                               16 * np + (lane >> 4) * 8);
          if constexpr (kPV == kPVRound) {
            mma_bf16(acc[0], pb[kk], b[0], b[1]);
            mma_bf16(acc[1], pb[kk], b[2], b[3]);
          } else {
#pragma unroll
            for (int w = 0; w < 2; ++w)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const uint32_t bv = b[2 * w + u];  // dims 16np + 8w.., keys 16kk + 8u..
                mma_tf32(acc[w], pl[2 * kk + u], bf16_lo(bv), bf16_hi(bv));
                mma_tf32(acc[w], ph[2 * kk + u], bf16_lo(bv), bf16_hi(bv));
              }
          }
        }
        rescale_add(O[2 * np], acc[0]);
        rescale_add(O[2 * np + 1], acc[1]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, off));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, off));
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  auto out = [&](int row) {
    return o + (heads_inner ? (((long)bb * L + row) * H + h) * D : ((long)bh * L + row) * D);
  };
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) {
    if (row0 < L)
      store2(out(row0) + 8 * nd + 2 * t, __fdiv_rn(O[nd][0], l0), __fdiv_rn(O[nd][1], l0));
    if (row1 < L)
      store2(out(row1) + 8 * nd + 2 * t, __fdiv_rn(O[nd][2], l1), __fdiv_rn(O[nd][3], l1));
  }
}

template <typename E, int D, int kPV>
__global__ void __launch_bounds__(kTCThreads)
    flash_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const int* __restrict__ lengths, E* __restrict__ o, int H, int L, int window,
                 float scale, int heads_inner) {
  flash_tile_rows<E, D, kPV>(q, k, v, lengths, o, H, L, window, scale, heads_inner);
}

// float32 above D 64, told it may take a whole SM's registers: ptxas then
// gives it more than under the bare bound, and at r10's widths (D 128) it
// ran a fifth faster so (the instances at D 16-64 ran slower so)
template <typename E, int D, int kPV>
__global__ void __launch_bounds__(kTCThreads, 1)
    flash_kernel_wide(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                      const int* __restrict__ lengths, E* __restrict__ o, int H, int L,
                      int window, float scale, int heads_inner) {
  flash_tile_rows<E, D, kPV>(q, k, v, lengths, o, H, L, window, scale, heads_inner);
}

template <typename E, int D, int kPV>
int attend(const E* q, const E* k, const E* v, const int* lengths, E* o, int B, int H, int L,
           int window, float scale, int heads_inner, cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (sizeof(E) == 4 && D > 64) return flash_kernel_wide<E, D, kPV>;
    else return flash_kernel<E, D, kPV>;
  }();
  constexpr int smem = Shape<E, D>::kSmem;
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  const dim3 grid((unsigned)((L + kBQ - 1) / kBQ), (unsigned)(B * H));
  kernel<<<grid, kTCThreads, smem, stream>>>(q, k, v, lengths, o, H, L, window, scale,
                                              heads_inner);
  return (int)cudaGetLastError();
}

template <typename E, bool kRoundP>
int attention(const E* q, const E* k, const E* v, const int* lengths, E* o, int B, int H,
              int L, int D, int window, float scale, int heads_inner, cudaStream_t stream) {
  if (B < 1 || H < 1 || L < 1 || B * H > 65535 || !head_dim_ok(D))
    return (int)cudaErrorInvalidValue;
  constexpr int kPV = pv_mode<E, kRoundP>();
  switch (D) {
    case 16:
      return attend<E, 16, kPV>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                stream);
    case 32:
      return attend<E, 32, kPV>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                stream);
    case 48:
      return attend<E, 48, kPV>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                stream);
    case 64:
      return attend<E, 64, kPV>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                stream);
    case 80:
      return attend<E, 80, kPV>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                stream);
    case 96:
      return attend<E, 96, kPV>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                stream);
    case 112:
      return attend<E, 112, kPV>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                 stream);
    case 128:
      return attend<E, 128, kPV>(q, k, v, lengths, o, B, H, L, window, scale, heads_inner,
                                 stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// whether the out projection of storage type E at width d and K = H D
// takes gemm_tc.cuh's tensor-core tile product (K a multiple of its 32-k
// stage) rather than f32.cuh's FFMA one. bf16 does at every width: timed
// against FFMA in one call on an H100 (B=32, L=9216; PERF.md section 6, PR
// 22), r10h64's K2 6.49-6.53 -> 3.75-3.80 ms, tiny's K2 at band 512
// 0.345-0.348 -> 0.319-0.323, its rows held to the 2^-6 share bar either
// way. float32 keeps FFMA: on the tensor cores r10's K2 ran 13.02-13.10 ->
// 12.56-12.61 within the 2e-4 bar, but the three TF32 products' sums (each
// 32-k stage truncated toward zero inside the tensor cores) moved enough
// int8 steps of the next K11 that the float32 r10 int8 golden's info head
// came 0.072 from herro_tpu's frozen logits, past the frozen 0.05
// (chip_smoke.py INT8_GOLDEN_BARS); and at tiny's widths FFMA timed no
// slower (K2 at band 512 0.778-0.785 against 0.783-0.809). tiny's tp 2
// shard (K = 16) is below a stage.
template <typename E>
inline bool outproj_on_tc(int d, int K) {
  return sizeof(E) == 2 && K % gemm_tc::kBK == 0;
}

// y [T, d] = (x + o @ Wo) + bo, o [T, K] the attention's output, Wo [K, d]
template <typename E>
int project(const E* o, const E* wo, const E* bo, const E* x, E* y, long T, int K, int d,
            cudaStream_t stream) {
  if (outproj_on_tc<E>(d, K))
    return gemm_tc::launch<E, kEpiResidualAfter>(o, wo, bo, x, y, T, K, d, stream);
  launch_gemm<E, kEpiResidualAfter>(o, wo, bo, x, y, T, K, d, stream);
  return (int)cudaGetLastError();
}

// attention into o [B, L, H, D] (bf16: P rounded), then y = (x + o @ Wo) + bo
template <typename E>
int outproj(const E* q, const E* k, const E* v, const E* x, const E* wo, const E* bo,
            const int* lengths, E* scratch, E* y, int B, int H, int L, int d, int D, int window,
            float scale, cudaStream_t stream) {
  if (!d_model_ok(d)) return (int)cudaErrorInvalidValue;
  int err = attention<E, true>(q, k, v, lengths, scratch, B, H, L, D, window, scale, 1, stream);
  if (err) return err;
  return project<E>(scratch, wo, bo, x, y, (long)B * L, H * D, d, stream);
}

// the out projection alone (an entry point of its own for its rows on the
// card): o [T, K] with K = H D, any H and D the attention takes
template <typename E>
int outproj_only(const E* o, const E* x, const E* wo, const E* bo, E* y, long T, int K, int d,
                 cudaStream_t stream) {
  if (T < 1 || !d_model_ok(d) || K < 16 || K % 16) return (int)cudaErrorInvalidValue;
  return project<E>(o, wo, bo, x, y, T, K, d, stream);
}

}  // namespace flash_tc
}  // namespace herro
