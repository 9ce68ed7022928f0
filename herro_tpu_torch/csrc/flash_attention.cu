// K9: standalone flash attention, one head per block, output [B, H, L, D].
//
// Replaces herro_tpu/ops/attention.py:_flash_kernel (via flash_attention).
// For every query row i of batch b and head h: online softmax over the keys
// j < length (and |i - j| <= window under a band) of scale * q_i . k_j, masked
// scores at -1e30, P rounded to bf16 for P.V, the result divided by the row
// sum clamped at 1e-30 and rounded to bf16. A batch element of length 0 walks
// no key tile and comes out 0, as the TPU kernel's clamped loop does; a row
// whose band holds no key below the length is padding (finite, unspecified).
// Bound on the H100: operations (4*D per query-key pair the mask lets
// through) over the bf16 tensor-core rate; under a narrow band the bytes of
// q, k, v and the output.
// Design: the flash-attention-2 form on mma.sync (a block owns 128 query
// rows, 8 warps of 16; scores, probabilities and the output accumulator stay
// in registers on mma.sync m16n8k16 with ldmatrix operands; key tiles of 64
// stream through a cp.async double buffer whose rows have a padded stride,
// kLdKV, for conflict-free ldmatrix; a warp skips tiles outside its rows'
// band). There is no out
// projection to fuse, so heads need not share a block. The grid is (query
// blocks, H, B), shared memory holds one head's Q tile and the K/V stages
// (104 KB), and a warp parks its bf16 result in its own rows of the Q tile
// to leave in 16-byte stores. It is the port's last attention kernel on this
// form: K2, K6 and K7 run on TMA and wgmma (flash_outproj_sm90.cuh).
#include "common.cuh"

namespace herro {

enum : int { kMaskBand = 0, kMaskFull = 1 };

constexpr int kD = 128;        // head dim
constexpr int kBQ = 128;       // query rows per block (8 warps x 16)
constexpr int kBK = 64;        // keys per tile
constexpr int kLdKV = kD + 8;  // K/V tile row stride (bf16): conflict-free ldmatrix
constexpr size_t kTileBytes = (size_t)kBK * kLdKV * 2;
constexpr size_t kKvBytes = 4 * kTileBytes;  // 2 stages x (K, V)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// rows [row0, row0 + rows) of a [L, D] head slab into a shared tile of row
// stride ld, asynchronously; rows past L are zero-filled
__device__ inline void load_rows_async(const bf16* __restrict__ src, int row0, int rows,
                                       int L, bf16* dst, int ld) {
  for (int e = threadIdx.x; e < rows * (kD / 8); e += blockDim.x) {
    const int r = e >> 4, c = (e & 15) * 8;
    const int row = row0 + r;
    const bool ok = row < L;
    cp_async16(dst + r * ld + c, src + (size_t)(ok ? row : 0) * kD + c, ok);
  }
}

constexpr size_t kFlashAttnSmem = kKvBytes + (size_t)kBQ * kLdKV * 2;

template <int kMask>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ lengths,
                       bf16* __restrict__ out, int H, int L, int window, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kv = reinterpret_cast<bf16*>(smem);  // [stage][K, V][kBK][kLdKV]
  bf16* qs = reinterpret_cast<bf16*>(smem + kKvBytes);  // [kBQ][kLdKV]
  auto k_tile = [&](int s) { return kv + (size_t)(2 * s) * kBK * kLdKV; };
  auto v_tile = [&](int s) { return kv + (size_t)(2 * s + 1) * kBK * kLdKV; };

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(lengths[b], L);
  const int r0 = q0 + warp * 16;  // this warp's first query row
  const int k_lo = kMask == kMaskBand ? max(0, q0 - window) : 0;
  const int k_hi = kMask == kMaskBand ? min(len, q0 + kBQ + window) : len;
  const int kt0 = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + kBK - 1) / kBK : 0;
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2 below
  const size_t slab = ((size_t)b * H + h) * L * kD;

  load_rows_async(q + slab, q0, kBQ, L, qs, kLdKV);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows_async(k + slab, kt0, kBK, L, k_tile(0), kLdKV);
    load_rows_async(v + slab, kt0, kBK, L, v_tile(0), kLdKV);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kLdKV + kk * 16 + (lane >> 4) * 8);

  float o[kD / 8][4];
  zero(o);
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const int iq0 = r0 + g, iq1 = r0 + g + 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt0 + it * kBK;
    if (it + 1 < n_tiles) {
      load_rows_async(k + slab, kt + kBK, kBK, L, k_tile((it + 1) & 1), kLdKV);
      load_rows_async(v + slab, kt + kBK, kBK, L, v_tile((it + 1) & 1), kLdKV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = k_tile(it & 1);
    const bf16* Vs = v_tile(it & 1);
    const bool live =
        kMask == kMaskBand
            ? r0 < L && kt + kBK - 1 >= r0 - window && kt <= r0 + 15 + window
            : r0 < L;
    if (live) {
      float s[kBK / 8][4];
      zero(s);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
        for (int nn = 0; nn < kBK / 8; nn += 2) {
          uint32_t bk[4];
          ldsm_x4(bk, Ks + (nn * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLdKV + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma16816(s[nn], qf[kk], bk[0], bk[1]);
          mma16816(s[nn + 1], qf[kk], bk[2], bk[3]);
        }

      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nn = 0; nn < kBK / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ik = kt + nn * 8 + 2 * t + e;
          if constexpr (kMask == kMaskBand) {
            s[nn][e] = (ik < len && abs(iq0 - ik) <= window) ? s[nn][e] * sl2 : kNegInf;
            s[nn][2 + e] =
                (ik < len && abs(iq1 - ik) <= window) ? s[nn][2 + e] * sl2 : kNegInf;
          } else {
            s[nn][e] = ik < len ? s[nn][e] * sl2 : kNegInf;
            s[nn][2 + e] = ik < len ? s[nn][2 + e] * sl2 : kNegInf;
          }
          mx0 = fmaxf(mx0, s[nn][e]);
          mx1 = fmaxf(mx1, s[nn][2 + e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
      // P in bf16 as the A operand of P.V: score tiles 2kk, 2kk+1 are the
      // low and high key halves of k-step kk
      uint32_t pf[kBK / 16][4];
#pragma unroll
      for (int nn = 0; nn < kBK / 8; ++nn) {
        const float p0 = exp2f(s[nn][0] - mn0), p1 = exp2f(s[nn][1] - mn0);
        const float p2 = exp2f(s[nn][2] - mn1), p3 = exp2f(s[nn][3] - mn1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pf[nn >> 1][(nn & 1) * 2] = pack_bf16(p0, p1);
        pf[nn >> 1][(nn & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int nn = 0; nn < kD / 8; nn += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdKV +
                                nn * 8 + (lane >> 4) * 8);
          mma16816(o[nn], pf[kk], bv[0], bv[1]);
          mma16816(o[nn + 1], pf[kk], bv[2], bv[3]);
        }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // the warp's 16 result rows replace its Q rows (read into qf above by this
  // warp alone), then leave as whole 256-byte rows
  bf16* own = qs + (size_t)warp * 16 * kLdKV;
  bf16* row0 = own + g * kLdKV + 2 * t;
  bf16* row1 = row0 + 8 * kLdKV;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    *reinterpret_cast<bf162*>(row0 + j * 8) =
        __floats2bfloat162_rn(o[j][0] / d0, o[j][1] / d0);
    *reinterpret_cast<bf162*>(row1 + j * 8) =
        __floats2bfloat162_rn(o[j][2] / d1, o[j][3] / d1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * (kD / 8); e += 32) {
    const int r = e >> 4, c = (e & 15) * 8;
    if (r0 + r < L)
      *reinterpret_cast<uint4*>(out + slab + (size_t)(r0 + r) * kD + c) =
          *reinterpret_cast<const uint4*>(own + r * kLdKV + c);
  }
}

// A band wider than L masks nothing more than L does, so it is clamped there
// and q0 + kBQ + window cannot overflow; the unbanded instantiation has no
// band arithmetic at all.
template <int kMask>
inline int flash_attention_launch(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out, int B, int H, int L,
                                  int window, float scale, void* stream) {
  window = window < L ? window : L;
  int err = set_smem((const void*)flash_attention_kernel<kMask>, kFlashAttnSmem);
  if (err) return err;
  dim3 grid((L + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<kMask><<<grid, kThreads, kFlashAttnSmem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, lengths, (bf16*)out, H, L, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace herro

// window < 0: no band, every key below the length
extern "C" int herro_flash_attention(const void* q, const void* k, const void* v,
                                     const int* lengths, void* out, int B, int H, int L,
                                     int window, float scale, void* stream) {
  using namespace herro;
  if (B < 1 || H < 1 || L < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (window < 0)
    return flash_attention_launch<kMaskFull>(q, k, v, lengths, out, B, H, L, 0, scale,
                                             stream);
  return flash_attention_launch<kMaskBand>(q, k, v, lengths, out, B, H, L, window, scale,
                                           stream);
}
