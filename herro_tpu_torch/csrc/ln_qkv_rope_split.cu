// K8: LayerNorm + qkv projection + rotary epilogue with the rope tables built
// inside the kernel (the split-half route, HERRO_TPU_ROPE=split).
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_kernel (via
// _ln_qkv_rope_pallas with rope_tbl=False; tables from _rope_tables_blk,
// rotation by _rope_apply).
// The function is K1's (ln_qkv_rope.cu) without the table inputs: qkv =
// bf16(LN(x) @ W + b); q and k take the rotate-half rope at the absolute
// column index in float32 and are rounded again; v passes through. Outputs
// are [B, H, L, D] with D = 128.
// Bound on the H100: operations (2*T*d*3*H*D) over the bf16 tensor-core rate.
// Design: K1's (a block owns 128 token rows, normalised once into shared
// memory; 8 warps of 16 rows walk the 3*H column blocks on mma.sync m16n8k16),
// plus rope.cuh's tables: the block computes cos/sin of its 128 rows x 64
// frequencies once into 72 KB of shared memory, beside the 150 KB K1 holds at
// d = 512 (224 KB of the 227 KB a block may use), and every q and k column
// block reads them from there.
#include "rope.cuh"

namespace herro {

constexpr int kD = 128;    // head dim (every shipped checkpoint)
constexpr int kRows = kRopeRows;  // token rows per block: 8 warps x 16

inline size_t qkv_split_smem(int d) {
  return align128((size_t)kRows * (d + 8) * 2) + kRopeBytes + kStageBytes;
}

__global__ void __launch_bounds__(kThreads)
ln_qkv_rope_split_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                         const float* __restrict__ ln_b, const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, bf16* __restrict__ q,
                         bf16* __restrict__ k, bf16* __restrict__ v, int B, int L, int d,
                         int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = d + 8;
  const size_t off_rope = align128((size_t)kRows * ldy * 2);
  bf16* y = reinterpret_cast<bf16*>(smem);
  float* cos_s = reinterpret_cast<float*>(smem + off_rope);
  float* sin_s = cos_s + kRows * kRopeLd;
  bf16* stage = reinterpret_cast<bf16*>(smem + off_rope + kRopeBytes);
  const long T = (long)B * L;
  const long row0 = (long)blockIdx.x * kRows;
  const int N = 3 * H * kD;

  layernorm_rows(x, ln_s, ln_b, row0, kRows, T, d, y, ldy);
  build_rope_tables(row0, L, cos_s, sin_s);
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
      const int r = warp * 16 + g + 8 * rr;
      const long row = row0 + r;
      if (row >= T) continue;
      const long b = row / L, l = row % L;
      bf16* o = dst + (((size_t)b * H + h) * L + l) * kD;
#pragma unroll
      for (int nn = 0; nn < half / 8; ++nn) {
        const int c = nn * 8 + 2 * t;  // first-half column; its pair is c + D/2
        float o1[2], o2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          o1[e] = bf16_round(acc[nn][2 * rr + e] + __bfloat162float(bias[n0 + c + e]));
          o2[e] = bf16_round(acc[nn + half / 8][2 * rr + e] +
                             __bfloat162float(bias[n0 + half + c + e]));
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

extern "C" int herro_ln_qkv_rope_split(const void* x, const float* ln_s, const float* ln_b,
                                       const void* w, const void* b, void* q, void* k,
                                       void* v, int B, int L, int d, int H, void* stream) {
  using namespace herro;
  if (d % kChunkK) return (int)cudaErrorInvalidValue;
  const size_t smem = qkv_split_smem(d);
  int err = set_smem((const void*)ln_qkv_rope_split_kernel, smem);
  if (err) return err;
  const long T = (long)B * L;
  const unsigned grid = (unsigned)((T + kRows - 1) / kRows);
  ln_qkv_rope_split_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, ln_s, ln_b, (const bf16*)w, (const bf16*)b, (bf16*)q, (bf16*)k,
      (bf16*)v, B, L, d, H);
  return (int)cudaGetLastError();
}
