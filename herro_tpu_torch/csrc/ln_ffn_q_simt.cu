// K11 on the CUDA cores: int8 LayerNorm + FFN + residual, for float32 or
// bf16 activations at any width the float32 kernels take.
//
// Replaces herro_tpu/ops/fused.py:_ln_ffn_q_kernel (via _ln_ffn_q_pallas)
// where the Hopper instance (ln_ffn_q.cu: int8 wgmma, bf16, d 256 with d_ff
// 512-1536 or d 512 with 256-1280) does not reach: float32 checkpoints,
// TINY_CONFIG (d 32, d_ff 64) and its tensor-parallel shards, d 384.
//   y   = E(LN(x));               y_i8, s_row  = quant_rows(y)   (per row over d)
//   h   = E(float(y_i8 @ W1_i8) * s_row * s1 + b1)
//   h   = E(gelu_tanh(h));        h_i8, hs_row = quant_rows(h)   (over all of d_ff)
//   out = E(x * res_scale + (float(h_i8 @ W2_i8) * hs_row * s2 + b2))
// E is x's type; both weights k-major (W1 as [f, d], W2 as [d, f]); scales
// and biases float32. The same three entry points as ln_ffn_q.cu: the whole
// function (res_scale 1), and a tensor-parallel shard's two passes
// (parallel/tensor.py): _rowmax stores each row's max |h| over the shard's
// columns and, given a buffer for them, how many columns reach it;
// _rowscale quantizes h by the given row maxima and scales x by res_scale.
//
// Bound on the H100: operations, 4 T d f int8 operations on __dp4a (at
// r10's widths, 6.2e11: about 4.6 ms at B=32, L=9216); _rowmax half of
// them.
// Design: two launches of int8_simt.cuh's tile product on one stream.
// - The hidden pass: a block takes 128 token rows, LayerNorm and the row
//   quantization once (a warp a row, the int8 rows resident in shared
//   memory), then walks the d_ff columns in tiles of 128 (64 at d_ff <= 64),
//   W1's stages streaming past. Its epilogue dequantizes, adds b1, rounds,
//   applies gelu and rounds again, keeps each row's running max |h| and its
//   tied count in registers, and stores h (of type E) to a [T, d_ff] scratch
//   the wrapper allocates (the TPU kernel keeps it in VMEM; a 128-row tile's
//   hidden at d_ff 2048 is 1 MB in float32, over a block's shared memory).
//   The row maxima meet in shared memory (atomicMax on the bits of a
//   non-negative float, then the counts of the threads that hold it).
// - The output pass: a block takes 128 rows x 128 output columns (64 at
//   d 32); each stage of the hidden is quantized by its row's scale as it is
//   staged, multiplied against W2's stage, and the epilogue adds the scaled
//   residual. The grid walks a row tile's column tiles together, so they
//   share its hidden through L2.
// _rowmax runs the hidden pass alone, storing nothing but the maxima.
#include "int8_simt.cuh"

namespace herro {
namespace ffn_simt8 {

using namespace simt8;

template <typename E, int BN, bool kStore>
__global__ void __launch_bounds__(kThreads, 2)
    hidden_kernel(const E* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const int8_t* __restrict__ w1t,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  E* __restrict__ hidden, float* __restrict__ hmax, int* __restrict__ hcnt,
                  long rows, int d, int f) {
  extern __shared__ __align__(16) int smem[];
  int* As = smem;
  int* Bs = As + (d / 4) * kApad;
  float* srow = reinterpret_cast<float*>(Bs + 2 * b_stage_words(BN));
  unsigned* smax = reinterpret_cast<unsigned*>(srow + kBM);
  int* scnt = reinterpret_cast<int*>(smax + kBM);
  const long r0 = (long)blockIdx.x * kBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int r = threadIdx.x; r < kBM; r += kThreads) smax[r] = 0u, scnt[r] = 0;
  ln_quant_rows<E>(x, rows, d, r0, ln_s, ln_b, As, srow);
  __syncthreads();
  float m[8];  // a thread's running max |h| of its 8 rows, and how many reach it
  int c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = 0.f, c[i] = 0;
  for (int n0 = 0; n0 < f; n0 += BN) {
    int acc[8][BN / 16];
    product_resident_a<BN>(acc, As, w1t, d, f, n0, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long row = r0 + tile_row(ty, i);
      const float sr = srow[tile_row(ty, i)];
#pragma unroll
      for (int g = 0; g < BN / 64; ++g) {
        const int n = n0 + tile_col(tx, 4 * g);
        if (row >= rows || n >= f) continue;  // f is a multiple of 4: four columns in or out
        float h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = round_to<E>(
              gelu_tanh(round_to<E>(dequant(acc[i][4 * g + e], sr, s1[n + e], b1[n + e]))));
          const float a = fabsf(h[e]);
          if (a > m[i]) {
            m[i] = a;
            c[i] = 1;
          } else if (a == m[i]) {
            ++c[i];
          }
        }
        if (kStore) store4(hidden + row * f + n, h);
      }
    }
  }
  if (hmax == nullptr) return;  // the same for every thread of the block
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (r0 + tile_row(ty, i) < rows) atomicMax(&smax[tile_row(ty, i)], __float_as_uint(m[i]));
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (r0 + tile_row(ty, i) < rows && __float_as_uint(m[i]) == smax[tile_row(ty, i)])
      atomicAdd(&scnt[tile_row(ty, i)], c[i]);
  __syncthreads();
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const long row = r0 + r;
    if (row >= rows) break;
    hmax[row] = __uint_as_float(smax[r]);
    if (hcnt != nullptr) hcnt[row] = scnt[r];
  }
}

template <typename E, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    out_kernel(const E* __restrict__ hidden, const float* __restrict__ hmax,
               const int8_t* __restrict__ w2t, const float* __restrict__ s2,
               const float* __restrict__ b2, const E* __restrict__ x, float res_scale,
               E* __restrict__ out, long rows, int f, int d) {
  __shared__ __align__(16) int As[2][kBK4 * kApad];
  __shared__ __align__(16) int Bs[2][b_stage_words(BN)];
  __shared__ float hs_row[kBM];
  const int n0 = blockIdx.x * BN;
  const long r0 = (long)blockIdx.y * kBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // a thread's share of a stage of A: row ar of the tile, k 16 ak4 / 4 ..
  // + 15 of the stage's 32, quantized by its row's scale as it is loaded
  const int ar = threadIdx.x / 2, ak4 = 4 * (threadIdx.x % 2);
  const long arow = r0 + ar;
  const float as = arow < rows ? quant_scale(hmax[arow]) : 1.f;
  if (threadIdx.x % 2 == 0) hs_row[ar] = as;
  auto load_a = [&](int k4, int (&ra)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float hv[4] = {0.f, 0.f, 0.f, 0.f};
      if (arow < rows) load4(hidden + arow * f + 4 * (k4 + ak4 + j), hv);
      ra[j] = (int)pack_s8(quant(hv[0], as), quant(hv[1], as), quant(hv[2], as),
                           quant(hv[3], as));
    }
  };
  auto store_a = [&](int* st, const int (&ra)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) st[(ak4 + j) * kApad + ar] = ra[j];
  };
  int acc[8][BN / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0;
  int ra[4];
  load_a(0, ra);
  int4 rb = load_w<BN>(w2t, f, d, n0, 0);
  store_a(As[0], ra);
  store_w<BN>(Bs[0], rb);
  __syncthreads();
  for (int k4 = 0, s = 0; k4 < f / 4; k4 += kBK4, s ^= 1) {
    const bool next = k4 + kBK4 < f / 4;
    if (next) {
      load_a(k4 + kBK4, ra);
      rb = load_w<BN>(w2t, f, d, n0, k4 + kBK4);
    }
    stage_dp4a<BN>(acc, As[s], Bs[s]);
    if (next) {
      store_a(As[s ^ 1], ra);
      store_w<BN>(Bs[s ^ 1], rb);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = r0 + tile_row(ty, i);
    if (row >= rows) continue;
    const float hs = hs_row[tile_row(ty, i)];
#pragma unroll
    for (int g = 0; g < BN / 64; ++g) {
      const int n = n0 + tile_col(tx, 4 * g);
      if (n >= d) continue;
      float xv[4], o[4];
      load4(x + row * d + n, xv);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = round_to<E>(__fadd_rn(__fmul_rn(xv[e], res_scale),
                                     dequant(acc[i][4 * g + e], hs, s2[n + e], b2[n + e])));
      store4(out + row * d + n, o);
    }
  }
}

// the hidden pass over every row: h into `hidden` (kStore), the row maxima
// into hmax and the tied counts into hcnt where they are not null
template <typename E, int BN, bool kStore>
int hidden_pass(const void* x, const float* ln_s, const float* ln_b, const void* w1t,
                const float* s1, const float* b1, void* hidden, float* hmax, int* hcnt,
                long rows, int d, int f, cudaStream_t stream) {
  auto kernel = hidden_kernel<E, BN, kStore>;
  const size_t smem = resident_smem(d, BN, 3);
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)((rows + kBM - 1) / kBM), kThreads, smem, stream>>>(
      (const E*)x, ln_s, ln_b, (const int8_t*)w1t, s1, b1, (E*)hidden, hmax, hcnt, rows, d, f);
  return (int)cudaGetLastError();
}

template <typename E, bool kStore>
int hidden_widths(const void* x, const float* ln_s, const float* ln_b, const void* w1t,
                  const float* s1, const float* b1, void* hidden, float* hmax, int* hcnt,
                  long rows, int d, int f, cudaStream_t stream) {
  if (f32::tile_width(f) == 64)
    return hidden_pass<E, 64, kStore>(x, ln_s, ln_b, w1t, s1, b1, hidden, hmax, hcnt, rows, d,
                                      f, stream);
  return hidden_pass<E, 128, kStore>(x, ln_s, ln_b, w1t, s1, b1, hidden, hmax, hcnt, rows, d,
                                     f, stream);
}

template <typename E>
int out_pass(const void* hidden, const float* hmax, const void* w2t, const float* s2,
             const float* b2, const void* x, float res_scale, void* out, long rows, int f, int d,
             cudaStream_t stream) {
  const unsigned row_tiles = (unsigned)((rows + kBM - 1) / kBM);
  if (f32::tile_width(d) == 64)
    out_kernel<E, 64><<<dim3(1, row_tiles), kThreads, 0, stream>>>(
        (const E*)hidden, hmax, (const int8_t*)w2t, s2, b2, (const E*)x, res_scale, (E*)out,
        rows, f, d);
  else
    out_kernel<E, 128><<<dim3((unsigned)((d + 127) / 128), row_tiles), kThreads, 0, stream>>>(
        (const E*)hidden, hmax, (const int8_t*)w2t, s2, b2, (const E*)x, res_scale, (E*)out,
        rows, f, d);
  return (int)cudaGetLastError();
}

// the hidden pass, storing h and (when hmax_out is set) its row maxima, then
// the output pass quantizing h by the maxima in hmax
template <typename E>
int both(const void* x, const float* ln_s, const float* ln_b, const void* w1t,
         const float* s1, const float* b1, const void* w2t, const float* s2, const float* b2,
         float* hmax_out, const float* hmax, float res_scale, void* hidden, void* out,
         long rows, int d, int f, cudaStream_t stream) {
  int err = hidden_widths<E, true>(x, ln_s, ln_b, w1t, s1, b1, hidden, hmax_out, nullptr, rows,
                                   d, f, stream);
  if (err) return err;
  return out_pass<E>(hidden, hmax, w2t, s2, b2, x, res_scale, out, rows, f, d, stream);
}

inline bool widths_ok(long rows, int d, int f) {
  return rows >= 1 && f32::d_model_ok(d) && f32::d_ff_ok(f);
}

}  // namespace ffn_simt8
}  // namespace herro

using herro::bf16;
namespace fs = herro::ffn_simt8;

// x and out bf16 when `is_bf16` is set, float32 otherwise; hidden [T, f] of
// x's type and hmax [T] float32 are the wrapper's scratch
extern "C" int herro_ln_ffn_q_simt(const void* x, const float* ln_s, const float* ln_b,
                                   const void* w1t, const float* s1, const float* b1,
                                   const void* w2t, const float* s2, const float* b2,
                                   void* hidden, float* hmax, void* out, long T, int d, int f,
                                   int is_bf16, void* stream) {
  if (!fs::widths_ok(T, d, f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fs::both<bf16>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, hmax, hmax, 1.f, hidden,
                          out, T, d, f, s);
  return fs::both<float>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, hmax, hmax, 1.f, hidden, out,
                         T, d, f, s);
}

// the first pass of a tensor-parallel shard: hmax [T] = max |h| of each row
// over the shard's columns, and where hcnt is not null, hcnt [T] = how many
// of them reach it
extern "C" int herro_ln_ffn_q_simt_rowmax(const void* x, const float* ln_s, const float* ln_b,
                                          const void* w1t, const float* s1, const float* b1,
                                          float* hmax, int* hcnt, long T, int d, int f,
                                          int is_bf16, void* stream) {
  if (!fs::widths_ok(T, d, f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fs::hidden_widths<bf16, false>(x, ln_s, ln_b, w1t, s1, b1, nullptr, hmax, hcnt, T,
                                          d, f, s);
  return fs::hidden_widths<float, false>(x, ln_s, ln_b, w1t, s1, b1, nullptr, hmax, hcnt, T, d,
                                         f, s);
}

// the second pass: h quantized by the given hmax [T], x scaled by res_scale;
// hidden [T, f] of x's type the wrapper's scratch
extern "C" int herro_ln_ffn_q_simt_rowscale(const void* x, const float* ln_s,
                                            const float* ln_b, const void* w1t,
                                            const float* s1, const float* b1, const void* w2t,
                                            const float* s2, const float* b2,
                                            const float* hmax, float res_scale, void* hidden,
                                            void* out, long T, int d, int f, int is_bf16,
                                            void* stream) {
  if (!fs::widths_ok(T, d, f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fs::both<bf16>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, nullptr, hmax, res_scale,
                          hidden, out, T, d, f, s);
  return fs::both<float>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, nullptr, hmax, res_scale,
                         hidden, out, T, d, f, s);
}
