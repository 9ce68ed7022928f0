// K11 on the tensor cores (mma.sync, int8): int8 LayerNorm + FFN +
// residual, for float32 or bf16 activations at any width the float32
// kernels take.
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
// The int32 products are exact, and every rounding around them is that of
// the CUDA-core int8 instance this one replaced, so its outputs are that
// instance's bit for bit.
//
// Bound on the H100: 4 T d f int8 operations at the tensor cores' int8 peak
// (1979e12/s) or the bytes of x and out, whichever is longer: at r10's
// widths in float32, B=32, L=9216, 0.31 ms of products beside 0.36 of bytes;
// _rowmax half the products and x alone. The hidden's way through the
// scratch (below) adds bytes the bound does not count: at r10 in float32 h
// written and read back as float32 (2.4 GB, 0.72 ms) and its int8 rows
// written and read (0.6 GB).
// Design: two launches of int8_simt.cuh's tensor-core product on one
// stream, 128 token rows and 8 warps a block, k in stages of 64 through a
// ring of four.
// - The hidden pass: LayerNorm and the row quantization once (a warp a
//   row, in int8_simt.cuh's order of sums, the next row's first read in
//   flight; layernorm_rows_i8), the int8 rows row-major and resident in
//   shared memory; then the d_ff columns in tiles of 128 (64 at d_ff <= 64),
//   W1's stages streaming past by cp.async. Its epilogue dequantizes, adds
//   b1, rounds, applies gelu and rounds again on each C fragment. The whole
//   function keeps each row's running max |h| in registers and stores h (of
//   type E) to the [T, d_ff] scratch the wrapper allocates (the TPU kernel
//   keeps it in VMEM; a 128-row tile's hidden at d_ff 1024 is 512 KB in
//   float32, over a block's shared memory); the row maxima meet across a
//   quad's four threads by shuffles, then across the two warps of a row in
//   shared memory (atomicMax on the bits of a non-negative float); then the
//   block quantizes its rows of h by them where they lie, each row's int8
//   values into the first d_ff bytes of its own row of the scratch, a warp
//   a row in order (the next 4 KB of them in flight while it works), so
//   that no byte is written before it is read. At d_ff <= 64 (one column
//   tile) h stays in registers until its maxima are known, and only the
//   int8 values are stored. _rowscale's maxima are given: its epilogue
//   quantizes h and stores the int8 values alone. _rowmax stores nothing
//   but the maxima, and with a buffer for them the tied counts (a thread's
//   running (max, count) pair; across the quad, equal maxima add their
//   counts and the larger takes its own; then the counts of the threads
//   that hold the row's maximum); it and the whole function skip the counts
//   otherwise.
// - The output pass: a block takes 128 rows x 128 output columns (64 at d
//   <= 64), h's int8 rows and W2's stages both by cp.async through one
//   ring, and the epilogue adds the scaled residual (at d <= 64 its values
//   loaded before the products). The grid walks a row tile's column tiles
//   together, so they share its int8 rows through L2.
// The CUDA-core instance quantized h as its output pass staged it, once for
// each of a row tile's column tiles; here each value is quantized once.
// Measured (tools/flash_rows_torch.py --against that instance's tree, one
// call, H100 at 700 W, B=32, L=9216; PERF.md section 6): r10 float32
// 6.92-7.18 -> 3.24 ms, d 384 bf16 6.85-6.92 -> 3.28, TINY_CONFIG
// 0.35-0.37 -> 0.30, every output the same bits. A hidden-pass warp's
// cycles at r10 (tools/ffn_q_simt_clocks_torch.py): LayerNorm 0.25, the
// epilogue 0.30, h quantized where it lies 0.21, products 0.12.
#include "int8_simt.cuh"

namespace herro {
namespace ffn_simt8 {

using namespace simt8;

// the merge of two (max |h|, how many reach it) pairs of one row
__device__ inline void merge_max(float& m, int& c, float m2, int c2) {
  if (m2 > m) {
    m = m2;
    c = c2;
  } else if (m2 == m) {
    c += c2;
  }
}

// 16 bytes of E as floats
__device__ inline void unpack16(const uint4& v, float (&o)[4]) {
  o[0] = __uint_as_float(v.x), o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z), o[3] = __uint_as_float(v.w);
}
__device__ inline void unpack16(const uint4& v, float (&o)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f2 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&w[i]));
    o[2 * i] = f2.x, o[2 * i + 1] = f2.y;
  }
}

// what the hidden pass keeps of h: nothing but its row maxima (_rowmax),
// and how many columns reach them (_rowmax with the tied counts); h of type
// E and the maxima, then h quantized by them where it lies (the whole
// function); or h quantized by the row maxima it is given (_rowscale)
enum HiddenMode { kMaxOnly, kMaxCount, kWhole, kScaled };

// the bytes between two rows of the scratch [T, f] of E that holds the
// hidden; its int8 row r sits in the first f bytes of its row r
template <typename E>
__host__ __device__ inline long hidden_row_bytes(int f) {
  return (long)f * sizeof(E);
}

template <typename E, int BN, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    hidden_kernel(const E* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const int8_t* __restrict__ w1t,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  uint8_t* __restrict__ hidden, float* __restrict__ hmax, int* __restrict__ hcnt,
                  const float* __restrict__ hmax_in, long rows, int d, int f) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int as = a_stride(d);
  uint8_t* As = smem;
  uint8_t* ring = As + kBM * as;
  float* srow = reinterpret_cast<float*>(ring + kTCStages * w_stage_bytes<BN>());
  unsigned* smax = reinterpret_cast<unsigned*>(srow + kBM);  // kScaled: h's row scales
  int* scnt = reinterpret_cast<int*>(smax + kBM);
  const long r0 = (long)blockIdx.x * kBM;
  const long hrow = hidden_row_bytes<E>(f);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = tc_warp_row(), wc = tc_warp_col<BN>();
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    if (kMode == kScaled)
      reinterpret_cast<float*>(smax)[r] = r0 + r < rows ? quant_scale(hmax_in[r0 + r]) : 1.f;
    else
      smax[r] = 0u, scnt[r] = 0;
  }
  layernorm_rows_i8<E>(x, rows, d, r0, ln_s, ln_b, As, as, srow);
  __syncthreads();
  float m[2][2];  // a thread's running max |h| of its rows (mt, g + 8 hf), and how many reach it
  int c[2][2];
  // the whole function at d_ff <= 64 (BN 64: one column tile) keeps h in
  // registers until its row maxima are known, and stores only its int8 values
  constexpr bool kInRegs = kMode == kWhole && BN == 64;
  float hk[2][BN / 16][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) m[mt][hf] = 0.f, c[mt][hf] = 0;
  product_resident<BN>(As, as, w1t, d, f, ring, [&](int n0, const AccI<BN>& acc) {
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt) {
      const int n = n0 + wc + 8 * nt + 2 * t;
      if (n >= f) continue;  // f is even: the pair is in or out together
      const float2 sc = *reinterpret_cast<const float2*>(s1 + n);
      const float2 bi = *reinterpret_cast<const float2*>(b1 + n);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rl = wr + 16 * mt + g + 8 * hf;
          const long row = r0 + rl;
          if (row >= rows) continue;
          const float sr = srow[rl];
          const float h0 = round_to<E>(
              gelu_tanh(round_to<E>(dequant(acc[mt][nt][2 * hf], sr, sc.x, bi.x))));
          const float h1 = round_to<E>(
              gelu_tanh(round_to<E>(dequant(acc[mt][nt][2 * hf + 1], sr, sc.y, bi.y))));
          uint8_t* dst = hidden + row * hrow;
          if constexpr (kMode == kScaled) {
            const float hs = reinterpret_cast<const float*>(smax)[rl];
            *reinterpret_cast<uint16_t*>(dst + n) =
                (uint16_t)((quant(h0, hs) & 0xff) | (quant(h1, hs) & 0xff) << 8);
          } else if constexpr (kMode == kMaxCount) {
            merge_max(m[mt][hf], c[mt][hf], fabsf(h0), 1);
            merge_max(m[mt][hf], c[mt][hf], fabsf(h1), 1);
          } else {
            m[mt][hf] = fmaxf(m[mt][hf], fmaxf(fabsf(h0), fabsf(h1)));
            if constexpr (kInRegs)
              hk[mt][nt][2 * hf] = h0, hk[mt][nt][2 * hf + 1] = h1;
            else if constexpr (kMode == kWhole)
              store2(reinterpret_cast<E*>(dst) + n, h0, h1);
          }
        }
    }
  });
  if constexpr (kMode != kScaled) {
    // the quad's four threads share a row
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float m2 = __shfl_xor_sync(0xffffffffu, m[mt][hf], o);
          if constexpr (kMode == kMaxCount)
            merge_max(m[mt][hf], c[mt][hf], m2, __shfl_xor_sync(0xffffffffu, c[mt][hf], o));
          else
            m[mt][hf] = fmaxf(m[mt][hf], m2);
        }
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rl = wr + 16 * mt + g + 8 * hf;
          if (r0 + rl < rows) atomicMax(&smax[rl], __float_as_uint(m[mt][hf]));
        }
    }
    __syncthreads();
    if (kMode == kMaxCount && t == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rl = wr + 16 * mt + g + 8 * hf;
          if (r0 + rl < rows && __float_as_uint(m[mt][hf]) == smax[rl])
            atomicAdd(&scnt[rl], c[mt][hf]);
        }
    }
    if (kMode == kMaxCount) __syncthreads();
    for (int r = threadIdx.x; r < kBM; r += kThreads) {
      const long row = r0 + r;
      if (row >= rows) break;
      hmax[row] = __uint_as_float(smax[r]);
      if (kMode == kMaxCount) hcnt[row] = scnt[r];
    }
  }
  if constexpr (kInRegs) {
    // h quantized by its row's maximum from the registers
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt) {
      const int n = wc + 8 * nt + 2 * t;
      if (n >= f) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rl = wr + 16 * mt + g + 8 * hf;
          if (r0 + rl >= rows) continue;
          const float hs = quant_scale(__uint_as_float(smax[rl]));
          *reinterpret_cast<uint16_t*>(hidden + (r0 + rl) * hrow + n) =
              (uint16_t)((quant(hk[mt][nt][2 * hf], hs) & 0xff) |
                         (quant(hk[mt][nt][2 * hf + 1], hs) & 0xff) << 8);
        }
    }
  } else if constexpr (kMode == kWhole) {
    // h quantized by its row's maximum where it lies. A warp takes its rows
    // (warp, warp + 8, ...) in units of up to 4 KB of a row (16 bytes of E a
    // lane a load, kSeg loads), the next unit's loads in flight while this
    // one is quantized; a unit's int8 values go over bytes of E it or an
    // earlier unit of its row read, and only this warp reads the row
    constexpr int kVec = 16 / (int)sizeof(E), kSeg = 8, kStep = kThreads / 32;
    const int warp = threadIdx.x / 32, per_row = f / kVec;  // f is a multiple of 32
    const int segs = (per_row + 32 * kSeg - 1) / (32 * kSeg);
    const int my_rows = (int)((min((long)kBM, rows - r0) - warp + kStep - 1) / kStep);
    const int units = my_rows > 0 ? my_rows * segs : 0;
    auto load = [&](int u, uint4 (&v)[kSeg]) {
      const E* hr = reinterpret_cast<const E*>(hidden + (r0 + warp + kStep * (u / segs)) * hrow);
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int e = (u % segs) * 32 * kSeg + 32 * i + lane;
        if (e < per_row) v[i] = *reinterpret_cast<const uint4*>(hr + kVec * e);
      }
    };
    uint4 next[kSeg];
    if (units > 0) load(0, next);
    for (int u = 0; u < units; ++u) {
      uint4 v[kSeg];
#pragma unroll
      for (int i = 0; i < kSeg; ++i) v[i] = next[i];
      __syncwarp();  // every lane's loads of this unit before any lane's stores
      if (u + 1 < units) load(u + 1, next);
      const int r = warp + kStep * (u / segs);
      const float hs = quant_scale(__uint_as_float(smax[r]));
      uint8_t* hr = hidden + (r0 + r) * hrow;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int e = (u % segs) * 32 * kSeg + 32 * i + lane;
        if (e >= per_row) continue;
        float h[kVec];
        unpack16(v[i], h);
        uint32_t w[kVec / 4];
#pragma unroll
        for (int j = 0; j < kVec / 4; ++j)
          w[j] = pack_s8(quant(h[4 * j], hs), quant(h[4 * j + 1], hs), quant(h[4 * j + 2], hs),
                         quant(h[4 * j + 3], hs));
        if constexpr (kVec == 4)
          *reinterpret_cast<uint32_t*>(hr + kVec * e) = w[0];
        else
          *reinterpret_cast<uint2*>(hr + kVec * e) = make_uint2(w[0], w[1]);
      }
    }
  }
}

// the bytes of the output pass's ring: a stage is the A tile's kBM int8 rows
// and W2's BN, kSS bytes each; then the rows' scales
template <int BN>
constexpr int out_smem() {
  return kTCStages * (kBM * kSS + w_stage_bytes<BN>()) + kBM * 4;
}

// out [T, d] = E(x * res_scale + dequant(h_i8 @ W2)), h_i8 the hidden's
// int8 rows (hrow bytes apart) and hmax their maxima
template <typename E, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    out_kernel(const uint8_t* __restrict__ hq, long hrow, const float* __restrict__ hmax,
               const int8_t* __restrict__ w2t, const float* __restrict__ s2,
               const float* __restrict__ b2, const E* __restrict__ x, float res_scale,
               E* __restrict__ out, long rows, int f, int d) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kStage = kBM * kSS + w_stage_bytes<BN>();
  float* hs_row = reinterpret_cast<float*>(smem + kTCStages * kStage);
  const int n0 = blockIdx.x * BN;
  const long r0 = (long)blockIdx.y * kBM;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = tc_warp_row(), wc = tc_warp_col<BN>();
  for (int r = threadIdx.x; r < kBM; r += kThreads)
    hs_row[r] = r0 + r < rows ? quant_scale(hmax[r0 + r]) : 1.f;
  // stage kt: A's rows r0 .. r0 + kBM - 1 and W2's columns n0 .. n0 + BN - 1
  // at k 64 kt .. 64 kt + 63 (rows past T and k past f zero-filled)
  auto copy = [&](int kt, uint8_t* st) {
    const int k0 = kt * kKB;
    for (int e = threadIdx.x; e < kBM * (kKB / 16); e += kThreads) {
      const int r = e / (kKB / 16), cc = (e % (kKB / 16)) * 16;
      const bool ok = r0 + r < rows && k0 + cc < f;
      cp_async16(st + r * kSS + cc, ok ? hq + (r0 + r) * hrow + k0 + cc : hq, ok);
    }
    copy_w<BN>(w2t, f, d, n0, k0, st + kBM * kSS);
  };
  const int nk = (f + kKB - 1) / kKB;  // stages
#pragma unroll
  for (int i = 0; i < kTCStages - 1; ++i) {
    if (i < nk) copy(i, smem + i * kStage);
    cp_async_commit();
  }
  // the residual's values of the thread's outputs, loaded while the stages
  // land where the tile is narrow (BN 64: d <= 64, a stage or two of k)
  constexpr bool kEarlyX = BN == 64;
  float2 xe[2][BN / 16][2];
  if constexpr (kEarlyX) {
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long row = r0 + wr + 16 * mt + g + 8 * hf;
          const int n = n0 + wc + 8 * nt + 2 * t;
          if (row < rows && n < d) xe[mt][nt][hf] = load2(x + row * d + n);
        }
  }
  AccI<BN> acc;
  zero_acc<BN>(acc);
  for (int kt = 0, s = 0; kt < nk; ++kt, s = s + 1 == kTCStages ? 0 : s + 1) {
    // stage kt is in, and every warp is done with stage kt - 1, whose
    // buffer takes stage kt + kTCStages - 1
    cp_async_wait<kTCStages - 2>();
    __syncthreads();
    if (kt + kTCStages - 1 < nk)
      copy(kt + kTCStages - 1, smem + (s == 0 ? kTCStages - 1 : s - 1) * kStage);
    cp_async_commit();
    const uint8_t* st = smem + s * kStage;
    stage_mma<BN>(acc, st + wr * kSS, kSS, st + kBM * kSS);
  }
#pragma unroll
  for (int nt = 0; nt < BN / 16; ++nt) {
    const int n = n0 + wc + 8 * nt + 2 * t;
    if (n >= d) continue;  // d is even: the pair is in or out together
    const float2 sc = *reinterpret_cast<const float2*>(s2 + n);
    const float2 bi = *reinterpret_cast<const float2*>(b2 + n);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rl = wr + 16 * mt + g + 8 * hf;
        const long row = r0 + rl;
        if (row >= rows) continue;
        const float hs = hs_row[rl];
        const long i = row * d + n;
        const float2 xv = kEarlyX ? xe[mt][nt][hf] : load2(x + i);
        store2(out + i,
               round_to<E>(__fadd_rn(__fmul_rn(xv.x, res_scale),
                                     dequant(acc[mt][nt][2 * hf], hs, sc.x, bi.x))),
               round_to<E>(__fadd_rn(__fmul_rn(xv.y, res_scale),
                                     dequant(acc[mt][nt][2 * hf + 1], hs, sc.y, bi.y))));
      }
  }
}

// the hidden pass over every row (kMode), into the scratch `hidden`; the row
// maxima into hmax and the tied counts into hcnt where they are not null;
// hmax_in the given maxima of kScaled
template <typename E, int kMode>
int hidden_pass(const void* x, const float* ln_s, const float* ln_b, const void* w1t,
                const float* s1, const float* b1, void* hidden, float* hmax, int* hcnt,
                const float* hmax_in, long rows, int d, int f, cudaStream_t stream) {
  auto launch = [&](auto kernel, int stage_bytes) {
    const size_t smem = (size_t)kBM * a_stride(d) + kTCStages * stage_bytes + 3 * kBM * 4;
    int err = set_smem((const void*)kernel, smem);
    if (err) return err;
    kernel<<<(unsigned)((rows + kBM - 1) / kBM), kThreads, smem, stream>>>(
        (const E*)x, ln_s, ln_b, (const int8_t*)w1t, s1, b1, (uint8_t*)hidden, hmax, hcnt,
        hmax_in, rows, d, f);
    return (int)cudaGetLastError();
  };
  if (f32::tile_width(f) == 64) return launch(hidden_kernel<E, 64, kMode>, w_stage_bytes<64>());
  return launch(hidden_kernel<E, 128, kMode>, w_stage_bytes<128>());
}

template <typename E>
int out_pass(const void* hidden, const float* hmax, const void* w2t, const float* s2,
             const float* b2, const void* x, float res_scale, void* out, long rows, int f, int d,
             cudaStream_t stream) {
  auto launch = [&](auto kernel, int BN, int smem) {
    int err = set_smem((const void*)kernel, smem);
    if (err) return err;
    const dim3 grid((unsigned)((d + BN - 1) / BN), (unsigned)((rows + kBM - 1) / kBM));
    kernel<<<grid, kThreads, smem, stream>>>((const uint8_t*)hidden, hidden_row_bytes<E>(f),
                                             hmax, (const int8_t*)w2t, s2, b2, (const E*)x,
                                             res_scale, (E*)out, rows, f, d);
    return (int)cudaGetLastError();
  };
  if (f32::tile_width(d) == 64) return launch(out_kernel<E, 64>, 64, out_smem<64>());
  return launch(out_kernel<E, 128>, 128, out_smem<128>());
}

// the hidden pass then the output pass: the whole function where hmax_out
// is set (h's row maxima found and stored there), else _rowscale's second
// pass on the given maxima hmax
template <typename E>
int both(const void* x, const float* ln_s, const float* ln_b, const void* w1t,
         const float* s1, const float* b1, const void* w2t, const float* s2, const float* b2,
         float* hmax_out, const float* hmax, float res_scale, void* hidden, void* out,
         long rows, int d, int f, cudaStream_t stream) {
  int err = hmax_out != nullptr
                ? hidden_pass<E, kWhole>(x, ln_s, ln_b, w1t, s1, b1, hidden, hmax_out, nullptr,
                                         nullptr, rows, d, f, stream)
                : hidden_pass<E, kScaled>(x, ln_s, ln_b, w1t, s1, b1, hidden, nullptr, nullptr,
                                          hmax, rows, d, f, stream);
  if (err) return err;
  return out_pass<E>(hidden, hmax, w2t, s2, b2, x, res_scale, out, rows, f, d, stream);
}

inline bool widths_ok(long rows, int d, int f) {
  return rows >= 1 && f32::int8_d_model_ok(d) && f32::int8_d_ff_ok(f);
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
    return hcnt != nullptr ? fs::hidden_pass<bf16, fs::kMaxCount>(x, ln_s, ln_b, w1t, s1, b1,
                                                                   nullptr, hmax, hcnt, nullptr,
                                                                   T, d, f, s)
                           : fs::hidden_pass<bf16, fs::kMaxOnly>(x, ln_s, ln_b, w1t, s1, b1,
                                                                  nullptr, hmax, nullptr, nullptr,
                                                                  T, d, f, s);
  return hcnt != nullptr ? fs::hidden_pass<float, fs::kMaxCount>(x, ln_s, ln_b, w1t, s1, b1,
                                                                  nullptr, hmax, hcnt, nullptr, T,
                                                                  d, f, s)
                         : fs::hidden_pass<float, fs::kMaxOnly>(x, ln_s, ln_b, w1t, s1, b1,
                                                                 nullptr, hmax, nullptr, nullptr,
                                                                 T, d, f, s);
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
