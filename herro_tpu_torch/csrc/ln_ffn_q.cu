// K11: int8 LayerNorm + FFN + residual, the hidden kept on chip.
//
// Replaces herro_tpu/ops/fused.py:_ln_ffn_q_kernel (via _ln_ffn_q_pallas).
//   y   = bf16(LN(x));            y_i8, s_row  = quant_rows(y)   (per row over d)
//   h   = bf16(float(y_i8 @ W1_i8) * s_row * s1 + b1)
//   h   = bf16(gelu_tanh(h));     h_i8, hs_row = quant_rows(h)   (over all of d_ff)
//   out = bf16(x + (float(h_i8 @ W2_i8) * hs_row * s2 + b2))
// Both weights arrive k-major (W1 as [f, d], W2 as [d, f]): int8 wgmma has
// no transpose, so both of its operands are K-major. The scales and biases
// are float32.
//
// Two more modes (template flag M) serve a tensor-parallel shard, which
// holds d_ff / tp columns of W1 and rows of W2 while h is quantized over the
// whole row (herro_tpu_torch/parallel/tensor.py runs them around one
// all-reduce of the row maxima):
// - kRowMax (entry herro_ln_ffn_q_rowmax) stops after GEMM1's epilogue and
//   stores each row's max|h| over the shard's columns, float32 [T]; asked
//   for them (Ties, under autograd), also how many of those columns reach
//   it, int32 [T], the share of the maximum's gradient that the shard's
//   ties take (parallel/tensor.py:all_reduce_max). The count costs the
//   epilogue a compare and a select a value, so inference takes the
//   instance without it;
// - kRowScale (herro_ln_ffn_q_rowscale) runs GEMM1 again, quantizes h by the
//   given row maxima instead of its own, and adds x * res_scale (x / tp,
//   exact for tp 2 or 4) where the whole kernel adds x.
// GEMM1 is recomputed rather than h stored between the passes: at B=32,
// L=9216 and tp 2 the bf16 hidden would be written and read back (2 x 302
// MB, about 0.18 ms at 3.35 TB/s) where the second GEMM1 costs 1.5e11 int8
// operations, about 0.08 ms at the int8 tensor-core rate.
//
// Bound on the H100: operations, 4*T*d*f over the int8 tensor-core rate;
// the two modes at the shard widths mostly bytes: x read (kRowMax), x read
// and out written (kRowScale).
//
// Design (sm_90a), K3's (ln_ffn.cu) with int8 wgmma: a persistent grid, one
// block per SM walking 64-row tiles, each block three warpgroups.
// - A producer warp streams W1 and W2 through a ring of 16 KB slots by TMA,
//   in the order the consumers take them: per 128-column chunk of the
//   hidden, d/128 stages of W1 ([128 rows][128 k], 128-byte swizzle); then
//   f/32 stages of W2 ([d rows][32 k], 32-byte swizzle, so that one stage
//   holds a k-step of every output column). Blocks run in clusters of
//   kCluster that walk the same weight stream; each loads its share of a
//   stage's boxes and multicasts them, so L2 serves each weight byte once
//   per kCluster tiles. The producer also loads each tile's x by TMA.
// - Two consumer warpgroups. LayerNorm, rounded to bf16, then quantized per
//   row into y_i8, written in the swizzled layout of wgmma's A operand. Per
//   chunk, each warpgroup computes half of the chunk's 128 hidden columns
//   (m64n64k32), then dequantizes, adds b1, rounds, applies gelu_tanh and
//   rounds in registers, keeps each row's running max|h| and stores the bf16
//   hidden. The second quantization needs the maximum of the whole d_ff row,
//   known only after the last chunk, so the [64, f] hidden stays in shared
//   memory (128 KB at f 1024) and is quantized there in place; then each
//   warpgroup accumulates its half of the output columns over K = f
//   (m64n256k32 at d 512, 128 int32 registers a thread), and the epilogue
//   applies hs_row, s2, b2 and the residual.
// - The in-place quantization: the bf16 hidden is stored column-chunk-major,
//   one 8 KB block of [64 rows][64 columns] after another, and the int8
//   hidden in 8 KB blocks of [64 rows][128 columns] (the A layout), so int8
//   block j lands on bf16 block j, whose columns (64j..) were quantized
//   already, into int8 block j/2. Per int8 block, every thread of a
//   warpgroup reads its values, one barrier, then writes. The int8 hidden
//   fills the lower half of the buffer; the next tile's x lands by TMA in
//   the upper half while this tile's GEMM2 runs. At d 256 and f >= 768,
//   y_i8 too lives in the upper half (in the last chunk's bf16 blocks, which
//   the last epilogue writes once both warpgroups' products are done), so
//   (256, 1536) fits in a two-slot ring.
// - Every rounding follows the plain version as it runs on the card
//   (fused.py:_ln_ffn_q_plain): LayerNorm's variance, normalisation and
//   affine in separate roundings and rsqrtf, as torch.rsqrt; gelu_tanh as
//   PyTorch's CUDA kernel computes it; true divisions in the quantization.
//   Only the order of LayerNorm's two sums differs.
// - setmaxnreg gives the consumers 232 registers and the producer 40; the
//   accumulators are never written by hand (a write while a product is in
//   flight serialises every wgmma).
// - Below f 2d (r10's shards: f 512 at tp 2, 256 at tp 4) x does not fit in
//   the upper half of the hidden and takes a buffer of its own; nothing else
//   changes.
// Shapes: d 256 or 512; f a multiple of 128, as far as shared memory holds
// the hidden and a ring of two slots (plan() below: f up to 1536 at d 256,
// 1280 at d 512; the wrapper takes f from 512 at d 256 and from 256 at d
// 512); any T >= 1 (rows past T read as zeros and are not stored).
#include "int8.cuh"
#include "sm90.cuh"

namespace herro {
namespace ffn_q {

using namespace sm90;

constexpr int kBM = 64;              // token rows per tile
constexpr int kFC = 128;             // hidden columns per GEMM1 chunk
constexpr int kBlock = kBM * 128;    // one swizzled [64 rows][128 bytes] block
constexpr int kSlotBytes = 16384;    // one ring slot
constexpr int kMaxSlots = 4;
constexpr int kSmallBytes = 1024;    // row maxima, row scales, barriers
constexpr int kThreadsFfnQ = 384;    // two consumer warpgroups and a producer
constexpr int kCluster = 2;          // blocks sharing one weight stream

// modes (the head of the file)
constexpr int kWhole = 0, kRowMax = 1, kRowScale = 2;

// shared-memory plan for (d, f):
// [ring][hidden][x if its own][y_i8 unless in the hidden][small]
struct Plan {
  int slots;        // ring slots, 0 when (d, f) does not fit
  bool y_in_h;      // y_i8 in the last chunk's bf16 blocks of the hidden
  bool x_own;       // x in a buffer of its own (f < 2d), not the hidden's upper half
  size_t h_off, x_off, y_off, small_off, bytes;
};

__host__ __device__ inline Plan plan(int d, int f) {
  Plan p;
  const size_t h_bytes = (size_t)kBM * f * 2;
  const size_t x_bytes = (size_t)kBM * d * 2;
  p.y_in_h = kBM * d <= 2 * kBlock && f >= 3 * d;
  p.x_own = f < 2 * d;
  const size_t fixed =
      h_bytes + (p.x_own ? x_bytes : 0) + (p.y_in_h ? 0 : (size_t)kBM * d) + kSmallBytes;
  const long room = (long)kMaxSmem - 1024 - (long)fixed;
  p.slots = room < 0 ? 0 : (int)(room / kSlotBytes < kMaxSlots ? room / kSlotBytes : kMaxSlots);
  if ((d != 256 && d != 512) || f < kFC || f % kFC || p.slots < 2) p.slots = 0;
  p.h_off = (size_t)p.slots * kSlotBytes;
  const size_t after_x = p.h_off + h_bytes + (p.x_own ? x_bytes : 0);
  p.x_off = p.x_own ? p.h_off + h_bytes : p.h_off + (size_t)kBM * f;  // else the upper half
  p.y_off = p.y_in_h ? p.h_off + h_bytes - (size_t)kBM * d : after_x;
  p.small_off = after_x + (p.y_in_h ? 0 : (size_t)kBM * d);
  p.bytes = 1024 + p.small_off + kSmallBytes;
  return p;
}

// a running maximum m and how many values c reached it (kRowMax's tied
// count): a value above m restarts the count, one equal to m adds to it
__device__ inline void tally(float& m, int& c, float v) {
  if (v > m) {
    m = v;
    c = 1;
  } else if (v == m) {
    ++c;
  }
}

// (m, c) and (m2, c2) of two sets of values as the pair of their union
__device__ inline void merge_tally(float& m, int& c, float m2, int c2) {
  c = m2 > m ? c2 : (m2 == m ? c + c2 : c);
  m = fmaxf(m, m2);
}

// h_i8 over the bf16 hidden, in place (see the head of the file), for the
// warpgroup's 32 rows: per int8 block j, a thread quantizes two 16-byte
// units, row 32 wg + t/8 (and 16 rows further), 16-byte chunk t % 8.
__device__ inline void quant_hidden(unsigned char* hbuf, const float* smax, int n_chunks,
                                    int wg, int t) {
  const int c = t & 7;
  int rr[2];
  float hs[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    rr[u] = wg * 32 + (t >> 3) + 16 * u;
    hs[u] = quant_scale(fmaxf(smax[rr[u]], smax[kBM + rr[u]]));
  }
  for (int j = 0; j < n_chunks; ++j) {
    // int8 columns 128j + 16c .. + 15: bf16 block 2j + c/4, chunks 2(c%4), 2(c%4)+1
    const unsigned char* src = hbuf + (2 * j + (c >> 2)) * kBlock;
    uint4 v[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[u][e] = *reinterpret_cast<const uint4*>(src + swizzle128(rr[u], 2 * (c & 3) + e));
    named_bar_sync(5 + wg, 128);  // block j's bf16 values were all read (at j/2 <= j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bf162* p = reinterpret_cast<const bf162*>(v[u]);
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 a = __bfloat1622float2(p[2 * k]), b = __bfloat1622float2(p[2 * k + 1]);
        w[k] = pack_s8(quant(a.x, hs[u]), quant(a.y, hs[u]), quant(b.x, hs[u]),
                       quant(b.y, hs[u]));
      }
      *reinterpret_cast<uint4*>(hbuf + j * kBlock + swizzle128(rr[u], c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// hmax: the row maxima M stores (kRowMax) or reads (kRowScale); hcnt: the
// tied counts kRowMax stores beside them when Ties; res_scale multiplies the
// residual x (1 in kWhole)
template <int D, int M, bool Ties>
__global__ void __launch_bounds__(kThreadsFfnQ, 1)
ln_ffn_q_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap w1_map,
                const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
                const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const float* __restrict__ s2, const float* __restrict__ b2,
                float* __restrict__ hmax, int* __restrict__ hcnt, float res_scale,
                bf16* __restrict__ out, long T, int f) {
  constexpr int kN2 = D / 2;           // output columns per consumer
  constexpr int kW2Box = kN2 * 32;     // [kN2 rows][32 k]: a consumer's half of a W2 stage
  constexpr int kS1 = D / 128;         // W1 stages per chunk
  const Plan p = plan(D, f);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* hbuf = smem + p.h_off;
  unsigned char* xt = smem + p.x_off;
  unsigned char* yq = smem + p.y_off;
  float* smax = reinterpret_cast<float*>(smem + p.small_off);  // [2][64]: per warpgroup
  float* srow = smax + 2 * kBM;                                // [64]: y's row scales
  // [2][64]: the tied counts per warpgroup, in the hidden kRowMax does not keep
  int* scnt = reinterpret_cast<int*>(hbuf);
  uint64_t* full = reinterpret_cast<uint64_t*>(srow + kBM);
  uint64_t* empty = full + kMaxSlots;
  uint64_t* x_full = empty + kMaxSlots;  // the tile's x has landed in `xt`
  uint64_t* h_free = x_full + 1;         // the upper half of the hidden is free for x

  const long n_tiles = (T + kBM - 1) / kBM;
  const int n_chunks = f / kFC;
  const int n_w2 = f / 32;
  constexpr int C = kCluster;
  const uint32_t rank = cluster_rank();
  const long group = cluster_id(), n_groups = cluster_count();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * C);
    }
    mbar_init(x_full, 1);
    mbar_init(h_free, 1);
    fence_barrier_init();
  }
  cluster_sync();  // the peers' barriers exist before anyone multicasts to them

  // the blocks of a cluster take C consecutive tiles per iteration; a block
  // whose tile lies past the end runs it on zero rows and stores nothing,
  // so that it keeps its share of the cluster's weight stream
  auto first_tile = [&](long it) { return (it * n_groups + group) * C; };

  if (threadIdx.x >= 256) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    prefetch_map(&x_map);
    prefetch_map(&w1_map);
    if constexpr (M != kRowMax) prefetch_map(&w2_map);
    int slot = 0;
    uint32_t phase = 0, free_phase = 0;
    auto acquire = [&](uint32_t bytes) {
      mbar_wait(&empty[slot], phase ^ 1);
      mbar_expect_tx(&full[slot], bytes);
      return ring + slot * kSlotBytes;
    };
    auto advance = [&]() {
      if (++slot == p.slots) {
        slot = 0;
        phase ^= 1;
      }
    };
    auto load = [&](void* dst, const CUtensorMap* map, int c0, int c1) {
      tma_load_2d_multicast(dst, map, &full[slot], c0, c1, (uint16_t)((1 << C) - 1));
    };
    for (long it = 0; first_tile(it) < n_tiles; ++it) {
      // this tile's x into the hidden's upper half once the last tile's
      // quantization has read it
      mbar_wait(h_free, free_phase ^ 1);
      free_phase ^= 1;
      mbar_expect_tx(x_full, kBM * D * 2);
      for (int b = 0; b < D / 64; ++b)
        tma_load_2d(xt + b * kBlock, &x_map, x_full, b * 64,
                    (int)((first_tile(it) + rank) * kBM));
      for (int c = 0; c < n_chunks; ++c)
        for (int s = 0; s < kS1; ++s) {
          unsigned char* dst = acquire(kSlotBytes);
          for (int b = rank; b < 2; b += C)
            load(dst + b * kBlock, &w1_map, s * 128, c * kFC + b * 64);
          advance();
        }
      for (int s = 0; s < (M == kRowMax ? 0 : n_w2); ++s) {
        unsigned char* dst = acquire(2 * kW2Box);
        for (int b = rank; b < 2; b += C) load(dst + b * kW2Box, &w2_map, s * 32, b * kN2);
        advance();
      }
    }
    // every slot released by every consumer of the cluster: no block may
    // exit while a peer can still arrive on its barriers
    for (int s = 0; s < p.slots; ++s) {
      mbar_wait(&empty[slot], phase ^ 1);
      advance();
    }
    return;
  }

  // ---------------- consumers ----------------
  reg_alloc<232>();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's rows of the tile
  int slot = 0, held = -1;
  uint32_t phase = 0, x_phase = 0;
  // release a slot to the producers of the cluster once its products are done
  auto release = [&](int s) {
    if (t < C) mbar_arrive_cluster(&empty[s], t);
  };
  // after committing a group on `slot`: the group before it is done
  auto retire_previous = [&]() {
    wgmma_wait<1>();
    if (held >= 0) release(held);
    held = slot;
    if (++slot == p.slots) {
      slot = 0;
      phase ^= 1;
    }
  };
  auto retire_all = [&]() {
    wgmma_wait<0>();
    if (held >= 0) release(held);
    held = -1;
  };

  for (long it = 0; first_tile(it) < n_tiles; ++it) {
    const long row0 = (first_tile(it) + rank) * kBM;
    mbar_wait(x_full, x_phase);
    x_phase ^= 1;
    ln_quant_tile<D, kBM>(ln_s, ln_b, xt, yq, srow);
    fence_proxy_async();
    named_bar_sync(1, 256);  // y_i8 complete; both warpgroups' last GEMM2 done

    const float sra = srow[ra], srb = srow[rb];
    float ma = 0.f, mb = 0.f;  // running max|h| of rows ra, rb over this thread's columns
    int ca = 0, cb = 0;        // Ties: how many of those columns reach it
    for (int c = 0; c < n_chunks; ++c) {
      int acc1[32];
      for (int s = 0; s < kS1; ++s) {
        mbar_wait(&full[slot], phase);
        const unsigned char* wb = ring + slot * kSlotBytes + wg * kBlock;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = wgmma_desc(yq + s * kBlock + kk * 32, 16, 1024);
          const uint64_t db = wgmma_desc(wb + kk * 32, 16, 1024);
          wgmma_s8_n64(acc1, da, db, s > 0 || kk > 0);
        }
        wgmma_commit();
        retire_previous();
      }
      retire_all();
      fence_operand(acc1);
      // y_i8 in the last chunk's blocks: both warpgroups' products are done
      if (p.y_in_h && c == n_chunks - 1) named_bar_sync(2, 256);

      // h = bf16(gelu(bf16(dequant(acc) + b1))) into bf16 block 2c + wg
      unsigned char* hc = hbuf + (2 * c + wg) * kBlock;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kFC + wg * 64 + 8 * j + 2 * q;
        const float sc0 = s1[col], sc1 = s1[col + 1], bb0 = b1[col], bb1 = b1[col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float sr = half ? srb : sra;
          const bf162 hv = __floats2bfloat162_rn(
              gelu_tanh(bf16_round(dequant(acc1[4 * j + 2 * half], sr, sc0, bb0))),
              gelu_tanh(bf16_round(dequant(acc1[4 * j + 2 * half + 1], sr, sc1, bb1))));
          if constexpr (Ties) {
            const float2 hf = __bfloat1622float2(hv);
            if (half) {
              tally(mb, cb, fabsf(hf.x));
              tally(mb, cb, fabsf(hf.y));
            } else {
              tally(ma, ca, fabsf(hf.x));
              tally(ma, ca, fabsf(hf.y));
            }
          } else if constexpr (M != kRowScale) {
            const float2 hf = __bfloat1622float2(hv);
            const float m = fmaxf(fabsf(hf.x), fabsf(hf.y));
            if (half) mb = fmaxf(mb, m); else ma = fmaxf(ma, m);
          }
          if constexpr (M != kRowMax)  // kRowMax keeps no hidden
            *reinterpret_cast<bf162*>(hc + swizzle128(ra + 8 * half, j) + 4 * q) = hv;
        }
      }
    }
    if constexpr (M == kRowScale) {
      // the given maxima, over every shard's columns (zero past T)
      if (threadIdx.x < kBM) {
        const long row = row0 + threadIdx.x;
        smax[threadIdx.x] = row < T ? hmax[row] : 0.f;
        smax[kBM + threadIdx.x] = 0.f;
      }
    } else {
      // the row maxima over the row's four lanes, then over the warpgroups
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float oa = __shfl_xor_sync(0xffffffffu, ma, o);
        const float ob = __shfl_xor_sync(0xffffffffu, mb, o);
        if constexpr (Ties) {
          const int na = __shfl_xor_sync(0xffffffffu, ca, o);
          const int nb = __shfl_xor_sync(0xffffffffu, cb, o);
          merge_tally(ma, ca, oa, na);
          merge_tally(mb, cb, ob, nb);
        } else {
          ma = fmaxf(ma, oa);
          mb = fmaxf(mb, ob);
        }
      }
      if (q == 0) {
        smax[wg * kBM + ra] = ma;
        smax[wg * kBM + rb] = mb;
        if constexpr (Ties) {
          scnt[wg * kBM + ra] = ca;
          scnt[wg * kBM + rb] = cb;
        }
      }
    }
    named_bar_sync(3, 256);  // the bf16 hidden and both warpgroups' maxima are in place
    if constexpr (M == kRowMax) {
      // (the next tile writes smax only after its barrier 1, which these
      // threads reach once they have read it)
      if (threadIdx.x < kBM && row0 + threadIdx.x < T) {
        if constexpr (Ties) {
          float m = smax[threadIdx.x];
          int n = scnt[threadIdx.x];
          merge_tally(m, n, smax[kBM + threadIdx.x], scnt[kBM + threadIdx.x]);
          hmax[row0 + threadIdx.x] = m;
          hcnt[row0 + threadIdx.x] = n;
        } else {
          hmax[row0 + threadIdx.x] = fmaxf(smax[threadIdx.x], smax[kBM + threadIdx.x]);
        }
      }
      if (threadIdx.x == 0) mbar_arrive(h_free);  // no hidden kept: x may land
      continue;
    }
    quant_hidden(hbuf, smax, n_chunks, wg, t);
    fence_proxy_async();
    named_bar_sync(4, 256);  // h_i8 complete
    if (threadIdx.x == 0) mbar_arrive(h_free);

    int acc2[kN2 / 2];
    for (int s = 0; s < n_w2; ++s) {
      mbar_wait(&full[slot], phase);
      const unsigned char* wb = ring + slot * kSlotBytes + wg * kW2Box;
      const int k = s * 32;
      wgmma_fence();
      const uint64_t da = wgmma_desc(hbuf + (k >> 7) * kBlock + (k & 127), 16, 1024);
      const uint64_t db = wgmma_desc_sw32(wb, 256);
      if constexpr (kN2 == 256) {
        wgmma_s8_n256(acc2, da, db, s > 0);
      } else {
        wgmma_s8_n128(acc2, da, db, s > 0);
      }
      wgmma_commit();
      retire_previous();
    }
    retire_all();
    fence_operand(acc2);

    // out = bf16(x + ((float(acc) * hs_row) * s2 + b2)) for this warpgroup's columns
    const float hsa = quant_scale(fmaxf(smax[ra], smax[kBM + ra]));
    const float hsb = quant_scale(fmaxf(smax[rb], smax[kBM + rb]));
#pragma unroll
    for (int j = 0; j < kN2 / 8; ++j) {
      const int col = wg * kN2 + 8 * j + 2 * q;
      const float sc0 = s2[col], sc1 = s2[col + 1], bb0 = b2[col], bb1 = b2[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long row = row0 + ra + 8 * half;
        if (row >= T) continue;
        const float hs = half ? hsb : hsa;
        const size_t o = (size_t)row * D + col;
        float2 xr = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + o));
        xr.x = __fmul_rn(xr.x, res_scale);  // exact: 1, or 1 / tp at tp 2 or 4
        xr.y = __fmul_rn(xr.y, res_scale);
        *reinterpret_cast<bf162*>(out + o) = __floats2bfloat162_rn(
            __fadd_rn(xr.x, dequant(acc2[4 * j + 2 * half], hs, sc0, bb0)),
            __fadd_rn(xr.y, dequant(acc2[4 * j + 2 * half + 1], hs, sc1, bb1)));
      }
    }
  }
}

template <int D, int M, bool Ties>
int launch(const void* x, const float* ln_s, const float* ln_b, const void* w1t,
           const float* s1, const float* b1, const void* w2t, const float* s2,
           const float* b2, float* hmax, int* hcnt, float res_scale, void* out, long T,
           int f, cudaStream_t stream) {
  const Plan p = plan(D, f);
  if (!p.slots) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, m1, m2;
  const uint64_t dimsx[2] = {D, (uint64_t)T}, stridesx[1] = {D * 2};
  const uint32_t boxx[2] = {64, kBM};
  const uint64_t dims1[2] = {D, (uint64_t)f}, strides1[1] = {D};
  const uint32_t box1[2] = {128, 64};
  const uint64_t dims2[2] = {(uint64_t)f, D}, strides2[1] = {(uint64_t)f};
  const uint32_t box2[2] = {32, D / 2};
  int err = make_map_bf16(&mx, x, 2, dimsx, stridesx, boxx);
  if (!err) err = make_map_u8(&m1, w1t, dims1, strides1, box1, CU_TENSOR_MAP_SWIZZLE_128B);
  if constexpr (M == kRowMax) {
    m2 = m1;  // no second product: a valid map the kernel never reads
  } else {
    if (!err) err = make_map_u8(&m2, w2t, dims2, strides2, box2, CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (err) return err;
  auto kernel = ln_ffn_q_kernel<D, M, Ties>;
  err = set_smem((const void*)kernel, p.bytes);
  if (err) return err;
  return launch_clusters(kernel, kCluster, kThreadsFfnQ, p.bytes, (T + kBM - 1) / kBM, stream,
                         mx, m1, m2, (const bf16*)x, ln_s, ln_b, s1, b1, s2, b2, hmax,
                         hcnt, res_scale, (bf16*)out, T, f);
}

template <int M>
int launch_widths(const void* x, const float* ln_s, const float* ln_b, const void* w1t,
                  const float* s1, const float* b1, const void* w2t, const float* s2,
                  const float* b2, float* hmax, int* hcnt, float res_scale, void* out,
                  long T, int d, int f, void* stream) {
  if (T < 1 || !plan(d, f).slots) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (M == kRowMax) {
    if (hcnt) {  // the tied counts asked for
      if (d == 512)
        return launch<512, M, true>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, hmax, hcnt,
                                    res_scale, out, T, f, s);
      return launch<256, M, true>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, hmax, hcnt,
                                  res_scale, out, T, f, s);
    }
  }
  if (d == 512)
    return launch<512, M, false>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, hmax, nullptr,
                                 res_scale, out, T, f, s);
  return launch<256, M, false>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, hmax, nullptr,
                               res_scale, out, T, f, s);
}

}  // namespace ffn_q
}  // namespace herro

extern "C" int herro_ln_ffn_q(const void* x, const float* ln_s, const float* ln_b,
                              const void* w1t, const float* s1, const float* b1,
                              const void* w2t, const float* s2, const float* b2, void* out,
                              long T, int d, int f, void* stream) {
  using namespace herro::ffn_q;
  return launch_widths<kWhole>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, nullptr, nullptr, 1.f,
                               out, T, d, f, stream);
}

// the first pass of a tensor-parallel shard: hmax [T] = max|h| of each row,
// and where hcnt is not null, hcnt [T] = how many of the row's columns reach it
extern "C" int herro_ln_ffn_q_rowmax(const void* x, const float* ln_s, const float* ln_b,
                                     const void* w1t, const float* s1, const float* b1,
                                     float* hmax, int* hcnt, long T, int d, int f,
                                     void* stream) {
  using namespace herro::ffn_q;
  return launch_widths<kRowMax>(x, ln_s, ln_b, w1t, s1, b1, nullptr, nullptr, nullptr, hmax,
                                hcnt, 1.f, nullptr, T, d, f, stream);
}

// the second pass: h quantized by the given hmax [T], x scaled by res_scale
extern "C" int herro_ln_ffn_q_rowscale(const void* x, const float* ln_s, const float* ln_b,
                                       const void* w1t, const float* s1, const float* b1,
                                       const void* w2t, const float* s2, const float* b2,
                                       const float* hmax, float res_scale, void* out,
                                       long T, int d, int f, void* stream) {
  using namespace herro::ffn_q;
  return launch_widths<kRowScale>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2,
                                  const_cast<float*>(hmax), nullptr, res_scale, out, T, d, f,
                                  stream);
}
