// The device code of the port's four attention kernels for Hopper (sm_90a):
// attention + out projection + residual, all heads in a block, fed by TMA and
// run on wgmma, as a template over the mask; or (DM 0) the attention alone.
//
//   flash_outproj.cu       K2  band |i - j| <= w, w a multiple of 256
//   flash_outproj_band.cu  K6  band with any w >= 1
//   flash_outproj_full.cu  K7  no band: every key below the length
//   flash_attention.cu     K9  DM 0: no out projection, either mask, any H
//
// For every query row i of batch b and head h: softmax over the keys j <
// length (and |i - j| <= window under kMaskBand) of scale * q_i . k_j (scores
// in log2 units, -1e30 where masked), P rounded to bf16 for P.V, the row sum
// clamped at 1e-30 and the division rounded to bf16; then out = bf16((x +
// bo) + sum_h attn_h @ Wo_h), the heads summed in float32 (the TPU kernels K6
// and K7 round after each head; one rounding at the end is the closer
// answer). Rows past the length are padding: finite, read by no later stage.
//
// Bound on the H100: operations (4*H*D per query-key pair the mask lets
// through, query and key below the length, plus the out projection, 2*H*D*d
// per query row below the length) over the bf16 tensor-core rate; ~6.6e11
// at B=32, L=9216, band 512, and ~3.45e12 with no band at the smoke run's
// lengths.
//
// Design (the FlashAttention-3 form, the out projection kept fused):
// - A persistent grid; a block takes tiles of 128 query rows of one batch
//   element, all heads. Under kMaskBand it walks them with a static stride
//   in the order (batch, query block), so the blocks in flight at once share
//   K/V in L2. Under kMaskFull a tile costs as many key tiles as its batch
//   element's length holds, up to 72 a head at L=9216, so equal strides
//   would leave some SMs a fifth longer than the mean: there the tiles below
//   each length come first, batch elements by descending length, then the
//   tiles past the lengths, and the blocks take them in a snake order (block
//   i takes position i of even rounds and G-1-i of odd ones). On the H100
//   K2's static stride took 15% longer at the smoke run's mixed lengths and
//   4.4% longer over the batches of an eval run, whose buckets hold lengths
//   from 0.75 L to L and whose last batches are part empty (PERF.md).
//   The producer warp finds each tile's position (full_tile_at) and hands it
//   to the consumers in shared memory with the tile's Q. A tile past the
//   length loads nothing and does no attention: its rows come out as
//   bf16(x + bo).
// - A producer warp loads by TMA (3-D tensor maps over [B*H, L, D], so rows
//   past L arrive as zeros): every head's Q into that head's columns of the
//   block's attn tile [128, H*D] (128-byte swizzled, free until the head's
//   result is written over it), then per head the walked 128-key K and V
//   tiles (the band's, or all below the length), then Wo in [64, 256] tiles,
//   all through one ring of three 32 KB stages with full/empty mbarriers.
// - Two consumer warpgroups own 64 query rows each. S = Q.K^T by wgmma from
//   shared memory (64x128 fp32, 64 registers); the mask only on the band's
//   edge tiles and the tile at the length, the online softmax in registers;
//   P stays in registers as the A operand of P.V (wgmma with A from
//   registers, V MN-major); O is 64x128 fp32, 64 registers. A warpgroup
//   skips the products of a tile its rows cannot reach (under kMaskFull:
//   every tile, once its first row is at or past the length) but still
//   releases it. Under kMaskFull no score is rewritten outside the tile at
//   the length: the scale goes into the exponent, exp2(s*sl2 - m) as one FMA.
//   Each warpgroup runs S, softmax and P.V of a tile in turn; the two
//   overlap each other only as they drift. Taking turns on the tensor cores
//   through named barriers, and issuing S(it + 1) before the softmax of S(it)
//   (FlashAttention-3's overlap inside a warpgroup), both measured slower on
//   the H100, for K2's 9 key tiles a head and for K7's up to 72 alike: with
//   O, P and S in flight at once a consumer needs more than its 232 (or 240)
//   registers, and ptxas spills and serialises the wgmma (C7511, C7514; the
//   ping-pong loop is in tools/kernel_variants/). So what the tensor cores
//   still wait on is the softmax.
// - After each head O is normalised and stored in bf16 to the head's attn
//   columns; after the last head the out projection runs by wgmma against
//   the streamed Wo tiles in passes of 256 output columns (128 registers),
//   and the epilogue adds bo and the residual.
// - setmaxnreg gives the consumers 232 registers and the producer 40 (the
//   block's 384 x 168 at launch, redistributed).
// - DM 0 (K9, the attention alone, out [B, H, L, D]): with no out projection
//   the heads need not share a block, so a tile is 128 query rows of one
//   head, H = 1 over the [B*H] axis of the tensor maps, its length that of
//   batch element bh / heads (`heads` the real H, any value; 1 for the
//   others). The fourth tensor map is then the output's, in [64, 64] boxes:
//   after the head's O is in its attn columns, each warpgroup meets at a
//   named barrier and one thread stores its 64 rows by TMA (clipped at L) and
//   waits until the store has read them before it frees attn for the next
//   tile's Q. A tile past the length (kMaskFull) stores zeros, so an example
//   of length 0 comes out all 0. Every difference is behind `if constexpr`.
// - One head (H 1, the shards of tensor parallelism): a pass of the out
//   projection takes two Wo stages, fewer than the ring holds; the ring's
//   slot and phase run on across passes, heads and tiles, so no place
//   assumes a whole ring a pass.
// Shapes: D 128, (H, d) = (4, 512), (3, 384), (2, 256), (2, 512), (1, 512) or
// (1, 256), any L, lengths 0..L; DM 0: any H.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace herro {
namespace fo90 {

using namespace sm90;

enum : int { kMaskBand = 0, kMaskFull = 1 };

constexpr int kD = 128;                // head dim
constexpr int kBQ = 128;               // query rows per tile, 64 per consumer warpgroup
constexpr int kBK = 128;               // keys per K/V tile
constexpr int kStageBytes = 32768;     // a K or V tile, or a [64, 256] Wo tile
constexpr int kStages = 3;
constexpr int kHalf = 16384;           // one [128][64] box of K, V or Q
constexpr int kWoRows = 64;            // Wo rows per stage: four [64][64] boxes
constexpr int kWoBox = kWoRows * 128;
constexpr int kThreadsFo = 384;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the ring, the attn tile, 2 * kStages + 2 mbarriers and the tile slot
template <int H>
constexpr size_t smem_bytes() {
  return 1024 + kStages * kStageBytes + (size_t)H * 2 * kHalf + (2 * kStages + 2) * 8 + 8;
}

struct Band {
  int len, kt0, n_kt;
};

// the key tiles a query block walks: those that meet its band below the length
__device__ inline Band band_of(const int* lengths, int b, int q0, int L, int window) {
  Band r;
  r.len = min(lengths[b], L);
  const int k_lo = max(0, q0 - window);
  const int k_hi = min(r.len, q0 + kBQ + window);
  r.kt0 = (k_lo / kBK) * kBK;
  r.n_kt = k_hi > r.kt0 ? (k_hi - r.kt0 + kBK - 1) / kBK : 0;
  return r;
}

// the query tiles of a batch element below its length
__device__ inline int live_tiles(int len, int L) {
  len = min(len, L);
  return len > 0 ? (len + kBQ - 1) / kBQ : 0;
}

// kMaskFull: the tile at position p of the order the blocks walk, as (b, q0):
// first the n_live tiles below the lengths, batch elements by descending
// count (ties by index), then the tiles past the lengths in batch order. A
// whole warp computes it, lane l testing batch elements l, l + 32, ...
// kPerHead (K9): each batch element holds `heads` times its tiles, head by
// head, and the tile is returned as (b * heads + h, q0).
template <bool kPerHead>
__device__ inline int2 full_tile_at(const int* lengths, int B, int heads, int L, int n_qb,
                                    int n_live, int p, int lane) {
  const bool live = p < n_live;
  const int pp = live ? p : p - n_live;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    int start = 0, n = 0, qb0 = 0;
    if (b < B) {
      const int nb = live_tiles(lengths[b], L);
      n = live ? nb : n_qb - nb;
      qb0 = live ? 0 : nb;
      for (int o = 0; o < B; ++o) {
        const int no = live_tiles(lengths[o], L);
        if (live ? no > nb || (no == nb && o < b) : o < b) start += live ? no : n_qb - no;
      }
      if constexpr (kPerHead) start *= heads;
    }
    const int span = kPerHead ? n * heads : n;
    const unsigned hit = __ballot_sync(0xffffffffu, pp >= start && pp < start + span);
    if (hit) {
      const int src = __ffs(hit) - 1;
      if constexpr (kPerHead) {
        const int at = __shfl_sync(0xffffffffu, pp - start, src);
        const int per = __shfl_sync(0xffffffffu, n, src);
        const int hb = __shfl_sync(0xffffffffu, b, src) * heads + at / per;
        const int qb = __shfl_sync(0xffffffffu, qb0, src) + at % per;
        return make_int2(hb, qb * kBQ);
      } else {
        const int hb = __shfl_sync(0xffffffffu, b, src);
        const int qb = __shfl_sync(0xffffffffu, qb0 + pp - start, src);
        return make_int2(hb, qb * kBQ);
      }
    }
  }
  return make_int2(0, L);  // not reached: the positions cover every tile
}

// DM 0 is K9: no out projection, one head a tile, `wo_map` the output's map
// and `heads` the real H (the others pass 1 and read neither x, bo nor heads).
template <int H, int DM, int kMask>
__global__ void __launch_bounds__(kThreadsFo, 1)
flash_outproj_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap wo_map,
                          const bf16* __restrict__ x, const bf16* __restrict__ bo,
                          const int* __restrict__ lengths, bf16* __restrict__ out, int B, int L,
                          int window, float scale, int heads) {
  constexpr bool kFull = kMask == kMaskFull;
  constexpr bool kStore = DM == 0;         // K9: O leaves by TMA store, per head
  // out-projection passes of 256 columns; at d 384 the second pass has 128
  constexpr int kPasses = (DM + 255) / 256;
  constexpr int kWoStages = H * kD / kWoRows;  // Wo stages per pass
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* attn = ring + kStages * kStageBytes;  // H*D/64 blocks of [128][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(attn + H * 2 * kHalf);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* attn_free = q_full + 1;
  int* tile_slot = reinterpret_cast<int*>(attn_free + 1);  // kMaskFull: (b, q0)

  const int n_qb = (L + kBQ - 1) / kBQ;
  const int n_tiles = B * (kStore ? heads : 1) * n_qb;
  // the batch element of tile row b: b itself, or under kStore b / heads
  auto elem = [&](int b) { return kStore ? b / heads : b; };
  // the position of this block's tile in round r (kMaskFull: snake order)
  auto position = [&](int r) {
    if constexpr (kFull)
      return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                                           : (int)blockIdx.x);
    else
      return (int)blockIdx.x + r * (int)gridDim.x;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(q_full, 1);
    mbar_init(attn_free, 2);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    // kMaskFull keeps the whole warp, which finds the tiles; one thread loads
    if (threadIdx.x >= (kFull ? 288 : 257)) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      prefetch_map(&wo_map);
    }
    int slot = 0;
    uint32_t phase = 0, free_phase = 0;
    auto acquire = [&](int bytes = kStageBytes) {
      mbar_wait(&empty[slot], phase ^ 1);
      mbar_expect_tx(&full[slot], bytes);
      return ring + slot * kStageBytes;
    };
    auto advance = [&]() {
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
    };
    // Q of every head, the walked K/V tiles of every head, then Wo
    auto load_tile = [&](int b, int q0, const Band& band) {
      mbar_expect_tx(q_full, H * 2 * kHalf);
      for (int h = 0; h < H; ++h)
        for (int c = 0; c < 2; ++c)
          tma_load_3d(attn + (2 * h + c) * kHalf, &q_map, q_full, c * 64, q0, b * H + h);
      for (int h = 0; h < H; ++h) {
        for (int it = 0; it < band.n_kt; ++it) {
          const int kt = band.kt0 + it * kBK;
          for (int kv = 0; kv < 2; ++kv) {  // K, then V
            const CUtensorMap* map = kv ? &v_map : &k_map;
            unsigned char* dst = acquire();
            for (int c = 0; c < 2; ++c)
              tma_load_3d(dst + c * kHalf, map, &full[slot], c * 64, kt, b * H + h);
            advance();
          }
        }
      }
      for (int p = 0; p < kPasses; ++p) {
        const int boxes = min(4, (DM - p * 256) / 64);  // Wo columns of this pass / 64
        for (int s = 0; s < kWoStages; ++s) {
          unsigned char* dst = acquire(boxes * kWoBox);
          for (int c = 0; c < boxes; ++c)
            tma_load_2d(dst + c * kWoBox, &wo_map, &full[slot], p * 256 + c * 64,
                        s * kWoRows);
          advance();
        }
      }
    };
    if constexpr (kFull) {
      int n_live = 0;
      for (int b = lane; b < B; b += 32) n_live += live_tiles(lengths[b], L);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) n_live += __shfl_xor_sync(0xffffffffu, n_live, off);
      if constexpr (kStore) n_live *= heads;
      for (int r = 0;; ++r) {
        const int p = position(r);
        if (p >= n_tiles) break;
        const int2 tile = full_tile_at<kStore>(lengths, B, heads, L, n_qb, n_live, p, lane);
        if (lane == 0) {
          // the slot and attn are free once the last tile is done with both
          mbar_wait(attn_free, free_phase ^ 1);
          free_phase ^= 1;
          tile_slot[0] = tile.x;
          tile_slot[1] = tile.y;
          const int len = min(lengths[elem(tile.x)], L);
          if (tile.y >= len)
            mbar_arrive(q_full);  // no attention: the slot alone
          else
            load_tile(tile.x, tile.y, Band{len, 0, (len + kBK - 1) / kBK});
        }
      }
    } else {
      for (int r = 0;; ++r) {
        const int tile = position(r);
        if (tile >= n_tiles) break;
        const int b = tile / n_qb, q0 = (tile % n_qb) * kBQ;
        const Band band = band_of(lengths, elem(b), q0, L, window);
        // Q of every head, once the last tile's out projection has read attn
        mbar_wait(attn_free, free_phase ^ 1);
        free_phase ^= 1;
        load_tile(b, q0, band);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  reg_alloc<232>();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2 below
  int slot = 0, held = -1;
  uint32_t phase = 0, q_phase = 0;
  auto release = [&](int s) {
    if (t == 0) mbar_arrive(&empty[s]);
  };
  auto next_slot = [&]() {
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  };

  for (int r = 0;; ++r) {
    const int tile = position(r);
    if (tile >= n_tiles) break;
    int b, q0;
    Band band;
    if constexpr (kFull) {
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      b = tile_slot[0];
      q0 = tile_slot[1];
      band.len = min(lengths[elem(b)], L);
      band.kt0 = 0;
      band.n_kt = (band.len + kBK - 1) / kBK;
    } else {
      b = tile / n_qb;
      q0 = (tile % n_qb) * kBQ;
      band = band_of(lengths, elem(b), q0, L, window);
    }
    const int r0 = q0 + wg * 64;                       // this warpgroup's first row
    const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;  // this thread's rows
    const int arow = wg * 64 + warp * 16 + g;          // row_a within the tile
    if constexpr (kFull) {
      if (q0 >= band.len) {
        const int n_rows = min(64, L - r0);
        if constexpr (kStore) {
          // past the length, K9: this warpgroup's rows below L are 0
          constexpr int kChunks = kD / 8;
          for (int e = t; e < n_rows * kChunks; e += 128)
            *reinterpret_cast<uint4*>(out + ((size_t)b * L + r0 + e / kChunks) * kD +
                                      (e % kChunks) * 8) = make_uint4(0, 0, 0, 0);
        } else {
          // past the length: this warpgroup's rows below L are bf16(x + bo)
          constexpr int kChunks = DM / 8;
          for (int e = t; e < n_rows * kChunks; e += 128) {
            const int c = (e % kChunks) * 8;
            const size_t o_ = ((size_t)b * L + r0 + e / kChunks) * DM + c;
            const uint4 xv = *reinterpret_cast<const uint4*>(x + o_);
            const uint4 bv = *reinterpret_cast<const uint4*>(bo + c);
            uint4 ov;
            const bf162* xp = reinterpret_cast<const bf162*>(&xv);
            const bf162* bp = reinterpret_cast<const bf162*>(&bv);
            bf162* op = reinterpret_cast<bf162*>(&ov);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 xf = __bfloat1622float2(xp[i]), bf = __bfloat1622float2(bp[i]);
              op[i] = __floats2bfloat162_rn(xf.x + bf.x, xf.y + bf.y);
            }
            *reinterpret_cast<uint4*>(out + o_) = ov;
          }
        }
        if (t == 0) mbar_arrive(attn_free);  // done with the slot
        continue;
      }
    } else {
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
    }

#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      float o[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
      const unsigned char* qh = attn + 2 * h * kHalf + wg * 64 * 128;

#pragma unroll 1
      for (int it = 0; it < band.n_kt; ++it) {
        const int kt = band.kt0 + it * kBK;
        bool live;
        if constexpr (kFull)
          live = r0 < band.len;
        else
          live = r0 < L && kt + kBK - 1 >= r0 - window && kt <= r0 + 63 + window;
        // zeroed, not only overwritten by the first product, so that no
        // value is carried in registers from the last tile
        float s[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] = 0.f;
        mbar_wait(&full[slot], phase);  // K
        if (live) {
          const unsigned char* ks = ring + slot * kStageBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kD / 16; ++kk) {
            const int off = (kk >> 2) * kHalf + (kk & 3) * 32;
            wgmma_ss_n128<0>(s, wgmma_desc(qh + off, 16, 1024), wgmma_desc(ks + off, 16, 1024),
                             kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operand(s);
        }
        release(slot);
        next_slot();

        uint32_t p[kBK / 16][4];
        if (live) {
          float mx_a = kNegInf, mx_b = kNegInf;
          if constexpr (kFull) {
            // only the tile at the length is masked; scores stay unscaled
            const bool edge = kt + kBK > band.len;
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& sa = s[4 * j + e];
                float& sb = s[4 * j + 2 + e];
                if (edge && kt + 8 * j + 2 * q + e >= band.len) {
                  sa = kNegInf;
                  sb = kNegInf;
                }
                mx_a = fmaxf(mx_a, sa);
                mx_b = fmaxf(mx_b, sb);
              }
          } else {
            // every score tested only on the band's edge tiles and at the length
            const bool edge = !(kt >= r0 + 63 - window && kt + kBK - 1 <= r0 + window) ||
                              kt + kBK > band.len;
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int ik = kt + 8 * j + 2 * q + e;
                float& sa = s[4 * j + e];
                float& sb = s[4 * j + 2 + e];
                if (edge) {
                  sa = (ik < band.len && abs(row_a - ik) <= window) ? sa * sl2 : kNegInf;
                  sb = (ik < band.len && abs(row_b - ik) <= window) ? sb * sl2 : kNegInf;
                } else {
                  sa *= sl2;
                  sb *= sl2;
                }
                mx_a = fmaxf(mx_a, sa);
                mx_b = fmaxf(mx_b, sb);
              }
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
          }
          // kMaskFull: the maximum in log2 units, as the band's scores are
          const float mn_a = fmaxf(m_a, kFull ? mx_a * sl2 : mx_a);
          const float mn_b = fmaxf(m_b, kFull ? mx_b * sl2 : mx_b);
          const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
          m_a = mn_a;
          m_b = mn_b;
          l_a *= al_a;
          l_b *= al_b;
#pragma unroll
          for (int j = 0; j < kD / 8; ++j) {
            o[4 * j] *= al_a;
            o[4 * j + 1] *= al_a;
            o[4 * j + 2] *= al_b;
            o[4 * j + 3] *= al_b;
          }
          // P in bf16 as the A operand of P.V: score columns 8j.. are k-step
          // j / 2, its low (j even) or high key half
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
            float p0, p1, p2, p3;
            if constexpr (kFull) {
              p0 = exp2f(fmaf(s[4 * j], sl2, -mn_a));
              p1 = exp2f(fmaf(s[4 * j + 1], sl2, -mn_a));
              p2 = exp2f(fmaf(s[4 * j + 2], sl2, -mn_b));
              p3 = exp2f(fmaf(s[4 * j + 3], sl2, -mn_b));
            } else {
              p0 = exp2f(s[4 * j] - mn_a);
              p1 = exp2f(s[4 * j + 1] - mn_a);
              p2 = exp2f(s[4 * j + 2] - mn_b);
              p3 = exp2f(s[4 * j + 3] - mn_b);
            }
            l_a += p0 + p1;
            l_b += p2 + p3;
            p[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
            p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
          }
        }

        mbar_wait(&full[slot], phase);  // V
        if (live) {
          const unsigned char* vs = ring + slot * kStageBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_rs_n128<1>(o, p[kk], wgmma_desc(vs + kk * 16 * 128, kHalf, 1024), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operand(o);
        }
        release(slot);
        next_slot();
      }

      // O / l in bf16 over this head's Q, in this warpgroup's rows
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        unsigned char* blk = attn + (2 * h + (j >> 3)) * kHalf + 4 * q;
        *reinterpret_cast<bf162*>(blk + swizzle128(arow, j & 7)) =
            __floats2bfloat162_rn(o[4 * j] / d_a, o[4 * j + 1] / d_a);
        *reinterpret_cast<bf162*>(blk + swizzle128(arow + 8, j & 7)) =
            __floats2bfloat162_rn(o[4 * j + 2] / d_b, o[4 * j + 3] / d_b);
      }
    }
    fence_proxy_async();  // attn, written by these threads, is read by wgmma next
    if constexpr (kStore) {
      // K9: this warpgroup's 64 rows of O leave by TMA from its attn rows,
      // clipped at L; attn is freed once the store has read them
      named_bar_sync(1 + wg, 128);
      if (t == 0) {
        if (r0 < L) {
          for (int c = 0; c < 2; ++c)
            tma_store_3d(&wo_map, attn + c * kHalf + wg * 64 * 128, c * 64, r0, b);
          bulk_commit();
          bulk_wait_read<0>();
        }
        mbar_arrive(attn_free);
      }
      continue;
    }

    // out = (x + bo) + attn @ Wo in passes of 256 columns; a stage is
    // released one committed group behind. A pass of 128 columns (d 384)
    // runs the same n256 product: the stage's upper half holds no Wo of this
    // pass, and the accumulator columns it gives are not stored.
#pragma unroll 1
    for (int pass = 0; pass < kPasses; ++pass) {
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int s = 0; s < kWoStages; ++s) {
        mbar_wait(&full[slot], phase);
        const unsigned char* ws = ring + slot * kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWoRows / 16; ++kk) {
          const uint64_t da = wgmma_desc(attn + s * kHalf + wg * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db = wgmma_desc(ws + kk * 16 * 128, kWoBox, 1024);
          wgmma_ss_n256<1>(acc, da, db, s > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0) release(held);
        held = slot;
        next_slot();
      }
      wgmma_wait<0>();
      release(held);
      held = -1;
      fence_operand(acc);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = pass * 256 + 8 * j + 2 * q;
        if (DM % 256 != 0 && c >= DM) break;
        const float2 br = __bfloat1622float2(*reinterpret_cast<const bf162*>(bo + c));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row_b : row_a;
          if (row >= L) continue;
          const size_t o_ = ((size_t)b * L + row) * DM + c;
          const float2 xr = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + o_));
          *reinterpret_cast<bf162*>(out + o_) =
              __floats2bfloat162_rn((xr.x + br.x) + acc[4 * j + 2 * half],
                                    (xr.y + br.y) + acc[4 * j + 2 * half + 1]);
        }
      }
    }
    if (t == 0) mbar_arrive(attn_free);  // this warpgroup is done reading attn
  }
  if constexpr (kStore) {
    if (t == 0) bulk_wait<0>();  // the stores are written before the block exits
  }
}

// Launch on `stream`; returns 0 or a CUDA error. A band wider than L masks
// nothing more than L does, so it is clamped there; kMaskFull reads no window.
// DM 0 (K9): no x, wo or bo; `heads` is the real H and the fourth map the
// output's.
template <int H, int DM, int kMask>
inline int launch(const void* q, const void* k, const void* v, const void* x, const void* wo,
                  const void* bo, const int* lengths, void* out, int B, int L, int window,
                  float scale, cudaStream_t stream, int heads = 1) {
  const long n_tiles = (long)B * heads * ((L + kBQ - 1) / kBQ);
  if (B < 1 || L < 1 || heads < 1 || n_tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  window = window < L ? window : L;
  CUtensorMap qm, km, vm, wm;
  const uint64_t dims[3] = {kD, (uint64_t)L, (uint64_t)B * H * heads};
  const uint64_t strides[2] = {kD * 2, (uint64_t)L * kD * 2};
  const uint32_t box[2] = {64, kBQ};
  int err = make_map_bf16(&qm, q, 3, dims, strides, box);
  if (!err) err = make_map_bf16(&km, k, 3, dims, strides, box);
  if (!err) err = make_map_bf16(&vm, v, 3, dims, strides, box);
  if constexpr (DM == 0) {
    const uint32_t obox[2] = {64, 64};  // a warpgroup's rows
    if (!err) err = make_map_bf16(&wm, out, 3, dims, strides, obox);
  } else {
    const uint64_t wdims[2] = {DM, H * kD}, wstrides[1] = {DM * 2};
    const uint32_t wbox[2] = {64, kWoRows};
    if (!err) err = make_map_bf16(&wm, wo, 2, wdims, wstrides, wbox);
  }
  if (err) return err;
  auto kernel = flash_outproj_sm90_kernel<H, DM, kMask>;
  const size_t smem = smem_bytes<H>();
  err = set_smem((const void*)kernel, smem);
  if (err) return err;
  const int sms = sm_count();
  const int grid = n_tiles < sms ? (int)n_tiles : sms;
  kernel<<<grid, kThreadsFo, smem, stream>>>(qm, km, vm, wm, (const bf16*)x, (const bf16*)bo,
                                             lengths, (bf16*)out, B, L, window, scale, heads);
  return (int)cudaGetLastError();
}

// The widths the kernels are built for, D 128: (H, d) = (4, 512) (r10) and
// (2, 256) (r9, r10deep), and the tensor-parallel shards of those, (2, 512)
// and (1, 512) (r10 at tp 2 and 4) and (1, 256) (r10deep at tp 2); and
// (3, 384), the d384x5L shape of tools/variant_step_time_torch.py.
template <int kMask>
inline int launch_widths(const void* q, const void* k, const void* v, const void* x,
                         const void* wo, const void* bo, const int* lengths, void* out, int B,
                         int H, int L, int d, int window, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H == 4 && d == 512)
    return launch<4, 512, kMask>(q, k, v, x, wo, bo, lengths, out, B, L, window, scale, s);
  if (H == 2 && d == 256)
    return launch<2, 256, kMask>(q, k, v, x, wo, bo, lengths, out, B, L, window, scale, s);
  if (H == 2 && d == 512)
    return launch<2, 512, kMask>(q, k, v, x, wo, bo, lengths, out, B, L, window, scale, s);
  if (H == 1 && d == 512)
    return launch<1, 512, kMask>(q, k, v, x, wo, bo, lengths, out, B, L, window, scale, s);
  if (H == 1 && d == 256)
    return launch<1, 256, kMask>(q, k, v, x, wo, bo, lengths, out, B, L, window, scale, s);
  if (H == 3 && d == 384)
    return launch<3, 384, kMask>(q, k, v, x, wo, bo, lengths, out, B, L, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fo90
}  // namespace herro
