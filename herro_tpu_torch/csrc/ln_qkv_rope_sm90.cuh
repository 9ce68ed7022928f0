// K1, K8 and K10: LayerNorm + qkv projection + rotary epilogue, q/k/v
// written per head, one Hopper design templated on the variant (the entry
// points are ln_qkv_rope.cu, ln_qkv_rope_split.cu and ln_qkv_rope_q.cu):
// - kTablesIn (K1): qkv = bf16(LN(x) @ W + b), the rope tables handed in;
// - kTablesBuilt (K8): the same with the tables built in the kernel
//   (rope.cuh), bit-equal to K1's inputs, so K8 equals K1 bit for bit;
// - kInt8 (K10): bf16(LN(x)) quantized per row, the int8 product with the
//   k-major int8 weight, qkv = bf16((float(acc) * s_row) * s_col + b), the
//   tables built in the kernel.
// q and k then take the rotate-half rope at the absolute column index in
// float32 and are rounded again; v passes through. W [d, 3*H*D] is the (3,
// H, D) c-major flattening (K10: its transpose [3*H*D, d], int8); outputs
// are [B, H, L, D] with D = 128.
//
// Bound on the H100 (B=32, L=9216, d=512, H=4): K1 and K8 operations,
// 2*T*d*3*H*D (4.6e11) over the bf16 tensor-core rate, 0.47 ms; K10 bytes, x
// in and q/k/v out (1.2 GB), 0.36 ms, the int8 rate putting the operations
// below that. The TPU kernel kept W (1.5 MB at d=512) whole in VMEM; here it
// streams from L2 once per 128-row tile.
//
// Design (sm_90a): a persistent grid, one block per SM walking 128-row tiles
// that never cross an example (tile = (b, l0), so rows past L are clipped by
// the tensor maps), each block three warpgroups.
// - A producer warp loads each tile's x by TMA (a 3-D map over [B, L, d],
//   zeros past L) straight into the LN tile, in the 128-byte-swizzled layout
//   of wgmma's A operand, as soon as the last tile's products are done with
//   it. It streams W through a 64 KB ring in the order the consumers take
//   them: per head block of 128 columns, its k-stages; bf16 in eight 8 KB
//   stages of [32 k][128 n] (MN-major), int8 in four 16 KB stages of [128 n
//   rows][128 k bytes] (K-major, as int8 wgmma has no transpose). Blocks
//   run in clusters of kCluster; each loads its share of a stage's boxes
//   and multicasts them, so L2 serves each W byte once per kCluster tiles.
// - Two consumer warpgroups, 64 rows each. At a tile's start each normalises
//   its rows of x in place (flax semantics: float32 statistics, the fast
//   variance clamped at 0, eps 1e-6, bf16 out) and reads the rope tables of
//   its rows into registers, once per tile (K8, K10: computes them there,
//   once per position, the frequencies once per launch; see the tile order
//   below). Per head block it accumulates [64,
//   128] in registers (wgmma m64n128k16, K10 m64n128k32 s8; both
//   warpgroups read the same W stage), adds the bias (K10: dequantizes
//   first) with a bf16 rounding, rotates the pair (c, c + 64), which sits
//   in accumulator columns j and j + 8 of one thread, in float32
//   with explicit roundings (no fused multiply-add, as the reference),
//   rounds again and writes the slab into a swizzled staging tile, which the
//   warpgroup then copies out in 16-byte stores: contiguous rows of one
//   (b, h) of q, k or v. (A TMA store of the slab measured slower, likely
//   as the TMA unit then also serves the W and x loads.) A ring stage is
//   released as soon as the products that read it are done.
// - setmaxnreg gives the consumers 232 registers and the producer 40 (the
//   block's 384 x 168 at launch, redistributed). The accumulator is not
//   zeroed by hand: writing it while a product is in flight makes ptxas
//   serialise every wgmma.
// What it waits on (clock64 counters per phase, B=32, L=9216, d=512): the
// products run at the tensor cores' rate once W flows, but about half of a
// tile goes elsewhere: the head epilogue (both warpgroups at once, the
// tensor cores idle) and the W ring's refill after it, the wait for the
// next tile's x, and the LayerNorm. The shared memory is spent (LN tile 128
// KB, ring 64 KB, staging 32 KB), so neither a deeper ring nor a second
// accumulator to overlap the epilogue with the next head's products fits:
// with the rope tables in registers the latter spills and ptxas serialises
// every wgmma (C7514). Prefetching the next tile's x into L2 (by TMA or by
// plain prefetches), a LayerNorm of two threads a row or of four rows at a
// time, and reading the bias before the products all measured no faster.
// K10's shared memory: the bf16 x tile (128 KB at d=512) and the int8 A
// operand (64 KB) do not both fit beside the ring and the staging tile, so
// LayerNorm quantizes in place into the tile's lower half (int8.cuh:
// ln_quant_tile, K11's function on 128 rows): int8 row r lands only on bf16
// row r, which the same warp has read in full. That keeps K1's 128-row tile,
// its ring and its epilogue; 64-row tiles (K11's choice) would stream every
// W byte from L2 twice as often. The row scales take 512 bytes more.
// Shapes: d 256 or 512 (K1, K8 also 384: a lane of the LayerNorm then holds
// one and a half 16-byte chunks of a row, six [128][64] blocks of x), D 128,
// any H >= 1, B >= 1, L >= 1.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "int8.cuh"
#include "rope.cuh"
#include "sm90.cuh"

namespace herro {
namespace qkv {

using namespace sm90;

// what an instantiation computes (see the head of the file)
enum Variant : int { kTablesIn = 0, kTablesBuilt = 1, kInt8 = 2 };

constexpr int kD = 128;                   // head dim (every shipped checkpoint)
constexpr int kHalf = kD / 2;             // the rope pair's distance
constexpr int kBM = 128;                  // token rows per tile: two warpgroups of 64
constexpr int kRingBytes = 65536;         // the W ring
constexpr int kOutBlk = 64 * 128;         // a warpgroup's [64][64] output box, 8 KB
constexpr int kOutBytes = 2 * kOutBlk;    // a warpgroup's [64][128] staging tile
constexpr int kThreadsQkv = 384;          // two consumer warpgroups and a producer
constexpr int kCluster = 2;               // blocks sharing one W stream

template <int D, int V>
struct Shape {
  static constexpr bool kQ = V == kInt8;
  // W per ring stage: k rows (bf16) or k bytes (int8)
  static constexpr int kBK = kQ ? 128 : 32;
  // one TMA box of W: [32 k][64 n] bf16, 4 KB, or [64 n][128 k] int8, 8 KB
  static constexpr int kBox = kQ ? 64 * 128 : kBK * 128;
  static constexpr int kStageBytes = 2 * kBox;  // one head block's k-stage
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kS = D / kBK;      // ring stages per head block
  static constexpr int kLnBytes = kBM * D * 2;
  static constexpr size_t kSmem = 1024 + kLnBytes + kStages * kStageBytes + 2 * kOutBytes +
                                  (2 * kStages + 2) * 8 + (kQ ? kBM * 4 : 0);
};

// LayerNorm (flax semantics, as fused.py:layernorm) in place on the
// x tile TMA left in `ln` (D/64 swizzled blocks of [128][64]), bf16 out.
// Warp w of the consumers takes rows 16w..16w+15, so each warpgroup
// normalises the 64 rows its own products read.
template <int D>
__device__ inline void layernorm_tile(const float* __restrict__ scale,
                                      const float* __restrict__ bias, unsigned char* ln) {
  // 16-byte chunks a lane holds of a row; at d 384 the second is held by
  // lanes 0-15 only (`has`)
  constexpr int kCh = (D + 255) / 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto has = [&](int i) { return D % 256 == 0 || lane + 32 * i < D / 8; };
  float sc[kCh][8], bi[kCh][8];
#pragma unroll
  for (int i = 0; i < kCh; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[i][e] = has(i) ? scale[(lane + 32 * i) * 8 + e] : 0.f;
      bi[i][e] = has(i) ? bias[(lane + 32 * i) * 8 + e] : 0.f;
    }
#pragma unroll 2
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    uint4* v[kCh];
    uint4 xv[kCh];
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      const int ch = lane + 32 * i;
      v[i] = reinterpret_cast<uint4*>(ln + (ch >> 3) * (kBM * 128) + swizzle128(r, ch & 7));
      xv[i] = has(i) ? *v[i] : make_uint4(0, 0, 0, 0);  // zeros add nothing to the sums
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      const bf162* p = reinterpret_cast<const bf162*>(&xv[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = __bfloat1622float2(p[e]);
        s += f2.x + f2.y;
        ss += f2.x * f2.x + f2.y * f2.y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / (float)D;
    const float var = fmaxf(ss / (float)D - mu * mu, 0.f);
    const float rs = 1.f / sqrtf(var + 1e-6f);
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      uint4 o;
      const bf162* p = reinterpret_cast<const bf162*>(&xv[i]);
      bf162* y = reinterpret_cast<bf162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = __bfloat1622float2(p[e]);
        y[e] = __floats2bfloat162_rn((f2.x - mu) * rs * sc[i][2 * e] + bi[i][2 * e],
                                     (f2.y - mu) * rs * sc[i][2 * e + 1] + bi[i][2 * e + 1]);
      }
      if (has(i)) *v[i] = o;
    }
  }
}

// cos_t, sin_t: K1's rope tables [L, 64]; s_col: K10's weight column
// scales [3*H*D]; a pointer its variant does not read is null
template <int D, int V>
__global__ void __launch_bounds__(kThreadsQkv, 1)
ln_qkv_rope_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                   const bf16* __restrict__ bias, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, const float* __restrict__ s_col,
                   bf16* __restrict__ q,
                   bf16* __restrict__ k, bf16* __restrict__ v, int B, int L, int H) {
  using S = Shape<D, V>;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ln = smem;
  unsigned char* ring = ln + S::kLnBytes;
  unsigned char* obuf = ring + kStages * S::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(obuf + 2 * kOutBytes);
  uint64_t* empty = full + kStages;
  uint64_t* x_full = empty + kStages;  // the tile's x has landed in `ln`
  uint64_t* ln_free = x_full + 1;      // both warpgroups' products are done with `ln`
  float* srow = reinterpret_cast<float*>(ln_free + 1);  // K10: the tile's row scales

  const int per_b = (L + kBM - 1) / kBM;  // tiles per example
  const long n_tiles = (long)B * per_b;
  const int n_heads = 3 * H;  // head blocks: q 0..H-1, k H..2H-1, v 2H..3H-1
  constexpr int C = kCluster;
  const uint32_t rank = cluster_rank();
  const long group = cluster_id(), n_groups = cluster_count();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * C);
    }
    mbar_init(x_full, 1);
    mbar_init(ln_free, 2);
    fence_barrier_init();
  }
  cluster_sync();  // the peers' barriers exist before anyone multicasts to them

  // the blocks of a cluster take C consecutive tiles per iteration; a block
  // whose tile lies past the end runs it on zero rows and stores nothing,
  // so that it keeps its share of the cluster's W stream. The tiles (b, l0)
  // are numbered column-major (the B tiles of one position l0 in a row) and
  // each cluster takes a contiguous run of them: a block's consecutive tiles
  // then share l0, and so their rope tables, which K8 and K10 build once per
  // position instead of once per tile (K1 reads them per tile all the same).
  const long n_pairs = (n_tiles + C - 1) / C;
  const long run0 = group * n_pairs / n_groups, run1 = (group + 1) * n_pairs / n_groups;
  // the tile of this block in the cluster's tile pair p: its example, first row
  auto locate = [&](long p, long& tile, int& b, int& l0) {
    tile = p * C + rank;
    b = (int)(tile % B);
    l0 = (int)(tile / B) * kBM;
  };

  if (threadIdx.x >= 256) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    prefetch_map(&x_map);
    prefetch_map(&w_map);
    int slot = 0;
    uint32_t phase = 0, free_phase = 0;
    auto advance = [&]() {
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
    };
    for (long p = run0; p < run1; ++p) {
      long tile;
      int b, l0;
      locate(p, tile, b, l0);
      // this tile's x into `ln` once the last tile's products have read it
      mbar_wait(ln_free, free_phase ^ 1);
      free_phase ^= 1;
      mbar_expect_tx(x_full, S::kLnBytes);
      for (int kb = 0; kb < D / 64; ++kb)
        tma_load_3d(ln + kb * (kBM * 128), &x_map, x_full, kb * 64, l0, b);
      for (int j = 0; j < n_heads; ++j)
        for (int s = 0; s < S::kS; ++s) {
          mbar_wait(&empty[slot], phase ^ 1);
          mbar_expect_tx(&full[slot], S::kStageBytes);
          unsigned char* dst = ring + slot * S::kStageBytes;
          for (int h = rank; h < 2; h += C) {
            if constexpr (S::kQ)  // rows of W^T are the n columns
              tma_load_2d_multicast(dst + h * S::kBox, &w_map, &full[slot], s * S::kBK,
                                    j * kD + h * 64, (uint16_t)((1 << C) - 1));
            else
              tma_load_2d_multicast(dst + h * S::kBox, &w_map, &full[slot], j * kD + h * 64,
                                    s * S::kBK, (uint16_t)((1 << C) - 1));
          }
          advance();
        }
    }
    // every stage released by every consumer of the cluster: no block may
    // exit while a peer can still arrive on its barriers
    for (int s = 0; s < kStages; ++s) {
      mbar_wait(&empty[slot], phase ^ 1);
      advance();
    }
    return;
  }

  // ---------------- consumers ----------------
  reg_alloc<232>();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  unsigned char* ob = obuf + wg * kOutBytes;
  int slot = 0, held = -1;
  uint32_t phase = 0, x_phase = 0;
  // release a stage to the producers of the cluster once its products are done
  auto release = [&](int s) {
    if (t < C) mbar_arrive_cluster(&empty[s], t);
  };
  // after committing a group on `slot`: the group before it is done
  auto retire_previous = [&]() {
    wgmma_wait<1>();
    if (held >= 0) release(held);
    held = slot;
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  };
  auto retire_all = [&]() {
    wgmma_wait<0>();
    if (held >= 0) release(held);
    held = -1;
  };
  // the rope tables of this thread's rows 16 warp + g (+ 8) at columns
  // 8j + 2q (+ 1), j < 8; rows past L read row L - 1 and are not stored
  float cs[2][16], sn[2][16];
  float freq[16];       // K8, K10: the rope frequencies of this thread's columns
  int tables_l0 = -1;   // K8, K10: the position whose tables cs, sn hold
  if constexpr (V != kTablesIn) rope_freqs(q4, freq);

  for (long p = run0; p < run1; ++p) {
    long tile;
    int b, l0;
    locate(p, tile, b, l0);
    const int row0 = l0 + wg * 64;  // this warpgroup's first row
    const bool live = tile < n_tiles && row0 < L;

    if constexpr (V == kTablesIn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = min(row0 + warp * 16 + g + 8 * half, L - 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const size_t o = (size_t)l * kHalf + 8 * j + 2 * q4;
          const float2 c2 = *reinterpret_cast<const float2*>(cos_t + o);
          const float2 s2 = *reinterpret_cast<const float2*>(sin_t + o);
          cs[half][2 * j] = c2.x;
          cs[half][2 * j + 1] = c2.y;
          sn[half][2 * j] = s2.x;
          sn[half][2 * j + 1] = s2.y;
        }
      }
    } else if (l0 != tables_l0) {
      rope_rows(row0 + warp * 16 + g, L, freq, cs, sn);
      tables_l0 = l0;
    }

    mbar_wait(x_full, x_phase);
    x_phase ^= 1;
    if constexpr (S::kQ)  // y_i8 into the tile's lower half, in place
      ln_quant_tile<D, kBM>(ln_s, ln_b, ln, ln, srow);
    else
      layernorm_tile<D>(ln_s, ln_b, ln);
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);  // this warpgroup's rows of LN(x) are in place
    float sr[2];                  // K10: the row scales of this thread's rows
    if constexpr (S::kQ) {
      sr[0] = srow[wg * 64 + warp * 16 + g];
      sr[1] = srow[wg * 64 + warp * 16 + g + 8];
    }

    for (int j = 0; j < n_heads; ++j) {
      std::conditional_t<S::kQ, int, float> acc[64];
      for (int s = 0; s < S::kS; ++s) {
        mbar_wait(&full[slot], phase);
        const unsigned char* wb = ring + slot * S::kStageBytes;
        wgmma_fence();
        if constexpr (S::kQ) {
          // A: int8 block s of the tile (128 k bytes); B: the stage's [128 n][128 k]
#pragma unroll
          for (int kk = 0; kk < S::kBK / 32; ++kk) {
            const uint64_t da =
                wgmma_desc(ln + s * (kBM * 128) + wg * (64 * 128) + kk * 32, 16, 1024);
            const uint64_t db = wgmma_desc(wb + kk * 32, 16, 1024);
            wgmma_s8_n128(acc, da, db, s > 0 || kk > 0);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < S::kBK / 16; ++kk) {
            const int kc = s * S::kBK + kk * 16;
            const uint64_t da = wgmma_desc(
                ln + (kc >> 6) * (kBM * 128) + wg * (64 * 128) + (kc & 63) * 2, 16, 1024);
            const uint64_t db = wgmma_desc(wb + kk * 16 * 128, S::kBox, 1024);
            wgmma_ss_n128<1>(acc, da, db, s > 0 || kk > 0);
          }
        }
        wgmma_commit();
        retire_previous();
      }
      retire_all();
      fence_operand(acc);

      named_bar_sync(1 + wg, 128);  // the last head's slab has left the staging tile
      // every warp of this warpgroup is past the tile's last product
      if (j == n_heads - 1 && t == 0) mbar_arrive(ln_free);

      const int part = j / H, h = j % H;
      const bf16* bj = bias + j * kD;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + 2 * q4;  // first-half column; its pair is c + 64
        const float2 b1 = __bfloat1622float2(*reinterpret_cast<const bf162*>(bj + c));
        const float2 b2 = __bfloat1622float2(*reinterpret_cast<const bf162*>(bj + kHalf + c));
        float2 s1, s2;  // K10: the column scales
        if constexpr (S::kQ) {
          s1 = *reinterpret_cast<const float2*>(s_col + j * kD + c);
          s2 = *reinterpret_cast<const float2*>(s_col + j * kD + kHalf + c);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + g + 8 * half;
          float o1[2], o2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x1, x2;
            if constexpr (S::kQ) {
              x1 = bf16_round(dequant(acc[4 * jj + 2 * half + e], sr[half], e ? s1.y : s1.x,
                                      e ? b1.y : b1.x));
              x2 = bf16_round(dequant(acc[4 * (jj + 8) + 2 * half + e], sr[half],
                                      e ? s2.y : s2.x, e ? b2.y : b2.x));
            } else {
              x1 = bf16_round(acc[4 * jj + 2 * half + e] + (e ? b1.y : b1.x));
              x2 = bf16_round(acc[4 * (jj + 8) + 2 * half + e] + (e ? b2.y : b2.x));
            }
            o1[e] = x1;
            o2[e] = x2;
            if (part < 2) {
              const float cv = cs[half][2 * jj + e], sv = sn[half][2 * jj + e];
              // explicit roundings: no fused multiply-add, as the reference
              o1[e] = __fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
              o2[e] = __fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv));
            }
          }
          *reinterpret_cast<bf162*>(ob + swizzle128(r, jj) + 4 * q4) =
              __floats2bfloat162_rn(o1[0], o1[1]);
          *reinterpret_cast<bf162*>(ob + kOutBlk + swizzle128(r, jj) + 4 * q4) =
              __floats2bfloat162_rn(o2[0], o2[1]);
        }
      }
      named_bar_sync(1 + wg, 128);  // the slab is in the staging tile
      // copy it out in 16-byte stores, two rows of 256 bytes a warp (the TMA
      // unit is left to the W and x loads)
      if (live) {
        bf16* dst = (part == 0 ? q : (part == 1 ? k : v)) +
                    ((size_t)(b * H + h) * L + row0) * kD;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = t + 128 * i, r = idx >> 4, c = idx & 15;
          if (row0 + r < L)
            *reinterpret_cast<uint4*>(dst + r * kD + c * 8) = *reinterpret_cast<const uint4*>(
                ob + (c >> 3) * kOutBlk + swizzle128(r, c & 7));
        }
      }
    }
  }
}

template <int D, int V>
int launch(const void* x, const float* ln_s, const float* ln_b, const void* w, const void* b,
           const float* cos_t, const float* sin_t, const float* s_col, void* q, void* k,
           void* v, int B, int L, int H, cudaStream_t stream) {
  using S = Shape<D, V>;
  const int N = 3 * H * kD;
  CUtensorMap mx, mw;
  const uint64_t dimsx[3] = {D, (uint64_t)L, (uint64_t)B};
  const uint64_t stridesx[2] = {D * 2, (uint64_t)L * D * 2};
  const uint32_t boxx[2] = {64, kBM};
  int err = make_map_bf16(&mx, x, 3, dimsx, stridesx, boxx);
  if (!err) {
    if constexpr (S::kQ) {
      // the k-major int8 weight [N rows][D bytes], boxes of [64 rows][128 bytes]
      const uint64_t dimsw[2] = {D, (uint64_t)N}, stridesw[1] = {D};
      const uint32_t boxw[2] = {S::kBK, 64};
      err = make_map_u8(&mw, w, dimsw, stridesw, boxw, CU_TENSOR_MAP_SWIZZLE_128B);
    } else {
      const uint64_t dimsw[2] = {(uint64_t)N, D}, stridesw[1] = {(uint64_t)N * 2};
      const uint32_t boxw[2] = {64, S::kBK};
      err = make_map_bf16(&mw, w, 2, dimsw, stridesw, boxw);
    }
  }
  if (err) return err;
  auto kernel = ln_qkv_rope_kernel<D, V>;
  err = set_smem((const void*)kernel, S::kSmem);
  if (err) return err;
  const long n_tiles = (long)B * ((L + kBM - 1) / kBM);
  return launch_clusters(kernel, kCluster, kThreadsQkv, S::kSmem, n_tiles, stream, mx, mw,
                         ln_s, ln_b, (const bf16*)b, cos_t, sin_t, s_col, (bf16*)q, (bf16*)k,
                         (bf16*)v, B, L, H);
}

// the instantiation for width d (256 or 512; K1 and K8 also 384, the
// d384x5L shape of tools/variant_step_time_torch.py), or cudaErrorInvalidValue
template <int V>
int launch_widths(const void* x, const float* ln_s, const float* ln_b, const void* w,
                  const void* b, const float* cos_t, const float* sin_t, const float* s_col,
                  void* q, void* k, void* v, int B, int L, int d, int H, void* stream) {
  if (B < 1 || L < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 512) return launch<512, V>(x, ln_s, ln_b, w, b, cos_t, sin_t, s_col, q, k, v, B, L, H, s);
  if (d == 256) return launch<256, V>(x, ln_s, ln_b, w, b, cos_t, sin_t, s_col, q, k, v, B, L, H, s);
  if constexpr (V != kInt8)
    if (d == 384) return launch<384, V>(x, ln_s, ln_b, w, b, cos_t, sin_t, s_col, q, k, v, B, L, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace qkv
}  // namespace herro
