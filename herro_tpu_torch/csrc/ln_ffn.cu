// K3: LayerNorm + FFN + residual, the hidden kept on chip.
//
// Replaces herro_tpu/ops/fused.py:_ln_ffn_kernel (via _ln_ffn_pallas).
// out = bf16(x + (h @ W2 + b2)),  h = bf16(gelu_tanh(bf16(LN(x) @ W1 + b1))).
//
// Bound on the H100: operations, 4*T*d*f (6.2e11 at T=294,912, d=512,
// f=1024) over the bf16 tensor-core rate, 0.63 ms; x in and out are 0.6 GB,
// 0.18 ms. The TPU kernel kept W1 and W2 whole in VMEM; 2 MB does not fit in
// an SM, so the weights stream from L2 once per 64-row tile (64 rows is what
// the output accumulator leaves room for in registers at d=512).
//
// Design (sm_90a): a persistent grid, one block per SM walking 64-row tiles,
// each block three warpgroups.
// - A producer warp streams W1 and W2 through a ring of four 32 KB stages by
//   TMA (128-byte swizzle), in the order the consumers take them: per
//   128-column chunk of the hidden, the W1 stages of its columns, then the W2
//   stages of its rows. Blocks run in clusters of kCluster; the blocks of a
//   cluster walk the same weight stream, each loads its share of a stage's
//   boxes and multicasts them to all, so L2 serves each weight byte once per
//   kCluster tiles.
// - The producer also loads each tile's x by TMA into the LN tile, as soon as
//   the last tile's GEMM1s are done with it, so the load overlaps the last
//   chunk's GEMM2 and the output epilogue. (LayerNorm read row by row from
//   device memory was latency-bound: the largest share of the kernel's time.)
// - Two consumer warpgroups run wgmma. At a tile's start they turn that x
//   into LN(x), bf16, in place: it already sits in the swizzled layout of
//   wgmma's A operand. Per chunk, each computes half of the chunk's 128
//   hidden columns (GEMM1, m64n64), adds b1, rounds, applies gelu_tanh and
//   rounds again in registers, and stores its half into a double-buffered
//   [64, 128] tile; after a barrier of the two, each accumulates its half of
//   the output columns over the chunk (GEMM2, m64n{d/2}, 128 registers a
//   thread at d=512). A ring stage is released as soon as the products that
//   read it have completed, one group behind the newest, so chunk c's GEMM2
//   and chunk c+1's GEMM1 run back to back. The [T, f] hidden never leaves
//   the SM. What the tensor cores still wait on is the gelu epilogue, which
//   both warpgroups run at once between a chunk's two products.
// - setmaxnreg gives the consumers 232 registers and the producer 40: the
//   block's 384 x 168 at launch, redistributed (asking for more than that
//   never returns). The accumulators are not zeroed by hand: writing them
//   while a product is in flight makes ptxas serialise every wgmma.
// - d 384 (the d384x5L shape of tools/variant_step_time_torch.py): each
//   consumer's output half is 192 columns, one m64n192 product; a W2 stage
//   holds 32 rows (24 KB of the 32 KB slot), as 42 would not divide a chunk.
// Shapes: d 256, 384 or 512, f a multiple of 128, any T >= 1 (rows past T
// read as zeros and are not stored).
#include "common.cuh"
#include "sm90.cuh"

namespace herro {
namespace ffn {

using namespace sm90;

constexpr int kBM = 64;              // token rows per tile
constexpr int kFC = 128;             // hidden columns per chunk
constexpr int kStageBytes = 32768;   // one ring stage
constexpr int kStages = 4;
constexpr int kW1Rows = 128;         // W1 rows per stage: two [128][64] boxes
constexpr int kW1Box = kW1Rows * 128;
constexpr int kHBytes = kBM * kFC * 2;  // one hidden chunk, two [64][64] blocks
constexpr int kThreadsFfn = 384;     // two consumer warpgroups and a producer
constexpr int kCluster = 2;        // blocks sharing one weight stream

template <int D>
struct Shape {
  // W2 rows per stage: as many as fill it (d 256: 64, 512: 32); at d 384, 32
  // of the 42 that fit, as the rows must divide a chunk's 128
  static constexpr int kW2Rows = D == 384 ? 32 : kStageBytes / (2 * D);
  static constexpr int kW2Bytes = kW2Rows * 2 * D;       // a W2 stage's bytes
  static constexpr int kW2Box = kW2Rows * 128;           // one [kW2Rows][64] box
  static constexpr int kS1 = D / kW1Rows;                // W1 stages per chunk
  static constexpr int kS2 = kFC / kW2Rows;              // W2 stages per chunk
  static constexpr int kN2 = D / 2;                      // output columns per consumer
  static constexpr int kLnBytes = kBM * D * 2;
  static constexpr size_t kSmem =
      1024 + kStages * kStageBytes + kLnBytes + 2 * kHBytes + (2 * kStages + 2) * 8;
};

__device__ inline float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

// LayerNorm (flax semantics, as fused.py:layernorm), in place on the
// x tile that TMA left in `ln` (D/64 swizzled blocks of [64][64]): float32
// statistics, the fast variance clamped at 0, eps 1e-6, bf16 out. Rows past T
// arrived as zeros and are never stored. The 8 consumer warps take 8 rows each.
template <int D>
__device__ inline void layernorm_tile(const float* __restrict__ scale,
                                      const float* __restrict__ bias, unsigned char* ln) {
  // 16-byte chunks a lane holds of a row; at d 384 the second is held by
  // lanes 0-15 only (`has`)
  constexpr int kCh = (D + 255) / 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto has = [&](int i) { return D % 256 == 0 || lane + 32 * i < D / 8; };
  float sc[kCh][8], bi[kCh][8];  // this lane's columns of the affine
#pragma unroll
  for (int i = 0; i < kCh; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[i][e] = has(i) ? scale[(lane + 32 * i) * 8 + e] : 0.f;
      bi[i][e] = has(i) ? bias[(lane + 32 * i) * 8 + e] : 0.f;
    }
#pragma unroll 2
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
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

template <int D>
__global__ void __launch_bounds__(kThreadsFfn, 1)
ln_ffn_kernel(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w1_map,
              const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
              const float* __restrict__ ln_s, const float* __restrict__ ln_b,
              const bf16* __restrict__ b1, const bf16* __restrict__ b2,
              bf16* __restrict__ out, long T, int f) {
  using S = Shape<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* ln = ring + kStages * kStageBytes;
  unsigned char* hbuf = ln + S::kLnBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(hbuf + 2 * kHBytes);
  uint64_t* empty = full + kStages;
  uint64_t* x_full = empty + kStages;  // the tile's x has landed in `ln`
  uint64_t* ln_free = x_full + 1;      // both warpgroups' GEMM1 reads of `ln` are done

  const long n_tiles = (T + kBM - 1) / kBM;
  const int n_chunks = f / kFC;
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
  // so that it keeps its share of the cluster's weight stream
  auto first_tile = [&](long it) { return (it * n_groups + group) * C; };

  if (threadIdx.x >= 256) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    prefetch_map(&x_map);
    prefetch_map(&w1_map);
    prefetch_map(&w2_map);
    int slot = 0;
    uint32_t phase = 0, free_phase = 0;
    auto acquire = [&](int bytes) {
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
    auto load = [&](void* dst, const CUtensorMap* map, int c0, int c1) {
      tma_load_2d_multicast(dst, map, &full[slot], c0, c1, (uint16_t)((1 << C) - 1));
    };
    for (long it = 0; first_tile(it) < n_tiles; ++it) {
      // this tile's x into `ln` once the last tile's GEMM1s have read it
      mbar_wait(ln_free, free_phase ^ 1);
      free_phase ^= 1;
      mbar_expect_tx(x_full, S::kLnBytes);
      for (int b = 0; b < D / 64; ++b)
        tma_load_2d(ln + b * (kBM * 128), &x_map, x_full, b * 64,
                    (int)((first_tile(it) + rank) * kBM));
      for (int c = 0; c < n_chunks; ++c) {
        for (int s = 0; s < S::kS1; ++s) {
          unsigned char* dst = acquire(kStageBytes);
          for (int b = rank; b < 2; b += C)
            load(dst + b * kW1Box, &w1_map, c * kFC + b * 64, s * kW1Rows);
          advance();
        }
        for (int s = 0; s < S::kS2; ++s) {
          unsigned char* dst = acquire(S::kW2Bytes);
          for (int b = rank; b < D / 64; b += C)
            load(dst + b * S::kW2Box, &w2_map, b * 64, c * kFC + s * S::kW2Rows);
          advance();
        }
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
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  int slot = 0, held = -1, hb = 0;
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

  for (long it = 0; first_tile(it) < n_tiles; ++it) {
    const long row0 = (first_tile(it) + rank) * kBM;
    mbar_wait(x_full, x_phase);
    x_phase ^= 1;
    layernorm_tile<D>(ln_s, ln_b, ln);
    fence_proxy_async();
    named_bar_sync(1, 256);  // LN(x) complete in `ln`

    // zeroed, not only overwritten by the first product, so that no value
    // is carried in registers from the last tile
    float acc2[S::kN2 / 2];
    for (int c = 0; c < n_chunks; ++c) {
      float acc1[32];
      for (int s = 0; s < S::kS1; ++s) {
        mbar_wait(&full[slot], phase);
        const unsigned char* wb = ring + slot * kStageBytes + wg * kW1Box;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kW1Rows / 16; ++kk) {
          const int k = s * kW1Rows + kk * 16;
          const uint64_t da = wgmma_desc(ln + (k >> 6) * (kBM * 128) + (k & 63) * 2, 16, 1024);
          const uint64_t db = wgmma_desc(wb + kk * 16 * 128, kW1Box, 1024);
          wgmma_ss_n64<1>(acc1, da, db, s > 0 || kk > 0);
        }
        wgmma_commit();
        retire_previous();
      }
      retire_all();
      fence_operand(acc1);
      if (c == n_chunks - 1 && t == 0) mbar_arrive(ln_free);

      // h = bf16(gelu(bf16(acc + b1))) into block wg of the hidden chunk
      unsigned char* hc = hbuf + hb * kHBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kFC + wg * 64 + 8 * j + 2 * q;
        const float bb0 = __bfloat162float(b1[col]), bb1 = __bfloat162float(b1[col + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + g + 8 * half;
          *reinterpret_cast<bf162*>(hc + wg * (kBM * 128) + swizzle128(r, j) + 4 * q) =
              __floats2bfloat162_rn(gelu_tanh(bf16_round(acc1[4 * j + 2 * half] + bb0)),
                                    gelu_tanh(bf16_round(acc1[4 * j + 2 * half + 1] + bb1)));
        }
      }
      fence_proxy_async();
      named_bar_sync(2, 256);  // both halves of the chunk are in place

      for (int s = 0; s < S::kS2; ++s) {
        mbar_wait(&full[slot], phase);
        const unsigned char* wb = ring + slot * kStageBytes + wg * (S::kN2 / 64) * S::kW2Box;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < S::kW2Rows / 16; ++kk) {
          const int k = s * S::kW2Rows + kk * 16;
          const uint64_t da = wgmma_desc(hc + (k >> 6) * (kBM * 128) + (k & 63) * 2, 16, 1024);
          const uint64_t db = wgmma_desc(wb + kk * 16 * 128, S::kW2Box, 1024);
          if constexpr (S::kN2 == 256) {
            wgmma_ss_n256<1>(acc2, da, db, c > 0 || s > 0 || kk > 0);
          } else if constexpr (S::kN2 == 192) {
            wgmma_ss_n192<1>(acc2, da, db, c > 0 || s > 0 || kk > 0);
          } else {
            wgmma_ss_n128<1>(acc2, da, db, c > 0 || s > 0 || kk > 0);
          }
        }
        wgmma_commit();
        retire_previous();
      }
      hb ^= 1;
    }
    retire_all();
    fence_operand(acc2);

    // out = bf16(x + (acc + b2)) for this warpgroup's columns
#pragma unroll
    for (int j = 0; j < S::kN2 / 8; ++j) {
      const int col = wg * S::kN2 + 8 * j + 2 * q;
      const float bb0 = __bfloat162float(b2[col]), bb1 = __bfloat162float(b2[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long row = row0 + warp * 16 + g + 8 * half;
        if (row >= T) continue;
        const size_t o = (size_t)row * D + col;
        const float2 xr = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + o));
        *reinterpret_cast<bf162*>(out + o) =
            __floats2bfloat162_rn(xr.x + (acc2[4 * j + 2 * half] + bb0),
                                  xr.y + (acc2[4 * j + 2 * half + 1] + bb1));
      }
    }
  }
}

template <int D>
int launch(const void* x, const float* ln_s, const float* ln_b, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, long T, int f,
           cudaStream_t stream) {
  using S = Shape<D>;
  constexpr int C = kCluster;
  CUtensorMap mx, m1, m2;
  const uint64_t dimsx[2] = {D, (uint64_t)T}, stridesx[1] = {D * 2};
  const uint32_t boxx[2] = {64, kBM};
  const uint64_t dims1[2] = {(uint64_t)f, D}, strides1[1] = {(uint64_t)f * 2};
  const uint32_t box1[2] = {64, kW1Rows};
  const uint64_t dims2[2] = {D, (uint64_t)f}, strides2[1] = {D * 2};
  const uint32_t box2[2] = {64, S::kW2Rows};
  int err = make_map_bf16(&mx, x, 2, dimsx, stridesx, boxx);
  if (!err) err = make_map_bf16(&m1, w1, 2, dims1, strides1, box1);
  if (!err) err = make_map_bf16(&m2, w2, 2, dims2, strides2, box2);
  if (err) return err;
  auto kernel = ln_ffn_kernel<D>;
  err = set_smem((const void*)kernel, S::kSmem);
  if (err) return err;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreadsFfn);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as fit on the card at once, no more than there are
  // groups of C tiles
  int clusters = 0;
  cfg.gridDim = dim3(C);
  err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err) return err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const long n_tiles = (T + kBM - 1) / kBM;
  const long groups = (n_tiles + C - 1) / C;
  cfg.gridDim = dim3((unsigned)(C * (groups < clusters ? groups : clusters)));
  err = (int)cudaLaunchKernelEx(&cfg, kernel, mx, m1, m2, (const bf16*)x, ln_s, ln_b,
                                (const bf16*)b1, (const bf16*)b2, (bf16*)out, T, f);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace ffn
}  // namespace herro

extern "C" int herro_ln_ffn(const void* x, const float* ln_s, const float* ln_b,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, long T, int d, int f, void* stream) {
  using namespace herro::ffn;
  if (T < 1 || f < kFC || f % kFC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 512) return launch<512>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, f, s);
  if (d == 256) return launch<256>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, f, s);
  if (d == 384) return launch<384>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, f, s);
  return (int)cudaErrorInvalidValue;
}
