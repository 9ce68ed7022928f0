// K4: pileup tokens + quals -> the d_model stream, one pass.
//
// Replaces herro_tpu/ops/fused.py:_entry_embed_kernel (via _entry_embed_pallas).
// out[t, :] = bf16( sum_r onehot(tok[r, t]) . E_r + sum_r bf16(qual[r, t]) wq_r + cb )
// As on the TPU, this is one product on the tensor cores: per token row the
// feature vector concat_r(onehot_r (V = 12 wide), bf16(qual_r), 3 zeros), a
// slot of 16 per pileup row, 31 slots padded to Kp = 512, times the col_proj
// table Wc [Kp, d] (row 16r + v = E_r[v], row 16r + 12 = wq_r, zero rows
// elsewhere; fused.col_proj_table, built once per weight state). The one-hot
// never reaches device memory. The sums are exact products of bf16 values
// accumulated in float32, as the Pallas kernel's are.
//
// Bound on the H100: bytes (tokens 1 B + quals 4 B per row and pileup
// column, the [B, L, d] bf16 output: 0.35 GB, 0.10 ms at B=32, L=9216). The
// function's own work is one multiply-add over d per nonzero of the
// one-hot|qual rows; the dense product also multiplies the zeros, 2*T*Kp*d =
// 1.5e11 tensor-core operations, 0.16 ms at peak, so this formulation cannot
// reach the bytes bound.
//
// Design (sm_90a): a persistent grid, one block per SM walking 128-row tiles
// that never cross an example (tile = (b, l0)), each block three warpgroups.
// - A producer warp streams Wc through a ring of four 16 KB stages
//   ([32 k][256 n], four TMA boxes) in the order the consumers take them: per
//   pass over 256 output columns, its Kp/32 k-stages. Blocks run in clusters
//   of kCluster; each loads its share of a stage's boxes and multicasts them,
//   so L2 serves each Wc byte once per kCluster tiles.
// - Two consumer warpgroups, 64 rows each, build their rows of the A tile
//   [128][Kp] bf16 directly in wgmma's 128-byte-swizzled layout: a (row,
//   pileup row) pair is one 32-byte slot, two 16-byte shared stores. Their
//   tokens and quals are read by coalesced loads along the column axis, and
//   the next tile's are loaded into registers while this tile's products run.
//   Per pass each accumulates [64, 256] (wgmma m64n256k16, 128 registers a
//   thread; both warpgroups read the same Wc stage) and adds the bias; each
//   warp then stages its 16 rows 64 columns at a time in two swizzled boxes
//   that TMA stores, one filled while the other is stored. A ring stage is
//   released as soon as the products that read it are done.
// - The mma.sync design built a [128, 416] tile in two-byte stores, staged Wc
//   by cp.async behind block-wide barriers and wrote 4-byte pairs from
//   registers. Measured per tile (clock64 counters), the products now run
//   at about the tensor cores' rate; the output, stored as 4-byte pairs
//   from registers, had taken longer than the products, and by TMA takes
//   well under their time.
// - setmaxnreg gives the consumers 232 registers and the producer 40 (the
//   block's 384 x 168 at launch, redistributed).
// Shapes: d 256, 384 (the d384x5L shape of tools/variant_step_time_torch.py:
// a pass of 256 columns and one of 128) or 512, V 12, R <= 32 (Kp 512), any
// B >= 1, L >= 1.
#include "common.cuh"
#include "sm90.cuh"

namespace herro {
namespace embed {

using namespace sm90;

constexpr int kBM = 128;                    // token rows per tile: two warpgroups of 64
constexpr int kSlot = 16;                   // k per pileup row: 12 one-hot, the qual, 3 zeros
constexpr int kKp = 512;                    // k of the product: 32 slots
constexpr int kSlots = kKp / kSlot;
constexpr int kBN = 256;                    // output columns per pass
constexpr int kBK = 32;                     // Wc rows per ring stage
constexpr int kBox = kBK * 128;             // one [32 k][64 n] box of Wc, 4 KB
constexpr int kStageBytes = kBK * kBN * 2;  // four boxes, 16 KB
constexpr int kStages = 4;
constexpr int kABytes = kBM * kKp * 2;      // the A tile, 128 KB
constexpr int kOutBlk = 16 * 128;           // a warp's [16][64] output box, 2 KB
constexpr int kThreadsEmbed = 384;          // two consumer warpgroups and a producer
constexpr int kCluster = 2;                 // blocks sharing one Wc stream
constexpr int kVocab = 12;
constexpr int kPairs = 64 * kSlots / 128;   // (row, slot) pairs a consumer thread builds
// a warp's staging: two output boxes, one filled while the other is stored
constexpr size_t kSmem =
    1024 + kABytes + kStages * kStageBytes + 8 * 2 * kOutBlk + 2 * kStages * 8;

// the [32 k][64 n] boxes of Wc in pass p over the output columns: at d 384
// the second pass has two, and its product's upper 128 columns are not
// stored (the stage's upper half holds no Wc of this pass)
__device__ inline int pass_boxes(int D, int p) { return min(kBN, D - p * kBN) / 64; }

template <int D>
__global__ void __launch_bounds__(kThreadsEmbed, 1)
entry_embed_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap out_map, const uint8_t* __restrict__ tok,
                   const float* __restrict__ quals, const float* __restrict__ cb, int B, int R,
                   int L) {
  constexpr int kPasses = (D + kBN - 1) / kBN;  // passes over the output columns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a = smem;
  unsigned char* ring = a + kABytes;
  unsigned char* obuf = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(obuf + 8 * 2 * kOutBlk);
  uint64_t* empty = full + kStages;

  const int per_b = (L + kBM - 1) / kBM;  // tiles per example
  const long n_tiles = (long)B * per_b;
  constexpr int C = kCluster;
  const uint32_t rank = cluster_rank();
  const long group = cluster_id(), n_groups = cluster_count();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * C);
    }
    fence_barrier_init();
  }
  cluster_sync();  // the peers' barriers exist before anyone multicasts to them

  // the blocks of a cluster take C consecutive tiles per iteration; a block
  // whose tile lies past the end runs it on zero rows and stores nothing,
  // so that it keeps its share of the cluster's Wc stream
  auto first_tile = [&](long it) { return (it * n_groups + group) * C; };

  if (threadIdx.x >= 256) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    prefetch_map(&w_map);
    int slot = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
    };
    for (long it = 0; first_tile(it) < n_tiles; ++it)
      for (int p = 0; p < kPasses; ++p)
        for (int s = 0; s < kKp / kBK; ++s) {
          const int boxes = pass_boxes(D, p);
          mbar_wait(&empty[slot], phase ^ 1);
          mbar_expect_tx(&full[slot], boxes * kBox);
          unsigned char* dst = ring + slot * kStageBytes;
          for (int bx = rank; bx < boxes; bx += C)
            tma_load_2d_multicast(dst + bx * kBox, &w_map, &full[slot], p * kBN + bx * 64,
                                  s * kBK, (uint16_t)((1 << C) - 1));
          advance();
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
  unsigned char* ob = obuf + (threadIdx.x >> 5) * 2 * kOutBlk;  // this warp's staging
  int slot = 0, held = -1;
  uint32_t phase = 0;
  auto release = [&](int s) {
    if (t < C) mbar_arrive_cluster(&empty[s], t);
  };
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

  // This thread builds row t % 64 of its warpgroup's 64 for the slots
  // 2i + t / 64: consecutive threads read consecutive columns. A token
  // outside the vocab (and every slot past R or row past L) is an all-zero
  // one-hot, its qual 0.
  const int arow = t & 63;
  uint32_t tk[kPairs];
  float qv[kPairs];
  auto fetch = [&](long tile) {
    const int b = (int)(tile / per_b);
    const int l = (int)(tile % per_b) * kBM + wg * 64 + arow;
    const bool ok = tile < n_tiles && l < L;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = 2 * i + (t >> 6);
      tk[i] = 0xFFu;
      qv[i] = 0.f;
      if (ok && r < R) {
        const size_t o = ((size_t)b * R + r) * L + l;
        tk[i] = tok[o];
        qv[i] = quals[o];
      }
    }
  };
  fetch(first_tile(0) + rank);

  for (long it = 0; first_tile(it) < n_tiles; ++it) {
    const long tile = first_tile(it) + rank;
    const int b = (int)(tile / per_b), l0 = (int)(tile % per_b) * kBM;
    const int row0 = l0 + wg * 64;  // this warpgroup's first row

    // this warpgroup's rows of A; its products of the last tile are done
    named_bar_sync(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = 2 * i + (t >> 6);
      const uint32_t v = tk[i] < kVocab ? tk[i] : 0xFFu;
      const uint32_t one = 0x3F80u << ((v & 1) << 4);  // bf16 1.0 in the low or high half
      const uint32_t w = v >> 1;                       // the 32-bit word it falls in
      const uint4 lo = make_uint4(w == 0 ? one : 0u, w == 1 ? one : 0u, w == 2 ? one : 0u,
                                  w == 3 ? one : 0u);
      const uint4 hi = make_uint4(w == 4 ? one : 0u, w == 5 ? one : 0u,
                                  (uint32_t)__bfloat16_as_ushort(__float2bfloat16(qv[i])), 0u);
      unsigned char* blk = a + (r >> 2) * (kBM * 128);
      const int row = wg * 64 + arow, c = 2 * (r & 3);
      *reinterpret_cast<uint4*>(blk + swizzle128(row, c)) = lo;
      *reinterpret_cast<uint4*>(blk + swizzle128(row, c + 1)) = hi;
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);  // this warpgroup's rows of A are in place
    fetch(first_tile(it + 1) + rank);  // in flight during the products

    const int wrow0 = row0 + warp * 16;  // this warp's first row
    const bool live = tile < n_tiles && wrow0 < L;
#pragma unroll 1
    for (int p = 0; p < kPasses; ++p) {
      float acc[128];
      for (int s = 0; s < kKp / kBK; ++s) {
        mbar_wait(&full[slot], phase);
        const unsigned char* wb = ring + slot * kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const int k = s * kBK + kk * 16;
          const uint64_t da = wgmma_desc(
              a + (k >> 6) * (kBM * 128) + wg * (64 * 128) + (k & 63) * 2, 16, 1024);
          const uint64_t db = wgmma_desc(wb + kk * 16 * 128, kBox, 1024);
          wgmma_ss_n256<1>(acc, da, db, s > 0 || kk > 0);
        }
        wgmma_commit();
        retire_previous();
      }
      retire_all();
      fence_operand(acc);
      if (!live) continue;
      // out = bf16(acc + cb), 64 columns at a time through the warp's two
      // staging boxes, each leaving by a TMA store of the warp's 16 rows
#pragma unroll
      for (int n = 0; n < kBN / 64; ++n) {
        if (D % kBN != 0 && n >= pass_boxes(D, p)) break;
        unsigned char* st = ob + (n & 1) * kOutBlk;
        if (lane == 0) bulk_wait_read<1>();  // the store before last has read `st`
        __syncwarp();
#pragma unroll
        for (int jl = 0; jl < 8; ++jl) {
          const int j = n * 8 + jl;
          const float2 bb = *reinterpret_cast<const float2*>(cb + p * kBN + 8 * j + 2 * q);
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<bf162*>(st + swizzle128(g + 8 * half, jl) + 4 * q) =
                __floats2bfloat162_rn(acc[4 * j + 2 * half] + bb.x,
                                      acc[4 * j + 2 * half + 1] + bb.y);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          tma_store_3d(&out_map, st, p * kBN + n * 64, wrow0, b);
          bulk_commit();
        }
      }
    }
  }
  if (lane == 0) bulk_wait<0>();  // the stores are done before the block exits
}

template <int D>
int launch(const uint8_t* tok, const float* quals, const void* wc, const float* cb, void* out,
           int B, int R, int L, cudaStream_t stream) {
  CUtensorMap mw, mo;
  const uint64_t dims[2] = {D, kKp}, strides[1] = {D * 2};
  const uint32_t box[2] = {64, kBK};
  const uint64_t dimso[3] = {D, (uint64_t)L, (uint64_t)B};
  const uint64_t strideso[2] = {D * 2, (uint64_t)L * D * 2};
  const uint32_t boxo[2] = {64, 16};
  int err = make_map_bf16(&mw, wc, 2, dims, strides, box);
  if (!err) err = make_map_bf16(&mo, out, 3, dimso, strideso, boxo);
  if (err) return err;
  auto kernel = entry_embed_kernel<D>;
  err = set_smem((const void*)kernel, kSmem);
  if (err) return err;
  const long n_tiles = (long)B * ((L + kBM - 1) / kBM);
  return launch_clusters(kernel, kCluster, kThreadsEmbed, kSmem, n_tiles, stream, mw, mo, tok,
                         quals, cb, B, R, L);
}

}  // namespace embed
}  // namespace herro

extern "C" int herro_entry_embed(const uint8_t* tok, const float* quals, const void* wc,
                                 const float* cb, void* out, int B, int R, int L, int d,
                                 int V, int kp, void* stream) {
  using namespace herro::embed;
  if (B < 1 || L < 1 || R < 1 || R > kSlots || V != kVocab || kp != kKp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 512) return launch<512>(tok, quals, wc, cb, out, B, R, L, s);
  if (d == 256) return launch<256>(tok, quals, wc, cb, out, B, R, L, s);
  if (d == 384) return launch<384>(tok, quals, wc, cb, out, B, R, L, s);
  return (int)cudaErrorInvalidValue;
}
