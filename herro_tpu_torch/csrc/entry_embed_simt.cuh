// K4 on the CUDA cores: pileup tokens + quals -> the d_model stream, for
// float32 configs and for bf16 at widths the Hopper instance (entry_embed.cu:
// d 256, 384 or 512, the 512-row table) lacks. Entry points:
// entry_embed_f32.cu (float32), entry_embed_bf16.cu (bf16).
//
// Replaces herro_tpu/ops/fused.py:_entry_embed_kernel (via _entry_embed_pallas):
//   out[t, c] = E((sum_r E_r[tok[r, t], c] + sum_r E(qual[r, t]) * wq_r[c]) + cb[c])
// with E_r[v] row 16r + v and wq_r row 16r + V of the col_proj table Wc
// [kp, d] of type E (fused.col_proj_table); a token outside the vocab adds
// nothing; the quals meet the weights in E, as the plain version's
// quals.to(out_dtype) rounds them, and the sums run in float32. cb stays
// float32.
//
// The arithmetic is the per-thread kernel's that ran here before, step for
// step, so every output keeps its bits (and tiny's bf16 outputs stay
// bit-equal with the plain version): e sums the token rows with __fadd_rn
// over r ascending, a token >= V adding nothing; q is one fmaf chain from 0
// over r ascending of E(qual) * wq_r; y = E((e + q) + cb). No tensor cores:
// an mma sums a k-chunk in an order of its own.
//
// Bound on the H100 (B=32, L=9216, R=31): bytes at tiny's width (tokens 1 B
// and quals 4 B a pileup row and position, the [B, L, d] output: 0.025 ms in
// float32, 0.019 in bf16), operations at r10's (d 512 float32, 2 d FLOPs a
// token or qual in the vocab: 0.279 ms at the FFMA rate). What the sums must
// read from shared memory is larger, and holds the kernel: a table row's 4
// columns a lane and (position, r), T R d 4 B in float32 (18.7 GB at r10,
// 0.56 ms at 128 B a clock an SM and 1.98 GHz; 1.17 GB at tiny), and a
// warp's reads of its quals and of wq_r, 4 wavefronts each a 16 positions.
//
// Design: a persistent grid of 256-thread blocks. A block owns one slice of
// kSlice = 32 columns of d (all of d at d 32) and strides over tiles of kTile
// = 128 consecutive positions of one example; block i takes slice i % (d /
// 32) and tiles i / (d / 32), i / (d / 32) + grid / (d / 32), ..., so the
// slices of one tile run side by side and all but the first read its tokens
// and quals from L2.
// - Tokens and quals staged once a tile: tok[b, 0:R, l0:l0+128] (u8) and
//   quals[...] (float32) into a slot of a two-slot ring, [R][kTile] each,
//   by one warp: one bulk copy (cp.async.bulk) a pileup row and operand,
//   completing the slot's mbarrier. No block barrier a tile: each warp
//   counts itself done with a slot, and the last one stages the tile a ring
//   on there, so that tile's copy flies while the next is summed and a slow
//   warp holds up no other. A bulk copy wants 16-byte addresses and sizes:
//   when L is not a multiple of 16 (or an operand is not 16-byte aligned)
//   that warp loads the tile itself, 8 loads a lane in flight, and arrives
//   on the barrier, in the same kernel. (Every L of the pipeline's buckets
//   is a multiple of 1024.)
// - The table resident: the block stages the (V + 1) R used rows of Wc for
//   its slice once, as float32 (a bf16 value widened, exactly), 128 bytes a
//   row (51.6 KB at R 31), and a row of zeros. With the ring
//   (2 R 128 5 B: 39.7 KB at R 31) every R and V the launch takes fits 227
//   KB; the launch sets the dynamic shared memory attribute for the largest
//   (R 63, V 15: 205 KB). Two blocks an SM at R 31.
// - The sums, one pass over r: lane (warp w, group g = lane / 8, cl = lane %
//   8) owns the 4 columns 4 cl.. of the slice at the 4 consecutive
//   positions 16 w + 4 g .. of the tile. A pileup row's 4 tokens are one
//   32-bit read of shared memory, its 4 quals one float4, both broadcast to
//   the group's 8 lanes; the token term reads a table row's 4 columns with
//   one 16-byte read a (position, r): a group's 8 lanes read one 128-byte
//   row, a quarter warp, free of bank conflicts. (bf16 rows of 64 bytes, each
//   held twice so that a half warp's two rows fell in distinct banks, read
//   half the bytes but took more instructions to widen: 0.097 ms at tiny in
//   bf16 against 0.089 with the float32 table, clock-instrumented builds of
//   tools/embed_clocks_torch.py.) A token outside the vocab reads the row of
//   zeros, so no read waits behind a branch. The quals term reads wq_r's 4
//   columns once a r for the lane's 4 positions, in the same pass (the two
//   terms in two passes took 6-8% longer, measured the same way).
// - The stores: 16 bytes a lane (8 in bf16), a position's slice from the 8
//   lanes of its group, coalesced.
// Measured (B=32, L=9216, R=31, H100 at 700 W, CUDA-graph replay; PERF.md
// section 6): r10 float32 1.20 ms, tiny float32 0.080, tiny bf16 0.085,
// against the per-thread kernel's 3.05 / 0.226 / 0.218; a warp spends
// 0.61-0.68 of its cycles in the sums, which wait on the shared-memory pipe
// (tools/embed_clocks_torch.py).
// Shapes: d a multiple of 32 up to 1024 (d / 32 slices, the grid a multiple
// of them), R 1-63, V < 16, kp >= 16 R, any B, L.
#pragma once

#include "f32.cuh"
#include "sm90.cuh"

namespace herro {
namespace embed_simt {

using namespace f32;

constexpr int kSlot = 16;     // col_proj_table's rows a pileup row
constexpr int kMaxRows = 63;  // R the launch takes
constexpr int kSlice = 32;    // columns of d a block
constexpr int kTile = 128;    // positions a tile
constexpr int kLanes = kSlice / 4;  // lanes a position: 4 columns each
constexpr int kPer = 4;       // positions a lane: one 32-bit word of tokens
constexpr int kBlock = 256;   // threads a block
constexpr int kWarps = kBlock / 32;
static_assert(kWarps * (32 / kLanes) * kPer == kTile, "a block's lanes cover a tile");
constexpr int kRing = 2;      // slots of the ring
constexpr int kHead = 64;     // the ring's mbarriers and counters

// bytes of one ring slot: tokens [R][kTile] u8, then quals [R][kTile] float
__host__ __device__ constexpr int slot_bytes(int R) { return R * kTile * 5; }

// the dynamic shared memory of a block: the head, the ring's slots, the
// table [R][V + 1][kSlice] of float32 and one row of zeros
__host__ __device__ constexpr int smem_bytes(int R, int V) {
  return kHead + kRing * slot_bytes(R) + (R * (V + 1) + 1) * kSlice * (int)sizeof(float);
}

// the tile's example and first position, and its positions (kTile but in
// an example's last tile)
struct Tile {
  long b;
  int l0, n;
};
__device__ inline Tile tile_at(long tile, int per_ex, int L) {
  const long b = tile / per_ex;
  const int l0 = (int)(tile - b * per_ex) * kTile;
  return {b, l0, L - l0 < kTile ? L - l0 : kTile};
}

// the tile's tokens and quals into ``slot`` by one warp, completing
// ``bar``'s phase: with ``bulk`` one copy a pileup row and operand, else
// the warp's own loads and an arrival
__device__ inline void stage_tile(unsigned char* slot, uint64_t* bar,
                                  const uint8_t* __restrict__ tok,
                                  const float* __restrict__ quals, int R, int L, Tile t,
                                  bool bulk) {
  const int lane = threadIdx.x % 32;
  float* const qs = reinterpret_cast<float*>(slot + R * kTile);
  const long row0 = t.b * R * L + t.l0;  // (b, r = 0, l0) in tok and quals
  if (bulk) {
    if (lane == 0) sm90::mbar_expect_tx(bar, (uint32_t)(R * t.n * 5));
    __syncwarp();
    sm90::fence_proxy_async();
    for (int r = lane; r < R; r += 32) {
      const long src = row0 + (long)r * L;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(sm90::smem_u32(slot + r * kTile)), "l"(tok + src), "r"(t.n),
          "r"(sm90::smem_u32(bar))
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(sm90::smem_u32(qs + r * kTile)), "l"(quals + src), "r"(4 * t.n),
          "r"(sm90::smem_u32(bar))
          : "memory");
    }
    return;
  }
  constexpr int kBatch = 8;  // loads of each operand a lane keeps in flight
  for (int i0 = 0; i0 < R * t.n; i0 += 32 * kBatch) {
    uint8_t tv[kBatch];
    float qv[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 32 * u + lane, r = i / t.n, j = i - r * t.n;
      at[u] = i < R * t.n ? r * kTile + j : -1;
      if (at[u] >= 0) {
        tv[u] = tok[row0 + (long)r * L + j];
        qv[u] = quals[row0 + (long)r * L + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0) {
        slot[at[u]] = tv[u];
        qs[at[u]] = qv[u];
      }
  }
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    sm90::mbar_arrive(bar);
  }
}

template <typename E>
__global__ void __launch_bounds__(kBlock)
    entry_embed_kernel(const uint8_t* __restrict__ tok, const float* __restrict__ quals,
                       const E* __restrict__ wc, const float* __restrict__ cb,
                       E* __restrict__ out, int R, int L, int d, int V, long tiles, int per_ex,
                       int bulk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem_raw);
  int* const done = reinterpret_cast<int*>(bars + kRing);  // warps done with a slot
  unsigned char* const ring = smem_raw + kHead;
  float* const table = reinterpret_cast<float*>(ring + kRing * slot_bytes(R));
  const int slices = d / kSlice, V1 = V + 1;
  const int c0 = (int)(blockIdx.x % slices) * kSlice;
  const long stride = gridDim.x / slices;
  long tile = blockIdx.x / slices;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / kLanes;
  const int c = 4 * (lane % kLanes);             // the lane's columns
  const int p0 = (warp * (32 / kLanes) + g) * kPer;  // its first position
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      sm90::mbar_init(&bars[i], 1);
      done[i] = 0;
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();  // the barriers' init
  // the first kRing tiles, one a warp
  if (warp < kRing && tile + warp * stride < tiles)
    stage_tile(ring + warp * slot_bytes(R), &bars[warp], tok, quals, R, L,
               tile_at(tile + warp * stride, per_ex, L), bulk);
  // the table: row (r, v) of the slice from Wc's row 16 r + v, v <= V
  for (int i = tid; i < R * V1 * kLanes; i += kBlock) {
    const int rv = i / kLanes, q4 = 4 * (i % kLanes), r = rv / V1;
    *reinterpret_cast<float4*>(table + rv * kSlice + q4) =
        load_f4(wc + (long)(kSlot * r + rv - r * V1) * d + c0 + q4);
  }
  if (tid < kLanes)  // the row a token outside the vocab reads
    reinterpret_cast<float4*>(table + R * V1 * kSlice)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 cb4 = *reinterpret_cast<const float4*>(cb + c0 + c);
  const float bias[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
  const float* const tcol = table + c;  // the lane's columns of every row
  const float* const zero = tcol + R * V1 * kSlice;
  __syncthreads();  // the table is whole
  for (int k = 0; tile < tiles; tile += stride, ++k) {
    const int s = k % kRing;
    unsigned char* const ts = ring + s * slot_bytes(R);
    const float* const qs = reinterpret_cast<const float*>(ts + R * kTile);
    sm90::mbar_wait(&bars[s], (k / kRing) & 1);  // the tile is in
    // the sums, one pass over r ascending: the token term reads one row of
    // the table a (position, r) (a token outside the vocab adds the row of
    // zeros, which leaves e as it is: e is never -0, it starts at +0 and is
    // a sum; so no read waits behind a branch), the quals term wq_r once
    // for the lane's positions
    float e[kPer][4] = {}, q[kPer][4] = {};
    for (int r = 0; r < R; ++r) {
      const uint32_t tw = *reinterpret_cast<const uint32_t*>(ts + r * kTile + p0);
      const float* const rows = tcol + r * V1 * kSlice;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int v = (tw >> (8 * j)) & 0xff;
        const float4 w = *reinterpret_cast<const float4*>(v < V ? rows + v * kSlice : zero);
        e[j][0] = __fadd_rn(e[j][0], w.x);
        e[j][1] = __fadd_rn(e[j][1], w.y);
        e[j][2] = __fadd_rn(e[j][2], w.z);
        e[j][3] = __fadd_rn(e[j][3], w.w);
      }
      const float4 wq = *reinterpret_cast<const float4*>(rows + V * kSlice);
      const float4 qv = *reinterpret_cast<const float4*>(qs + r * kTile + p0);
      const float qj[kPer] = {round_to<E>(qv.x), round_to<E>(qv.y), round_to<E>(qv.z),
                              round_to<E>(qv.w)};
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        q[j][0] = fmaf(qj[j], wq.x, q[j][0]);
        q[j][1] = fmaf(qj[j], wq.y, q[j][1]);
        q[j][2] = fmaf(qj[j], wq.z, q[j][2]);
        q[j][3] = fmaf(qj[j], wq.w, q[j][3]);
      }
    }
    // the slot is free once every warp is done with it (its reads all
    // consumed above): the last warp to be done stages the tile kRing tiles
    // on there
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      last = atomicAdd(&done[s], 1) == kWarps - 1;
      if (last) done[s] = 0;
    }
    if (__shfl_sync(0xffffffffu, last, 0) && tile + kRing * stride < tiles)
      stage_tile(ts, &bars[s], tok, quals, R, L, tile_at(tile + kRing * stride, per_ex, L),
                 bulk);
    // the epilogue, into e
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[j][i] = round_to<E>(__fadd_rn(__fadd_rn(e[j][i], q[j][i]), bias[i]));
    const Tile t = tile_at(tile, per_ex, L);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (p0 + j < t.n) store4(out + ((t.b * L + t.l0 + p0 + j) * d + c0 + c), e[j]);
  }
}

template <typename E>
int launch(const uint8_t* tok, const float* quals, const E* wc, const float* cb, E* out, int B,
           int R, int L, int d, int V, int kp, cudaStream_t stream) {
  if (B < 1 || L < 1 || R < 1 || R > kMaxRows || V < 1 || V >= kSlot || kp < kSlot * R ||
      !d_model_ok(d))
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)entry_embed_kernel<E>;
  const int smem = smem_bytes(R, V);
  // the attribute for the most any launch asks, so no later one is refused
  int err = set_smem(kernel, smem_bytes(kMaxRows, kSlot - 1));
  if (!err)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kBlock, smem);
  if (err) return err;
  const int per_ex = (L + kTile - 1) / kTile, slices = d / kSlice;
  const long tiles = (long)B * per_ex, items = tiles * slices;
  // a persistent grid, a multiple of the slices: every block keeps its slice
  long grid = (long)sms * per / slices * slices;
  if (grid < slices) grid = slices;
  if (grid > items) grid = items;
  const int bulk = L % 16 == 0 && (reinterpret_cast<uintptr_t>(tok) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(quals) & 15) == 0;
  entry_embed_kernel<E><<<(unsigned)grid, kBlock, smem, stream>>>(
      tok, quals, wc, cb, out, R, L, d, V, tiles, per_ex, bulk);
  return (int)cudaGetLastError();
}

}  // namespace embed_simt
}  // namespace herro
