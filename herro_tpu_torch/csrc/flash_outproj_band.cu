// K6: banded flash attention + out projection + residual for any band
// w >= 1: narrower than one key tile, not a multiple of any tile, or wider
// than the sequence (w >= L, clamped to L).
//
// Replaces herro_tpu/ops/fused.py:_banded_flash_outproj_kernel (via
// _banded_flash_outproj_pallas), whose general branch tests |iq - ik| <= w
// per score. The TPU kernel gathers the 2*ceil(w/blk)+1 key tiles around a
// query block and takes one exact softmax over them; here the band's 128-key
// tiles stream through the online softmax of flash_outproj_sm90.cuh under
// kMaskBand, K2's own instantiation, which is the same function: the first
// key tile is rounded down to a tile boundary, only the band's edge tiles
// and the tile at the length test each score, and a consumer warpgroup
// skips the tiles its 64 rows cannot reach. A 128-row query tile walks
// ceil((128 + 2w) / 128) or one more key tiles a head: 3 at w=40, 7 at
// w=384 (K2 at w=512: 9).
// Bound on the H100: operations (4*H*D per in-band query-key pair below the
// length plus the out projection, 2*H*D*d per row below the length) over the
// bf16 tensor-core rate; for bands
// below about 100 the bytes of q, k, v, x and the output bound it instead.
// Under such a band most of each 128-key tile is masked, so a narrow band
// spends most of its products on masked scores; a smaller key tile would cut
// that (see PERF.md).
#include "flash_outproj_sm90.cuh"

extern "C" int herro_flash_outproj_band(const void* q, const void* k, const void* v,
                                        const void* x, const void* wo, const void* bo,
                                        const int* lengths, void* out, int B, int H,
                                        int L, int d, int window, float scale,
                                        void* stream) {
  using namespace herro::fo90;
  if (window < 1) return (int)cudaErrorInvalidValue;
  return launch_widths<kMaskBand>(q, k, v, x, wo, bo, lengths, out, B, H, L, d, window,
                                  scale, stream);
}
