// K6: banded flash attention + out projection + residual for any band
// w >= 1: narrower than one key tile (w < 64), not a multiple of any tile,
// or wider than the sequence (w >= L).
//
// Replaces herro_tpu/ops/fused.py:_banded_flash_outproj_kernel (via
// _banded_flash_outproj_pallas), whose general branch tests |iq - ik| <= w
// per score. The TPU kernel gathers the 2*ceil(w/blk)+1 key tiles around a
// query block and takes one exact softmax over them; here the band's key
// tiles stream through the online softmax of flash_outproj.cuh (kMaskBand),
// which is the same function: the first key tile is rounded down to a tile
// boundary, the per-score test cuts the band to its exact width, and a warp
// skips the tiles its own 16 rows cannot reach, so a narrow band costs one
// or two tiles a warp.
// Bound on the H100: operations (4*H*D per in-band query-key pair plus the
// out projection 2*B*L*H*D*d) over the bf16 tensor-core rate; for bands
// below about 100 the bytes of q, k, v, x and the output bound it instead.
#include "flash_outproj.cuh"

extern "C" int herro_flash_outproj_band(const void* q, const void* k, const void* v,
                                        const void* x, const void* wo, const void* bo,
                                        const int* lengths, void* out, int B, int H,
                                        int L, int d, int window, float scale,
                                        void* stream) {
  if (window < 1) return (int)cudaErrorInvalidValue;
  return herro::flash_outproj_launch<herro::kMaskBand>(q, k, v, x, wo, bo, lengths, out, B,
                                                       H, L, d, window, scale, stream);
}
