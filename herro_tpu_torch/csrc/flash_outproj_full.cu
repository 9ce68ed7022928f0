// K7: full (unbanded) flash attention + out projection + residual: every
// query row attends every key below its batch element's length.
//
// Replaces herro_tpu/ops/fused.py:_flash_outproj_kernel (via
// _flash_outproj_full_pallas) at local_window=None.
// Bound on the H100: operations, 4*H*D per query-key pair below the length
// (1.7e11 per window at L=9216, H=4) plus the out projection, over the bf16
// tensor-core rate. The device code is the kMaskFull instantiation of
// flash_outproj.cuh: the tile loop runs over the keys below the length and
// nothing else, with no band arithmetic and no window argument (the TPU
// kernel's loop bound n_kb_valid). A batch element of length 0 walks no tile
// and comes out as x + bo.
#include "flash_outproj.cuh"

extern "C" int herro_flash_outproj_full(const void* q, const void* k, const void* v,
                                        const void* x, const void* wo, const void* bo,
                                        const int* lengths, void* out, int B, int H,
                                        int L, int d, float scale, void* stream) {
  return herro::flash_outproj_launch<herro::kMaskFull>(q, k, v, x, wo, bo, lengths, out, B,
                                                       H, L, d, 0, scale, stream);
}
