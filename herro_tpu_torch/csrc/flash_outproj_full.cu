// K7: full (unbanded) flash attention + out projection + residual: every
// query row attends every key below its batch element's length.
//
// Replaces herro_tpu/ops/fused.py:_flash_outproj_kernel (via
// _flash_outproj_full_pallas) at local_window=None.
// Bound on the H100: operations, 4*H*D per query-key pair below the length
// (sum of length^2 over the batch; 1.7e11 per full window at L=9216, H=4)
// plus the out projection of the rows below the length (2*H*D*d a row),
// over the bf16 tensor-core rate. The device code
// is flash_outproj_sm90.cuh under kMaskFull (TMA ring, one producer warp, two
// wgmma consumer warpgroups), which describes the design. What the mask
// changes: a query tile walks the key tiles [0, ceil(length / 128)) with no
// band arithmetic (the TPU kernel's loop bound n_kb_valid) and tests scores
// only in the tile at the length; a query tile at or past the length loads
// nothing and comes out as bf16(x + bo), so the work is the pairs below the
// lengths, as the bound counts them (a batch element of length 0 is all
// x + bo); tiles are ordered longest first and dealt in a snake order, since
// their cost grows with their element's length.
#include "flash_outproj_sm90.cuh"

extern "C" int herro_flash_outproj_full(const void* q, const void* k, const void* v,
                                        const void* x, const void* wo, const void* bo,
                                        const int* lengths, void* out, int B, int H,
                                        int L, int d, float scale, void* stream) {
  using namespace herro::fo90;
  return launch_widths<kMaskFull>(q, k, v, x, wo, bo, lengths, out, B, H, L, d, 0, scale,
                                  stream);
}
