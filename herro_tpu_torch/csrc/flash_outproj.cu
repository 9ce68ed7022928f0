// K2: banded flash attention + out projection + residual, for a band that is
// a multiple of 256 (every shipped checkpoint: 512).
//
// Replaces herro_tpu/ops/fused.py:_banded_flash_outproj_rot_kernel (via
// _banded_flash_outproj_rot_pallas).
// Bound on the H100: operations (4*H*D per in-band query-key pair below the
// length plus the out projection, 2*H*D*d per row below the length; ~6.6e11
// at B=32, L=9216) over the bf16 tensor-core rate. The device code is flash_outproj_sm90.cuh under
// kMaskBand (TMA ring, one producer warp, two wgmma consumer warpgroups),
// which describes the design; K6 runs the same instantiation. The TPU
// kernel's rotation slots are a VMEM-reuse schedule with no counterpart here.
#include "flash_outproj_sm90.cuh"

extern "C" int herro_flash_outproj(const void* q, const void* k, const void* v,
                                   const void* x, const void* wo, const void* bo,
                                   const int* lengths, void* out, int B, int H, int L,
                                   int d, int window, float scale, void* stream) {
  using namespace herro::fo90;
  if (window < 0 || window % 256) return (int)cudaErrorInvalidValue;
  return launch_widths<kMaskBand>(q, k, v, x, wo, bo, lengths, out, B, H, L, d, window,
                                  scale, stream);
}
