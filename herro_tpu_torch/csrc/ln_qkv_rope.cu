// K1: LayerNorm + qkv projection + rotary epilogue, the rope tables handed
// in, q/k/v written per head.
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_tbl_kernel (via
// _ln_qkv_rope_pallas, tables from _rope_tables_full).
// qkv = bf16(LN(x) @ W + b); q and k then take the rotate-half rope at the
// absolute column index in float32, the cos/sin tables [L, 64] read from
// device memory, and are rounded again; v passes through.
// Bound on the H100: operations, 2*T*d*3*H*D over the bf16 tensor-core rate.
// Design: ln_qkv_rope_sm90.cuh under kTablesIn; d 256 or 512, D 128.
#include "ln_qkv_rope_sm90.cuh"

extern "C" int herro_ln_qkv_rope(const void* x, const float* ln_s, const float* ln_b,
                                 const void* w, const void* b, const float* cos_t,
                                 const float* sin_t, void* q, void* k, void* v, int B,
                                 int L, int d, int H, void* stream) {
  using namespace herro::qkv;
  return launch_widths<kTablesIn>(x, ln_s, ln_b, w, b, cos_t, sin_t, nullptr, q, k, v, B, L,
                                  d, H, stream);
}
