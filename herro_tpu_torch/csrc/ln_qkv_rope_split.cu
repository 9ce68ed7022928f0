// K8: LayerNorm + qkv projection + rotary epilogue with the rope tables built
// inside the kernel (the split-half route, HERRO_TPU_ROPE=split).
//
// Replaces herro_tpu/ops/fused.py:_ln_qkv_rope_kernel (via
// _ln_qkv_rope_pallas with rope_tbl=False; tables from _rope_tables_blk,
// rotation by _rope_apply).
// The function is K1's (ln_qkv_rope.cu) without the table inputs: each
// consumer thread computes the cos/sin of its two rows at its 16 columns
// (rope.cuh) where K1 loads them, with the functions torch.exp/cos/sin run
// on the card, so the tables equal K1's inputs and K8 equals K1 bit for bit.
// Bound on the H100: operations, 2*T*d*3*H*D over the bf16 tensor-core rate.
// Design: ln_qkv_rope_sm90.cuh under kTablesBuilt; d 256 or 512, D 128.
#include "ln_qkv_rope_sm90.cuh"

extern "C" int herro_ln_qkv_rope_split(const void* x, const float* ln_s, const float* ln_b,
                                       const void* w, const void* b, void* q, void* k,
                                       void* v, int B, int L, int d, int H, void* stream) {
  using namespace herro::qkv;
  return launch_widths<kTablesBuilt>(x, ln_s, ln_b, w, b, nullptr, nullptr, nullptr, q, k, v,
                                     B, L, d, H, stream);
}
