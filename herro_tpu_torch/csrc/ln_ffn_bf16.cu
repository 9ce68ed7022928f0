// K3 in bf16 at the widths the Hopper kernel (ln_ffn.cu: d 256, 384 or 512,
// d_ff a multiple of 128) lacks: TINY_CONFIG in bf16 (d 32, d_ff 64), its
// tensor-parallel shard (d_ff 32); any d a multiple of 32 up to 1024 and d_ff
// a multiple of 32 up to 4096.
//   out = bf16(x + ((h @ W2) + b2)),  h = bf16(gelu_tanh(bf16(LN(x) @ W1 + b1)))
// with LN(x) rounded to bf16 before the product, as the bf16 plain version
// (ops/fused.py:_ln_ffn_plain) rounds it.
//
// Replaces herro_tpu/ops/fused.py:_ln_ffn_kernel (via _ln_ffn_pallas) there.
// Bound on the H100: the products, 4 T d d_ff operations at the bf16 peak,
// or the bytes at tiny's widths.
// Design: ln_ffn_f32.cu's two launches of gemm_tc.cuh's tensor-core tile
// product (ffn), at E = bf16: m16n8k16 on the bf16 operands, float32 sums,
// the hidden through a [T, d_ff] bf16 scratch the wrapper allocates; at d 32
// narrow.cuh's ffn at E = bf16 (one launch, `hidden` unread).
#include "narrow.cuh"

extern "C" int herro_ln_ffn_bf16(const void* x, const float* scale, const float* bias,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* hidden, void* out, long T, int d, int f, void* stream) {
  using namespace herro::f32;
  using herro::bf16;
  if (T < 1 || !d_model_ok(d) || !d_ff_ok(f)) return (int)cudaErrorInvalidValue;
  if (d <= herro::narrow::kWidth)
    return herro::narrow::ffn<bf16>((const bf16*)x, scale, bias, (const bf16*)w1,
                                    (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                                    (bf16*)out, T, d, f, (cudaStream_t)stream);
  return herro::gemm_tc::ffn<bf16>((const bf16*)x, scale, bias, (const bf16*)w1,
                                   (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                                   (bf16*)hidden, (bf16*)out, T, d, f, (cudaStream_t)stream);
}
