// K3 in float32: x + gelu_tanh(LN(x) @ W1 + b1) @ W2 + b2.
//
// Replaces herro_tpu/ops/fused.py:_ln_ffn_kernel (via _ln_ffn_pallas) for
// float32 configs at any d a multiple of 32 up to 1024 and d_ff a multiple
// of 32 up to 4096, which the bf16 Hopper kernel (ln_ffn.cu) does not take.
//
// Bound on the H100: the products, 4 T d d_ff operations as three TF32
// products at a third of the TF32 peak (at r10's widths in float32, 6.2e11:
// 3.75 ms at B=32, L=9216).
// Design: gemm_tc.cuh's LayerNorm launch into the output buffer, then two
// launches of its tensor-core tile product on one stream. The first reads
// LN(x) against W1 and writes gelu(h + b1) to a [T, d_ff] scratch the
// wrapper allocates (the TPU kernel keeps the hidden in VMEM; here a tile of
// 64 rows' hidden at d_ff 4096 is 1 MB, over a block's shared memory; the
// scratch at B=32, L=9216, d_ff 4096 is 4.8 GB in float32, 2.4 GB in bf16). The second reads it against W2 and adds b2 and
// the residual, in the plain version's order: x + ((h @ W2) + b2). The two
// launches are gemm_tc.cuh's ffn, at E = float (ln_ffn_bf16.cu: at bf16).
// At d 32 narrow.cuh's ffn instead: one launch, the hidden kept on chip
// (`hidden` unread, the caller may pass none).
#include "narrow.cuh"

extern "C" int herro_ln_ffn_f32(const float* x, const float* scale, const float* bias,
                                const float* w1, const float* b1, const float* w2,
                                const float* b2, float* hidden, float* out, long T, int d,
                                int f, void* stream) {
  using namespace herro::f32;
  if (T < 1 || !d_model_ok(d) || !d_ff_ok(f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= herro::narrow::kWidth)
    return herro::narrow::ffn<float>(x, scale, bias, w1, b1, w2, b2, out, T, d, f, s);
  return herro::gemm_tc::ffn<float>(x, scale, bias, w1, b1, w2, b2, hidden, out, T, d, f, s);
}
