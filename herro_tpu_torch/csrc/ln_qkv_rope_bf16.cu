// K1 and K8 in bf16 at the head dims and widths the Hopper kernels
// (ln_qkv_rope_sm90.cuh: D 128, d 256, 384 or 512) lack: TINY_CONFIG in bf16
// (d 32, D 16), head dim 64, their tensor-parallel shards; any D a multiple
// of 16 from 16 to 128 and d a multiple of 32 up to 1024 (D 16, 32, 64 or
// 128 at d 32). The device code, its bound and
// its design are ln_qkv_rope_simt.cuh's, at E = bf16, and at d 32
// narrow.cuh's: x, the weight, the bias, q/k/v and the [B L, d] scratch y
// of LayerNorm's output (unread at d 32, where the caller may pass none)
// bf16, LayerNorm's parameters and the rope tables float32.
// herro_ln_qkv_rope_bf16 takes the rope tables (K1),
// herro_ln_qkv_rope_bf16_split builds them in the kernel (K8,
// HERRO_TPU_ROPE=split).
#include "narrow.cuh"

using herro::bf16;

extern "C" int herro_ln_qkv_rope_bf16(const void* x, const float* scale, const float* bias,
                                      const void* w, const void* b, const float* cos_t,
                                      const float* sin_t, void* y, void* q, void* k, void* v,
                                      int B, int L, int d, int H, int D, void* stream) {
  if (d <= herro::narrow::kWidth)
    return herro::narrow::qkv_rope<bf16, true>(
        (const bf16*)x, scale, bias, (const bf16*)w, (const bf16*)b, cos_t, sin_t, (bf16*)q,
        (bf16*)k, (bf16*)v, B, L, d, H, D, (cudaStream_t)stream);
  return herro::qkv_simt::launch<bf16, true>(
      (const bf16*)x, scale, bias, (const bf16*)w, (const bf16*)b, cos_t, sin_t, (bf16*)y,
      (bf16*)q, (bf16*)k, (bf16*)v, B, L, d, H, D, (cudaStream_t)stream);
}

extern "C" int herro_ln_qkv_rope_bf16_split(const void* x, const float* scale,
                                            const float* bias, const void* w, const void* b,
                                            void* y, void* q, void* k, void* v, int B, int L,
                                            int d, int H, int D, void* stream) {
  if (d <= herro::narrow::kWidth)
    return herro::narrow::qkv_rope<bf16, false>(
        (const bf16*)x, scale, bias, (const bf16*)w, (const bf16*)b, nullptr, nullptr, (bf16*)q,
        (bf16*)k, (bf16*)v, B, L, d, H, D, (cudaStream_t)stream);
  return herro::qkv_simt::launch<bf16, false>(
      (const bf16*)x, scale, bias, (const bf16*)w, (const bf16*)b, nullptr, nullptr, (bf16*)y,
      (bf16*)q, (bf16*)k, (bf16*)v, B, L, d, H, D, (cudaStream_t)stream);
}
