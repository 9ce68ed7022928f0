// K1 and K8 in float32: LayerNorm + qkv projection + rope for float32
// configs at any head dim D a multiple of 16 from 16 to 128 and d a multiple
// of 32 up to 1024 (D 16, 32, 64 or 128 at d 32), which the bf16 Hopper
// kernels (ln_qkv_rope_sm90.cuh, D 128) do not take. The device code, its
// bound and its design are ln_qkv_rope_simt.cuh's, at E = float, and at d 32
// narrow.cuh's; y is a [B L, d] scratch for LayerNorm's output (unread at
// d 32, where the caller may pass none):
// herro_ln_qkv_rope_f32 takes the rope tables (K1), herro_ln_qkv_rope_f32_split
// builds them in the kernel (K8, HERRO_TPU_ROPE=split).
#include "narrow.cuh"

extern "C" int herro_ln_qkv_rope_f32(const float* x, const float* scale, const float* bias,
                                     const float* w, const float* b, const float* cos_t,
                                     const float* sin_t, float* y, float* q, float* k, float* v,
                                     int B, int L, int d, int H, int D, void* stream) {
  if (d <= herro::narrow::kWidth)
    return herro::narrow::qkv_rope<float, true>(x, scale, bias, w, b, cos_t, sin_t, q, k, v, B,
                                                L, d, H, D, (cudaStream_t)stream);
  return herro::qkv_simt::launch<float, true>(x, scale, bias, w, b, cos_t, sin_t, y, q, k, v, B,
                                              L, d, H, D, (cudaStream_t)stream);
}

extern "C" int herro_ln_qkv_rope_f32_split(const float* x, const float* scale,
                                           const float* bias, const float* w, const float* b,
                                           float* y, float* q, float* k, float* v, int B, int L,
                                           int d, int H, int D, void* stream) {
  if (d <= herro::narrow::kWidth)
    return herro::narrow::qkv_rope<float, false>(x, scale, bias, w, b, nullptr, nullptr, q, k, v,
                                                 B, L, d, H, D, (cudaStream_t)stream);
  return herro::qkv_simt::launch<float, false>(x, scale, bias, w, b, nullptr, nullptr, y, q, k,
                                               v, B, L, d, H, D, (cudaStream_t)stream);
}
