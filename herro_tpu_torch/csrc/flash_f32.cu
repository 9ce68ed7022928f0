// K2, K6, K7 and K9 in float32, for float32 configs at any head dim D a
// multiple of 16 from 16 to 128 and d a multiple of 32 up to 1024, which the
// bf16 Hopper kernels of
// flash_outproj_sm90.cuh (D 128) do not take. The device code, its bound and
// its design are flash_tc.cuh's, at E = float (every product as three TF32
// products on the tensor cores): herro_flash_f32 (K2, K6:
// any band), herro_flash_f32_full (K7: every key below the length),
// herro_flash_f32_attention (K9: attention alone, window -1 for no band),
// herro_flash_f32_outproj (K2/K6/K7's out projection alone, for its rows on
// the card).
#include "flash_tc.cuh"

extern "C" int herro_flash_f32(const float* q, const float* k, const float* v, const float* x,
                               const float* wo, const float* bo, const int* lengths,
                               float* scratch, float* y, int B, int H, int L, int d, int D,
                               int window, float scale, void* stream) {
  if (window < 0) return (int)cudaErrorInvalidValue;
  return herro::flash_tc::outproj<float>(q, k, v, x, wo, bo, lengths, scratch, y, B, H, L, d,
                                           D, window, scale, (cudaStream_t)stream);
}

extern "C" int herro_flash_f32_full(const float* q, const float* k, const float* v,
                                    const float* x, const float* wo, const float* bo,
                                    const int* lengths, float* scratch, float* y, int B, int H,
                                    int L, int d, int D, float scale, void* stream) {
  return herro::flash_tc::outproj<float>(q, k, v, x, wo, bo, lengths, scratch, y, B, H, L, d,
                                           D, -1, scale, (cudaStream_t)stream);
}

extern "C" int herro_flash_f32_attention(const float* q, const float* k, const float* v,
                                         const int* lengths, float* o, int B, int H, int L,
                                         int D, int window, float scale, void* stream) {
  return herro::flash_tc::attention<float, false>(q, k, v, lengths, o, B, H, L, D, window,
                                                    scale, 0, (cudaStream_t)stream);
}

extern "C" int herro_flash_f32_outproj(const float* o, const float* x, const float* wo,
                                       const float* bo, float* y, long T, int K, int d,
                                       void* stream) {
  return herro::flash_tc::outproj_only<float>(o, x, wo, bo, y, T, K, d, (cudaStream_t)stream);
}
