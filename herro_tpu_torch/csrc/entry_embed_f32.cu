// K4 in float32: pileup tokens + quals -> the d_model stream, for float32
// configs (TINY_CONFIG, a float32 checkpoint; d a multiple of 32 up to 1024,
// R 1-63), which the bf16 Hopper kernel (entry_embed.cu) does not take. The device code, its bound and its design
// are entry_embed_simt.cuh's, at E = float.
#include "entry_embed_simt.cuh"

extern "C" int herro_entry_embed_f32(const uint8_t* tok, const float* quals, const float* wc,
                                     const float* cb, float* out, int B, int R, int L, int d,
                                     int V, int kp, void* stream) {
  return herro::embed_simt::launch<float>(tok, quals, wc, cb, out, B, R, L, d, V, kp,
                                          (cudaStream_t)stream);
}
