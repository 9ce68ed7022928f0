// K2, K6, K7 and K9 in bf16 at the head dims and (heads, width) pairs the
// Hopper kernels of flash_outproj_sm90.cuh (D 128; the shipped (H, d) and
// their shards) lack: TINY_CONFIG in bf16 (H 2 x D 16, d 32), head dim 64,
// their tensor-parallel shards; any D a multiple of 16 from 16 to 128, any
// H, d a multiple of 32 up to 1024. The device code, its bound and its design are
// flash_tc.cuh's, at E = bf16: q/k/v, x, Wo, bo, the scratch and the
// outputs bf16, the sums float32; every mode rounds P to bf16 before P.V,
// as herro_tpu's Pallas kernels do.
// herro_flash_bf16 (K2, K6: any band), herro_flash_bf16_full (K7),
// herro_flash_bf16_attention (K9: window -1 for no band),
// herro_flash_bf16_outproj (K2/K6/K7's out projection alone, for its rows on
// the card).
#include "flash_tc.cuh"

using herro::bf16;

extern "C" int herro_flash_bf16(const void* q, const void* k, const void* v, const void* x,
                                const void* wo, const void* bo, const int* lengths,
                                void* scratch, void* y, int B, int H, int L, int d, int D,
                                int window, float scale, void* stream) {
  if (window < 0) return (int)cudaErrorInvalidValue;
  return herro::flash_tc::outproj<bf16>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)x, (const bf16*)wo,
      (const bf16*)bo, lengths, (bf16*)scratch, (bf16*)y, B, H, L, d, D, window, scale,
      (cudaStream_t)stream);
}

extern "C" int herro_flash_bf16_full(const void* q, const void* k, const void* v,
                                     const void* x, const void* wo, const void* bo,
                                     const int* lengths, void* scratch, void* y, int B, int H,
                                     int L, int d, int D, float scale, void* stream) {
  return herro::flash_tc::outproj<bf16>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)x, (const bf16*)wo,
      (const bf16*)bo, lengths, (bf16*)scratch, (bf16*)y, B, H, L, d, D, -1, scale,
      (cudaStream_t)stream);
}

extern "C" int herro_flash_bf16_attention(const void* q, const void* k, const void* v,
                                          const int* lengths, void* o, int B, int H, int L,
                                          int D, int window, float scale, void* stream) {
  return herro::flash_tc::attention<bf16, true>((const bf16*)q, (const bf16*)k,
                                                  (const bf16*)v, lengths, (bf16*)o, B, H, L,
                                                  D, window, scale, 0, (cudaStream_t)stream);
}

extern "C" int herro_flash_bf16_outproj(const void* o, const void* x, const void* wo,
                                        const void* bo, void* y, long T, int K, int d,
                                        void* stream) {
  return herro::flash_tc::outproj_only<bf16>((const bf16*)o, (const bf16*)x, (const bf16*)wo,
                                             (const bf16*)bo, (bf16*)y, T, K, d,
                                             (cudaStream_t)stream);
}
