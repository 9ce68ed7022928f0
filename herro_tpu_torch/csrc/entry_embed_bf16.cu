// K4 in bf16 at the widths the Hopper kernel (entry_embed.cu: d 256, 384 or
// 512, a col_proj table of 512 rows) lacks: TINY_CONFIG in bf16 (d 32), any
// d a multiple of 32 up to 1024, R 1-63. The device code, its bound and its
// design are entry_embed_simt.cuh's, at E = bf16: the table and the output
// bf16, the quals and the bias float32, the quals rounded to bf16 before
// they meet the weights.
#include "entry_embed_simt.cuh"

extern "C" int herro_entry_embed_bf16(const uint8_t* tok, const float* quals, const void* wc,
                                      const float* cb, void* out, int B, int R, int L, int d,
                                      int V, int kp, void* stream) {
  using herro::bf16;
  return herro::embed_simt::launch<bf16>(tok, quals, (const bf16*)wc, cb, (bf16*)out, B, R, L,
                                         d, V, kp, (cudaStream_t)stream);
}
