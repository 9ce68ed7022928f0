// K9: standalone flash attention, output [B, H, L, D].
//
// Replaces herro_tpu/ops/attention.py:_flash_kernel (via flash_attention).
// For every query row i of batch b and head h: online softmax over the keys
// j < length (and |i - j| <= window under a band, any window >= 0) of
// scale * q_i . k_j, masked scores at -1e30, P rounded to bf16 for P.V, the
// result divided by the row sum clamped at 1e-30 and rounded to bf16. A batch
// element of length 0 comes out 0, as the TPU kernel's clamped loop leaves
// it; a row whose band holds no key below the length is padding (finite).
// Bound on the H100: operations (4*D per query-key pair the mask lets
// through, query below the length) over the bf16 tensor-core rate; under a
// narrow band the bytes of q, k, v and the output.
// The device code is flash_outproj_sm90.cuh with DM 0, K2's, K6's and K7's
// design without the out projection (TMA ring, one producer warp, two wgmma
// consumer warpgroups): a tile is 128 query rows of one head, so any H runs;
// no band takes K7's longest-first snake order and skips the key tiles and
// query tiles past the length, a band K2's tile walk; O leaves by TMA store.
// A band below one 128-key tile spends most of each edge tile's products on
// masked scores (see PERF.md for w = 40).
#include "flash_outproj_sm90.cuh"

// window < 0: no band, every key below the length
extern "C" int herro_flash_attention(const void* q, const void* k, const void* v,
                                     const int* lengths, void* out, int B, int H, int L,
                                     int window, float scale, void* stream) {
  using namespace herro::fo90;
  cudaStream_t s = (cudaStream_t)stream;
  if (window < 0)
    return launch<1, 0, kMaskFull>(q, k, v, nullptr, nullptr, nullptr, lengths, out, B, L, 0,
                                   scale, s, H);
  return launch<1, 0, kMaskBand>(q, k, v, nullptr, nullptr, nullptr, lengths, out, B, L,
                                 window, scale, s, H);
}
