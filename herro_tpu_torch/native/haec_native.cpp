// Native host kernels for herro_tpu.
//
// The reference implements its host hot loops in Rust (src/windowing.rs,
// src/features.rs, src/haec_io.rs); these are the C++ equivalents, exposed
// with a plain C ABI and bound via ctypes. Semantics mirror the Python/numpy
// implementations exactly (which are property-tested against per-op oracles);
// parity between the two paths is itself under test.
//
// Build: make -C herro_tpu/native   (g++ -O3 -march=native -shared -fPIC)

#include <array>
#include <atomic>
#include <chrono>
#include <cstdint>
#if defined(__AVX2__) || defined(__SSE2__)
#include <immintrin.h>
#endif
#include <cmath>
#include <cstdlib>
#include <new>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr uint8_t OP_M = 0;
constexpr uint8_t OP_I = 1;
constexpr uint8_t OP_D = 2;

constexpr uint8_t BASE_OF_CODE[4] = {'A', 'C', 'G', 'T'};

// Lazily-built lookup tables use C++11 magic statics (thread-safe init):
// featgen calls these kernels from multiple Python threads with the GIL
// released, so a hand-rolled `if (!init)` first-call race would be UB.
const std::array<uint8_t, 256>& lower_table() {
  static const std::array<uint8_t, 256> t = [] {
    std::array<uint8_t, 256> x{};
    for (int i = 0; i < 256; ++i) x[i] = (uint8_t)i;
    x['A'] = 'a'; x['C'] = 'c'; x['G'] = 'g'; x['T'] = 't';
    return x;
  }();
  return t;
}

const std::array<uint64_t, 256>& encode_table() {
  static const std::array<uint64_t, 256> t = [] {
    std::array<uint64_t, 256> x{};
    x['A'] = 0; x['C'] = 1; x['G'] = 2; x['T'] = 3;
    x['a'] = 0; x['c'] = 1; x['g'] = 2; x['t'] = 3;
    return x;
  }();
  return t;
}

// Case fold for the phase-score byte compares: acgt -> ACGT, everything else
// ('#', '*', '.', ACGT, quals) unchanged — mirrors features/extract.py _UPPER.
const std::array<uint8_t, 256>& upper_table() {
  static const std::array<uint8_t, 256> t = [] {
    std::array<uint8_t, 256> x{};
    for (int i = 0; i < 256; ++i) x[i] = (uint8_t)i;
    x['a'] = 'A'; x['c'] = 'C'; x['g'] = 'G'; x['t'] = 'T';
    return x;
  }();
  return t;
}

const std::array<uint8_t, 256>& class_table() {
  static const std::array<uint8_t, 256> t = [] {
    // Class 5 is a dummy slot for every non-base byte ('.', pad, …) so the
    // counting inner loop increments unconditionally — branchless.
    std::array<uint8_t, 256> x{};
    for (int i = 0; i < 256; ++i) x[i] = 5;
    const char* fwd = "ACGT*";
    const char* rev = "acgt#";
    for (int k = 0; k < 5; ++k) {
      x[(uint8_t)fwd[k]] = (uint8_t)k;
      x[(uint8_t)rev[k]] = (uint8_t)k;
    }
    return x;
  }();
  return t;
}

// Effective op length of op j within a window slice [op_s, op_e) with
// start/end offsets (reference: src/features.rs:181-188).
inline int64_t eff_len(const int32_t* lens, int64_t op_s, int64_t off_s,
                       int64_t op_e, int64_t off_e, int64_t j) {
  int64_t n = op_e - op_s;
  int64_t l = lens[op_s + j];
  if (n == 1) return off_e - off_s;
  if (j == 0) return l - off_s;
  if (j == n - 1) return off_e;
  return l;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// 2-bit sequence codec (reference: src/haec_io.rs:121-173)
// ---------------------------------------------------------------------------

namespace {

// 256 -> 4-ascii-byte decode tables: source byte b holds bases 4k..4k+3
// (base j at bits 2j, little-endian arena layout). fwd emits them in
// ascending order; rc emits the complements in descending order (so the
// caller walks source bytes backwards and writes forward).
struct Decode4 {
  uint32_t fwd[256];
  uint32_t rc[256];
  Decode4() {
    for (int b = 0; b < 256; ++b) {
      uint8_t f[4], r[4];
      for (int j = 0; j < 4; ++j) {
        const int code = (b >> (2 * j)) & 3;
        f[j] = BASE_OF_CODE[code];
        r[3 - j] = BASE_OF_CODE[code ^ 3];
      }
      memcpy(&fwd[b], f, 4);
      memcpy(&rc[b], r, 4);
    }
  }
};
const Decode4& decode4() {
  static const Decode4 t;
  return t;
}

}  // namespace

void ht_decode_2bit(const uint64_t* words, int64_t start, int64_t end, int rc,
                    uint8_t* out) {
  if (start >= end) return;
  const int64_t n = end - start;
  const uint8_t* bytes = (const uint8_t*)words;
  const Decode4& t = decode4();
  if (!rc) {
    int64_t idx = 0, i = start;
    while (idx < n && (i & 3)) {  // scalar head to a 4-base boundary
      out[idx++] = BASE_OF_CODE[(bytes[i >> 2] >> ((i & 3) * 2)) & 3];
      ++i;
    }
    for (; idx + 4 <= n; idx += 4, i += 4) {
      uint32_t v = t.fwd[bytes[i >> 2]];
      memcpy(out + idx, &v, 4);
    }
    for (; idx < n; ++idx, ++i)
      out[idx] = BASE_OF_CODE[(bytes[i >> 2] >> ((i & 3) * 2)) & 3];
  } else {
    int64_t idx = 0, i = end - 1;
    while (idx < n && (i & 3) != 3) {  // head until source byte boundary
      out[idx++] = BASE_OF_CODE[((bytes[i >> 2] >> ((i & 3) * 2)) & 3) ^ 3];
      --i;
    }
    for (; idx + 4 <= n; idx += 4, i -= 4) {
      uint32_t v = t.rc[bytes[i >> 2]];
      memcpy(out + idx, &v, 4);
    }
    for (; idx < n; ++idx, --i)
      out[idx] = BASE_OF_CODE[((bytes[i >> 2] >> ((i & 3) * 2)) & 3) ^ 3];
  }
}

void ht_encode_2bit(const uint8_t* seq, int64_t n, uint64_t* words) {
  const auto& table = encode_table();
  int64_t n_words = (n + 31) / 32;
  for (int64_t w = 0; w < n_words; ++w) words[w] = 0;
  for (int64_t i = 0; i < n; ++i) {
    words[i >> 5] |= table[seq[i]] << ((i << 1) & 63);
  }
}

// ---------------------------------------------------------------------------
// Window extraction (reference: src/windowing.rs:44-273)
//
// Writes rows of 8 int64 per emitted window:
//   win_idx, t_window_start, q_start, q_end, op_start, start_off, op_end,
//   end_off.
// Returns the number of rows (or -1 if max_rows would be exceeded).
// ---------------------------------------------------------------------------

int64_t ht_extract_windows(const uint8_t* codes, const int32_t* lens,
                           int64_t n_ops, int64_t tstart, int64_t tend,
                           int64_t tlen, int64_t qstart, int64_t qend,
                           int64_t W, int64_t* out, int64_t max_rows) {
  if (tend - tstart < W || qend - qstart < W) return 0;

  int64_t zeroth = (int64_t)(0.1 * (double)W);
  int64_t nth = tlen - zeroth;
  int64_t first_window = tstart < zeroth ? 0 : (tstart + W - 1) / W;
  int64_t last_window = tend > nth ? (tend - 1) / W + 1 : tend / W;
  if (last_window - first_window < 1) return 0;

  bool state_set = (tstart % W == 0) || (tstart < zeroth);
  int64_t t_ws = tstart, q_ws = 0, op_s = 0, off_s = 0;
  int64_t n_rows = 0;

  int64_t tpos = tstart;  // target pos before current op
  int64_t qpos = 0;       // query pos before current op (relative)
  int64_t next_b = (tstart / W + 1) * W;

  for (int64_t i = 0; i < n_ops; ++i) {
    uint8_t op = codes[i];
    int64_t l = lens[i];
    if (op == OP_I) {
      qpos += l;
      continue;
    }
    int64_t t_end_op = tpos + l;

    while (next_b <= t_end_op && next_b <= tend) {
      int64_t b = next_b;
      int64_t offset = b - tpos;
      int64_t q_at_b = qpos + (op == OP_M ? offset : 0);

      int64_t q_end_w, op_e, off_e, nxt_op, nxt_off;
      if (t_end_op == b) {
        if (i + 1 < n_ops && codes[i + 1] == OP_I) {
          q_end_w = q_at_b + lens[i + 1];
          op_e = i + 2;
          off_e = lens[i + 1];
          nxt_op = i + 2;
          nxt_off = 0;
        } else {
          q_end_w = q_at_b;
          op_e = i + 1;
          off_e = l;
          nxt_op = i + 1;
          nxt_off = 0;
        }
      } else {
        q_end_w = q_at_b;
        op_e = i + 1;
        off_e = offset;
        nxt_op = i;
        nxt_off = offset;
      }

      if (state_set) {
        if (n_rows == max_rows) return -1;
        int64_t* r = out + 8 * n_rows++;
        r[0] = b / W - 1;
        r[1] = t_ws;
        r[2] = q_ws;
        r[3] = q_end_w;
        r[4] = op_s;
        r[5] = off_s;
        r[6] = op_e;
        r[7] = off_e;
      }
      t_ws = b;
      q_ws = q_end_w;
      op_s = nxt_op;
      off_s = nxt_off;
      state_set = true;
      next_b += W;
    }

    tpos = t_end_op;
    if (op == OP_M) qpos += l;
  }

  if (tend > nth && tend % W != 0 && state_set) {
    if (n_rows == max_rows) return -1;
    int64_t* r = out + 8 * n_rows++;
    r[0] = last_window - 1;
    r[1] = t_ws;
    r[2] = q_ws;
    r[3] = qpos;
    r[4] = op_s;
    r[5] = off_s;
    r[6] = n_ops;
    r[7] = lens[n_ops - 1];
  }
  return n_rows;
}

// ---------------------------------------------------------------------------
// Per-window max-insertion counts (reference: src/features.rs:44-95)
// ---------------------------------------------------------------------------

void ht_max_ins(const uint8_t* codes, const int32_t* lens, int64_t op_s,
                int64_t off_s, int64_t op_e, int64_t off_e, int64_t t_base,
                int32_t* max_ins /* [win_len] */) {
  int64_t tpos = t_base;
  int64_t n = op_e - op_s;
  for (int64_t j = 0; j < n; ++j) {
    uint8_t op = codes[op_s + j];
    if (op == OP_I) {
      // insertions use raw length (never offset-truncated in practice)
      int32_t l = lens[op_s + j];
      if (tpos > 0 && max_ins[tpos - 1] < l) max_ins[tpos - 1] = l;
      continue;
    }
    tpos += eff_len(lens, op_s, off_s, op_e, off_e, j);
  }
}

// ---------------------------------------------------------------------------
// Pileup row fill (reference: src/features.rs:110-266).
//
// bases/quals are strided rows: element k lives at bases[k * stride].
// anchor[t] = flat column of target-relative position t (win_len + 1 entries).
// qseq/qqual are the window's oriented query bytes (already RC'd for reverse
// strand; lowercase transform applied here).
// ---------------------------------------------------------------------------

void ht_fill_query_row(uint8_t* bases, uint8_t* quals, int64_t stride,
                       int64_t length, const uint8_t* codes,
                       const int32_t* lens, int64_t op_s, int64_t off_s,
                       int64_t op_e, int64_t off_e, int64_t t_base,
                       int strand_rev, const uint8_t* qseq,
                       const uint8_t* qqual, const int64_t* anchor,
                       const int32_t* max_ins) {
  uint8_t gap = strand_rev ? '#' : '*';
  for (int64_t k = 0; k < length; ++k) bases[k * stride] = gap;

  int64_t idx0 = anchor[t_base];
  for (int64_t k = 0; k < idx0; ++k) bases[k * stride] = '.';

  const auto& lower = lower_table();

  int64_t tpos = t_base;
  int64_t idx = idx0;
  int64_t qp = 0;
  int64_t n = op_e - op_s;
  for (int64_t j = 0; j < n; ++j) {
    uint8_t op = codes[op_s + j];
    int64_t l = eff_len(lens, op_s, off_s, op_e, off_e, j);
    if (op == OP_M) {
      for (int64_t i = 0; i < l; ++i) {
        uint8_t b = qseq[qp];
        bases[idx * stride] = strand_rev ? lower[b] : b;
        quals[idx * stride] = qqual[qp];
        ++qp;
        idx += 1 + max_ins[tpos + i];
      }
      tpos += l;
    } else if (op == OP_D) {
      for (int64_t i = 0; i < l; ++i) idx += 1 + max_ins[tpos + i];
      tpos += l;
    } else {  // OP_I — raw length, written into reserved columns
      int64_t li = lens[op_s + j];
      if (tpos > 0) {
        int64_t at = idx - max_ins[tpos - 1];
        for (int64_t i = 0; i < li; ++i) {
          uint8_t b = qseq[qp];
          bases[(at + i) * stride] = strand_rev ? lower[b] : b;
          quals[(at + i) * stride] = qqual[qp];
          ++qp;
        }
      } else {
        // Window-leading insertion: ht_max_ins reserved no columns for it
        // (its tpos > 0 guard), so there is nowhere to write — consume the
        // query bases and move on.
        qp += li;
      }
    }
  }
  for (int64_t k = idx; k < length; ++k) bases[k * stride] = '.';
}

// ---------------------------------------------------------------------------
// Window-local alignment accuracy (reference: src/features.rs:585-679)
// ---------------------------------------------------------------------------

double ht_window_accuracy(const uint8_t* codes, const int32_t* lens,
                          int64_t op_s, int64_t off_s, int64_t op_e,
                          int64_t off_e, const uint8_t* tseq,
                          const uint8_t* qseq) {
  int64_t tp = 0, qp = 0;
  int64_t m = 0, s = 0, ins = 0, del = 0;
  int64_t n = op_e - op_s;
  for (int64_t j = 0; j < n; ++j) {
    uint8_t op = codes[op_s + j];
    int64_t l = eff_len(lens, op_s, off_s, op_e, off_e, j);
    if (op == OP_M) {
      for (int64_t i = 0; i < l; ++i) {
        if (tseq[tp + i] == qseq[qp + i]) ++m; else ++s;
      }
      tp += l;
      qp += l;
    } else if (op == OP_I) {
      ins += l;
      qp += l;
    } else {
      del += l;
      tp += l;
    }
  }
  int64_t total = m + s + ins + del;
  return total ? (double)m / (double)total : 0.0;
}

// ---------------------------------------------------------------------------
// CIGAR byte parse (the ingest hot loop: ~2.7k ops per ultra-long alignment,
// tens of millions of ops per 50k-read batch). Emits (code, len) arrays;
// '='/'X' fold into M (adjacent merging happens in numpy when flagged).
// Returns the op count, or -1 on malformed input. out_flags bit0 set when
// any '='/'X' was seen (caller must coalesce).
// ---------------------------------------------------------------------------

int64_t ht_parse_cigar(const uint8_t* s, int64_t n, uint8_t* codes,
                       int32_t* lens, int32_t* out_flags) {
  int64_t count = 0;
  int64_t num = 0;
  bool have_num = false;
  int32_t flags = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t c = s[i];
    if (c >= '0' && c <= '9') {
      num = num * 10 + (c - '0');
      if (num > INT32_MAX) return -1;
      have_num = true;
      continue;
    }
    uint8_t code;
    switch (c) {
      case 'M': code = OP_M; break;
      case 'I': code = OP_I; break;
      case 'D': code = OP_D; break;
      case '=': case 'X': code = OP_M; flags |= 1; break;
      default: return -1;
    }
    if (!have_num) return -1;
    codes[count] = code;
    lens[count] = (int32_t)num;
    ++count;
    num = 0;
    have_num = false;
  }
  if (have_num) return -1;  // trailing digits without an op
  *out_flags = flags;
  return count;
}

// ---------------------------------------------------------------------------
// Batched per-window entry points: one call per window instead of one per
// overlap row — the ctypes call overhead dominates at ~30 rows/window.
// Pointer arrays arrive as uint64 addresses.
// ---------------------------------------------------------------------------

void ht_max_ins_batch(const uint64_t* codes_p, const uint64_t* lens_p,
                      const int64_t* op_s, const int64_t* off_s,
                      const int64_t* op_e, const int64_t* off_e,
                      const int64_t* t_base, int64_t n, int32_t* max_ins) {
  for (int64_t i = 0; i < n; ++i)
    ht_max_ins((const uint8_t*)codes_p[i], (const int32_t*)lens_p[i], op_s[i],
               off_s[i], op_e[i], off_e[i], t_base[i], max_ins);
}

// Contiguous (stride-1) variant of ht_fill_query_row: rows are built in a
// flat scratch plane so the CIGAR walk writes sequential bytes, then a
// cache-blocked transpose scatters them into the (L, C) pileup. The strided
// per-byte stores of the direct path were the fill bottleneck at heavy
// coverage.
static void fill_query_row_flat(uint8_t* rb, uint8_t* rq, int64_t length,
                                const uint8_t* codes, const int32_t* lens,
                                int64_t op_s, int64_t off_s, int64_t op_e,
                                int64_t off_e, int64_t t_base, int strand_rev,
                                const uint8_t* qseq, const uint8_t* qqual,
                                const int64_t* anchor,
                                const int32_t* max_ins) {
  uint8_t gap = strand_rev ? '#' : '*';
  int64_t idx0 = anchor[t_base];
  memset(rb, '.', (size_t)idx0);
  memset(rb + idx0, gap, (size_t)(length - idx0));

  const auto& lower = lower_table();

  int64_t tpos = t_base;
  int64_t idx = idx0;
  int64_t qp = 0;
  int64_t n = op_e - op_s;
  for (int64_t j = 0; j < n; ++j) {
    uint8_t op = codes[op_s + j];
    int64_t l = eff_len(lens, op_s, off_s, op_e, off_e, j);
    if (op == OP_M) {
      for (int64_t i = 0; i < l; ++i) {
        uint8_t b = qseq[qp];
        rb[idx] = strand_rev ? lower[b] : b;
        rq[idx] = qqual[qp];
        ++qp;
        idx += 1 + max_ins[tpos + i];
      }
      tpos += l;
    } else if (op == OP_D) {
      for (int64_t i = 0; i < l; ++i) idx += 1 + max_ins[tpos + i];
      tpos += l;
    } else {  // OP_I — raw length, written into reserved columns
      int64_t li = lens[op_s + j];
      if (tpos > 0) {
        int64_t at = idx - max_ins[tpos - 1];
        for (int64_t i = 0; i < li; ++i) {
          uint8_t b = qseq[qp];
          rb[at + i] = strand_rev ? lower[b] : b;
          rq[at + i] = qqual[qp];
          ++qp;
        }
      } else {
        qp += li;  // window-leading insertion: no reserved columns (see above)
      }
    }
  }
  memset(rb + idx, '.', (size_t)(length - idx));
}

// Scatter n contiguous scratch rows (each `length` bytes) into pileup
// columns 1..n of a row-major (length, n_cols) byte matrix. SSE2 path moves
// 8 rows x 16 columns per step: three unpack levels build, for each pileup
// column, one u64 of the 8 rows' bytes, stored directly at the strided
// destination — ~8x the scalar blocked transpose (the measured featgen
// bottleneck at heavy coverage, ARCHITECTURE.md round-2 ablation).
static void scatter_rowptrs_to_cols(const uint8_t* const* rp, int64_t n,
                                    int64_t length, uint8_t* dst,
                                    int64_t n_cols) {
  int64_t i0 = 0;
#ifdef __SSE2__
  for (; i0 + 8 <= n; i0 += 8) {
    const uint8_t* r[8];
    for (int k = 0; k < 8; ++k) r[k] = rp[i0 + k];
    int64_t l = 0;
    for (; l + 16 <= length; l += 16) {
      __m128i r0 = _mm_loadu_si128((const __m128i*)(r[0] + l));
      __m128i r1 = _mm_loadu_si128((const __m128i*)(r[1] + l));
      __m128i r2 = _mm_loadu_si128((const __m128i*)(r[2] + l));
      __m128i r3 = _mm_loadu_si128((const __m128i*)(r[3] + l));
      __m128i r4 = _mm_loadu_si128((const __m128i*)(r[4] + l));
      __m128i r5 = _mm_loadu_si128((const __m128i*)(r[5] + l));
      __m128i r6 = _mm_loadu_si128((const __m128i*)(r[6] + l));
      __m128i r7 = _mm_loadu_si128((const __m128i*)(r[7] + l));
      __m128i a0 = _mm_unpacklo_epi8(r0, r1), a1 = _mm_unpackhi_epi8(r0, r1);
      __m128i a2 = _mm_unpacklo_epi8(r2, r3), a3 = _mm_unpackhi_epi8(r2, r3);
      __m128i a4 = _mm_unpacklo_epi8(r4, r5), a5 = _mm_unpackhi_epi8(r4, r5);
      __m128i a6 = _mm_unpacklo_epi8(r6, r7), a7 = _mm_unpackhi_epi8(r6, r7);
      __m128i b0 = _mm_unpacklo_epi16(a0, a2), b1 = _mm_unpackhi_epi16(a0, a2);
      __m128i b2 = _mm_unpacklo_epi16(a4, a6), b3 = _mm_unpackhi_epi16(a4, a6);
      __m128i b4 = _mm_unpacklo_epi16(a1, a3), b5 = _mm_unpackhi_epi16(a1, a3);
      __m128i b6 = _mm_unpacklo_epi16(a5, a7), b7 = _mm_unpackhi_epi16(a5, a7);
      // c[k] holds columns (2k, 2k+1): low/high u64 = that column's 8 rows
      __m128i c[8] = {
          _mm_unpacklo_epi32(b0, b2), _mm_unpackhi_epi32(b0, b2),
          _mm_unpacklo_epi32(b1, b3), _mm_unpackhi_epi32(b1, b3),
          _mm_unpacklo_epi32(b4, b6), _mm_unpackhi_epi32(b4, b6),
          _mm_unpacklo_epi32(b5, b7), _mm_unpackhi_epi32(b5, b7)};
      uint8_t* d = dst + l * n_cols + 1 + i0;
      for (int k = 0; k < 8; ++k) {
        _mm_storel_epi64((__m128i*)(d + (2 * k) * n_cols), c[k]);
        _mm_storel_epi64((__m128i*)(d + (2 * k + 1) * n_cols),
                         _mm_unpackhi_epi64(c[k], c[k]));
      }
    }
    for (; l < length; ++l)
      for (int k = 0; k < 8; ++k) dst[l * n_cols + 1 + i0 + k] = r[k][l];
  }
#endif
  const int64_t BS = 64;  // scalar cache-blocked tail (n % 8 rows)
  if (i0 < n) {
    for (int64_t l0 = 0; l0 < length; l0 += BS) {
      int64_t l1 = std::min(l0 + BS, length);
      for (int64_t l = l0; l < l1; ++l) {
        uint8_t* d = dst + l * n_cols + 1;
        for (int64_t i = i0; i < n; ++i) d[i] = rp[i][l];
      }
    }
  }
}

static void scatter_rows_to_cols(const uint8_t* s, int64_t n, int64_t length,
                                 uint8_t* dst, int64_t n_cols) {
  std::vector<const uint8_t*> rp((size_t)n);
  for (int64_t i = 0; i < n; ++i) rp[i] = s + i * length;
  scatter_rowptrs_to_cols(rp.data(), n, length, dst, n_cols);
}

// Per-column class counts {A,C,G,T,*} (case pairs a,c,g,t,#; '.' counts
// nothing) accumulated from row-major planes — the row-plane twin of
// ht_supported_mask's per-column scan, used by ht_read_build to decide
// supported columns WITHOUT materialising the full (length, n_rows) pileup
// matrix first (at 90x coverage only the top-30 rows survive re-ranking, so
// the full-width fill+transpose was ~half of featgen, HT_PROF round 5).
// cnt is class-major [5][length], caller-zeroed, u16 (batches of 255 rows
// accumulate in saturating-free u8 then widen).
static void class_counts_rows(const uint8_t* const* rp, int64_t n,
                              int64_t length, uint16_t* cnt) {
  std::vector<uint8_t> acc((size_t)(5 * length));
  const uint8_t fwd_c[5] = {'A', 'C', 'G', 'T', '*'};
  const uint8_t rev_c[5] = {'a', 'c', 'g', 't', '#'};
  int64_t i = 0;
  while (i < n) {
    const int64_t batch = std::min<int64_t>(n - i, 255);
    memset(acc.data(), 0, acc.size());
    for (int64_t r = 0; r < batch; ++r) {
      const uint8_t* row = rp[i + r];
      int64_t l = 0;
#ifdef __SSE2__
      __m128i fwd[5], rev[5];
      for (int k = 0; k < 5; ++k) {
        fwd[k] = _mm_set1_epi8((char)fwd_c[k]);
        rev[k] = _mm_set1_epi8((char)rev_c[k]);
      }
      for (; l + 16 <= length; l += 16) {
        __m128i chunk = _mm_loadu_si128((const __m128i*)(row + l));
        for (int k = 0; k < 5; ++k) {
          __m128i eq = _mm_or_si128(_mm_cmpeq_epi8(chunk, fwd[k]),
                                    _mm_cmpeq_epi8(chunk, rev[k]));
          uint8_t* a = acc.data() + k * length + l;
          // eq bytes are 0xFF on match: subtracting adds 1 per match
          _mm_storeu_si128(
              (__m128i*)a,
              _mm_sub_epi8(_mm_loadu_si128((const __m128i*)a), eq));
        }
      }
#endif
      for (; l < length; ++l) {
        const uint8_t b = row[l];
        for (int k = 0; k < 5; ++k)
          if (b == fwd_c[k] || b == rev_c[k]) {
            ++acc[(size_t)(k * length + l)];
            break;
          }
      }
    }
    for (int64_t j = 0; j < 5 * length; ++j) cnt[j] += acc[(size_t)j];
    i += batch;
  }
}

void ht_fill_rows(uint8_t* bases, uint8_t* quals, int64_t n_cols,
                  int64_t length, const uint64_t* codes_p,
                  const uint64_t* lens_p, const int64_t* op_s,
                  const int64_t* off_s, const int64_t* op_e,
                  const int64_t* off_e, const int64_t* t_base,
                  const uint8_t* strand_rev, const uint64_t* qseq_p,
                  const uint64_t* qqual_p, const int64_t* anchor,
                  const int32_t* max_ins, int64_t n, int64_t no_aln_qual) {
  uint8_t* sb = (uint8_t*)malloc((size_t)(2 * n * length));
  if (sb == nullptr) {  // fall back to the direct strided fill
    for (int64_t i = 0; i < n; ++i)
      ht_fill_query_row(bases + (i + 1), quals + (i + 1), n_cols, length,
                        (const uint8_t*)codes_p[i], (const int32_t*)lens_p[i],
                        op_s[i], off_s[i], op_e[i], off_e[i], t_base[i],
                        (int)strand_rev[i], (const uint8_t*)qseq_p[i],
                        (const uint8_t*)qqual_p[i], anchor, max_ins);
    return;
  }
  uint8_t* sq = sb + n * length;
  // Quals default to the caller's init value at positions the walk never
  // touches (gaps/flanks), matching the direct path which leaves them alone.
  memset(sq, (int)no_aln_qual, (size_t)(n * length));
  for (int64_t i = 0; i < n; ++i)
    fill_query_row_flat(sb + i * length, sq + i * length, length,
                        (const uint8_t*)codes_p[i], (const int32_t*)lens_p[i],
                        op_s[i], off_s[i], op_e[i], off_e[i], t_base[i],
                        (int)strand_rev[i], (const uint8_t*)qseq_p[i],
                        (const uint8_t*)qqual_p[i], anchor, max_ins);

  scatter_rows_to_cols(sb, n, length, bases, n_cols);
  scatter_rows_to_cols(sq, n, length, quals, n_cols);
  free(sb);
}

void ht_window_accuracies(const uint64_t* codes_p, const uint64_t* lens_p,
                          const int64_t* op_s, const int64_t* off_s,
                          const int64_t* op_e, const int64_t* off_e,
                          const uint64_t* tseq_p, const uint64_t* qseq_p,
                          int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = ht_window_accuracy((const uint8_t*)codes_p[i],
                                (const int32_t*)lens_p[i], op_s[i], off_s[i],
                                op_e[i], off_e[i], (const uint8_t*)tseq_p[i],
                                (const uint8_t*)qseq_p[i]);
}

// ---------------------------------------------------------------------------
// Supported-column mask (reference: src/features.rs:681-722)
//
// bases is the (L, C) row-major pileup byte matrix; a pileup column l is
// supported when >= 2 of the case-folded classes {A,C,G,T,*} reach `thresh`
// occurrences among its C reads.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Banded fitting alignment with traceback (eval-side truth mapping).
//
// Aligns a (a corrected fragment, length n) against b (the truth sequence,
// length m) with free end-gaps on b only, inside a diagonal band
// [diag0 - band, diag0 + band] (diag = j - i). No reference counterpart: the
// reference publishes quality only as downstream assembly stats; this kernel
// powers the framework-local per-base / het-site / homopolymer eval metrics.
//
// Outputs:
//   b2a[m]    : per truth position j, the a byte aligned there, 255 if the
//               truth base was deleted in a, 254 outside the aligned span;
//   ins_after[m+1] : #a bases inserted between b[j-1] and b[j] (index j);
//   span[2]   : aligned truth span [j0, j1);
//   counts[4] : matches, subs, ins, del within the span.
// Returns the fitting edit distance, or -1 when the optimum leaves the band
// (caller should widen and retry).
// ---------------------------------------------------------------------------

int64_t ht_fit_align(const uint8_t* a, int64_t n, const uint8_t* b, int64_t m,
                     int64_t diag0, int64_t band, uint8_t* b2a,
                     int32_t* ins_after, int64_t* span, int64_t* counts) {
  const int64_t width = 2 * band + 1;
  const int64_t BIG = ((int64_t)1) << 40;
  int64_t* prev = (int64_t*)malloc((size_t)(2 * width) * sizeof(int64_t));
  uint8_t* tb = (uint8_t*)malloc((size_t)((n + 1) * width));
  if (prev == nullptr || tb == nullptr) {
    free(prev);
    free(tb);
    return -1;
  }
  int64_t* cur = prev + width;

  // row i covers j = diag0 + i + (k - band), k in [0, width)
  for (int64_t k = 0; k < width; ++k) {
    int64_t j = diag0 + (k - band);
    prev[k] = (j >= 0 && j <= m) ? 0 : BIG;  // free prefix of b
    tb[k] = 3;                               // start marker
  }

  for (int64_t i = 1; i <= n; ++i) {
    uint8_t* trow = tb + i * width;
    const uint8_t ai = a[i - 1];
    for (int64_t k = 0; k < width; ++k) {
      int64_t j = diag0 + i + (k - band);
      if (j < 0 || j > m) {
        cur[k] = BIG;
        trow[k] = 3;
        continue;
      }
      // diag: D[i-1][j-1] is prev[k] (same k: j-1 - (i-1) = j - i)
      int64_t best = BIG;
      uint8_t move = 3;
      if (j >= 1 && prev[k] < BIG) {
        int64_t c = prev[k] + (b[j - 1] == ai ? 0 : 1);
        if (c < best) { best = c; move = 0; }
      }
      // up: D[i-1][j] is prev[k+1] (insertion in a)
      if (k + 1 < width && prev[k + 1] < BIG) {
        int64_t c = prev[k + 1] + 1;
        if (c < best) { best = c; move = 1; }
      }
      // left: D[i][j-1] is cur[k-1] (deletion from a)
      if (j >= 1 && k >= 1 && cur[k - 1] < BIG) {
        int64_t c = cur[k - 1] + 1;
        if (c < best) { best = c; move = 2; }
      }
      cur[k] = best;
      trow[k] = move;
    }
    int64_t* t = prev;
    prev = cur;
    cur = t;
  }

  // free suffix of b: best cell in the last computed row (now in prev)
  int64_t best = BIG, bestk = -1;
  for (int64_t k = 0; k < width; ++k) {
    int64_t j = diag0 + n + (k - band);
    if (j < 0 || j > m) continue;
    if (prev[k] < best) { best = prev[k]; bestk = k; }
  }
  if (bestk < 0 || best >= BIG) {
    free(prev < cur ? prev : cur);
    free(tb);
    return -1;
  }

  for (int64_t j = 0; j <= m; ++j) ins_after[j] = 0;
  for (int64_t j = 0; j < m; ++j) b2a[j] = 254;

  int64_t i = n, k = bestk;
  int64_t j1 = diag0 + n + (bestk - band);
  int64_t mt = 0, sb = 0, ins = 0, del = 0;
  while (i > 0) {
    int64_t j = diag0 + i + (k - band);
    uint8_t move = tb[i * width + k];
    if (move == 0) {  // diag
      b2a[j - 1] = a[i - 1];
      if (a[i - 1] == b[j - 1]) ++mt; else ++sb;
      --i;  // k unchanged
    } else if (move == 1) {  // up: a[i-1] inserted between b[j-1] and b[j]
      if (ins_after[j] < INT32_MAX) ++ins_after[j];
      ++ins;
      --i;
      ++k;
    } else if (move == 2) {  // left: b[j-1] deleted
      b2a[j - 1] = 255;
      ++del;
      --k;
    } else {
      break;  // hit the band edge mid-path: shouldn't happen when ret >= 0
    }
  }
  int64_t j0 = diag0 + i + (k - band);
  span[0] = j0;
  span[1] = j1;
  counts[0] = mt;
  counts[1] = sb;
  counts[2] = ins;
  counts[3] = del;

  free(prev < cur ? prev : cur);
  free(tb);
  return best;
}

void ht_supported_mask(const uint8_t* bases, int64_t L, int64_t C,
                       int64_t thresh, uint8_t* mask) {
#ifdef __AVX2__
  // One 32-byte vector covers the typical C=31 row: per class, two
  // byte-equality compares (case pair), OR, movemask, popcount. ~6x the
  // scalar table-gather loop.
  const __m256i fwd[5] = {
      _mm256_set1_epi8('A'), _mm256_set1_epi8('C'), _mm256_set1_epi8('G'),
      _mm256_set1_epi8('T'), _mm256_set1_epi8('*')};
  const __m256i rev[5] = {
      _mm256_set1_epi8('a'), _mm256_set1_epi8('c'), _mm256_set1_epi8('g'),
      _mm256_set1_epi8('t'), _mm256_set1_epi8('#')};
  alignas(32) uint8_t buf[32];
  for (int64_t l = 0; l < L; ++l) {
    const uint8_t* row = bases + l * C;
    int32_t counts[5] = {0, 0, 0, 0, 0};
    int64_t c = 0;
    for (; c + 32 <= C; c += 32) {
      __m256i chunk = _mm256_loadu_si256((const __m256i*)(row + c));
      for (int k = 0; k < 5; ++k) {
        __m256i eq = _mm256_or_si256(_mm256_cmpeq_epi8(chunk, fwd[k]),
                                     _mm256_cmpeq_epi8(chunk, rev[k]));
        counts[k] += __builtin_popcount(
            (uint32_t)_mm256_movemask_epi8(eq));
      }
    }
    if (c < C) {  // tail: pad with 0 (matches no symbol)
      memset(buf, 0, 32);
      memcpy(buf, row + c, (size_t)(C - c));
      __m256i chunk = _mm256_load_si256((const __m256i*)buf);
      for (int k = 0; k < 5; ++k) {
        __m256i eq = _mm256_or_si256(_mm256_cmpeq_epi8(chunk, fwd[k]),
                                     _mm256_cmpeq_epi8(chunk, rev[k]));
        counts[k] += __builtin_popcount(
            (uint32_t)_mm256_movemask_epi8(eq));
      }
    }
    int n_reach = 0;
    for (int k = 0; k < 5; ++k) n_reach += counts[k] >= thresh;
    mask[l] = n_reach >= 2;
  }
#else
  const auto& cls = class_table();
  for (int64_t l = 0; l < L; ++l) {
    const uint8_t* row = bases + l * C;
    int32_t counts[6] = {0, 0, 0, 0, 0, 0};
    for (int64_t c = 0; c < C; ++c) ++counts[cls[row[c]]];
    int n_reach = 0;
    for (int k = 0; k < 5; ++k) n_reach += counts[k] >= thresh;
    mask[l] = n_reach >= 2;
  }
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Per-READ featurization (reference: the whole of src/features.rs:326-583 in
// one call). One build call runs, for every window of one target read:
// window grouping, the long-indel filter, accuracy sort, max-ins, the flat
// fill + SIMD transpose, the first-pass supported mask, haplotype phase-score
// accumulation, the top-30 re-rank, all-gap column compaction and the final
// supported positions. The Python per-window orchestration this replaces was
// ~30-50% of featgen wall time (round-3 profile).
//
// Protocol: ht_read_build fills per-window dims (final length, #supported,
// #rows) and returns an opaque handle; ht_read_emit copies the finished
// windows into caller-allocated buffers (pointer arrays, one per window);
// ht_read_free releases the handle. Build returns nullptr on allocation
// failure or malformed input — the caller falls back to the per-window path.
// ---------------------------------------------------------------------------

namespace {

// Phase profiling for ht_read_build, enabled by HT_PROF=1 in the
// environment (read once). Accumulates nanoseconds per phase across calls
// and threads; drained from Python via ht_prof_dump (native/__init__.py).
// Phases: 0 extract+indel-filter, 1 accuracy+sort, 2 max_ins+anchors,
// 3 row fill+transpose, 4 supported+phase-accum, 5 re-rank+compaction,
// 6 final supported, 7 whole build, 8 tensor emit.
constexpr int PROF_N = 9;
std::atomic<int64_t> g_prof_ns[PROF_N];

bool prof_enabled() {
  static const bool on = [] {
    const char* e = std::getenv("HT_PROF");
    return e != nullptr && e[0] != '\0' && e[0] != '0';
  }();
  return on;
}

struct ProfScope {
  int slot;
  std::chrono::steady_clock::time_point t0;
  explicit ProfScope(int s) : slot(-1) {
    if (prof_enabled()) {
      slot = s;
      t0 = std::chrono::steady_clock::now();
    }
  }
  ~ProfScope() {
    if (slot >= 0)
      g_prof_ns[slot].fetch_add(
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now() - t0)
              .count(),
          std::memory_order_relaxed);
  }
};

struct RFRow {
  int32_t aln;
  int32_t plane;  // index of this row's anchor plane (original arrival order)
  int64_t t_ws, q_ws, op_s, off_s, op_e, off_e;
  double acc;
};

// SSE2 match counter for the merged anchor-fill + accuracy walk.
static inline int64_t count_matches(const uint8_t* a, const uint8_t* b,
                                    int64_t l) {
  int64_t m = 0, i = 0;
#ifdef __SSE2__
  for (; i + 16 <= l; i += 16) {
    __m128i eq =
        _mm_cmpeq_epi8(_mm_loadu_si128((const __m128i*)(a + i)),
                       _mm_loadu_si128((const __m128i*)(b + i)));
    m += __builtin_popcount((unsigned)_mm_movemask_epi8(eq));
  }
#endif
  for (; i < l; ++i) m += a[i] == b[i];
  return m;
}

// Lowercase copy for reverse-strand rows. Query bytes come from the 2-bit
// sequence arena so they are always uppercase ACGT, for which `| 0x20` is
// exactly lower_table() (asserted nowhere hotter than here: the scalar tail
// uses the table, so any non-ACGT byte would still fold identically to the
// old per-byte path).
static inline void copy_lower(uint8_t* dst, const uint8_t* src, int64_t l) {
  int64_t i = 0;
#ifdef __SSE2__
  const __m128i m20 = _mm_set1_epi8(0x20);
  for (; i + 16 <= l; i += 16)
    _mm_storeu_si128(
        (__m128i*)(dst + i),
        _mm_or_si128(_mm_loadu_si128((const __m128i*)(src + i)), m20));
#endif
  const auto& lower = lower_table();
  for (; i < l; ++i) dst[i] = lower[src[i]];
}

// One walk per overlap row: fill the ANCHOR-COLUMN base plane (win_len
// bytes — insertion columns do not exist yet) and compute the window-local
// alignment accuracy. Pass 1 only ever needs anchor columns (supported
// mask, phase scores) — the full insertion-aware fill is deferred to pass 2
// for the top-k surviving rows only, which at heavy coverage (~90 rows
// down to 31) is the difference between filling 1.7 MB and 0.4 MB per
// window (fill was 35-50% of build, HT_PROF). The accuracy walk
// (previously a separate full cigar pass, ht_window_accuracy) rides along:
// identical counters, including the divergent query-position traces for
// boundary-partial insertions (accuracy consumes the effective length,
// the fill consumes the raw op length — src/features.rs:585-679 vs
// 110-266).
static double fill_anchor_row_acc(uint8_t* plane, int64_t win_len,
                                  const uint8_t* codes, const int32_t* lens,
                                  int64_t op_s, int64_t off_s, int64_t op_e,
                                  int64_t off_e, int64_t t_base,
                                  int strand_rev, const uint8_t* qseq,
                                  const uint8_t* tseq_row) {
  const uint8_t gap = strand_rev ? '#' : '*';
  memset(plane, '.', (size_t)t_base);
  int64_t tp = 0, qp_f = 0, qp_a = 0;
  int64_t m = 0, s = 0, ins = 0, del = 0;
  const int64_t n = op_e - op_s;
  for (int64_t j = 0; j < n; ++j) {
    const uint8_t op = codes[op_s + j];
    const int64_t l = eff_len(lens, op_s, off_s, op_e, off_e, j);
    if (op == OP_M) {
      const int64_t mm = count_matches(tseq_row + tp, qseq + qp_a, l);
      m += mm;
      s += l - mm;
      if (strand_rev)
        copy_lower(plane + t_base + tp, qseq + qp_f, l);
      else
        memcpy(plane + t_base + tp, qseq + qp_f, (size_t)l);
      tp += l;
      qp_a += l;
      qp_f += l;
    } else if (op == OP_D) {
      memset(plane + t_base + tp, gap, (size_t)l);
      del += l;
      tp += l;
    } else {  // OP_I
      ins += l;
      qp_a += l;
      qp_f += lens[op_s + j];  // fill trace consumes the RAW insertion
    }
  }
  memset(plane + t_base + tp, '.', (size_t)(win_len - (t_base + tp)));
  const int64_t total = m + s + ins + del;
  return total ? (double)m / (double)total : 0.0;
}

struct RFWin {
  std::vector<uint8_t> bases, quals;  // final row-major (len, top_k + 1)
  std::vector<uint16_t> sup_pos;
  std::vector<uint8_t> sup_ins;
  std::vector<int32_t> sup_flat;  // flat column index per supported pos
  std::vector<int32_t> row_aln;  // re-ranked row -> caller aln index
  int64_t len = 0;
};

struct RFStaged {
  // First pass stages only ANCHOR-COLUMN base planes ([n, win_len], one per
  // overlap row, arrival order — RFRow.plane indexes them): the supported
  // mask, phase scores and accuracy never look at insertion columns, so the
  // full [length]-wide insertion-aware fill is deferred to pass 2 and runs
  // for the top-k *surviving* rows only (at ~90x: 31 of ~90).
  std::vector<uint8_t> anch;    // [n, win_len] anchor base planes
  std::vector<int64_t> anchor;  // win_len + 1
  std::vector<RFRow> rows;      // accuracy-sorted
  int64_t length = 0, n_cols = 0, win_len = 0;
};

struct RFHandle {
  std::vector<RFWin> wins;
};

}  // namespace

extern "C" {

void* ht_read_build(
    int64_t n_alns, const uint64_t* codes_p, const uint64_t* lens_p,
    const int64_t* n_ops, const int64_t* tstart, const int64_t* tend,
    const int64_t* tlen, const int64_t* qstart, const int64_t* qend,
    const uint8_t* strand_rev, const uint64_t* qseq_p, const uint64_t* qqual_p,
    const int64_t* qid_local, int64_t n_qid, const uint8_t* tseq,
    const uint8_t* tqual, int64_t read_len, int64_t W, int64_t top_k,
    int64_t max_indel, int64_t no_aln_qual, int64_t* out_len,
    int64_t* out_nsup, int64_t* out_nrows) {
  const int64_t n_windows = (read_len + W - 1) / W;
  const auto& upper = upper_table();
  ProfScope prof_total(7);

  std::vector<RFStaged> staged(n_windows);
  std::vector<int64_t> tmp;

  // 1. Window grouping + long-indel filter (src/features.rs:362-383).
  {
    ProfScope p0(0);
    for (int64_t a = 0; a < n_alns; ++a) {
      int64_t max_rows = (tend[a] - tstart[a]) / W + 3;
      tmp.resize((size_t)(max_rows * 8));
      int64_t nr = ht_extract_windows(
          (const uint8_t*)codes_p[a], (const int32_t*)lens_p[a], n_ops[a],
          tstart[a], tend[a], tlen[a], qstart[a], qend[a], W, tmp.data(),
          max_rows);
      if (nr < 0) return nullptr;
      const uint8_t* cods = (const uint8_t*)codes_p[a];
      const int32_t* lns = (const int32_t*)lens_p[a];
      for (int64_t r = 0; r < nr; ++r) {
        const int64_t* row = tmp.data() + 8 * r;
        int64_t w = row[0];
        if (w < 0 || w >= n_windows) return nullptr;
        bool bad = false;  // raw op lengths, as in window_has_long_indel
        for (int64_t j = row[4]; j < row[6]; ++j)
          if (cods[j] != OP_M && lns[j] > max_indel) { bad = true; break; }
        if (bad) continue;
        staged[w].rows.push_back(
            {(int32_t)a, 0, row[1], row[2], row[4], row[5], row[6], row[7],
             0.0});
      }
    }
  }

  std::vector<int64_t> num((size_t)n_qid, 0), den((size_t)n_qid, 0);
  std::vector<int32_t> max_ins;
  std::vector<uint8_t> mask;
  std::vector<const uint8_t*> rowptrs;
  std::vector<uint16_t> counts;
  std::vector<int64_t> sup_anchor;

  // 2. First pass per window: sort, fill, supported, phase accumulation.
  for (int64_t w = 0; w < n_windows; ++w) {
    RFStaged& st = staged[w];
    const int64_t win_start = w * W;
    st.win_len = (w == n_windows - 1) ? read_len - win_start : W;
    auto& rows = st.rows;
    const int64_t n = (int64_t)rows.size();

    // Anchor-plane fill + window-local accuracy in one walk per row, then
    // stable accuracy sort (features.rs:386-409). Planes stay in arrival
    // order (RFRow.plane) so the sort moves 64-byte rows, not megabytes.
    {
      ProfScope p1(1);
      if (n) st.anch.resize((size_t)(n * st.win_len));
      for (int64_t i = 0; i < n; ++i) {
        RFRow& r = rows[i];
        r.plane = (int32_t)i;
        r.acc = fill_anchor_row_acc(
            st.anch.data() + i * st.win_len, st.win_len,
            (const uint8_t*)codes_p[r.aln], (const int32_t*)lens_p[r.aln],
            r.op_s, r.off_s, r.op_e, r.off_e, r.t_ws - win_start,
            (int)strand_rev[r.aln], (const uint8_t*)qseq_p[r.aln] + r.q_ws,
            tseq + r.t_ws);
      }
      std::stable_sort(rows.begin(), rows.end(),
                       [](const RFRow& x, const RFRow& y) { return x.acc > y.acc; });
    }

    {
      ProfScope p2(2);
      max_ins.assign((size_t)st.win_len, 0);
      for (auto& r : rows)
        ht_max_ins((const uint8_t*)codes_p[r.aln], (const int32_t*)lens_p[r.aln],
                   r.op_s, r.off_s, r.op_e, r.off_e, r.t_ws - win_start,
                   max_ins.data());
      st.anchor.resize((size_t)st.win_len + 1);
      st.anchor[0] = 0;
      for (int64_t t = 0; t < st.win_len; ++t)
        st.anchor[t + 1] = st.anchor[t] + 1 + max_ins[t];
      st.length = st.anchor[st.win_len];
      st.n_cols = 1 + std::max<int64_t>(n, top_k);
    }

    // Haplotype phase scores accumulate over supported *anchor* columns
    // only: insertion columns carry '*' in the target row and are excluded
    // by the tgt != GAP filter (features.rs:461-509; extract.py). Supported
    // columns come from anchor-plane class counts — identical bytes at
    // anchor columns to the old full-width planes (the target anchor plane
    // IS the raw read slice; insertion columns never reach the counts the
    // anchor loop sampled, and '.' padding counts nothing).
    if (n) {
      ProfScope p4(4);
      rowptrs.resize((size_t)n + 1);
      rowptrs[0] = tseq + win_start;
      for (int64_t i = 0; i < n; ++i)
        rowptrs[(size_t)i + 1] = st.anch.data() + i * st.win_len;
      counts.assign((size_t)(5 * st.win_len), 0);
      class_counts_rows(rowptrs.data(), n + 1, st.win_len, counts.data());
      const int64_t thresh = (int64_t)((double)st.n_cols * 0.1);
      sup_anchor.clear();
      for (int64_t t = 0; t < st.win_len; ++t) {
        int reach = 0;
        for (int k = 0; k < 5; ++k)
          reach += counts[(size_t)(k * st.win_len + t)] >= thresh;
        if (reach >= 2) sup_anchor.push_back(t);
      }
      for (int64_t i = 0; i < n; ++i) {
        const int64_t q = qid_local[rows[i].aln];
        const uint8_t* plane = st.anch.data() + rows[i].plane * st.win_len;
        int64_t nn = 0, dd = 0;
        for (const int64_t t : sup_anchor) {
          if (upper[plane[t]] == tseq[win_start + t]) ++nn; else ++dd;
        }
        num[q] += nn;
        den[q] += dd;
      }
    }
  }

  // 3. Phase scores (features.rs:502-509): (n/t) * ln(t + 1).
  std::vector<double> score((size_t)n_qid, 0.0);
  for (int64_t q = 0; q < n_qid; ++q) {
    const int64_t t = num[q] + den[q];
    if (t) score[q] = ((double)num[q] / (double)t) * std::log((double)t + 1.0);
  }

  // 4. Second pass: re-rank rows, drop all-gap columns, final supported.
  RFHandle* h = new (std::nothrow) RFHandle();
  if (h == nullptr) return nullptr;
  h->wins.resize((size_t)n_windows);
  const int64_t C = top_k + 1;
  std::vector<int32_t> sr;
  std::vector<int32_t> max_ins_w;
  std::vector<uint8_t> rowb, rowq;  // pass-2 scratch: top-k full row planes
  for (int64_t w = 0; w < n_windows; ++w) {
    RFStaged& st = staged[w];
    RFWin& wn = h->wins[w];
    const int64_t n = (int64_t)st.rows.size();
    const int64_t win_start = w * W;

    int64_t L2 = 0;
    {
      ProfScope p5(5);
      sr.resize((size_t)n + 1);
      for (int64_t i = 0; i <= n; ++i) sr[i] = (int32_t)i;
      // target row (score +inf) stays first; stable sort keeps accuracy
      // order among equal scores, matching the Python sorted(key=-score).
      std::stable_sort(sr.begin() + 1, sr.end(), [&](int32_t x, int32_t y) {
        return score[qid_local[st.rows[x - 1].aln]] >
               score[qid_local[st.rows[y - 1].aln]];
      });
      const int64_t m = std::min<int64_t>(n + 1, C);

      wn.row_aln.resize((size_t)n);
      for (int64_t i = 0; i < n; ++i)
        wn.row_aln[i] = st.rows[sr[i + 1] - 1].aln;

      // Full insertion-aware fill for the m-1 SURVIVING rows only (pass 1
      // staged anchor planes only); max_ins recovers from the anchor
      // prefix. Then build the (length, C) pileup directly in re-ranked
      // column order: col 0 is the target plane, cols 1..m-1 the selected
      // row planes (transposed), cols m.. stay '.'-padding with no-aln
      // quals — the same bytes the old full-width matrix + colmap
      // indirection gave.
      wn.bases.assign((size_t)(st.length * C), '.');
      wn.quals.assign((size_t)(st.length * C), (uint8_t)no_aln_qual);
      for (int64_t l = 0; l < st.length; ++l)
        wn.bases[(size_t)(l * C)] = '*';
      for (int64_t t = 0; t < st.win_len; ++t) {
        wn.bases[(size_t)(st.anchor[t] * C)] = tseq[win_start + t];
        wn.quals[(size_t)(st.anchor[t] * C)] = tqual[w * W + t];
      }
      if (m > 1) {
        ProfScope p3(3);
        max_ins_w.resize((size_t)st.win_len);
        for (int64_t t = 0; t < st.win_len; ++t)
          max_ins_w[(size_t)t] =
              (int32_t)(st.anchor[t + 1] - st.anchor[t] - 1);
        rowb.resize((size_t)((m - 1) * st.length));
        rowq.assign((size_t)((m - 1) * st.length), (uint8_t)no_aln_qual);
        for (int64_t j = 1; j < m; ++j) {
          const RFRow& r = st.rows[sr[j] - 1];
          fill_query_row_flat(
              rowb.data() + (j - 1) * st.length,
              rowq.data() + (j - 1) * st.length, st.length,
              (const uint8_t*)codes_p[r.aln], (const int32_t*)lens_p[r.aln],
              r.op_s, r.off_s, r.op_e, r.off_e,
              r.t_ws - win_start, (int)strand_rev[r.aln],
              (const uint8_t*)qseq_p[r.aln] + r.q_ws,
              (const uint8_t*)qqual_p[r.aln] + r.q_ws, st.anchor.data(),
              max_ins_w.data());
        }
        rowptrs.resize((size_t)(2 * (m - 1)));
        for (int64_t j = 1; j < m; ++j) {
          rowptrs[(size_t)(j - 1)] = rowb.data() + (j - 1) * st.length;
          rowptrs[(size_t)(m - 1 + j - 1)] =
              rowq.data() + (j - 1) * st.length;
        }
        scatter_rowptrs_to_cols(rowptrs.data(), m - 1, st.length,
                                wn.bases.data(), C);
        scatter_rowptrs_to_cols(rowptrs.data() + (m - 1), m - 1, st.length,
                                wn.quals.data(), C);
      }

      // In-place all-gap column compaction (forward scan: dst <= src).
#ifdef __SSE2__
      const __m128i dot_v = _mm_set1_epi8('.');
      const __m128i star_v = _mm_set1_epi8('*');
      const __m128i hash_v = _mm_set1_epi8('#');
#endif
      for (int64_t l = 0; l < st.length; ++l) {
        const uint8_t* ob = wn.bases.data() + l * C;
        bool keep = false;
#ifdef __SSE2__
        if (C >= 16) {
          // a column is kept iff any byte is a real base; test 16 bytes per
          // step, the tail re-testing the last 16 (overlap is harmless)
          for (int64_t j = 0;; j += 16) {
            if (j + 16 > C) j = C - 16;
            __m128i ch = _mm_loadu_si128((const __m128i*)(ob + j));
            __m128i gapish = _mm_or_si128(
                _mm_or_si128(_mm_cmpeq_epi8(ch, dot_v),
                             _mm_cmpeq_epi8(ch, star_v)),
                _mm_cmpeq_epi8(ch, hash_v));
            if (_mm_movemask_epi8(gapish) != 0xFFFF) { keep = true; break; }
            if (j == C - 16) break;
          }
        } else
#endif
        {
          for (int64_t j = 0; j < C; ++j) {
            const uint8_t b = ob[j];
            keep |= (b != '.' && b != '*' && b != '#');
          }
        }
        if (keep) {
          if (L2 != l) {
            memmove(wn.bases.data() + L2 * C, ob, (size_t)C);
            memmove(wn.quals.data() + L2 * C, wn.quals.data() + l * C,
                    (size_t)C);
          }
          ++L2;
        }
      }
      wn.bases.resize((size_t)(L2 * C));
      wn.quals.resize((size_t)(L2 * C));
      wn.len = L2;
      st.anch.clear(); st.anch.shrink_to_fit();
    }

    {
      ProfScope p6(6);
      const int64_t thresh2 = (int64_t)((double)C * 0.1);
      mask.resize((size_t)L2);
      ht_supported_mask(wn.bases.data(), L2, C, thresh2, mask.data());
      int64_t apos = -1, last_anchor = -1;
      for (int64_t l = 0; l < L2; ++l) {
        const bool is_anchor = wn.bases[l * C] != '*';
        if (is_anchor) { ++apos; last_anchor = l; }
        if (mask[l]) {
          wn.sup_pos.push_back((uint16_t)apos);
          wn.sup_ins.push_back((uint8_t)(is_anchor ? 0 : l - last_anchor));
          // anchors[pos] + ins == last_anchor + (l - last_anchor) == l: the
          // flat supported column index the batcher wants is just l.
          wn.sup_flat.push_back((int32_t)l);
        }
      }
    }

    out_len[w] = L2;
    out_nsup[w] = (int64_t)wn.sup_pos.size();
    out_nrows[w] = n;
  }
  return h;
}

void ht_read_emit(void* handle, const uint64_t* bases_p,
                  const uint64_t* quals_p, const uint64_t* sup_pos_p,
                  const uint64_t* sup_ins_p, const uint64_t* row_aln_p,
                  int64_t top_k) {
  RFHandle* h = (RFHandle*)handle;
  const int64_t C = top_k + 1;
  for (size_t w = 0; w < h->wins.size(); ++w) {
    const RFWin& wn = h->wins[w];
    memcpy((void*)bases_p[w], wn.bases.data(), (size_t)(wn.len * C));
    memcpy((void*)quals_p[w], wn.quals.data(), (size_t)(wn.len * C));
    memcpy((void*)sup_pos_p[w], wn.sup_pos.data(),
           wn.sup_pos.size() * sizeof(uint16_t));
    memcpy((void*)sup_ins_p[w], wn.sup_ins.data(), wn.sup_ins.size());
    memcpy((void*)row_aln_p[w], wn.row_aln.data(),
           wn.row_aln.size() * sizeof(int32_t));
  }
}

// Device-ready emit: per window, vocab-mapped token nibble rows packed
// [P, len] (P = (C+1)/2; packed row p holds pileup rows 2p low / 2p+1 high,
// the phantom odd row reading `token_pad` — exactly batching.pack_tokens on
// BASES_MAP-encoded bases), quals transposed row-major [C, len], and the
// flat supported column indices (int32). These are the bytes the inference
// batch ships to the device (batching.collate), so the Python tensorize +
// pack + per-window transpose passes (~1/6 of heavy-profile host CPU)
// disappear; byte parity with that path is enforced by
// tests/test_extract_parity.py.
void ht_read_emit_tensors(void* handle, const uint8_t* vocab_lut,
                          int64_t token_pad, const uint64_t* tokp_p,
                          const uint64_t* qualr_p, const uint64_t* supflat_p,
                          const uint64_t* row_aln_p, int64_t top_k) {
  ProfScope prof_emit(8);
  RFHandle* h = (RFHandle*)handle;
  const int64_t C = top_k + 1;
  const int64_t P = (C + 1) / 2;
  for (size_t w = 0; w < h->wins.size(); ++w) {
    const RFWin& wn = h->wins[w];
    const int64_t L = wn.len;
    uint8_t* tok = (uint8_t*)tokp_p[w];
    uint8_t* qr = (uint8_t*)qualr_p[w];
    const uint8_t* b = wn.bases.data();
    const uint8_t* q = wn.quals.data();
    for (int64_t p = 0; p < P; ++p) {
      const int64_t r0 = 2 * p, r1 = 2 * p + 1;
      uint8_t* dst = tok + p * L;
      if (r1 < C) {
        const uint8_t* s0 = b + r0;
        const uint8_t* s1 = b + r1;
        for (int64_t l = 0; l < L; ++l)
          dst[l] = (uint8_t)(vocab_lut[s0[l * C]] |
                             (vocab_lut[s1[l * C]] << 4));
      } else {
        const uint8_t* s0 = b + r0;
        const uint8_t hi = (uint8_t)(token_pad << 4);
        for (int64_t l = 0; l < L; ++l)
          dst[l] = (uint8_t)(vocab_lut[s0[l * C]] | hi);
      }
    }
    for (int64_t j = 0; j < C; ++j) {
      uint8_t* dst = qr + j * L;
      const uint8_t* src = q + j;
      for (int64_t l = 0; l < L; ++l) dst[l] = src[l * C];
    }
    memcpy((void*)supflat_p[w], wn.sup_flat.data(),
           wn.sup_flat.size() * sizeof(int32_t));
    memcpy((void*)row_aln_p[w], wn.row_aln.data(),
           wn.row_aln.size() * sizeof(int32_t));
  }
}

void ht_read_free(void* handle) { delete (RFHandle*)handle; }

// Drain the HT_PROF phase accumulators (nanoseconds, PROF_N slots) into
// `out`; no-ops to zeros when profiling was not enabled.
void ht_prof_dump(int64_t* out) {
  for (int i = 0; i < PROF_N; ++i)
    out[i] = g_prof_ns[i].load(std::memory_order_relaxed);
}

void ht_prof_reset() {
  for (int i = 0; i < PROF_N; ++i)
    g_prof_ns[i].store(0, std::memory_order_relaxed);
}

}  // extern "C"
