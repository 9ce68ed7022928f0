"""CIGAR parsing and algebra over op arrays.

The reference keeps CIGARs as raw ASCII and re-parses byte ranges per window
(src/aligners.rs:252-293). Here every alignment's CIGAR is parsed exactly once
into parallel numpy arrays ``(codes, lens)`` plus cumulative target/query
positions, and windows reference *op index* ranges — cheaper and
vectorisation-friendly.

Op codes: M=0 (match-or-mismatch), I=1, D=2.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

M, I, D = 0, 1, 2

# '='/'X' fold into M at parse time — the array equivalent of the reference's
# mismatch->match rewrite in get_proper_cigar (src/aligners.rs:105-112).
_CIGAR_RE = re.compile(rb"(\d+)([MID=X])")
_CODE_OF = {b"M": M, b"I": I, b"D": D, b"=": M, b"X": M}


@dataclass
class Cigar:
    """Parsed CIGAR with cumulative coordinates.

    ``t_cum[i]`` / ``q_cum[i]`` are the target / query bases consumed by ops
    ``[0, i)``; hence ``t_cum[-1]`` is the total target span.
    """

    codes: np.ndarray  # uint8 [n_ops]
    lens: np.ndarray  # int32 [n_ops]
    t_cum: np.ndarray  # int64 [n_ops + 1]
    q_cum: np.ndarray  # int64 [n_ops + 1]

    def __len__(self) -> int:
        return self.codes.shape[0]

    def long_indel_prefix(self, max_len: int) -> np.ndarray:
        """``prefix[i]`` = #I/D ops longer than ``max_len`` among ops [0, i).

        One cumulative pass per alignment turns the per-window long-indel
        filter (raw op lengths, src/features.rs:315-324) into an O(1)
        subtraction: a slice [s, e) is clean iff prefix[e] == prefix[s].
        """
        cached = getattr(self, "_li_prefix", None)
        if cached is None or cached[0] != max_len:
            bad = (self.codes != M) & (self.lens.astype(np.int64) > max_len)
            prefix = np.zeros(self.codes.shape[0] + 1, dtype=np.int32)
            np.cumsum(bad, out=prefix[1:])
            cached = (max_len, prefix)
            self._li_prefix = cached
        return cached[1]


def _build(codes: np.ndarray, lens: np.ndarray) -> Cigar:
    n = codes.shape[0]
    t_adv = np.where(codes != I, lens, 0).astype(np.int64)
    q_adv = np.where(codes != D, lens, 0).astype(np.int64)
    t_cum = np.zeros(n + 1, dtype=np.int64)
    q_cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(t_adv, out=t_cum[1:])
    np.cumsum(q_adv, out=q_cum[1:])
    return Cigar(codes, lens, t_cum, q_cum)


def _coalesce(codes: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Merge adjacent same-code runs (src/aligners.rs:127-135)."""
    if codes.shape[0] == 0:
        return codes, lens
    new_run = np.empty(codes.shape[0], dtype=bool)
    new_run[0] = True
    new_run[1:] = codes[1:] != codes[:-1]
    seg = np.cumsum(new_run) - 1
    out_lens = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
    np.add.at(out_lens, seg, lens.astype(np.int64))
    return codes[new_run], out_lens.astype(np.int32)


_MAX_RUN = 2**31 - 1  # run lengths are int32


def parse_cigar(cigar: bytes) -> Cigar:
    from .. import native

    if native.available():
        parsed = native.parse_cigar_arrays(cigar)
        if parsed is None:
            raise ValueError(f"Invalid CIGAR: {cigar[:60]!r}")
        codes, lens, has_eqx = parsed
        if has_eqx:
            codes, lens = _coalesce(codes, lens)
        return _build(codes, lens)

    ops = _CIGAR_RE.findall(cigar)
    n = len(ops)
    # Validate: the regex must consume the whole string.
    if sum(len(l) + 1 for l, _ in ops) != len(cigar):
        raise ValueError(f"Invalid CIGAR: {cigar[:60]!r}")
    codes = np.empty(n, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int32)
    has_eqx = False
    for i, (l, op) in enumerate(ops):
        codes[i] = _CODE_OF[op]
        if int(l) > _MAX_RUN:  # the native parser rejects such a run too
            raise ValueError(f"Invalid CIGAR: {cigar[:60]!r}")
        lens[i] = int(l)
        has_eqx |= op in (b"=", b"X")
    if has_eqx:
        codes, lens = _coalesce(codes, lens)
    return _build(codes, lens)


def cigar_to_string(cig: Cigar) -> bytes:
    sym = b"MID"
    return b"".join(b"%d%c" % (l, sym[c]) for c, l in zip(cig.codes, cig.lens))


def orient_cigar(cig: Cigar, is_target: bool, strand_rev: bool) -> Cigar:
    """Re-orient a target-oriented CIGAR for the query side
    (src/aligners.rs:105-136 ``get_proper_cigar``).

    Query-side view swaps I<->D; a reverse-strand query additionally reverses
    the op order. Mismatch folding already happened at parse time.
    """
    if is_target:
        return cig
    swapped = cig.codes.copy()
    swapped[cig.codes == I] = D
    swapped[cig.codes == D] = I
    lens = cig.lens
    if strand_rev:
        swapped = swapped[::-1].copy()
        lens = lens[::-1].copy()
    codes, lens = _coalesce(swapped, lens)
    return _build(codes, lens)


def left_align_indels(
    cig: Cigar, tseq: np.ndarray, qseq: np.ndarray
) -> tuple[Cigar, int, int]:
    """Left-align indels through repeats, minimap2-style
    (src/aligners.rs:138-250 ``fix_cigar``; upstream minimap2 align.c:91).

    An indel flanked by match ops shifts left while the base preceding it
    equals the base the shift exposes (homopolymers / tandem repeats slide to
    their leftmost placement). Leading zero-length matches and a leading
    indel are dropped; a dropped leading deletion / insertion is reported as
    ``tshift`` / ``qshift`` (bases the caller must advance its start by).
    Returns the normalised CIGAR with adjacent same-kind ops merged.
    """
    codes = cig.codes.astype(np.int64).tolist()
    lens = cig.lens.astype(np.int64).tolist()
    n = len(codes)
    tpos = qpos = 0
    for i in range(n):
        if codes[i] == M:
            tpos += lens[i]
            qpos += lens[i]
            continue
        if 0 < i < n - 1 and codes[i - 1] == M and codes[i + 1] == M:
            prev_len = lens[i - 1]
            length = lens[i]
            shift = 0
            if codes[i] == I:
                while shift < prev_len and qseq[qpos - 1 - shift] == qseq[
                    qpos + length - 1 - shift
                ]:
                    shift += 1
            else:
                while shift < prev_len and tseq[tpos - 1 - shift] == tseq[
                    tpos + length - 1 - shift
                ]:
                    shift += 1
            if shift:
                lens[i - 1] -= shift
                lens[i + 1] += shift
                tpos -= shift
                qpos -= shift
        if codes[i] == I:
            qpos += lens[i]
        else:
            tpos += lens[i]

    # Trim the (possibly emptied) head, record a leading indel as a shift.
    tshift = qshift = 0
    start = 0
    while start < len(codes):
        if codes[start] == M and lens[start] > 0:
            break
        if codes[start] == I:
            qshift = lens[start]
            start += 1
            break
        if codes[start] == D:
            tshift = lens[start]
            start += 1
            break
        start += 1  # zero-length match
    keep = [(c, l) for c, l in zip(codes[start:], lens[start:]) if l > 0]
    if keep:
        kc = np.asarray([c for c, _ in keep], dtype=np.uint8)
        kl = np.asarray([l for _, l in keep], dtype=np.int32)
        kc, kl = _coalesce(kc, kl)
    else:
        kc = np.empty(0, dtype=np.uint8)
        kl = np.empty(0, dtype=np.int32)
    return _build(kc, kl), tshift, qshift


def slice_lengths(
    cig: Cigar, op_start: int, start_off: int, op_end: int, end_off: int
) -> np.ndarray:
    """Effective op lengths of the window slice ``ops[op_start:op_end]``.

    The first op loses ``start_off`` leading bases, the last op is truncated to
    ``end_off`` consumed bases; a single-op slice spans
    ``end_off - start_off`` (reference: src/features.rs:181-188).
    """
    lens = cig.lens[op_start:op_end].astype(np.int64)
    n = lens.shape[0]
    if n == 0:
        return lens
    if n == 1:
        lens = lens.copy()
        lens[0] = end_off - start_off
        return lens
    lens = lens.copy()
    lens[0] -= start_off
    lens[-1] = end_off
    return lens


def window_has_long_indel(
    cig: Cigar, op_start: int, op_end: int, max_len: int
) -> bool:
    """True if any I/D op in the slice is longer than ``max_len``.

    Mirrors the reference filter, which tests *raw* op lengths of the byte
    slice without offset truncation (src/features.rs:315-324).
    """
    codes = cig.codes[op_start:op_end]
    lens = cig.lens[op_start:op_end]
    return bool(np.any((codes != M) & (lens > max_len)))


def window_accuracy(
    cig: Cigar,
    op_start: int,
    start_off: int,
    op_end: int,
    end_off: int,
    tseq: np.ndarray,
    qseq: np.ndarray,
) -> float:
    """Window-local alignment accuracy m / (m + s + i + d).

    Match ops are split into true matches / substitutions by comparing the
    decoded target and query bases (reference: src/features.rs:585-679).
    ``tseq`` / ``qseq`` are the window-local target and oriented query bytes.
    """
    from .. import native

    if native.available():
        return native.window_accuracy(
            cig.codes,
            cig.lens,
            op_start,
            start_off,
            op_end,
            end_off,
            np.ascontiguousarray(tseq),
            np.ascontiguousarray(qseq),
        )

    codes = cig.codes[op_start:op_end]
    lens = slice_lengths(cig, op_start, start_off, op_end, end_off)

    t_adv = np.where(codes != I, lens, 0)
    q_adv = np.where(codes != D, lens, 0)
    t_pos = np.concatenate([[0], np.cumsum(t_adv)[:-1]])
    q_pos = np.concatenate([[0], np.cumsum(q_adv)[:-1]])

    is_m = codes == M
    m = 0
    if is_m.any():
        # expand all M runs into flat index arrays: one vectorised compare
        lm = lens[is_m]
        total_m = int(lm.sum())
        off = np.arange(total_m, dtype=np.int64) - np.repeat(
            np.cumsum(lm) - lm, lm
        )
        ti = np.repeat(t_pos[is_m], lm) + off
        qi = np.repeat(q_pos[is_m], lm) + off
        m = int(np.count_nonzero(tseq[ti] == qseq[qi]))
    else:
        total_m = 0
    s = total_m - m
    i = int(np.sum(lens[codes == I]))
    d = int(np.sum(lens[codes == D]))
    total = m + s + i + d
    return m / total if total else 0.0
