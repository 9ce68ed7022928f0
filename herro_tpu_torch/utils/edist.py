"""Banded Levenshtein distance, vectorised with numpy.

Used to score corrected reads against ground truth (per-base identity /
Q-score). The band is laid out in diagonal-offset coordinates; the
within-row insertion chain is a min-plus prefix scan computed as
``minimum.accumulate(cand - arange) + arange``. Exact whenever the true
alignment stays within the band (band auto-sizes to the length difference
plus a slack).
"""

from __future__ import annotations

import numpy as np

_BIG = np.int64(1 << 40)


def banded_edit_distance(a: bytes | np.ndarray, b: bytes | np.ndarray,
                         band: int | None = None) -> int:
    """Levenshtein distance of a and b, exact within the band."""
    a = np.frombuffer(a, dtype=np.uint8) if isinstance(a, (bytes, bytearray)) else a
    b = np.frombuffer(b, dtype=np.uint8) if isinstance(b, (bytes, bytearray)) else b
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if band is None:
        band = abs(n - m) + max(32, (n + m) // 20)
    band = min(band, max(n, m))

    width = 2 * band + 1
    ar = np.arange(width, dtype=np.int64)
    offs = ar - band  # diagonal offsets d = j - i

    # row i=0: D[0][j] = j  (j = d here)
    row = np.where(offs >= 0, offs, _BIG)
    if m - 0 < band:
        row[offs > m] = _BIG

    for i in range(1, n + 1):
        j = i + offs  # text positions covered by the band in this row
        valid = (j >= 0) & (j <= m)

        # diag: D[i-1][j-1] lives at the same offset index in the prior row
        cost = np.full(width, 1, dtype=np.int64)
        jj = j - 1
        ok = (jj >= 0) & (jj < m)
        cmp_idx = np.where(ok, jj, 0)
        cost[ok & (b[cmp_idx] == a[i - 1])] = 0
        diag = row + cost

        # up: D[i-1][j] lives at offset index +1 in the prior row
        up = np.concatenate([row[1:], [_BIG]])
        up = up + 1

        cand = np.minimum(diag, up)
        cand[~valid] = _BIG

        # left chain within the row (insertions into a): min-plus scan
        g = np.minimum.accumulate(cand - ar)
        new_row = np.minimum(cand, g + ar)
        new_row[~valid] = _BIG
        row = new_row

    d = m - n  # offset of (n, m)
    if abs(d) > band:
        return int(min(row.min() + 1, n + m))  # band overflow: lower bound-ish
    return int(row[d + band])


def fitting_edit_distance(a: bytes | np.ndarray, b: bytes | np.ndarray,
                          band: int | None = None) -> int:
    """Fitting-alignment distance: best Levenshtein distance of ``a`` against
    any substring of ``b`` (free end-gaps on ``b`` only).

    Consensus trims a corrected read to its covered window span
    (src/consensus.rs:90-101), so scoring against the *full* truth charges the
    trim as errors; the fitting distance scores only the aligned span.
    """
    a = np.frombuffer(a, dtype=np.uint8) if isinstance(a, (bytes, bytearray)) else a
    b = np.frombuffer(b, dtype=np.uint8) if isinstance(b, (bytes, bytearray)) else b
    n, m = len(a), len(b)
    if n == 0:
        return 0
    if m == 0:
        return n
    if band is None:
        band = abs(n - m) + max(32, (n + m) // 20)
    band = min(band, max(n, m))

    width = 2 * band + 1
    ar = np.arange(width, dtype=np.int64)
    offs = ar - band

    # free prefix of b: D[0][j] = 0
    row = np.where(offs >= 0, 0, _BIG).astype(np.int64)
    row[offs > m] = _BIG

    for i in range(1, n + 1):
        j = i + offs
        valid = (j >= 0) & (j <= m)

        cost = np.full(width, 1, dtype=np.int64)
        jj = j - 1
        ok = (jj >= 0) & (jj < m)
        cmp_idx = np.where(ok, jj, 0)
        cost[ok & (b[cmp_idx] == a[i - 1])] = 0
        diag = row + cost

        up = np.concatenate([row[1:], [_BIG]])
        up = up + 1

        cand = np.minimum(diag, up)
        cand[~valid] = _BIG

        g = np.minimum.accumulate(cand - ar)
        new_row = np.minimum(cand, g + ar)
        new_row[~valid] = _BIG
        row = new_row

    # free suffix of b: min over the last row
    return int(min(row.min(), n + m))


def infix_identity(corrected: bytes, truth: bytes, band: int | None = None) -> float:
    """1 - fitting_edit_distance / len(corrected): per-base identity of the
    corrected fragment over the truth span it actually covers."""
    if not corrected:
        return 0.0
    dist = fitting_edit_distance(corrected, truth, band)
    return max(0.0, 1.0 - dist / len(corrected))


def identity(corrected: bytes, truth: bytes, band: int | None = None) -> float:
    """1 - editdistance / len(truth)."""
    if not truth:
        return 0.0
    dist = banded_edit_distance(corrected, truth, band)
    return max(0.0, 1.0 - dist / len(truth))


def qscore(identity_value: float) -> float:
    err = max(1.0 - identity_value, 1e-9)
    return -10.0 * float(np.log10(err))
