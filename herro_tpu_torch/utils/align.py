"""Truth-mapping alignment for evaluation.

Aligns a corrected fragment against its read's ground-truth sequence (banded
fitting alignment, free end-gaps on the truth) *with traceback*, producing a
per-truth-position view of the corrected output:

* ``b2a[j]``      — the corrected byte aligned to truth position ``j``
                    (255 = the truth base was deleted, 254 = outside the
                    aligned span);
* ``ins_after[j]`` — corrected bases inserted between truth ``j-1`` and ``j``;
* per-span (match, sub, ins, del) counts.

This powers the eval metrics the reference cannot produce locally (it
publishes quality only as downstream assembly stats, SURVEY.md §6): het-site
allele preservation and homopolymer-indel accuracy.

The band follows one diagonal; the start diagonal is estimated by exact
k-mer seeding (several k-mers of the fragment voted against a truth k-mer
index), so fragments from anywhere in a split read locate correctly. The
native kernel (ht_fit_align) does the DP; a vectorised numpy twin backs the
no-native path and the parity tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BIG = np.int64(1) << 40


@dataclass
class TruthAlignment:
    distance: int
    b2a: np.ndarray  # uint8 [m], 255 = deleted, 254 = outside span
    ins_after: np.ndarray  # int32 [m+1]
    j0: int  # aligned truth span start
    j1: int  # aligned truth span end (exclusive)
    matches: int
    subs: int
    ins: int
    dels: int

    @property
    def span_len(self) -> int:
        return self.j1 - self.j0

    def errors_at(self) -> np.ndarray:
        """bool [m]: truth position substituted or deleted (within the span)."""
        err = np.zeros(self.b2a.shape[0], dtype=bool)
        sl = slice(self.j0, self.j1)
        truth = self._truth
        err[sl] = (self.b2a[sl] != truth[sl])
        return err

    _truth: np.ndarray = None  # set by align_to_truth


def _fit_align_np(
    a: np.ndarray, b: np.ndarray, diag0: int, band: int
) -> tuple | None:
    """Numpy twin of the native ht_fit_align (same outputs)."""
    n, m = a.shape[0], b.shape[0]
    width = 2 * band + 1
    ar = np.arange(width, dtype=np.int64)

    j_row0 = diag0 + (ar - band)
    row = np.where((j_row0 >= 0) & (j_row0 <= m), 0, _BIG)
    tb = np.full((n + 1, width), 3, dtype=np.uint8)

    for i in range(1, n + 1):
        j = diag0 + i + (ar - band)
        valid = (j >= 0) & (j <= m)

        jj = j - 1
        ok = (jj >= 0) & (jj < m)
        cmp_idx = np.where(ok, jj, 0)
        cost = np.where(ok & (b[cmp_idx] == a[i - 1]), 0, 1)
        diag = np.where(ok, row + cost, _BIG)

        up = np.concatenate([row[1:], [_BIG]]) + 1

        cand = np.minimum(diag, up)
        move = np.where(diag <= up, 0, 1).astype(np.uint8)
        cand = np.where(valid, cand, _BIG)

        # left chain within the row: min-plus prefix scan
        g = np.minimum.accumulate(cand - ar)
        new_row = np.minimum(cand, g + ar)
        is_left = new_row < cand
        move = np.where(is_left, 2, move)
        new_row = np.where(valid, new_row, _BIG)
        move[~valid] = 3
        tb[i] = move
        row = new_row

    j_last = diag0 + n + (ar - band)
    row_m = np.where((j_last >= 0) & (j_last <= m), row, _BIG)
    bestk = int(np.argmin(row_m))
    best = int(row_m[bestk])
    if best >= int(_BIG):
        return None

    b2a = np.full(m, 254, dtype=np.uint8)
    ins_after = np.zeros(m + 1, dtype=np.int32)
    i, k = n, bestk
    j1 = diag0 + n + (bestk - band)
    mt = sb = ins = dl = 0
    while i > 0:
        j = diag0 + i + (k - band)
        move = tb[i, k]
        if move == 0:
            b2a[j - 1] = a[i - 1]
            if a[i - 1] == b[j - 1]:
                mt += 1
            else:
                sb += 1
            i -= 1
        elif move == 1:
            ins_after[j] += 1
            ins += 1
            i -= 1
            k += 1
        elif move == 2:
            b2a[j - 1] = 255
            dl += 1
            k -= 1
        else:
            break
    j0 = diag0 + i + (k - band)
    counts = np.array([mt, sb, ins, dl], dtype=np.int64)
    return best, b2a, ins_after, (int(j0), int(j1)), counts


def estimate_diagonal(a: np.ndarray, b: np.ndarray, k: int = 24) -> int | None:
    """Median (j - i) diagonal of exact k-mer hits of ``a`` in ``b``."""
    n, m = a.shape[0], b.shape[0]
    if n < k or m < k:
        return 0
    index: dict[bytes, int] = {}
    bb = b.tobytes()
    for j in range(0, m - k + 1, 1):
        kmer = bb[j : j + k]
        # first occurrence wins; collisions are rare on random-ish genomes
        if kmer not in index:
            index[kmer] = j
    ab = a.tobytes()
    diags = []
    step = max(1, n // 64)
    for i in range(0, n - k + 1, step):
        j = index.get(ab[i : i + k])
        if j is not None:
            diags.append(j - i)
    if not diags:
        return None
    return int(np.median(diags))


def align_to_truth(
    corrected: bytes | np.ndarray,
    truth: bytes | np.ndarray,
    band: int | None = None,
) -> TruthAlignment | None:
    """Banded fitting alignment of a corrected fragment to the truth.

    Seeds the diagonal with exact k-mer votes, then runs the banded DP,
    doubling the band (up to the sequence length) if the alignment quality
    suggests band overflow. Returns None when no alignment is found.
    """
    from .. import native

    a = (
        np.frombuffer(corrected, dtype=np.uint8)
        if isinstance(corrected, (bytes, bytearray))
        else corrected
    )
    b = (
        np.frombuffer(truth, dtype=np.uint8)
        if isinstance(truth, (bytes, bytearray))
        else truth
    )
    n, m = a.shape[0], b.shape[0]
    if n == 0 or m == 0:
        return None

    diag0 = estimate_diagonal(a, b)
    if diag0 is None:
        return None

    band = band or max(96, abs(m - n) // 8 + n // 50)
    kernel = native.fit_align if native.available() else _fit_align_np
    while True:
        res = kernel(a, b, diag0, band)
        if res is not None:
            dist = res[0]
            # a plausible corrected fragment aligns at >75% identity; a path
            # worse than that usually means the optimum left the band
            if dist <= 0.25 * n or band >= max(n, m):
                break
        if band >= max(n, m):
            return None
        band = min(2 * band, max(n, m))
    dist, b2a, ins_after, (j0, j1), counts = res
    ta = TruthAlignment(
        distance=int(dist),
        b2a=b2a,
        ins_after=ins_after,
        j0=j0,
        j1=j1,
        matches=int(counts[0]),
        subs=int(counts[1]),
        ins=int(counts[2]),
        dels=int(counts[3]),
    )
    ta._truth = b
    return ta
