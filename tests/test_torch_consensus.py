"""The port's consensus decoding held against herro_tpu.

The cases of tests/test_consensus.py run through the port's numpy twin and
its batched counting rule (the CPU plain version of kernel K5), and random
pileups give the same decisions as herro_tpu's ``count_decisions_np``. The
counting rule is integer logic: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from herro_tpu.constants import BASES_MAP
from herro_tpu.ops.consensus import count_decisions_np as ref_count_np
from herro_tpu.ops.consensus import stitch_read as ref_stitch
from herro_tpu_torch.ops.consensus import (
    count_decisions,
    count_decisions_np,
    decode_window,
    stitch_read,
)


def toks(s: bytes) -> np.ndarray:
    return BASES_MAP[np.frombuffer(s, dtype=np.uint8)]


def col(target: bytes, *rows: bytes) -> np.ndarray:
    """A [L, R] token window from per-read strings."""
    return np.stack([toks(target)] + [toks(r) for r in rows], axis=1).astype(np.uint8)


def batched(w: np.ndarray, n_alns: int) -> list[int]:
    """The device-layout rule ([B, R, L]) on one window, padded to 31 rows."""
    L, R = w.shape
    full = np.full((1, 31, L), 11, np.uint8)
    full[0, :R] = w.T
    out = count_decisions(torch.from_numpy(full), torch.tensor([n_alns], dtype=torch.int32))
    return out[0].tolist()


CASES = [
    # (window, n_alns, expected class)
    (col(b"A", b"C", b"C", b"C"), 3, 1),  # plurality overrides the target
    (col(b"A", b"C"), 1, 0),  # top count < 2 keeps the target
    (col(b"A", b"a", b"C", b"c"), 3, 0),  # a tie involving the target keeps it
    (col(b"G", b"A", b"a", b"C", b"c"), 4, 0),  # tie without target: smaller idx
    # dots excluded, case folded: A1 *2 T2 -> T (3) and * tie, target not in
    # the top two -> plurality T
    (col(b"A", b".", b"#", b"*", b"t", b"T"), 5, 3),
    # rows past n_alns do not count
    (col(b"A", b"C", b"C", b"C"), 1, 0),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_counting_rule_cases(case):
    w, n_alns, expected = CASES[case]
    assert count_decisions_np(w, n_alns).tolist() == [expected]
    assert batched(w, n_alns) == [expected]
    assert ref_count_np(w, n_alns).tolist() == [expected]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_tokens_match_reference_np(seed):
    rng = np.random.default_rng(seed)
    B, L, R = 4, 57, 31
    tokens = rng.integers(0, 12, size=(B, L, R)).astype(np.uint8)
    tokens[:, :, 0] = rng.integers(0, 5, size=(B, L))
    n_alns = rng.integers(0, 31, size=B).astype(np.int32)
    out = count_decisions(
        torch.from_numpy(np.ascontiguousarray(tokens.transpose(0, 2, 1))),
        torch.from_numpy(n_alns),
    ).numpy()
    for b in range(B):
        ref = ref_count_np(tokens[b], int(n_alns[b]))
        np.testing.assert_array_equal(out[b], ref)
        np.testing.assert_array_equal(count_decisions_np(tokens[b], int(n_alns[b])), ref)


def test_decode_window_drops_gaps_and_padding():
    d = np.array([0, 4, 1, 2, 255, 4, 3], dtype=np.uint8)
    assert decode_window(d) == b"ACGT"


def test_stitch_read_trims_and_splits():
    d1 = np.array([0, 1], dtype=np.uint8)
    d2 = np.array([2, 3], dtype=np.uint8)
    windows = [
        (0, np.array([], dtype=np.uint8)),
        (3, d1),
        (1, np.array([0], dtype=np.uint8)),
        (3, d2),
        (0, np.array([], dtype=np.uint8)),
    ]
    assert stitch_read(windows) == [b"AC", b"GT"] == ref_stitch(windows)


def test_stitch_read_no_coverage():
    assert stitch_read([(1, np.array([0], dtype=np.uint8))]) is None
