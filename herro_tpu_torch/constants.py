"""Global constants shared across the herro_tpu_torch framework.

These mirror the observable constants of the reference pipeline so that
features / model inputs / consensus decisions are bit-compatible where it
matters (reference: src/lib.rs:39-42, src/features.rs:22, src/inference.rs:15-31).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Pipeline-level constants (reference: src/lib.rs:39-42)
# ---------------------------------------------------------------------------
READS_BATCH_SIZE = 50_000
ALN_CHANNEL_CAPACITY = 50_000
INFER_CHANNEL_CAP_FACTOR = 2
DEFAULT_WINDOW_SIZE = 4096

# Number of highest-ranked query rows kept per pileup window
# (reference: src/features.rs:22).
TOP_K = 30
N_ROWS = TOP_K + 1  # target row + TOP_K query rows

# Overlap windows containing an indel longer than this are dropped
# (reference: src/features.rs:315-324).
MAX_INDEL_LEN = 50

# ---------------------------------------------------------------------------
# Pileup byte alphabet (reference: src/features.rs:24-42)
#
# Forward-strand query bases are uppercase with gap '*'; reverse-strand query
# bases are reverse-complemented, lowercased, with gap '#'. Columns where the
# query has no alignment are '.' and their qual is '!'.
# ---------------------------------------------------------------------------
GAP_FWD = ord("*")
GAP_REV = ord("#")
NO_ALN = ord(".")
NO_ALN_QUAL = ord("!")

# Map any pileup byte to its case-folded forward-strand symbol
# ('#'->'*', lowercase->uppercase); used for supported-position counting
# (reference: src/features.rs:34-42).
BASE_FORWARD = np.full(128, 255, dtype=np.uint8)
for _fwd, _rev in zip(b"ACGT*", b"acgt#"):
    BASE_FORWARD[_fwd] = _fwd
    BASE_FORWARD[_rev] = _fwd

# Lowercase complement table used when writing reverse-strand rows.
BASE_LOWER = np.full(128, 255, dtype=np.uint8)
for _u, _l in zip(b"ACGT", b"acgt"):
    BASE_LOWER[_u] = _l
    BASE_LOWER[_l] = _l

# ---------------------------------------------------------------------------
# Model input vocabulary (reference: src/inference.rs:23-31)
#   A C G T * a c g t # .  ->  0..10, padding = 11
# ---------------------------------------------------------------------------
TOKEN_PAD = 11
VOCAB_SIZE = 12

TOKENS = b"ACGT*acgt#."
BASES_MAP = np.full(128, 255, dtype=np.uint8)
for _i, _b in enumerate(TOKENS):
    BASES_MAP[_b] = _i

# token id -> case-folded consensus class {A,C,G,T,*} = {0,1,2,3,4}
# (reference: src/consensus.rs:18-19). Token 10 ('.') and 11 (pad) are
# excluded from counting; value 5 marks them invalid.
TOKEN_TO_CLASS = np.array([0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 5], dtype=np.uint8)
CLASS_TO_BASE = b"ACGT*"

# ---------------------------------------------------------------------------
# Quality normalisation (reference: src/inference.rs:15-21)
#   phred+33 byte in [33, 126]  ->  float in [-1, 1]
# ---------------------------------------------------------------------------
QUAL_MIN_VAL = 33.0
QUAL_MAX_VAL = 126.0
QUAL_SCALE = 2.0 / (QUAL_MAX_VAL - QUAL_MIN_VAL)
QUAL_OFFSET = 2.0 * QUAL_MIN_VAL / (QUAL_MAX_VAL - QUAL_MIN_VAL) + 1.0
QUAL_PAD = int(QUAL_MAX_VAL)  # padding value before normalisation

# ---------------------------------------------------------------------------
# minimap2 all-vs-all preset (reference: src/mm2.rs:15-37)
# ---------------------------------------------------------------------------
MM2_ARGS = [
    "-K8g",
    "-cx",
    "ava-ont",
    "-k25",
    "-w17",
    "-e200",
    "-r150",
    "-m2500",
    "-f0.005",
    "-z200",
    "--dual=yes",
]
