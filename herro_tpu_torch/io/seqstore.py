"""2-bit packed sequence storage.

Same bit layout as the reference store (src/haec_io.rs:77-173): base ``i`` of a
read occupies bits ``2*(i % 32) .. 2*(i % 32)+1`` of the ``i // 32``-th little
endian u64 word, with A=0, C=1, G=2, T=3 (case-insensitive). Reverse
complement is decode-with-xor-3 over the reversed index range.

Unlike the reference (one heap Vec per read), all reads of a shard are packed
into a single contiguous ``uint64`` arena with an offsets table, so decodes
are pure vectorised gathers and the arena can be shared zero-copy between
feature-generation worker processes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_CODE_OF_BASE = np.zeros(256, dtype=np.uint8)
_CODE_OF_BASE[ord("A")] = 0
_CODE_OF_BASE[ord("C")] = 1
_CODE_OF_BASE[ord("G")] = 2
_CODE_OF_BASE[ord("T")] = 3
_CODE_OF_BASE[ord("a")] = 0
_CODE_OF_BASE[ord("c")] = 1
_CODE_OF_BASE[ord("g")] = 2
_CODE_OF_BASE[ord("t")] = 3

_BASE_OF_CODE = np.frombuffer(b"ACGT", dtype=np.uint8)

_SHIFTS = (2 * np.arange(32, dtype=np.uint64)).astype(np.uint64)


def encode(seq: bytes | np.ndarray) -> np.ndarray:
    """Pack an ASCII sequence into little-endian 2-bit words (uint64)."""
    raw = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    codes = _CODE_OF_BASE[raw].astype(np.uint64)
    n = codes.shape[0]
    n_words = (n + 31) // 32
    padded = np.zeros(n_words * 32, dtype=np.uint64)
    padded[:n] = codes
    return np.bitwise_or.reduce(
        padded.reshape(n_words, 32) << _SHIFTS[None, :], axis=1
    )


def decode(words: np.ndarray, start: int, end: int, rc: bool = False) -> np.ndarray:
    """Decode ``[start, end)`` back to ASCII bytes (uint8 array).

    With ``rc=True`` returns the reverse complement of that range
    (reference: src/haec_io.rs:138-173).
    """
    if start >= end:
        return np.empty(0, dtype=np.uint8)
    from .. import native

    if native.available():
        return native.decode_2bit(words, start, end, rc)
    idx = np.arange(start, end, dtype=np.int64)
    if rc:
        idx = idx[::-1]
    codes = (words[idx >> 5] >> ((idx.astype(np.uint64) << np.uint64(1)) & np.uint64(63))) & np.uint64(3)
    if rc:
        codes = codes ^ np.uint64(3)
    return _BASE_OF_CODE[codes.astype(np.intp)]


@dataclass
class PackedSeqs:
    """Arena of 2-bit packed sequences with per-read offsets.

    ``words`` is one flat uint64 buffer; read ``i`` occupies words
    ``word_offsets[i] : word_offsets[i+1]`` and has ``lengths[i]`` bases.
    """

    words: np.ndarray  # uint64 arena
    word_offsets: np.ndarray  # int64, len n_reads+1
    lengths: np.ndarray  # int64, len n_reads

    @classmethod
    def from_sequences(cls, seqs: list[bytes]) -> "PackedSeqs":
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        n_words = (lengths + 31) // 32
        word_offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(n_words, out=word_offsets[1:])
        arena = np.zeros(int(word_offsets[-1]), dtype=np.uint64)
        for i, s in enumerate(seqs):
            arena[word_offsets[i] : word_offsets[i + 1]] = encode(s)
        return cls(arena, word_offsets, lengths)

    def __len__(self) -> int:
        return self.lengths.shape[0]

    def length(self, rid: int) -> int:
        return int(self.lengths[rid])

    def get(self, rid: int, start: int = 0, end: int | None = None, rc: bool = False) -> np.ndarray:
        """ASCII bytes of read ``rid`` over ``[start, end)`` (RC if ``rc``)."""
        if end is None:
            end = int(self.lengths[rid])
        base = int(self.word_offsets[rid])
        words = self.words[base : int(self.word_offsets[rid + 1])]
        return decode(words, start, end, rc=rc)
