from .ops import Cigar, parse_cigar, cigar_to_string, slice_lengths, window_accuracy, window_has_long_indel, M, I, D
from .windowing import OverlapWindow, extract_windows

__all__ = [
    "Cigar",
    "parse_cigar",
    "cigar_to_string",
    "slice_lengths",
    "window_accuracy",
    "window_has_long_indel",
    "M",
    "I",
    "D",
    "OverlapWindow",
    "extract_windows",
]
