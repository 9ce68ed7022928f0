from .extract import WindowFeatures, extract_read_features
from .pileup import (
    fill_window_pileup,
    get_supported,
    window_max_ins,
    window_slice_arrays,
)

__all__ = [
    "WindowFeatures",
    "extract_read_features",
    "fill_window_pileup",
    "get_supported",
    "window_max_ins",
    "window_slice_arrays",
]
