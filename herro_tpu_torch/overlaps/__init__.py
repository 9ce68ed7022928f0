from .paf import Alignment, parse_paf, STRAND_FWD, STRAND_REV
from .batches import BatchWriter, list_batches, read_batch
from .mm2 import minimap2_available, overlap_batches, run_minimap2

__all__ = [
    "Alignment",
    "parse_paf",
    "STRAND_FWD",
    "STRAND_REV",
    "BatchWriter",
    "list_batches",
    "read_batch",
    "minimap2_available",
    "overlap_batches",
    "run_minimap2",
]
