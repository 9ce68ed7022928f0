from .batching import Batch, BucketBatcher, BucketSpec, WindowTensors, collate, tensorize
from .engine import AlnMode, ConsensusAccumulator, alignment_stream, run_correction
from .infer import CorrectionRunner, WindowResult, make_correct_step

__all__ = [
    "Batch",
    "BucketBatcher",
    "BucketSpec",
    "WindowTensors",
    "collate",
    "tensorize",
    "AlnMode",
    "ConsensusAccumulator",
    "alignment_stream",
    "run_correction",
    "CorrectionRunner",
    "WindowResult",
    "make_correct_step",
]
