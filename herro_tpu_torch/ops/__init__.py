from .consensus import (
    DECISION_PAD,
    count_decisions,
    count_decisions_np,
    decode_window,
    stitch_read,
)

__all__ = [
    "DECISION_PAD",
    "count_decisions",
    "count_decisions_np",
    "decode_window",
    "stitch_read",
]
