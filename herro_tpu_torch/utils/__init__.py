from .edist import banded_edit_distance, identity, qscore

__all__ = ["banded_edit_distance", "identity", "qscore"]
