from .model import (
    CONFIGS,
    CorrectionModel,
    ModelConfig,
    R9_CONFIG,
    R10_CONFIG,
    TINY_CONFIG,
)
from .checkpoint import load_model, load_or_init, params_from_jax, params_to_jax, save_model

__all__ = [
    "CONFIGS",
    "CorrectionModel",
    "ModelConfig",
    "R9_CONFIG",
    "R10_CONFIG",
    "TINY_CONFIG",
    "load_model",
    "load_or_init",
    "params_from_jax",
    "params_to_jax",
    "save_model",
]
