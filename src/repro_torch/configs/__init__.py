"""Config registry: `get_config(name)` resolves an `--arch` id."""
from .base import (
    ArchConfig,
    DECODE_32K,
    LM_SHAPES,
    LONG_500K,
    PREFILL_32K,
    ShapeConfig,
    TRAIN_4K,
    model_flops,
    shapes_for,
    smoke_config,
)
from .lm_archs import ALL_ARCHS

CONFIGS = {c.name: c for c in ALL_ARCHS}
SHAPES = {s.name: s for s in LM_SHAPES}


def get_config(name: str) -> ArchConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")


__all__ = [
    "ArchConfig", "ShapeConfig", "CONFIGS", "SHAPES", "ALL_ARCHS",
    "get_config", "get_shape", "model_flops", "shapes_for", "smoke_config",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K", "LM_SHAPES",
]
