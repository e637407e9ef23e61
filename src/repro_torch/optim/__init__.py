"""Optimizer of the port (the counterpart of `repro.optim`): AdamW with f32
master weights, learning-rate schedules, gradient clipping, micro-batch
accumulation and error-feedback int8 compression."""
from .adamw import AdamWConfig, adamw_init, adamw_update
from .grad import GradAccumulator, clip_by_global_norm, compress_gradients
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
    "linear_warmup_cosine", "clip_by_global_norm", "GradAccumulator",
    "compress_gradients",
]
