"""Data of the port (the counterpart of `repro.data`): the deterministic
synthetic token stream, a copy of the reference's numpy module, and the
prefetching pipeline that hands its batches to the card."""
from .pipeline import DataPipeline
from .synthetic import SyntheticConfig, SyntheticTokenDataset

__all__ = ["DataPipeline", "SyntheticConfig", "SyntheticTokenDataset"]
