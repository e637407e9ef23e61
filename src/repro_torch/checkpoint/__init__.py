"""Checkpoints of the port, byte-compatible with `repro.checkpoint`."""
from .checkpointer import restore_checkpoint, save_checkpoint, list_checkpoints
from .manager import CheckpointManager

__all__ = ["CheckpointManager", "list_checkpoints", "restore_checkpoint",
           "save_checkpoint"]
