"""Checkpoint manager: async writes, rotation, latest-pointer resume (the
port of `repro.checkpoint.manager`)."""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional, Tuple

import torch

from .checkpointer import (
    _flatten,
    _unflatten,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)


class CheckpointManager:
    """Keep-K rotating checkpoints with optional async (background) saves.

    Async saves snapshot the state on the caller's thread (a host copy of
    every leaf) and write on a worker thread so the train loop only blocks
    for the host copy, not the disk write — `wait()` joins before
    exit/restore.
    """

    def __init__(self, directory: str, keep: int = 3,
                 async_saves: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_saves = async_saves
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state) -> None:
        self.wait()
        if self.async_saves:
            # a host copy of every leaf: `.cpu()` of a CPU tensor is the
            # tensor itself, and the train step updates its state in place
            snapshot = _unflatten(state, {
                k: torch.as_tensor(v).detach().to("cpu", copy=True)
                for k, v in _flatten(state)})

            def work():
                try:
                    save_checkpoint(self.directory, step, snapshot)
                    self._rotate()
                except BaseException as e:  # noqa: BLE001
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.directory, step, state)
            self._rotate()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _rotate(self) -> None:
        ckpts = list_checkpoints(self.directory)
        for old in ckpts[: max(0, len(ckpts) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, old),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    def restore_latest(self, like, device=None) -> Tuple[Any, int]:
        self.wait()
        return restore_checkpoint(self.directory, like, device=device)

    def has_checkpoint(self) -> bool:
        return bool(list_checkpoints(self.directory))
