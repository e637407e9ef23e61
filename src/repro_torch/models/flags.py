"""Model-level switches of the port.

The port's counterpart of `repro.models.flags`.  It has one switch:

  force_plain : False — every CUDA tensor goes through the hand-written
                        kernels (flash attention and the selective scan in
                        prefill, RMSNorm at every norm);
                True  — the models take their plain PyTorch paths on the card
                        too.  It exists so `chip_smoke.py` can hold the kernel
                        path against the plain one on the same inputs; nothing
                        on the serving path sets it.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelFlags:
    force_plain: bool = False


_FLAGS = ModelFlags()


def get_flags() -> ModelFlags:
    return _FLAGS


@contextmanager
def flags(**kwargs):
    global _FLAGS
    prev = _FLAGS
    _FLAGS = replace(_FLAGS, **kwargs)
    try:
        yield _FLAGS
    finally:
        _FLAGS = prev
