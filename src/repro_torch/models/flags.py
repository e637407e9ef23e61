"""Model-level switches of the port.

The port's counterpart of `repro.models.flags`.  Two switches:

  attention_impl : "kernel" — CUDA tensors go through the flash-attention
                              kernel (K1) in prefill and the loss;
                   "plain"  — they go through `chunked_attention`, the
                              online softmax in PyTorch ops, whose state
                              round-trips device memory per key block.
                   The counterpart of the reference's `attention_impl`
                   ("xla" -> "plain", "pallas_fused" -> "kernel"): the switch
                   the LEO loop flips after the diagnosis implicates the
                   attention accumulator traffic.
  force_plain    : False — every CUDA tensor goes through the hand-written
                           kernels (flash attention under
                           attention_impl="kernel", the selective scan in
                           prefill, RMSNorm at every norm);
                   True  — the models take their plain PyTorch paths on the
                           card too, whatever attention_impl says.  It exists
                           so `chip_smoke.py` can hold the kernel path against
                           the plain one on the same inputs; nothing on the
                           serving path sets it.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace


ATTENTION_IMPLS = ("kernel", "plain")


@dataclass(frozen=True)
class ModelFlags:
    attention_impl: str = "kernel"
    force_plain: bool = False

    def __post_init__(self) -> None:
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")


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
