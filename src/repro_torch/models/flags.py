"""Model-level switches of the port.

The port's counterpart of `repro.models.flags`.  Four switches:

  attention_impl : "kernel" — CUDA tensors go through the flash-attention
                              kernel (K1) in prefill and the loss;
                   "plain"  — they go through `chunked_attention`, the
                              online softmax in PyTorch ops, whose state
                              round-trips device memory per key block.
                   The counterpart of the reference's `attention_impl`
                   ("xla" -> "plain", "pallas_fused" -> "kernel"): the switch
                   the LEO loop flips after the diagnosis implicates the
                   attention accumulator traffic.
  ssm_fused      : False — the SSM mixer discretizes a and bx for the whole
                           sequence, (B, S, din, N) f32 each, and CUDA
                           tensors go through the selective scan's entry
                           `ssm_scan` (K4) on them;
                   True  — it discretizes per chunk of 128 inside the scan,
                           as the reference's `chunk_step` does, so a and bx
                           exist only as (B, 128, din, N) transients.  CUDA
                           tensors then run the chunked form in PyTorch ops
                           (`ssm_fused_plain`), an explicit variant as
                           attention_impl="plain" is, and no fallback.
  ssm_pallas     : False — as above;
                   True  — under ssm_fused, CUDA tensors go through K4's
                           fused entry `ssm_scan_fused`: discretization and
                           scan in one kernel, xin in and y out.  As in the
                           reference, it acts only inside the fused branch
                           (`repro/models/ssm.py:84` sits under `:69`).
  force_plain    : False — every CUDA tensor goes through the hand-written
                           kernels (flash attention under
                           attention_impl="kernel", the selective scan as
                           ssm_fused and ssm_pallas choose and both xLSTM
                           recurrences in prefill, RMSNorm at every norm);
                   True  — the models take their plain PyTorch paths on the
                           card too, whatever attention_impl says.  It exists
                           so `chip_smoke.py` can hold the kernel path against
                           the plain one on the same inputs; nothing on the
                           serving path sets it.

The reference's `mlstm_pallas` marks both xLSTM mixers' regions, the sLSTM
scan's too (`repro/models/xlstm.py:208`); here both mixers take their
kernels on CUDA tensors unless `force_plain` says otherwise, so the one
switch governs both, as there.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace


ATTENTION_IMPLS = ("kernel", "plain")


@dataclass(frozen=True)
class ModelFlags:
    attention_impl: str = "kernel"
    ssm_fused: bool = False
    ssm_pallas: bool = False
    force_plain: bool = False

    def __post_init__(self) -> None:
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")


_FLAGS = ModelFlags()


def get_flags() -> ModelFlags:
    return _FLAGS


def set_flags(**kwargs) -> ModelFlags:
    global _FLAGS
    _FLAGS = replace(_FLAGS, **kwargs)
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
