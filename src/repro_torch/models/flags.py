"""Model-level switches of the port.

The port's counterpart of `repro.models.flags`.  Seven switches:

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
  sequence_parallel : False — as the reference's: between blocks the
                           residual stream is constrained sequence-sharded
                           over the current mesh's "model" axis
                           (`transformer.py::_sp_constraint`).  On a mesh
                           whose "model" axis is 1, the card's own, the
                           constraint is the identity, as the reference's is
                           on one device; in the per-device program of a
                           larger mesh (`parallel/spmd.py`) the stream is
                           cut along the sequence over "model"; a mesh
                           with no devices behind it, or a larger mesh
                           outside its per-device program, raises.
  moe_impl       : "global"      — every token of the batch routed together
                                   (`moe.py::moe_forward`);
                   "ep_shardmap" — the reference's expert-parallel form:
                                   each shard of the current mesh routes its
                                   own tokens and exchanges them with the
                                   expert shards by two all-to-alls
                                   (`moe.py::moe_forward_ep`).  Off a mesh,
                                   or where the "model" axis does not divide
                                   the experts, it falls back to "global",
                                   as the reference does.
  fsdp_threshold_mb : 128 — the per-shard size above which
                           `parallel/sharding.py` shards a weight over the
                           data axes (auto-FSDP), as the reference's.
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
MOE_IMPLS = ("global", "ep_shardmap")


@dataclass(frozen=True)
class ModelFlags:
    attention_impl: str = "kernel"
    ssm_fused: bool = False
    ssm_pallas: bool = False
    sequence_parallel: bool = False
    moe_impl: str = "global"
    fsdp_threshold_mb: int = 128
    force_plain: bool = False

    def __post_init__(self) -> None:
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r} not in "
                             f"{MOE_IMPLS}")


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
