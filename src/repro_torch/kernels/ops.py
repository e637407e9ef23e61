"""Public entry points of the port's kernels (the counterpart of
`repro.kernels.ops`): `rmsnorm_op` is the pipelined variant, as there,
`rmsnorm_baseline_op` the baseline of the case study, `ssm_scan_op`
the selective scan (`ssm_scan_fused` its entry with the discretization
fused in), and `mlstm_chunkwise_op` / `slstm_scan_op` xLSTM's two
recurrences.

`launch_counts()` / `reset_launch_counts()` read and zero the wrappers'
launch counters, so a run can show that its path went through the kernels;
the reset also zeroes `flash_attention.body_launches`, the launches of each
of its two bodies.
"""
from __future__ import annotations

from typing import Dict

from .flash_attention import flash_attention, flash_attention_plain
from .mlstm_scan import mlstm_chunkwise, mlstm_chunkwise_plain
from .rmsnorm import rmsnorm_baseline, rmsnorm_pipelined, rmsnorm_plain
from .slstm_scan import slstm_scan, slstm_scan_plain
from .ssm_scan import (ssm_fused_plain, ssm_scan, ssm_scan_chunked,
                       ssm_scan_fused, ssm_scan_plain)

rmsnorm_op = rmsnorm_pipelined
rmsnorm_baseline_op = rmsnorm_baseline
ssm_scan_op = ssm_scan
mlstm_chunkwise_op = mlstm_chunkwise
slstm_scan_op = slstm_scan

KERNELS = {"flash_attention": flash_attention,
           "rmsnorm_pipelined": rmsnorm_pipelined,
           "rmsnorm_baseline": rmsnorm_baseline,
           "ssm_scan": ssm_scan,
           "ssm_scan_fused": ssm_scan_fused,
           "mlstm_chunkwise": mlstm_chunkwise,
           "slstm_scan": slstm_scan}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    flash_attention.body_launches = dict.fromkeys(
        flash_attention.body_launches, 0)


__all__ = [
    "KERNELS", "flash_attention", "flash_attention_plain", "launch_counts",
    "mlstm_chunkwise", "mlstm_chunkwise_op", "mlstm_chunkwise_plain",
    "reset_launch_counts", "rmsnorm_baseline", "rmsnorm_baseline_op",
    "rmsnorm_op", "rmsnorm_pipelined", "rmsnorm_plain", "slstm_scan",
    "slstm_scan_op", "slstm_scan_plain", "ssm_fused_plain", "ssm_scan",
    "ssm_scan_chunked", "ssm_scan_fused", "ssm_scan_op", "ssm_scan_plain",
]
