"""Public entry points of the port's kernels (the counterpart of
`repro.kernels.ops`): `rmsnorm_op` is the pipelined variant, as there, and
`ssm_scan_op` the selective scan.

`launch_counts()` / `reset_launch_counts()` read and zero the wrappers'
launch counters, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from .flash_attention import flash_attention, flash_attention_plain
from .rmsnorm import rmsnorm_pipelined, rmsnorm_plain
from .ssm_scan import ssm_scan, ssm_scan_plain

rmsnorm_op = rmsnorm_pipelined
ssm_scan_op = ssm_scan

KERNELS = {"flash_attention": flash_attention,
           "rmsnorm_pipelined": rmsnorm_pipelined,
           "ssm_scan": ssm_scan}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS", "flash_attention", "flash_attention_plain", "launch_counts",
    "reset_launch_counts", "rmsnorm_op", "rmsnorm_pipelined", "rmsnorm_plain",
    "ssm_scan", "ssm_scan_op", "ssm_scan_plain",
]
