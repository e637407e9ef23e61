"""Pipelined RMSNorm: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel `repro/kernels/rmsnorm.py::rmsnorm_pipelined`
(body `_rmsnorm_pipelined_kernel`), the double-buffered variant with one
completion counter per buffer that is the paper's split-wait-counter case
study.  The CUDA source is `csrc/rmsnorm.cu`: a block walks several row
blocks of 8 rows through a 2-stage ring of `cp.async` groups in shared
memory, so row block i+1 is in flight while row block i is reduced (f32,
warp shuffles, one warp per row).

Bound on the H100: bytes, `2*R*D*itemsize + D*itemsize` over 3.35 TB/s.
The kernel reads each input byte once and writes each output byte once.

`rmsnorm_pipelined` takes a CPU tensor to `rmsnorm_plain` and a CUDA tensor
to the kernel; on anything else, or on a CUDA input the kernel does not
take, it raises.  It never falls back.
"""
from __future__ import annotations

import functools

import torch

from . import _build

ROWS_PER_BLOCK = 8  # kRowsPerBlock in csrc/rmsnorm.cu


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """`x * rsqrt(mean(x^2) + eps) * scale` in f32, cast to x's dtype (the
    port of `kernels/ref.py::rmsnorm_ref`)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm_pipelined: x on {x.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    if x.dtype not in _build.DTYPE_CODE or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm_pipelined: x {x.dtype}, scale "
                         f"{scale.dtype}; the kernel takes float32 or "
                         f"bfloat16, one dtype")
    if x.dim() != 2 or scale.shape != (x.shape[1],) or x.shape[0] < 1:
        raise ValueError(f"rmsnorm_pipelined: x {tuple(x.shape)} must be "
                         f"(R, D) and scale {tuple(scale.shape)} (D,)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_pipelined: inputs must be contiguous")
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"rmsnorm_pipelined: rows of {row_bytes} bytes at "
                         f"{x.data_ptr():#x}; cp.async needs 16-byte "
                         f"multiples and alignment")
    if 2 * ROWS_PER_BLOCK * row_bytes > _build.MAX_SMEM:
        raise ValueError(f"rmsnorm_pipelined: D={x.shape[1]} too wide for "
                         f"the shared-memory ring")


def rmsnorm_pipelined(x: torch.Tensor, scale: torch.Tensor, *,
                      eps: float = 1e-5) -> torch.Tensor:
    """x (R, D); scale (D,).  Returns (R, D) in x's dtype."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    lib = _build.library()
    _check_cuda(x, scale)
    r, d = x.shape
    n_blocks = -(-r // ROWS_PER_BLOCK)
    # one block per SM, each walking several row blocks: what it walks is
    # what the ring overlaps
    grid = min(n_blocks, _sm_count(x.device.index))
    out = torch.empty_like(x)
    err = lib.repro_rmsnorm_pipelined_fwd(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
        out.data_ptr(), r, d, eps, grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm_pipelined")
    rmsnorm_pipelined.launches += 1
    return out


rmsnorm_pipelined.launches = 0
