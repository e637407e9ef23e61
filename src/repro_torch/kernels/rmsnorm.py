"""RMSNorm, two hand-written Hopper kernels and their plain version.

The CUDA source is `csrc/rmsnorm.cu`; both kernels compute
`x * rsqrt(mean(x^2) + eps) * scale` in f32, cast to x's dtype, and are the
two halves of the paper's baseline-vs-pipelined case study (section VI-D(b)):

* `rmsnorm_pipelined` replaces the Pallas TPU kernel `repro/kernels/
  rmsnorm.py::rmsnorm_pipelined` (body `_rmsnorm_pipelined_kernel`), the
  double-buffered variant with one completion counter per buffer: a block
  walks several row blocks of 8 rows through a 2-stage ring of `cp.async`
  groups in shared memory, so row block i+1 is in flight while row block i
  is reduced (f32, warp shuffles, one warp per row).
* `rmsnorm_baseline` replaces `repro/kernels/rmsnorm.py::rmsnorm_baseline`
  (body `_rmsnorm_kernel`): one block per 8-row block, one warp per row,
  each row loaded straight from device memory into registers, no `cp.async`
  and no ring.

Bound on the H100 for both: bytes, `(2*R*D + D)*itemsize` over 3.35 TB/s.
Each kernel reads each input byte once and writes each output byte once.

Each wrapper takes a CPU tensor to `rmsnorm_plain` and a CUDA tensor to its
kernel; on anything else, or on a CUDA input the kernel does not take, it
raises.  It never falls back.  `check_rmsnorm_pipelined` and
`check_rmsnorm_baseline` (also each wrapper's `check`) raise what the
wrappers raise for a CUDA input, and launch nothing.
"""
from __future__ import annotations

import functools

import torch

from . import _build

ROWS_PER_BLOCK = 8  # kRowsPerBlock in csrc/rmsnorm.cu
BASELINE_MAX_D = 32 * 64  # the baseline keeps a row in 64 registers a lane


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


def _check_cuda(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    if x.dtype not in _build.DTYPE_CODE or scale.dtype != x.dtype:
        raise ValueError(f"{name}: x {x.dtype}, scale {scale.dtype}; the "
                         f"kernel takes float32 or bfloat16, one dtype")
    if x.dim() != 2 or scale.shape != (x.shape[1],) or x.shape[0] < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be (R, D) and "
                         f"scale {tuple(scale.shape)} (D,)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def check_rmsnorm_pipelined(x: torch.Tensor, scale: torch.Tensor, *,
                            eps: float = 1e-5) -> None:
    _check_cuda("rmsnorm_pipelined", x, scale)
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"rmsnorm_pipelined: rows of {row_bytes} bytes; "
                         f"cp.async needs 16-byte multiples")
    if 2 * ROWS_PER_BLOCK * row_bytes > _build.MAX_SMEM:
        raise ValueError(f"rmsnorm_pipelined: D={x.shape[1]} too wide for "
                         f"the shared-memory ring")


def check_rmsnorm_baseline(x: torch.Tensor, scale: torch.Tensor, *,
                           eps: float = 1e-5) -> None:
    _check_cuda("rmsnorm_baseline", x, scale)
    if x.shape[1] > BASELINE_MAX_D:
        raise ValueError(f"rmsnorm_baseline: D={x.shape[1]} above "
                         f"{BASELINE_MAX_D}, the row a warp keeps in "
                         f"registers")


def rmsnorm_pipelined(x: torch.Tensor, scale: torch.Tensor, *,
                      eps: float = 1e-5) -> torch.Tensor:
    """x (R, D); scale (D,).  Returns (R, D) in x's dtype."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    lib = _build.library()
    check_rmsnorm_pipelined(x, scale)
    if x.data_ptr() % 16:
        raise ValueError(f"rmsnorm_pipelined: x at {x.data_ptr():#x}; "
                         f"cp.async needs 16-byte alignment")
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


def rmsnorm_baseline(x: torch.Tensor, scale: torch.Tensor, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """x (R, D) with D <= 2048; scale (D,).  Returns (R, D) in x's
    dtype."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    lib = _build.library()
    check_rmsnorm_baseline(x, scale)
    r, d = x.shape
    out = torch.empty_like(x)
    err = lib.repro_rmsnorm_baseline_fwd(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
        out.data_ptr(), r, d, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm_baseline")
    rmsnorm_baseline.launches += 1
    return out


rmsnorm_pipelined.launches = 0
rmsnorm_pipelined.check = check_rmsnorm_pipelined
rmsnorm_baseline.launches = 0
rmsnorm_baseline.check = check_rmsnorm_baseline
