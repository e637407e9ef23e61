"""RMSNorm, two hand-written Hopper kernels and their plain version.

The CUDA source is `csrc/rmsnorm.cu`; both kernels compute
`x * rsqrt(mean(x^2) + eps) * scale` in f32, cast to x's dtype, are the
two halves of the paper's baseline-vs-pipelined case study (section VI-D(b)),
and return the same bits on every input both take (one per-lane order of
the sum of squares, one shuffle tree).  Both move 16-byte vectors: a row is
cut into 16-byte chunks, lane l of the row's warp takes chunks l, l + 32,
..., and holds them in registers (`lane_chunks` of them, an instantiation
of the kernel; a wider row is read twice).

* `rmsnorm_pipelined` replaces the Pallas TPU kernel `repro/kernels/
  rmsnorm.py::rmsnorm_pipelined` (body `_rmsnorm_pipelined_kernel`), the
  double-buffered variant with one completion counter per buffer: a block
  walks row blocks of `stage_rows` rows through a 2-stage ring of
  `cp.async` groups in shared memory, so row block i+1 is in flight while
  row block i is reduced; scale is held for the whole block, in registers
  up to HOLD_CHUNKS chunks a lane, beyond in shared memory beside the ring
  where it fits (`staged_scale`), else read as the row is scaled.
  It is launched with as many blocks as reside on the card at once
  (`ring_plan`, `ring_grid`).  Rows must be 16-byte multiples, x and
  scale 16-byte aligned.
* `rmsnorm_baseline` replaces `repro/kernels/rmsnorm.py::rmsnorm_baseline`
  (body `_rmsnorm_kernel`): blocks of `BASE_ROWS` rows, each row loaded
  straight from device memory into registers with scale beside it, no
  `cp.async` and no ring.  It takes any width and alignment: `vectors`
  says whether a call takes the 16-byte instantiation or the one that
  moves one value at a time.

Bound on the H100 for both: bytes, `(2*R*D + D)*itemsize` over 3.35 TB/s.
Each kernel reads each input byte once and writes each output byte once
(a row read twice is read from shared memory by the pipelined kernel).

Each wrapper takes a CPU tensor to `rmsnorm_plain` and a CUDA tensor to its
kernel; on anything else, or on a CUDA input the kernel does not take, it
raises.  It never falls back.  `check_rmsnorm_pipelined` and
`check_rmsnorm_baseline` (also each wrapper's `check`) raise what the
wrappers raise for a CUDA input, and launch nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

# kMaxRows in csrc/rmsnorm.cu: the most rows a stage of the pipelined ring
# (a warp a row); the wrapper takes this many where two stages fit.
ROWS_PER_STAGE = 8
BASE_ROWS = 4  # kBaseRows: rows (warps) a block of the baseline kernel
# A call of few rows spreads over at least this many blocks: a stage holds
# at most ceil(R / SPREAD) rows.
SPREAD = 4
# The instantiations of CHUNKS in csrc/rmsnorm.cu (`by_chunks`): 16-byte
# chunks a lane holds in registers.  A row of more takes CHUNKS = 0 and is
# read twice.  Up to HOLD_CHUNKS (`kHoldScale`) a lane also holds scale's.
LANE_CHUNKS = (1, 2, 3, 4, 7, 8, 13, 16, 32)
HOLD_CHUNKS = 16


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """`x * rsqrt(mean(x^2) + eps) * scale` in f32, cast to x's dtype (the
    port of `kernels/ref.py::rmsnorm_ref`)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def lane_chunks(d: int, itemsize: int) -> int:
    """The instantiation a row of `d` values takes: the fewest 16-byte
    chunks a lane of LANE_CHUNKS that hold its share of the row, or 0
    (read twice)."""
    chunks = -(-d * itemsize // 16)  # a row's
    need = -(-chunks // 32)  # a lane's
    return next((c for c in LANE_CHUNKS if c >= need), 0)


def vectors(row_bytes: int, x_addr: int, scale_addr: int) -> bool:
    """Whether the baseline kernel takes its 16-byte instantiation: rows of
    16-byte multiples, x and scale on 16-byte boundaries (out is a fresh
    allocation, always aligned)."""
    return not (row_bytes % 16 or (x_addr | scale_addr) % 16)


@functools.lru_cache(maxsize=None)
def staged_scale(d: int, itemsize: int) -> bool:
    """Whether the pipelined kernel copies scale into shared memory beside
    its ring: where a lane does not hold scale's chunks (more than
    HOLD_CHUNKS a lane) and scale fits beside two stages of one row.  (On
    an H100, scale read from device memory as the row is scaled cost 5-9%
    at f32 R 4096, D 3840 and 4096: a ring of 213-229 KB leaves the SM
    little L1.)"""
    return not 0 < lane_chunks(d, itemsize) <= HOLD_CHUNKS and \
        3 * d * itemsize <= _build.MAX_SMEM


@functools.lru_cache(maxsize=None)
def ring_rows(d: int, itemsize: int) -> int:
    """The most rows a stage of the pipelined ring: ROWS_PER_STAGE, or as
    many as let both stages (and scale, where staged) fit in shared memory;
    0 when not even one row a stage does."""
    row = d * itemsize
    fixed = row if staged_scale(d, itemsize) else 0
    return min(ROWS_PER_STAGE, (_build.MAX_SMEM - fixed) // (2 * row))


def stage_rows(r: int, d: int, itemsize: int) -> int:
    """Rows a stage for a call of `r` rows: `ring_rows`, but no more than
    spread the call over SPREAD blocks (a decode tick's 8 rows take 4
    blocks of 2, not one of 8)."""
    return min(ring_rows(d, itemsize), -(-r // SPREAD))


def ring_grid(r: int, rows: int, resident: int) -> int:
    """Blocks of a pipelined launch: one a row block, but no more than
    `resident` (the blocks the card holds at once); each then walks
    further row blocks through its ring."""
    return min(-(-r // rows), resident)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def ring_plan(dtype: torch.dtype, d: int, device_index: int,
              rows: int) -> Tuple[int, int]:
    """(lane chunks, blocks resident on the card) of the pipelined kernel
    for rows of `d` values, `rows` a stage: the residency is the CUDA
    occupancy calculator's for that instantiation, block size and shared
    memory, times the SMs."""
    chunks = lane_chunks(d, dtype.itemsize)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().repro_rmsnorm_pipelined_occupancy(
            _build.DTYPE_CODE[dtype], d, chunks, rows,
            staged_scale(d, dtype.itemsize), ctypes.byref(per_sm))
    _build.check(err, "rmsnorm_pipelined occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"rmsnorm_pipelined: no block of {rows} rows of "
                           f"{d} values fits an SM")
    return chunks, per_sm.value * _sm_count(device_index)


def _check_cuda(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    _build.check_no_grad(name, x, scale)
    if not x.is_cuda or scale.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    if x.dtype not in _build.DTYPE_CODE or scale.dtype != x.dtype:
        raise ValueError(f"{name}: x {x.dtype}, scale {scale.dtype}; the "
                         f"kernel takes float32 or bfloat16, one dtype")
    shape = x.shape
    if len(shape) != 2 or scale.shape != shape[1:] or shape[0] < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be (R, D) and "
                         f"scale {tuple(scale.shape)} (D,)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def check_rmsnorm_pipelined(x: torch.Tensor, scale: torch.Tensor, *,
                            eps: float = 1e-5) -> None:
    _check_cuda("rmsnorm_pipelined", x, scale)
    itemsize = x.element_size()
    row_bytes = x.shape[1] * itemsize
    if row_bytes % 16:
        raise ValueError(f"rmsnorm_pipelined: rows of {row_bytes} bytes; "
                         f"cp.async needs 16-byte multiples")
    if (x.storage_offset() * itemsize | scale.storage_offset() * itemsize) \
            % 16:
        raise ValueError("rmsnorm_pipelined: x or scale starts off a "
                         "16-byte boundary; cp.async needs 16-byte alignment")
    if ring_rows(x.shape[1], itemsize) < 1:
        raise ValueError(f"rmsnorm_pipelined: D={x.shape[1]} too wide for "
                         f"the shared-memory ring (two rows, "
                         f"{2 * row_bytes} bytes, above {_build.MAX_SMEM})")


def check_rmsnorm_baseline(x: torch.Tensor, scale: torch.Tensor, *,
                           eps: float = 1e-5) -> None:
    _check_cuda("rmsnorm_baseline", x, scale)


def rmsnorm_pipelined(x: torch.Tensor, scale: torch.Tensor, *,
                      eps: float = 1e-5) -> torch.Tensor:
    """x (R, D); scale (D,).  Returns (R, D) in x's dtype."""
    if x.is_cpu and scale.is_cpu:
        return rmsnorm_plain(x, scale, eps=eps)
    lib = _build.library()
    check_rmsnorm_pipelined(x, scale)
    xp, sp = x.data_ptr(), scale.data_ptr()
    if (xp | sp) % 16:
        raise ValueError(f"rmsnorm_pipelined: x at {xp:#x}, scale at "
                         f"{sp:#x}; cp.async needs 16-byte alignment")
    r, d = x.shape
    itemsize = x.element_size()
    rows = stage_rows(r, d, itemsize)
    chunks, resident = ring_plan(x.dtype, d, x.get_device(), rows)
    out = torch.empty_like(x)
    err = lib.repro_rmsnorm_pipelined_fwd(
        _build.DTYPE_CODE[x.dtype], xp, sp, out.data_ptr(), r, d, eps,
        chunks, rows, staged_scale(d, itemsize),
        ring_grid(r, rows, resident), _build.current_stream(x))
    _build.check(err, "rmsnorm_pipelined")
    rmsnorm_pipelined.launches += 1
    return out


def rmsnorm_baseline(x: torch.Tensor, scale: torch.Tensor, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """x (R, D); scale (D,).  Returns (R, D) in x's dtype."""
    if x.is_cpu and scale.is_cpu:
        return rmsnorm_plain(x, scale, eps=eps)
    lib = _build.library()
    check_rmsnorm_baseline(x, scale)
    r, d = x.shape
    itemsize = x.element_size()
    xp, sp = x.data_ptr(), scale.data_ptr()
    out = torch.empty_like(x)
    err = lib.repro_rmsnorm_baseline_fwd(
        _build.DTYPE_CODE[x.dtype], xp, sp, out.data_ptr(), r, d, eps,
        lane_chunks(d, itemsize), vectors(d * itemsize, xp, sp),
        _build.current_stream(x))
    _build.check(err, "rmsnorm_baseline")
    rmsnorm_baseline.launches += 1
    return out


rmsnorm_pipelined.launches = 0
rmsnorm_pipelined.check = check_rmsnorm_pipelined
rmsnorm_baseline.launches = 0
rmsnorm_baseline.check = check_rmsnorm_baseline
