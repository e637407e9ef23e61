"""Selective scan: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel `repro/kernels/ssm_scan.py::ssm_scan` (body
`_ssm_kernel`): `h_t = a_t * h_{t-1} + bx_t`, `y_t = h_t . c_t`, `h_0 = 0`.
The CUDA source is `csrc/ssm_scan.cu`: one thread owns one (b, d, n) and
keeps h in a register for the whole sequence, the N lanes of a channel sum
y with warp shuffles, and the time loop runs inside the kernel with the next
8 steps of a/bx loaded while the current 8 are computed.

Bound on the H100: bytes, `(2*B*S*din*N + B*S*N) * itemsize + B*S*din*4`
over 3.35 TB/s (a/bx/c read once, y written once).

`ssm_scan` takes CPU tensors to `ssm_scan_plain` and CUDA tensors to the
kernel; on anything else, or on a CUDA input the kernel does not take, it
raises.  It never falls back.  `check_ssm_scan` (also the wrapper's
`check`) raises what the wrapper raises for a CUDA input, and launches
nothing.
"""
from __future__ import annotations

import torch

from . import _build


def ssm_scan_plain(a: torch.Tensor, bx: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """The exact sequential recurrence in f32 (the port of `kernels/ref.py::
    ssm_scan_ref`).  a/bx (B,S,din,N), c (B,S,N) -> y (B,S,din) f32."""
    b, s, din, n = a.shape
    h = torch.zeros((b, din, n), dtype=torch.float32, device=a.device)
    ys = []
    for t in range(s):
        h = a[:, t].float() * h + bx[:, t].float()
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t].float()))
    return torch.stack(ys, dim=1)


def check_ssm_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor, *,
                   chunk: int = 16) -> None:
    for name, t in (("a", a), ("bx", bx), ("c", c)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"ssm_scan: {name} is on {t.device}; all "
                             f"inputs must be on one CUDA device")
        if t.dtype not in _build.DTYPE_CODE:
            raise ValueError(f"ssm_scan: {name} is {t.dtype}; the kernel "
                             f"takes float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    if bx.dtype != a.dtype or c.dtype != a.dtype:
        raise ValueError(f"ssm_scan: a {a.dtype}, bx {bx.dtype} and c "
                         f"{c.dtype} must share a dtype")
    if a.dim() != 4 or bx.shape != a.shape or \
            c.shape != (a.shape[0], a.shape[1], a.shape[3]):
        raise ValueError(f"ssm_scan: shapes a {tuple(a.shape)}, bx "
                         f"{tuple(bx.shape)}, c {tuple(c.shape)}; expected "
                         f"(B,S,din,N), (B,S,din,N), (B,S,N)")
    b, s, din, n = a.shape
    if n < 1 or 32 % n:
        raise ValueError(f"ssm_scan: state size N={n} must divide 32 (the "
                         f"lanes of a channel reduce within one warp)")
    if not 1 <= b <= 65535 or s < 1 or din < 1:
        raise ValueError(f"ssm_scan: B={b}, S={s}, din={din} out of range")
    if chunk < 1:
        raise ValueError(f"ssm_scan: chunk {chunk} must be >= 1")


def ssm_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 16) -> torch.Tensor:
    """a/bx (B,S,din,N) discretized recurrence terms; c (B,S,N) readout.

    Returns y (B,S,din) f32.  `chunk` is the TPU kernel's time block; the
    CUDA kernel walks the whole sequence in one loop, so it is checked and
    does not change the result."""
    if all(t.device.type == "cpu" for t in (a, bx, c)):
        return ssm_scan_plain(a, bx, c)
    lib = _build.library()
    check_ssm_scan(a, bx, c, chunk=chunk)
    b, s, din, n = a.shape
    y = torch.empty((b, s, din), dtype=torch.float32, device=a.device)
    err = lib.repro_ssm_scan_fwd(
        _build.DTYPE_CODE[a.dtype], a.data_ptr(), bx.data_ptr(),
        c.data_ptr(), y.data_ptr(), b, s, din, n,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ssm_scan")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
ssm_scan.check = check_ssm_scan
