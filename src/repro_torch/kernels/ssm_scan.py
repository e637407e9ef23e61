"""Selective scan: the hand-written Hopper kernel's two entries and their
plain versions.

`ssm_scan` replaces the Pallas TPU kernel `repro/kernels/ssm_scan.py::
ssm_scan` (body `_ssm_kernel`): `h_t = a_t * h_{t-1} + bx_t`,
`y_t = h_t . c_t`, `h_0 = 0`, on discretized terms a/bx (B,S,din,N).  The
CUDA source is `csrc/ssm_scan.cu`: one thread owns one (b, d, n) and keeps h
in a register for the whole sequence, the N lanes of a channel sum y with
warp shuffles, and the time loop runs inside the kernel with the next 8
steps of a/bx loaded while the current 8 are computed.  Bound on the H100:
bytes, `(2*B*S*din*N + B*S*N) * itemsize + B*S*din*4` over 3.35 TB/s
(a/bx/c read once, y written once).

`ssm_scan_fused` is the counterpart of what the reference's `ssm_pallas`
region wraps (`repro/models/ssm.py:84-91`, the fused form's scan marked as
one kernel region): discretization and scan in one kernel, xin (B,S,din) in
and y out, `dt = softplus(x * w_dt)`, `a = exp(-exp(a_log) * dt)`,
`bx = (dt * x) * bsel`, then the recurrence above.  a and bx never reach
device memory.  Same file, entry `repro_ssm_scan_fused_fwd`.  Bound on the
H100: the special-function unit, not the bytes.  At hymba-1.5b's prefill (B
2, S 2048, din 3200, N 16) the bytes are ~79 MB (xin in bf16, y in f32,
bsel/csel), ~0.024 ms at 3.35 TB/s, while the exponentials of `a` alone
are B*S*din*N = 2.1e8, ~0.05 ms at 16 a clock on each of the 132 SMs at
1.98 GHz.

The plain versions: `ssm_scan_plain`, the exact sequential loop (the port of
`kernels/ref.py::ssm_scan_ref`), is the kernels' oracle; `ssm_scan_chunked`
and `ssm_fused_plain` are the reference's chunked forms (a scan within each
chunk of 128, the state carried from chunk to chunk), which the models run
on the plain path and record in a capture: S/128 iterations a layer, not S.

`ssm_scan` and `ssm_scan_fused` take CPU tensors to their plain versions
and CUDA tensors to the kernel; on anything else, or on a CUDA input the
kernel does not take, they raise.  They never fall back.  Each wrapper's
`check` raises what the wrapper raises for a CUDA input, and launches
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


SSM_CHUNK = 128  # the reference model's chunk (`repro/models/ssm.py:55`)


def softplus(v: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`'s formula, `max(v, 0) + log1p(exp(-|v|))`, which
    the fused kernel computes too (`F.softplus` differs by under 2e-9)."""
    return v.clamp_min(0) + torch.log1p(torch.exp(-v.abs()))


def discretize(xin: torch.Tensor, w_dt: torch.Tensor, a_log: torch.Tensor,
               bsel: torch.Tensor):
    """xin (..., din), w_dt (din), a_log (din, N), bsel (..., N) f32 ->
    (a, bx), each (..., din, N) f32, as the reference's `_discretize`."""
    x = xin.float()
    dt = softplus(x * w_dt)                                   # (..., din)
    a = torch.exp(-torch.exp(a_log) * dt[..., None])
    bx = (dt * x)[..., None] * bsel[..., None, :]
    return a, bx


def _scan_chunk(a: torch.Tensor, bx: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """h of every step of one chunk, a/bx (B, L, din, N) f32, from the state
    h0 (B, din, N) before it.  The inclusive scan of the pairs (a, bx) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2) by log-depth doubling (7
    steps for L 128), then h_t = A_t h0 + B_t.  No division: `cumprod(a)`
    underflows to 0 within a chunk (a reaches e^-16 in one step), and a
    closed form that divides by it gives inf/NaN."""
    step, length = 1, a.shape[1]
    while step < length:
        bx = torch.cat([bx[:, :step], bx[:, :-step] * a[:, step:]
                        + bx[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return a * h0[:, None] + bx


def _scan_chunks(terms, c: torch.Tensor, h: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """The loop over chunks that both chunked forms share: `terms(t0, t1)`
    gives the chunk's (a, bx) f32, which are scanned from the carried state
    h (B, din, N) and read out with c (B,S,N) -> y (B,S,din) f32."""
    ys = []
    for t0 in range(0, c.shape[1], chunk):
        hs = _scan_chunk(*terms(t0, t0 + chunk), h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs,
                               c[:, t0:t0 + chunk].float()))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)


def ssm_scan_chunked(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                     chunk: int = SSM_CHUNK) -> torch.Tensor:
    """The recurrence of `ssm_scan_plain`, a chunk of `chunk` steps at a
    time, as the reference's whole-sequence form scans it.  a/bx
    (B,S,din,N), c (B,S,N) -> y (B,S,din) f32; S need not divide."""
    if chunk < 1:
        raise ValueError(f"ssm_scan_chunked: chunk {chunk} must be >= 1")
    b, _, din, n = a.shape
    h = torch.zeros((b, din, n), dtype=torch.float32, device=a.device)
    return _scan_chunks(lambda t0, t1: (a[:, t0:t1].float(),
                                        bx[:, t0:t1].float()), c, h, chunk)


def ssm_fused_plain(xin: torch.Tensor, w_dt: torch.Tensor,
                    a_log: torch.Tensor, bsel: torch.Tensor,
                    csel: torch.Tensor, chunk: int = SSM_CHUNK
                    ) -> torch.Tensor:
    """The reference's fused form (`repro/models/ssm.py:69-93`): each chunk
    discretized in turn inside the loop over chunks, so its (B, chunk, din,
    N) transients are the only (..., din, N) tensors.  xin (B,S,din) f32 or
    bf16, w_dt (din), a_log (din,N), bsel/csel (B,S,N) f32 -> y (B,S,din)
    f32."""
    if chunk < 1:
        raise ValueError(f"ssm_fused_plain: chunk {chunk} must be >= 1")
    b, _, din = xin.shape
    h = torch.zeros((b, din, a_log.shape[-1]), dtype=torch.float32,
                    device=xin.device)
    return _scan_chunks(lambda t0, t1: discretize(xin[:, t0:t1], w_dt, a_log,
                                                  bsel[:, t0:t1]),
                        csel, h, chunk)


def check_ssm_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor, *,
                   chunk: int = 16) -> None:
    _build.check_no_grad("ssm_scan", a, bx, c)
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
        _build.current_stream(a))
    _build.check(err, "ssm_scan")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
ssm_scan.check = check_ssm_scan


def check_ssm_scan_fused(xin: torch.Tensor, w_dt: torch.Tensor,
                         a_log: torch.Tensor, bsel: torch.Tensor,
                         csel: torch.Tensor) -> None:
    tensors = (("xin", xin), ("w_dt", w_dt), ("a_log", a_log),
               ("bsel", bsel), ("csel", csel))
    _build.check_no_grad("ssm_scan_fused", *(t for _, t in tensors))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != xin.device:
            raise ValueError(f"ssm_scan_fused: {name} is on {t.device}; all "
                             f"inputs must be on one CUDA device")
    if xin.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"ssm_scan_fused: xin is {xin.dtype}; the kernel "
                         f"takes float32 or bfloat16")
    for name, t in tensors[1:]:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ssm_scan_fused: {name} must be contiguous "
                             f"float32, not {t.dtype}"
                             f"{'' if t.is_contiguous() else ' strided'}")
    if xin.dim() != 3 or xin.stride(-1) != 1 or min(xin.stride()) < 0:
        raise ValueError(f"ssm_scan_fused: xin {tuple(xin.shape)} with "
                         f"strides {xin.stride()}; expected (B,S,din) with "
                         f"unit stride along din")
    b, s, din = xin.shape
    n = a_log.shape[-1]
    if w_dt.shape != (din,) or a_log.shape != (din, n) or \
            bsel.shape != (b, s, n) or csel.shape != (b, s, n):
        raise ValueError(f"ssm_scan_fused: shapes xin {tuple(xin.shape)}, "
                         f"w_dt {tuple(w_dt.shape)}, a_log "
                         f"{tuple(a_log.shape)}, bsel {tuple(bsel.shape)}, "
                         f"csel {tuple(csel.shape)}; expected (B,S,din), "
                         f"(din,), (din,N), (B,S,N), (B,S,N)")
    if n < 1 or 32 % n:
        raise ValueError(f"ssm_scan_fused: state size N={n} must divide 32 "
                         f"(the lanes of a channel reduce within one warp)")
    if not 1 <= b <= 65535 or s < 1 or din < 1:
        raise ValueError(f"ssm_scan_fused: B={b}, S={s}, din={din} out of "
                         f"range")


def ssm_scan_fused(xin: torch.Tensor, w_dt: torch.Tensor,
                   a_log: torch.Tensor, bsel: torch.Tensor,
                   csel: torch.Tensor) -> torch.Tensor:
    """xin (B,S,din) f32 or bf16, any row strides (the model hands the view
    `xz[..., :din]`); w_dt (din), a_log (din,N), bsel/csel (B,S,N) f32.

    Returns y (B,S,din) f32.  The kernel walks the whole sequence in one
    loop; its plain version scans chunks of SSM_CHUNK."""
    if all(t.device.type == "cpu" for t in (xin, w_dt, a_log, bsel, csel)):
        return ssm_fused_plain(xin, w_dt, a_log, bsel, csel)
    lib = _build.library()
    check_ssm_scan_fused(xin, w_dt, a_log, bsel, csel)
    b, s, din = xin.shape
    y = torch.empty((b, s, din), dtype=torch.float32, device=xin.device)
    err = lib.repro_ssm_scan_fused_fwd(
        _build.DTYPE_CODE[xin.dtype], xin.data_ptr(), xin.stride(0),
        xin.stride(1), w_dt.data_ptr(), a_log.data_ptr(), bsel.data_ptr(),
        csel.data_ptr(), y.data_ptr(), b, s, din, a_log.shape[-1],
        _build.current_stream(xin))
    _build.check(err, "ssm_scan_fused")
    ssm_scan_fused.launches += 1
    return y


ssm_scan_fused.launches = 0
ssm_scan_fused.check = check_ssm_scan_fused
