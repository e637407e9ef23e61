"""sLSTM scan: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel `repro/kernels/slstm_scan.py::slstm_scan`
(body `_slstm_kernel`): xLSTM's scalar-memory recurrence, `g = xg_t +
h_{t-1} r` split into the i, f, z, o gates, exponential gating stabilised by
`m`, `h = sigmoid(o) c / max(n, 1)`.  The CUDA source is
`csrc/slstm_scan.cu`: a persistent kernel whose blocks split the D units
over the SMs (a block owns `ceil(D / SMs)` units), each keeping its units'
columns of r in shared memory in f32 for the whole sequence.  A step
is latency-bound, so the blocks meet through a step counter, not a grid
barrier: each warp that owns units of h publishes them with a release add,
and a block waits on the count with acquire loads; the recurrent state
stays in registers; warps split D and lanes the gate columns, so r and h
are each read from shared memory once a step.  The launch is cooperative
(`cudaLaunchCooperativeKernel`), which guarantees the co-residency the
spinning needs: at most one block an SM.

Bound on the H100, as `chip_smoke.py` reports it: the larger of the
operations, `8*B*S*D^2` (the recurrent product) over the peak rate for the
inputs' type (989 TFLOP/s bf16, 67 TFLOP/s f32), and the bytes of xg, r
and h once over 3.35 TB/s.  At xlstm-125m's prefill the operations bound it.

`slstm_scan` takes CPU tensors to `slstm_scan_plain` and CUDA tensors to
the kernel; on anything else, or on a CUDA input the kernel does not take,
it raises.  It never falls back.  `check_slstm_scan` (also the wrapper's
`check`) raises what the wrapper raises for a CUDA input, and launches
nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

H100_SMS = 132  # SMs of the H100 that a capture without a card is priced for
MAX_UNITS = 16  # 4 * units <= kColLanes * kMaxSlots in csrc/slstm_scan.cu
MAX_ROWS = 8  # kMaxRows there: batch rows a tile
WARPS = 8  # kWarps there


def _sm_count(device: torch.device) -> int:
    """SMs of `device`, over which the kernel spreads D.  A capture on a
    build without a card checks against the H100 it prices."""
    if not torch.cuda.is_available():
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _padded(d: int) -> int:
    """D rounded up to whole 16-byte vectors of f32."""
    return -(-d // 4) * 4


def smem_bytes(d: int, units: int, rows: int) -> int:
    """Shared memory of one block owning `units` units, with `rows` batch
    rows a tile (`smem_bytes` in csrc/slstm_scan.cu: r's 4*units columns in
    f32, the rows of h padded to whole vectors, two buffers of the 8 warps'
    partial gate sums), whatever the inputs' dtype."""
    return 4 * _padded(d) * (4 * units + rows) + \
        2 * 4 * WARPS * rows * 4 * units


def plan(b: int, d: int, sms: int):
    """(units a block, rows a tile) of the launch, as the kernel's host code
    picks them; rows is 0 where not even one row fits beside r."""
    units = -(-d // sms)
    rows = min(MAX_ROWS, b)
    while rows and smem_bytes(d, units, rows) > _build.MAX_SMEM:
        rows -= 1
    if rows:
        tiles = -(-b // rows)
        rows = -(-b // tiles)
    return units, rows


def hbuf_floats(b: int, d: int) -> int:
    """f32 scratch of the exchange: two buffers of h (2, B, D padded to a
    16-byte vector) and the 64-bit step counter."""
    return 2 * b * _padded(d) + 2


def slstm_step(xg_t: torch.Tensor, rec: torch.Tensor, c, n, m):
    """One step of the recurrence in f32 from the gate pre-activations
    `xg_t + rec` (B, 4D); returns (c, n, h, m)."""
    d = c.shape[-1]
    g = xg_t.float() + rec
    gi, gf, gz, go = g[..., :d], g[..., d:2 * d], g[..., 2 * d:3 * d], \
        g[..., 3 * d:]
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + m, gi)
    i_w = torch.exp(gi - m_new)
    f_w = torch.exp(log_f + m - m_new)
    c = f_w * c + i_w * torch.tanh(gz)
    n = f_w * n + i_w
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
    return c, n, h, m_new


def slstm_scan_plain(xg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The exact sequential recurrence in f32 (the port of `kernels/ref.py::
    slstm_scan_ref`).  xg (B,S,4D), r (D,4D) -> h (B,S,D) in xg's dtype."""
    b, s, d4 = xg.shape
    d = d4 // 4
    z = torch.zeros((b, d), dtype=torch.float32, device=xg.device)
    c, n, h = z, z, z
    m = torch.full((b, d), -1e30, dtype=torch.float32, device=xg.device)
    rf = r.float()
    hs = []
    for t in range(s):
        c, n, h, m = slstm_step(xg[:, t], h @ rf, c, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1).to(xg.dtype)


def check_slstm_scan(xg: torch.Tensor, r: torch.Tensor) -> None:
    _build.check_no_grad("slstm_scan", xg, r)
    for name, t in (("xg", xg), ("r", r)):
        if t.device.type != "cuda" or t.device != xg.device:
            raise ValueError(f"slstm_scan: {name} is on {t.device}; both "
                             f"inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"slstm_scan: {name} must be contiguous")
    if xg.dtype not in _build.DTYPE_CODE or r.dtype != xg.dtype:
        raise ValueError(f"slstm_scan: xg {xg.dtype}, r {r.dtype}; the "
                         f"kernel takes float32 or bfloat16, one dtype")
    if xg.dim() != 3 or xg.shape[2] % 4 or \
            r.shape != (xg.shape[2] // 4, xg.shape[2]):
        raise ValueError(f"slstm_scan: shapes xg {tuple(xg.shape)}, r "
                         f"{tuple(r.shape)}; expected (B,S,4D), (D,4D)")
    b, s, d4 = xg.shape
    d = d4 // 4
    if not (1 <= b <= 1 << 20 and s >= 1 and 1 <= d <= 1 << 20):
        raise ValueError(f"slstm_scan: B={b}, S={s}, D={d} out of range")
    units, rows = plan(b, d, _sm_count(xg.device))
    if units > MAX_UNITS or not rows:
        raise ValueError(f"slstm_scan: D={d} leaves a block {units} units "
                         f"(at most {MAX_UNITS}) whose columns of r must fit "
                         f"in shared memory beside one row of h")


def slstm_scan(xg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """xg (B,S,4D) gate pre-activations; r (D,4D) recurrent weights, of
    xg's dtype.  Returns h (B,S,D) in xg's dtype."""
    if xg.device.type == "cpu" and r.device.type == "cpu":
        return slstm_scan_plain(xg, r)
    lib = _build.library()
    check_slstm_scan(xg, r)
    b, s, d4 = xg.shape
    d = d4 // 4
    out = torch.empty((b, s, d), dtype=xg.dtype, device=xg.device)
    hbuf = torch.zeros(hbuf_floats(b, d), dtype=torch.float32,
                       device=xg.device)
    _, rows = plan(b, d, _sm_count(xg.device))
    # c, n, m leave registers only when the batch takes several tiles
    state = torch.empty((3, b, d) if rows < b else (0,),
                        dtype=torch.float32, device=xg.device)
    err = lib.repro_slstm_scan_fwd(
        _build.DTYPE_CODE[xg.dtype], xg.data_ptr(), r.data_ptr(),
        out.data_ptr(), hbuf.data_ptr(), state.data_ptr(), b, s, d,
        _build.current_stream(xg))
    _build.check(err, "slstm_scan")
    slstm_scan.launches += 1
    return out


slstm_scan.launches = 0
slstm_scan.check = check_slstm_scan
