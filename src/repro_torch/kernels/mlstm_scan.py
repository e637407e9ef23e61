"""Chunkwise mLSTM: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel `repro/kernels/mlstm_scan.py::
mlstm_chunkwise` (body `_mlstm_kernel`): xLSTM's matrix-memory recurrence,
stabilised chunk by chunk, with the (hd, hd) state `C`, the normaliser `n`
and the stabiliser `m` carried in f32 from one chunk to the next.  The CUDA
source is `csrc/mlstm_scan.cu`: one block walks the chunks of one (b, h) in
order and owns 32 of C's value columns (a (b, h) is split over
ceil(hd / 32) blocks, so C fits in shared memory at hd 192); inside a chunk
it computes the gated scores of the whole chunk and the inter-chunk read of
C, then updates C, all in f32 on the CUDA cores.

Bound on the H100, as `chip_smoke.py` reports it: the larger of the
operations, `B*H*(S/L)*(4*L^2*hd + 4*L*hd^2)` for a chunk of L steps, over
the peak rate for the inputs' type (989 TFLOP/s bf16, 67 TFLOP/s f32), and
the bytes of q, k, v, out and the gates over 3.35 TB/s.  At xlstm-125m's
prefill the bytes bound it in bf16 and the operations in f32.

`mlstm_chunkwise` takes CPU tensors to `mlstm_chunkwise_plain`, the
step-by-step oracle, and CUDA tensors to the kernel; on anything else, or on
a CUDA input the kernel does not take, it raises.  It never falls back.
`check_mlstm_chunkwise` (also the wrapper's `check`) raises what the wrapper
raises for a CUDA input, and launches nothing.
"""
from __future__ import annotations

import torch

from . import _build

MAX_CHUNK = 128  # kMaxChunk in csrc/mlstm_scan.cu
_COLS, _SLICE = 32, 32  # kCols and kSlice there


def smem_bytes(chunk: int, hd: int) -> int:
    """Shared memory of one block at `chunk` and head dim `hd` (the
    `Layout` of csrc/mlstm_scan.cu)."""
    lp = -(-chunk // 4) * 4
    ls = lp + 1
    v = hd * _COLS + hd + 2 * _SLICE * ls + lp * ls
    v = -(-v // 4) * 4
    return 4 * (v + lp * _COLS + 6 * lp + 4)


def mlstm_chunkwise_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_i: torch.Tensor,
                          log_f: torch.Tensor) -> torch.Tensor:
    """The step-by-step stabilised recurrence in f32 (the port of
    `kernels/ref.py::mlstm_ref`).  q/k/v (B,S,H,hd), log_i/log_f (B,S,H)
    -> (B,S,H,hd) in q's dtype."""
    b, s, h, hd = q.shape
    c = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        li, lf = log_i[:, t].float(), log_f[:, t].float()
        m_new = torch.maximum(lf + m, li)
        i_w = torch.exp(li - m_new)
        f_w = torch.exp(lf + m - m_new)
        c = c * f_w[..., None, None] + torch.einsum(
            "bhd,bhe,bh->bhde", kt, vt, i_w)
        n = n * f_w[..., None] + kt * i_w[..., None]
        num = torch.einsum("bhd,bhde->bhe", qt, c)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(),
                            torch.exp(-m_new))
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1).to(q.dtype)


def check_mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_i: torch.Tensor, log_f: torch.Tensor, *,
                          chunk: int = 64) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("log_i", log_i),
                    ("log_f", log_f)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"mlstm_chunkwise: {name} is on {t.device}; all "
                             f"inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"mlstm_chunkwise: {name} must be contiguous")
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"mlstm_chunkwise: q {q.dtype}, k {k.dtype}, v "
                         f"{v.dtype}; the kernel takes float32 or bfloat16, "
                         f"one dtype")
    if log_i.dtype != torch.float32 or log_f.dtype != torch.float32:
        raise ValueError(f"mlstm_chunkwise: gates {log_i.dtype}, "
                         f"{log_f.dtype}; the kernel takes them in float32")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or \
            log_i.shape != q.shape[:3] or log_f.shape != q.shape[:3]:
        raise ValueError(f"mlstm_chunkwise: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, gates "
                         f"{tuple(log_i.shape)}, {tuple(log_f.shape)}; "
                         f"expected (B,S,H,hd) x3 and (B,S,H) x2")
    b, s, h, hd = q.shape
    if not (1 <= b <= 65535 and 1 <= h <= 65535 and s >= 1 and hd >= 1):
        raise ValueError(f"mlstm_chunkwise: B={b}, S={s}, H={h}, hd={hd} "
                         f"out of range")
    run = min(chunk, s)
    if not 1 <= run <= MAX_CHUNK or s % run:
        raise ValueError(f"mlstm_chunkwise: chunk {chunk} (run at {run}) "
                         f"must be 1..{MAX_CHUNK} and divide S={s}")
    if smem_bytes(run, hd) > _build.MAX_SMEM:
        raise ValueError(f"mlstm_chunkwise: chunk {run} at head dim {hd} "
                         f"needs {smem_bytes(run, hd)} bytes of shared "
                         f"memory, above {_build.MAX_SMEM}")


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_i: torch.Tensor, log_f: torch.Tensor, *,
                    chunk: int = 64) -> torch.Tensor:
    """q/k/v (B,S,H,hd) of one dtype, k already divided by sqrt(hd);
    log_i (pre-activation) and log_f (log-sigmoid) (B,S,H) f32.

    Returns the normalised hidden states (B,S,H,hd) in q's dtype.  The
    chunk is `min(chunk, S)`, which must divide S, as in the reference."""
    if all(t.device.type == "cpu" for t in (q, k, v, log_i, log_f)):
        return mlstm_chunkwise_plain(q, k, v, log_i, log_f)
    lib = _build.library()
    check_mlstm_chunkwise(q, k, v, log_i, log_f, chunk=chunk)
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    err = lib.repro_mlstm_chunkwise_fwd(
        _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        log_i.data_ptr(), log_f.data_ptr(), out.data_ptr(), b, s, h, hd,
        min(chunk, s), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mlstm_chunkwise")
    mlstm_chunkwise.launches += 1
    return out


mlstm_chunkwise.launches = 0
mlstm_chunkwise.check = check_mlstm_chunkwise
