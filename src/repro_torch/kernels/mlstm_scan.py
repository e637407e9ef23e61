"""Chunkwise mLSTM: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel `repro/kernels/mlstm_scan.py::
mlstm_chunkwise` (body `_mlstm_kernel`): xLSTM's matrix-memory recurrence,
stabilised chunk by chunk, with the (hd, hd) state `C`, the normaliser `n`
and the stabiliser `m` carried in f32 from one chunk to the next.  The CUDA
source is `csrc/mlstm_scan.cu`, two launches a call:
1. the states: blocks that each hold a tile of C walk the chunks of their
   (b, h) in order and store C, n and m as they stand before each chunk in
   f32 scratch that this wrapper allocates (`state_floats`);
2. the outputs: one block per (b, h, chunk, column block), all in parallel.
bf16 runs both on the tensor cores (`mma.sync`, f32 accumulation; k w, C
and the gated scores each split into two bf16 parts), f32 on the CUDA
cores.

Bound on the H100, as `chip_smoke.py` reports it: the larger of the
operations, `B*H*(S/L)*(2*L*(L+1)*hd + 4*L*hd^2)` for a chunk of L steps,
over the peak rate for the inputs' type (989 TFLOP/s bf16, 67 TFLOP/s f32),
and the bytes of q, k, v, out and the gates over 3.35 TB/s.  At xlstm-125m's
prefill the bytes bound it in bf16 and the operations in f32.

`mlstm_chunkwise` takes CPU tensors to `mlstm_chunkwise_plain`, the
step-by-step oracle, and CUDA tensors to the kernel; on anything else, or on
a CUDA input the kernel does not take, it raises.  It never falls back.
`check_mlstm_chunkwise` (also the wrapper's `check`) raises what the wrapper
raises for a CUDA input, and launches nothing.  `mlstm_chunkwise_passes`
times the two launches apart for `chip_smoke.py`; it counts no launch.
"""
from __future__ import annotations

import torch

from . import _build

MAX_CHUNK = 128  # kMaxChunk in csrc/mlstm_scan.cu
_COLS, _SLICE = 32, 32  # kCols and kQkSlice there


def smem_bytes(chunk: int, hd: int) -> int:
    """Shared memory of one f32 output block at `chunk` and head dim `hd`
    (the `Layout` of csrc/mlstm_scan.cu).  The bf16 output block and the
    state blocks take a fixed size at any hd."""
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


def state_floats(b: int, s: int, h: int, hd: int, chunk: int):
    """Element counts of the f32 state scratch: C (B, H, S/L, hd, hd), n
    (B, H, S/L, hd) and m (B, H, S/L), each chunk's slot the state before
    it."""
    slots = b * h * (s // chunk)
    return slots * hd * hd, slots * hd, slots


def check_mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_i: torch.Tensor, log_f: torch.Tensor, *,
                          chunk: int = 64) -> None:
    _build.check_no_grad("mlstm_chunkwise", q, k, v, log_i, log_f)
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
    if (s // run) * -(-hd // _COLS) >= 1 << 31:
        raise ValueError(f"mlstm_chunkwise: {s // run} chunks of head dim "
                         f"{hd} exceed the grid")
    if q.dtype == torch.float32 and smem_bytes(run, hd) > _build.MAX_SMEM:
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
    out, scratch = _outputs(q, chunk)
    _build.check(_launch(lib, q, k, v, log_i, log_f, out, scratch, chunk, 3),
                 "mlstm_chunkwise")
    mlstm_chunkwise.launches += 1
    return out


def _outputs(q: torch.Tensor, chunk: int):
    b, s, h, hd = q.shape
    scratch = [torch.empty(n, dtype=torch.float32, device=q.device)
               for n in state_floats(b, s, h, hd, min(chunk, s))]
    return torch.empty_like(q), scratch


def _launch(lib, q, k, v, log_i, log_f, out, scratch, chunk: int,
            passes: int) -> int:
    b, s, h, hd = q.shape
    return lib.repro_mlstm_chunkwise_fwd(
        _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        log_i.data_ptr(), log_f.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in scratch), b, s, h, hd, min(chunk, s),
        passes, _build.current_stream(q))


def mlstm_chunkwise_passes(q, k, v, log_i, log_f, *, chunk: int = 64,
                           reps: int = 10):
    """Device ms of each of the kernel's two launches (states, outputs) on
    CUDA inputs, CUDA events around each launch, the median of `reps`
    calls; a timing aid for `chip_smoke.py` that counts no launch."""
    lib = _build.library()
    check_mlstm_chunkwise(q, k, v, log_i, log_f, chunk=chunk)
    out, scratch = _outputs(q, chunk)
    times = ([], [])
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        for i, passes in enumerate((1, 2)):
            _build.check(_launch(lib, q, k, v, log_i, log_f, out, scratch,
                                 chunk, passes), "mlstm_chunkwise")
            ev[i + 1].record()
        ev[2].synchronize()
        for i in range(2):
            times[i].append(ev[i].elapsed_time(ev[i + 1]))
    return tuple(sorted(t[1:])[len(t[1:]) // 2] for t in times)


mlstm_chunkwise.launches = 0
mlstm_chunkwise.check = check_mlstm_chunkwise
