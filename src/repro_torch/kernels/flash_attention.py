"""Flash attention: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
flash_attention` (body `_flash_kernel`).  The CUDA source is
`csrc/flash_attention.cu`: one block per (batch, q-head, q-block), one thread
per query row holding (m, l, acc) in f32 registers, K/V tiles staged in
shared memory, and the causal / sliding-window band computed from positions,
so `block_q != block_k` and an S that is no multiple of the block are right.

Bound on the H100: operations, `2*B*H*S^2*hd` for causal attention over
989 TFLOP/s bf16 (the scores never reach device memory; the bytes, q, k, v
and out once each, are far smaller).  This first version computes on the
CUDA cores in f32 and sits far above that bound; its times are in PERF.md.

`flash_attention` takes a CPU tensor to `flash_attention_plain` and a CUDA
tensor to the kernel; on anything else, or on a CUDA input the kernel does
not take, it raises.  It never falls back.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Full-matrix attention in f32 (the port of `kernels/ref.py::
    flash_attention_ref`).  q (B,S,H,hd), k/v (B,S,Kv,hd)."""
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _check_cuda(q, k, v, block_q: int, block_k: int,
                window: Optional[int]) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}; "
                             f"all inputs must be on one CUDA device")
        if t.dtype not in _build.DTYPE_CODE or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the "
                             f"kernel takes float32 or bfloat16, one dtype")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"(B, S, heads, hd) tensor")
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: {h} q-heads not a multiple of "
                         f"{k.shape[2]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not 1 <= block_q <= 1024 or block_k < 1 or \
            2 * block_k * hd * 4 > _build.MAX_SMEM:
        raise ValueError(f"flash_attention: block_q {block_q}, block_k "
                         f"{block_k} out of range")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if h > 65535 or b > 65535:
        raise ValueError("flash_attention: B and H must be <= 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,S,Kv,hd) with H % Kv == 0. Returns (B,S,H,hd).

    Forward only: nothing in the port trains through it yet."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    lib = _build.library()
    _check_cuda(q, k, v, block_q, block_k, window)
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    err = lib.repro_flash_attention_fwd(
        _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, s, h, k.shape[2], hd, block_q,
        block_k, int(causal), window or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
