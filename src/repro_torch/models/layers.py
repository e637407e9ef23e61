"""Shared model layers (the port of `repro.models.layers`).

Plain functions on tensors; params are nested dicts as in the reference.
`rmsnorm` is the one layer with a kernel: on a CUDA tensor it runs the
pipelined RMSNorm kernel, unless `flags(force_plain=True)` asks for the plain
path.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.torch_frontend import kernel_call
from ..kernels.rmsnorm import rmsnorm_pipelined, rmsnorm_plain
from .flags import get_flags

Params = Dict[str, torch.Tensor]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis in f32, cast back to x's dtype."""
    rows = x.reshape(-1, x.shape[-1])
    plain = functools.partial(rmsnorm_plain, eps=eps)
    if rows.device.type == "cpu" or get_flags().force_plain:
        return plain(rows, scale).reshape(x.shape)
    return kernel_call(rmsnorm_pipelined, rows, scale, eps=eps,
                       plain_fn=plain).reshape(x.shape)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# -- RoPE --------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim//2), f32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., n_heads, head_dim), half-split layout; cos/sin broadcastable
    to (..., head_dim//2).  The rotation runs in f32."""
    half = x.shape[-1] // 2
    cos = cos[..., None, :].float()
    sin = sin[..., None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# -- MLP ---------------------------------------------------------------------

def mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    """SwiGLU MLP (the GELU form of the reference is a later slice)."""
    h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    return linear(h, p["w_down"])


# -- Embedding ---------------------------------------------------------------

def embed(tokens: torch.Tensor, p: Params,
          dtype: torch.dtype) -> torch.Tensor:
    # F.embedding rather than `table[tokens]`: the same gather, and one a
    # capture of a CUDA program can trace on the CPU (core/torch_frontend)
    return F.embedding(tokens, p["table"].to(dtype))


def unembed(x: torch.Tensor, table_or_w: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    w = table_or_w.to(x.dtype)
    return x @ w.t() if transpose else x @ w
