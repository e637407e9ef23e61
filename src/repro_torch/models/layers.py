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
from ..parallel import spmd
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

def init_mlp(reps: int, d_model: int, d_ff: int, kind: str, normal,
             dtype: torch.dtype) -> Params:
    """The reference's `init_mlp`, layer-stacked (leading `reps` axis):
    `w_gate` only for SwiGLU; `normal(shape, scale, dtype)` draws."""
    p: Params = {}
    if kind == "swiglu":
        p["w_gate"] = normal((reps, d_model, d_ff), 0.02, dtype)
    p["w_up"] = normal((reps, d_model, d_ff), 0.02, dtype)
    p["w_down"] = normal((reps, d_ff, d_model), 0.02, dtype)
    return p


def mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    """SwiGLU MLP, or the GELU form where `p` has no "w_gate".  GELU is the
    tanh approximation: `jax.nn.gelu`'s default, which the reference
    calls."""
    if "w_gate" in p:
        h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    else:
        h = F.gelu(linear(x, p["w_up"]), approximate="tanh")
    return linear(h, p["w_down"])


# -- Embedding ---------------------------------------------------------------

def embed(tokens: torch.Tensor, p: Params, dtype: torch.dtype,
          vocab: Optional[int] = None) -> torch.Tensor:
    """The rows of the table at `tokens`.  In a per-device program whose
    table holds only its share of the `vocab` rows (the rules shard them
    over "model"), each rank takes the tokens in its rows, zeros the
    others, and the ranks' rows are summed over "model": the vocab-parallel
    embedding."""
    table = p["table"].to(dtype)
    if vocab is None or table.shape[0] == vocab:
        # F.embedding rather than `table[tokens]`: the same gather, and
        # one a capture of a CUDA program can trace on the CPU
        # (core/torch_frontend)
        return F.embedding(tokens, table)
    lo = spmd.current().index("model") * table.shape[0]
    local = tokens - lo
    mine = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(torch.where(mine, local, torch.zeros_like(local)),
                       table)
    rows = rows * mine[..., None].to(dtype)
    return spmd.all_reduce(rows, "model")


def unembed(x: torch.Tensor, table_or_w: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    w = table_or_w.to(x.dtype)
    return x @ w.t() if transpose else x @ w
