"""Selective state-space mixer, Mamba-style (the port of `repro.models.ssm`).

Recurrence per channel with state size N:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t          (N-vector)
    y_t = C_t . h_t + D * x_t

Prefill discretizes the whole sequence into a/bx (B, S, din, N) f32, as the
reference's non-fused branch does, and runs the selective-scan kernel on
CUDA tensors; the plain path (CPU tensors, or `flags(force_plain=True)`) is
the exact sequential scan `ssm_scan_plain`.  Decode carries `h` as O(1)
state and is plain PyTorch, as the reference's is plain jnp.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.torch_frontend import kernel_call
from ..kernels.ssm_scan import ssm_scan, ssm_scan_plain
from .flags import get_flags
from .layers import linear

Params = Dict[str, torch.Tensor]

def init_ssm(cfg: ArchConfig, reps: int, normal, dtype: torch.dtype,
             device) -> Params:
    """Layer-stacked params (leading `reps` axis) with the reference's
    shapes and init scales; `normal(shape, scale, dtype)` draws the random
    ones."""
    d, n = cfg.d_model, cfg.ssm_state
    din = cfg.ssm_expand * d
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
    return {
        "w_in": normal((reps, d, 2 * din), 0.02, dtype),  # x and z
        "w_b": normal((reps, din, n), 0.02, dtype),
        "w_c": normal((reps, din, n), 0.02, dtype),
        "w_dt": normal((reps, din), 1.0, torch.float32),
        "a_log": a_log.expand(reps, din, n).contiguous(),
        "d_skip": torch.ones((reps, din), dtype=torch.float32,
                             device=device),
        "w_out": normal((reps, din, d), 0.02, dtype),
    }


def _discretize(p: Params, xin: torch.Tensor):
    """xin (..., din) -> (a (...,din,N), bx (...,din,N), c (...,N)), f32."""
    dt = F.softplus(xin.float() * p["w_dt"])                  # (..., din)
    a = torch.exp(-torch.exp(p["a_log"]) * dt[..., None])     # (..., din, N)
    bsel = linear(xin, p["w_b"]).float()                      # (..., N)
    csel = linear(xin, p["w_c"]).float()                      # (..., N)
    bx = (dt * xin.float())[..., None] * bsel[..., None, :]
    return a, bx, csel


def _readout(p: Params, y: torch.Tensor, xin: torch.Tensor, z: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Skip term and SiLU gate in f32, cast back before the out-projection."""
    y = y + xin.float() * p["d_skip"]
    y = (y * F.silu(z.float())).to(dtype)
    return linear(y, p["w_out"])


def ssm_forward(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D)."""
    din = cfg.ssm_expand * x.shape[-1]
    xz = linear(x, p["w_in"])
    xin, z = xz[..., :din], xz[..., din:]
    a, bx, csel = _discretize(p, xin)
    if x.device.type == "cuda" and not get_flags().force_plain:
        y = kernel_call(ssm_scan, a, bx, csel, plain_fn=ssm_scan_plain)
    else:
        y = ssm_scan_plain(a, bx, csel)
    return _readout(p, y, xin, z, x.dtype)


def init_ssm_state(cfg: ArchConfig, batch: int, device) -> Params:
    din = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((batch, din, cfg.ssm_state),
                             dtype=torch.float32, device=device)}


def ssm_decode(p: Params, x: torch.Tensor, state: Params,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """x (B, D) one token; state {"h": (B, din, N) f32}, an O(1) update.
    Returns (y (B, D), new state)."""
    din = cfg.ssm_expand * cfg.d_model
    xz = linear(x, p["w_in"])
    xin, z = xz[..., :din], xz[..., din:]
    a, bx, csel = _discretize(p, xin)          # (B, din, N) x2, (B, N)
    h = a * state["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, csel)
    return _readout(p, y, xin, z, x.dtype), {"h": h}
