"""Selective state-space mixer, Mamba-style (the port of `repro.models.ssm`).

Recurrence per channel with state size N:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t          (N-vector)
    y_t = C_t . h_t + D * x_t

Prefill has the reference's two forms, chosen by `flags.ssm_fused`:
  * whole-sequence (default): a/bx discretized for the whole sequence,
    (B, S, din, N) f32 each; CUDA tensors go through the selective-scan
    kernel's entry `ssm_scan` (K4) on them;
  * fused: each chunk of 128 discretized inside the scan, so a/bx exist
    only as (B, 128, din, N) transients; under `flags.ssm_pallas` CUDA
    tensors go through K4's fused entry `ssm_scan_fused` (xin in, y out),
    otherwise through the chunked form in PyTorch ops.
The plain path (CPU tensors, or `flags(force_plain=True)`) of either form
is the reference's chunked scan (`kernels/ssm_scan.py::ssm_scan_chunked`,
`ssm_fused_plain`), and so is the region a capture records for each kernel:
S/128 chunk iterations a layer.  Decode carries `h` as O(1) state and is
plain PyTorch, as the reference's is plain jnp.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.torch_frontend import kernel_call
from ..kernels.ssm_scan import (discretize, ssm_fused_plain, ssm_scan,
                                ssm_scan_chunked, ssm_scan_fused)
from ..parallel import spmd
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


def _selections(p: Params, xin: torch.Tensor):
    """bsel, csel (..., N) f32, from the linear in xin's dtype."""
    return linear(xin, p["w_b"]).float(), linear(xin, p["w_c"]).float()


def _discretize(p: Params, xin: torch.Tensor):
    """xin (..., din) -> (a (...,din,N), bx (...,din,N), c (...,N)), f32."""
    bsel, csel = _selections(p, xin)
    a, bx = discretize(xin, p["w_dt"], p["a_log"], bsel)
    return a, bx, csel


def _readout(p: Params, y: torch.Tensor, xin: torch.Tensor, z: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Skip term and SiLU gate in f32, cast back before the out-projection."""
    y = y + xin.float() * p["d_skip"]
    y = (y * F.silu(z.float())).to(dtype)
    return linear(y, p["w_out"])


def _kernel_path(x: torch.Tensor) -> bool:
    """Whether prefill takes K4: CUDA tensors, unless `force_plain`."""
    return x.device.type == "cuda" and not get_flags().force_plain


def ssm_forward(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), a chunk of SSM_CHUNK (128) steps at a time
    on the plain path."""
    din = cfg.ssm_expand * x.shape[-1]
    xz = linear(x, p["w_in"])
    xin, z = xz[..., :din], xz[..., din:]
    f = get_flags()
    kernel = _kernel_path(x)
    if f.ssm_fused:
        args = (xin, p["w_dt"], p["a_log"], *_selections(p, xin))
        y = kernel_call(ssm_scan_fused, *args, plain_fn=ssm_fused_plain) \
            if kernel and f.ssm_pallas else ssm_fused_plain(*args)
    else:
        a, bx, csel = _discretize(p, xin)
        y = kernel_call(ssm_scan, a, bx, csel, plain_fn=ssm_scan_chunked) \
            if kernel else ssm_scan_chunked(a, bx, csel)
    return _readout(p, y, xin, z, x.dtype)


def init_ssm_state(cfg: ArchConfig, batch: int, device) -> Params:
    din = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((batch, din, cfg.ssm_state),
                             dtype=torch.float32, device=device)}


def ssm_decode(p: Params, x: torch.Tensor, state: Params,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """x (B, D) one token; state {"h": (B, din, N) f32}, an O(1) update.
    Returns (y (B, D), new state).

    In a decode step's per-device program whose rules cut the channels
    over "model" (`w_b`, `w_c`, `w_dt`, `a_log`, `d_skip` and `w_out` by
    their din rows; `w_in` by its 2 din columns, x's and z's halves laid
    end to end), each rank runs its din / tp channels: `w_in`'s product on
    its columns, all-gathered over "model" so that each rank takes its
    channels of each half; the selections' products, which sum over din,
    summed over "model"; the state, whole on every rank, read and written
    at its channels, the new channels all-gathered.  y is then this rank's
    partial sum of `w_out`'s rows."""
    din = cfg.ssm_expand * cfg.d_model
    xz = linear(x, p["w_in"])
    mine = p["w_out"].shape[0]
    if mine == din:
        xin, z = xz[..., :din], xz[..., din:]
        a, bx, csel = _discretize(p, xin)      # (B, din, N) x2, (B, N)
        h = a * state["h"] + bx
        y = torch.einsum("bdn,bn->bd", h, csel)
        return _readout(p, y, xin, z, x.dtype), {"h": h}
    if xz.shape[-1] != 2 * din:
        xz = spmd.all_gather(xz, "model", -1)
    lo = spmd.current().index("model") * mine
    xin, z = xz[..., lo:lo + mine], xz[..., din + lo:din + lo + mine]
    bsel, csel = (spmd.all_reduce(t, "model") for t in _selections(p, xin))
    a, bx = discretize(xin, p["w_dt"], p["a_log"], bsel)
    h = a * state["h"][:, lo:lo + mine] + bx
    y = torch.einsum("bdn,bn->bd", h, csel)
    return _readout(p, y, xin, z, x.dtype), {
        "h": spmd.all_gather(h, "model", 1)}
