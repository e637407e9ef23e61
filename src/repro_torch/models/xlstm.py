"""xLSTM blocks: chunkwise mLSTM and sequential sLSTM (the port of
`repro.models.xlstm`).

mLSTM (matrix memory): per head, C_t = f_t C_{t-1} + i_t v_t k_t^T with
exponential gating stabilised by a running max m_t.  Prefill takes the
chunkwise form: the (hd x hd) state carried from chunk to chunk, the
contributions inside a chunk as masked gated attention.  On CUDA tensors it
runs the chunkwise mLSTM kernel (K5); the plain path (CPU tensors, or
`flags(force_plain=True)`) is `_mlstm_chunks`, the reference model's own
`chunk_step` in a Python loop, which is also the kernel's region in a
capture.

sLSTM (scalar memory): a strictly sequential exponential-gated recurrence
with a dense recurrent weight, then the paper's gated (4/3) FFN.  On CUDA
tensors the recurrence runs the sLSTM scan kernel (K6); the plain path is
the kernel's plain version, `slstm_scan_plain`.  Decode of both mixers is
plain PyTorch, as the reference's is plain jnp.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.torch_frontend import kernel_call
from ..kernels.mlstm_scan import mlstm_chunkwise
from ..kernels.slstm_scan import slstm_scan, slstm_scan_plain, slstm_step
from .flags import get_flags
from .layers import linear, rmsnorm

Params = Dict[str, torch.Tensor]

_M0 = -1e30  # the stabiliser's start, as in the reference


# -- mLSTM -------------------------------------------------------------------

def init_mlstm(cfg: ArchConfig, reps: int, normal, dtype: torch.dtype,
               device) -> Params:
    """Layer-stacked params (leading `reps` axis) with the reference's
    shapes and init scales; `w_if` is f32 whatever the config's dtype, as
    the reference keeps it."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
    din = h * hd
    return {
        "w_up": normal((reps, d, 2 * din), 0.02, dtype),   # x and gate
        "wq": normal((reps, din, h * hd), 0.02, dtype),
        "wk": normal((reps, din, h * hd), 0.02, dtype),
        "wv": normal((reps, din, h * hd), 0.02, dtype),
        "w_if": normal((reps, din, 2 * h), 0.02, torch.float32),
        "norm": torch.ones((reps, din), dtype=dtype, device=device),
        "w_down": normal((reps, din, d), 0.02, dtype),
    }


def _mlstm_chunks(q, k, v, log_i, log_f, chunk: int) -> torch.Tensor:
    """The reference model's stabilised chunkwise recurrence (`xlstm.py::
    mlstm_forward`'s `chunk_step`), one chunk at a time.  q/k/v (B,S,H,hd),
    k already scaled; gates (B,S,H) f32.  Returns (B,S,H,hd) f32."""
    b, s, h, hd = q.shape
    nc = s // chunk
    qc, kc, vc = (t.reshape(b, nc, chunk, h, hd) for t in (q, k, v))
    lic = log_i.reshape(b, nc, chunk, h)
    lfc = log_f.reshape(b, nc, chunk, h)
    c_state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                          device=q.device)
    n_state = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    m_state = torch.full((b, h), _M0, dtype=torch.float32, device=q.device)
    idx = torch.arange(chunk, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    ys = []
    for i in range(nc):
        # Unstabilised, per target u: C_u = exp(F_u) C_in + sum_{t<=u}
        # exp(F_u - F_t + i_t) v_t k_t^T with F_t = cumsum(log f); the
        # stabiliser M_u = max(m_in + F_u, F_u + max_{t<=u}(i_t - F_t))
        # keeps every exp() <= 1.
        qk, kk, vk = qc[:, i].float(), kc[:, i].float(), vc[:, i].float()
        li, lf = lic[:, i], lfc[:, i]
        f_cum = torch.cumsum(lf, dim=1)                        # (B,C,H)
        f_tot = f_cum[:, -1]                                   # (B,H)
        s_runmax = torch.cummax(li - f_cum, dim=1).values
        m_u = torch.maximum(m_state[:, None], s_runmax) + f_cum
        log_w = (f_cum[:, :, None, :] - f_cum[:, None, :, :] +
                 li[:, None, :, :] - m_u[:, :, None, :])       # (B,U,T,H)
        w = torch.where(causal, torch.exp(log_w), 0.0)
        scores = torch.einsum("buhd,bthd->buth", qk, kk) * w
        intra = torch.einsum("buth,bthd->buhd", scores, vk)
        norm_intra = scores.sum(dim=2)                         # (B,U,H)
        d_u = torch.exp(f_cum + m_state[:, None] - m_u)
        inter = torch.einsum("buhd,bhde->buhe", qk, c_state) * d_u[..., None]
        norm_inter = torch.einsum("buhd,bhd->buh", qk, n_state) * d_u
        denom = torch.maximum((norm_inter + norm_intra).abs(),
                              torch.exp(-m_u))
        ys.append((inter + intra) / denom[..., None])
        m_new = m_u[:, -1]
        carry = torch.exp(f_tot + m_state - m_new)             # (B,H)
        src_w = torch.exp(li + (f_tot[:, None] - f_cum) - m_new[:, None])
        c_state = c_state * carry[..., None, None] + torch.einsum(
            "bthd,bthe,bth->bhde", kk, vk, src_w)
        n_state = n_state * carry[..., None] + torch.einsum(
            "bthd,bth->bhd", kk, src_w)
        m_state = m_new
    return torch.stack(ys, dim=1).reshape(b, s, h, hd)


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                  chunk: int = 128) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D).  S must be a multiple of min(chunk, S), as
    the reference asserts."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim_
    din = h * hd
    up = linear(x, p["w_up"])
    xin, zgate = up[..., :din], up[..., din:]
    q = linear(xin, p["wq"]).reshape(b, s, h, hd)
    # k scaled in the model's dtype before the scan, as the reference does
    k = linear(xin, p["wk"]).reshape(b, s, h, hd) / (hd ** 0.5)
    v = linear(xin, p["wv"]).reshape(b, s, h, hd)
    gates = linear(xin, p["w_if"]).float()                     # (B,S,2H)
    # pre-act i, copied out of the slice for the kernel (clone, not
    # `.contiguous()`: the same copy, and one a capture of a CUDA program
    # can trace on the CPU, core/torch_frontend)
    log_i = gates[..., :h].clone(memory_format=torch.contiguous_format)
    log_f = F.logsigmoid(gates[..., h:])                       # log f_t
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mlstm_forward: seq {s} % chunk {chunk} != 0")
    plain = functools.partial(_mlstm_chunks, chunk=chunk)
    if x.device.type == "cuda" and not get_flags().force_plain:
        y = kernel_call(mlstm_chunkwise, q, k, v, log_i, log_f, chunk=chunk,
                        plain_fn=plain)
    else:
        y = plain(q, k, v, log_i, log_f)
    y = rmsnorm(y.reshape(b, s, din).to(x.dtype), p["norm"], cfg.norm_eps)
    y = y * F.silu(zgate)
    return linear(y, p["w_down"])


def init_mlstm_state(cfg: ArchConfig, batch: int, device) -> Params:
    h, hd = cfg.n_heads, cfg.head_dim_
    return {"c": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, h), _M0, dtype=torch.float32,
                            device=device)}


def mlstm_decode(p: Params, x: torch.Tensor, state: Params,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """x (B, D) one token; state {"c", "n", "m"}.  Returns (y, new state).

    The denominator is clamped at 1.0, as the reference's `mlstm_decode`
    clamps it (`xlstm.py:157`), where prefill and the kernel clamp at
    exp(-m): decode and prefill of the reference disagree, and the port
    keeps that rather than fix it."""
    b, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim_
    din = h * hd
    up = linear(x, p["w_up"])
    xin, zgate = up[..., :din], up[..., din:]
    q = linear(xin, p["wq"]).reshape(b, h, hd).float()
    k = (linear(xin, p["wk"]).reshape(b, h, hd) / (hd ** 0.5)).float()
    v = linear(xin, p["wv"]).reshape(b, h, hd).float()
    gates = linear(xin, p["w_if"]).float()
    log_i = gates[..., :h]
    log_f = F.logsigmoid(gates[..., h:])
    m_new = torch.maximum(log_f + state["m"], log_i)
    i_w = torch.exp(log_i - m_new)
    f_w = torch.exp(log_f + state["m"] - m_new)
    c = state["c"] * f_w[..., None, None] + \
        torch.einsum("bhd,bhe,bh->bhde", k, v, i_w)
    n = state["n"] * f_w[..., None] + k * i_w[..., None]
    num = torch.einsum("bhd,bhde->bhe", q, c)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", q, n).abs(), min=1.0)
    y = (num / den[..., None]).reshape(b, din).to(x.dtype)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    y = y * F.silu(zgate)
    return linear(y, p["w_down"]), {"c": c, "n": n, "m": m_new}


# -- sLSTM -------------------------------------------------------------------

def init_slstm(cfg: ArchConfig, reps: int, normal, dtype: torch.dtype,
               device) -> Params:
    d = cfg.d_model
    ffd = int(d * 4 / 3)
    return {
        "w_gates": normal((reps, d, 4 * d), 0.02, dtype),  # i, f, z, o
        "r_gates": normal((reps, d, 4 * d), 0.01, dtype),
        "ffn_gate": normal((reps, d, ffd), 0.02, dtype),
        "ffn_up": normal((reps, d, ffd), 0.02, dtype),
        "ffn_down": normal((reps, ffd, d), 0.02, dtype),
    }


def _slstm_cell(p: Params, xg: torch.Tensor, state):
    """xg (B, 4D) precomputed input gates; state (c, n, h, m) each (B, D)
    f32.  The recurrent product is f32: h is f32 and `linear` casts r to
    it, as the reference's does."""
    c, n, hprev, m = state
    rec = linear(hprev, p["r_gates"]).float()
    c, n, h, m = slstm_step(xg, rec, c, n, m)
    return (c, n, h, m), h


def _ffn(p: Params, y: torch.Tensor) -> torch.Tensor:
    f = F.silu(linear(y, p["ffn_gate"])) * linear(y, p["ffn_up"])
    return linear(f, p["ffn_down"])


def slstm_forward(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D)."""
    xg = linear(x, p["w_gates"])                       # (B, S, 4D)
    if x.device.type == "cuda" and not get_flags().force_plain:
        y = kernel_call(slstm_scan, xg, p["r_gates"],
                        plain_fn=slstm_scan_plain)
    else:
        y = slstm_scan_plain(xg, p["r_gates"])
    return _ffn(p, y.to(x.dtype))


def init_slstm_state(cfg: ArchConfig, batch: int, device) -> Params:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full_like(z, _M0)}


def slstm_decode(p: Params, x: torch.Tensor, state: Params,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    xg = linear(x, p["w_gates"])
    (c, n, h, m), y = _slstm_cell(
        p, xg, (state["c"], state["n"], state["h"], state["m"]))
    return _ffn(p, y.to(x.dtype)), {"c": c, "n": n, "h": h, "m": m}
