"""GQA attention, causal or sliding-window (the port of the GQA part of
`repro.models.attention`).

Prefill runs the flash-attention kernel on CUDA tensors; `chunked_attention`
is the plain path (CPU tensors, `flags(attention_impl="plain")` or
`flags(force_plain=True)`).  Decode is
plain PyTorch, as the reference's `decode_attention` is plain jnp, against a
layer-stacked KV cache (L, B, S, Kv, hd) with one position per batch slot;
under sliding-window attention the cache is a ring of `min(max_len,
window)` entries.  MLA belongs to a later slice of the port.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..core.torch_frontend import kernel_call
from ..kernels.flash_attention import flash_attention
from .flags import get_flags
from .layers import apply_rope, linear, rope_cos_sin

Params = Dict[str, torch.Tensor]

_NEG_INF = -1e30


def _window(cfg: ArchConfig) -> Optional[int]:
    """The sliding window of `cfg`, None for full causal attention."""
    if cfg.attention not in ("full", "swa"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} ({cfg.name}) is not ported yet; "
            f"the port serves full and sliding-window GQA attention")
    return cfg.window if cfg.attention == "swa" else None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk: int = 512,
                      window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) online-softmax attention.

    q (B,S,H,hd); k (B,S,Kv,hd); v (B,S,Kv,vd), H % Kv == 0.  Returns
    (B,S,H,vd).  A Python loop over the key chunks each query chunk can see
    stands in for the reference's `lax.scan`."""
    b, s, h, hd = q.shape
    vd = v.shape[-1]
    groups = h // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    n_chunks = s // chunk
    win_chunks = None if window is None else max(1, -(-window // chunk))
    rows = torch.arange(chunk, device=q.device)

    outputs = []
    for i in range(n_chunks):
        lo = 0 if win_chunks is None else max(0, i - win_chunks)
        qi = q[:, i * chunk:(i + 1) * chunk] * scale  # input dtype
        m = torch.full((b, h, chunk), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, chunk), device=q.device)
        acc = torch.zeros((b, h, chunk, vd), device=q.device)
        for j in range(lo, i + 1):
            kj = k[:, j * chunk:(j + 1) * chunk]
            vj = v[:, j * chunk:(j + 1) * chunk]
            if groups > 1:
                kj = kj.repeat_interleave(groups, dim=2)
                vj = vj.repeat_interleave(groups, dim=2)
            scores = torch.einsum("bchd,bxhd->bhcx", qi.float(), kj.float())
            q_pos = i * chunk + rows[:, None]
            k_pos = j * chunk + rows[None, :]
            mask = k_pos <= q_pos
            if window is not None:
                mask = mask & (k_pos > q_pos - window)
            scores = scores.masked_fill(~mask, _NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhcx,bxhd->bhcd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outputs.append(out.transpose(1, 2))  # (B, C, H, vd)
    return torch.cat(outputs, dim=1).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length_mask: torch.Tensor) -> torch.Tensor:
    """One-token attention against a cache.

    q (B,H,hd); caches (B,S,Kv,hd); length_mask (B,S) bool."""
    b, h, hd = q.shape
    kv_heads = k_cache.shape[2]
    groups = h // kv_heads
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(b, kv_heads, groups, hd) * scale
    scores = torch.einsum("bkgd,bskd->bkgs", qf.float(), k_cache.float())
    scores = scores.masked_fill(~length_mask[:, None, None, :], _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def attn_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Full-sequence causal attention (prefill), windowed under SWA."""
    window = _window(cfg)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, s, kv, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, s, kv, hd)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    f = get_flags()
    if x.device.type == "cuda" and not f.force_plain and \
            f.attention_impl == "kernel":
        # a capture records the plain path as the kernel's region
        out = kernel_call(flash_attention, q, k, v, causal=True,
                          window=window, plain=functools.partial(
                              chunked_attention, q, k, v, chunk=chunk,
                              window=window))
    else:
        out = chunked_attention(q, k, v, chunk=chunk, window=window)
    return linear(out.reshape(b, s, h * hd), p["wo"])


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device) -> Params:
    window = _window(cfg)
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    s = max_len if window is None else min(max_len, window)
    return {"k": torch.zeros((batch, s, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, s, kv, hd), dtype=dtype,
                             device=device)}


def attn_decode(p: Params, x: torch.Tensor, cache: Params, pos: torch.Tensor,
                cfg: ArchConfig, layer_idx: int) -> torch.Tensor:
    """x (B, d); pos (B,) int, one position per batch slot.

    `cache` holds layer-stacked buffers (L, B, S, Kv, hd).  The new token's
    K/V are written in place at (layer_idx, b, slot[b]): the in-place update
    replaces the reference's functional `dynamic_update_slice`, so a step
    costs one token of writes per layer and no copy of the cache.  Under
    SWA the cache is a ring: slot[b] = pos[b] % S, and once pos[b] >= S
    every entry holds one of the last S positions and is valid (the
    reference's `attn_decode`, written per batch slot).  Returns y (B, d);
    the cache is updated in place."""
    window = _window(cfg)
    b, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = linear(x, p["wq"], p.get("bq")).reshape(b, h, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, kv, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, kv, hd)
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)  # (B, hd//2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    cache_len = cache["k"].shape[2]
    slot = pos if window is None else pos % cache_len
    rows = torch.arange(b, device=x.device)
    cache["k"][layer_idx, rows, slot] = k.to(cache["k"].dtype)
    cache["v"][layer_idx, rows, slot] = v.to(cache["v"].dtype)
    k_cache, v_cache = cache["k"][layer_idx], cache["v"][layer_idx]
    idx = torch.arange(cache_len, device=x.device)
    valid = idx[None, :] <= slot[:, None]
    if window is not None:
        valid = valid | (pos[:, None] >= cache_len)
    out = decode_attention(q, k_cache, v_cache, valid)
    return linear(out.reshape(b, h * hd), p["wo"])
