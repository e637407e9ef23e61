"""Attention: GQA, causal or sliding-window, and MLA (the port of
`repro.models.attention`).

GQA prefill runs the flash-attention kernel on CUDA tensors;
`chunked_attention` is the plain path (CPU tensors,
`flags(attention_impl="plain")` or `flags(force_plain=True)`).  Decode is
plain PyTorch, as the reference's `decode_attention` is plain jnp, against a
layer-stacked KV cache (L, B, S, Kv, hd) with one position per batch slot;
under sliding-window attention the cache is a ring of `min(max_len,
window)` entries.

MLA (DeepSeek-V2's multi-head latent attention) prefills through
`chunked_attention` on every device, by design: its q/k heads are qk_nope +
qk_rope wide (192 at full width) and its v heads v_head_dim (128), and the
flash-attention kernel, as the reference's Pallas kernel, takes one head
dim for q, k and v.  Its norms (`q_norm`, `kv_norm`) go through the RMSNorm
kernel as every norm does.  Decode is the reference's absorbed form against
a compressed, layer-stacked cache {"kv_c" (L, B, S, kv_lora), "k_rope" (L,
B, S, qk_rope)}, one position per batch slot.

In a per-device program whose rules cut the heads over "model", both
kinds run on a rank's heads, each reading its local head count off its
weights' shapes, and return its partial sum of `wo`'s rows.  MLA's latent
(`wkv_a`, the norms, the compressed cache) is whole on every rank; `wq_a`'s
q_lora columns are cut, and its output is all-gathered before `q_norm`
(`_mla_q`, `_mla_heads`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..core.torch_frontend import kernel_call
from ..kernels.flash_attention import flash_attention
from ..parallel import spmd
from .flags import get_flags
from .layers import apply_rope, linear, rmsnorm, rope_cos_sin

Params = Dict[str, torch.Tensor]

_NEG_INF = -1e30


def _window(cfg: ArchConfig) -> Optional[int]:
    """The sliding window of `cfg`, None for full causal attention."""
    if cfg.attention not in ("full", "swa"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} ({cfg.name}) is not GQA: this "
            f"path takes full and sliding-window attention (MLA runs "
            f"`mla_forward` and `mla_decode`)")
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
                     v_cache: torch.Tensor, length_mask: torch.Tensor,
                     seq_axes=()) -> torch.Tensor:
    """One-token attention against a cache.

    q (B,H,hd); caches (B,S,Kv,hd); length_mask (B,S) bool.  `seq_axes`:
    the mesh axes the cache's positions are cut over in a per-device
    program; the softmax is then distributed, its max, its sum and the
    weighted values each reduced over them."""
    b, h, hd = q.shape
    kv_heads = k_cache.shape[2]
    groups = h // kv_heads
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(b, kv_heads, groups, hd) * scale
    scores = torch.einsum("bkgd,bskd->bkgs", qf.float(), k_cache.float())
    scores = scores.masked_fill(~length_mask[:, None, None, :], _NEG_INF)
    if seq_axes:
        m = spmd.all_reduce_max(scores.amax(dim=-1), seq_axes)
        p = torch.exp(scores - m[..., None])
        l = spmd.all_reduce(p.sum(dim=-1), seq_axes)
        out = spmd.all_reduce(torch.einsum(
            "bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
            v_cache.float()), seq_axes) / l[..., None]
        return out.reshape(b, h, hd).to(q.dtype)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def attn_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Full-sequence causal attention (prefill), windowed under SWA."""
    window = _window(cfg)
    b, s, _ = x.shape
    hd = cfg.head_dim_
    # in a per-device program whose rules shard the heads over "model",
    # this rank's heads (`_local_kv`); otherwise every head
    h = p["wq"].shape[-1] // hd
    kv = p["wk"].shape[-1] // hd
    if h != cfg.n_heads and kv == cfg.n_kv_heads:
        # whole KV projections of which each rank reads its query heads'
        # groups (`_local_kv`): their gradients are summed over "model"
        p = {k: (spmd.copy_to(w, "model") if k in ("wk", "wv", "bk", "bv")
                 else w) for k, w in p.items()}
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, s, kv, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, s, kv, hd)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k, v = _local_kv(k, v, h, cfg)
    f = get_flags()
    if x.device.type == "cuda" and not f.force_plain and \
            f.attention_impl == "kernel":
        # a capture records the plain path as the kernel's region, and a
        # gradient is the plain path's
        out = kernel_call(flash_attention, q, k, v, causal=True,
                          window=window, plain_fn=functools.partial(
                              chunked_attention, chunk=chunk, window=window))
    else:
        out = chunked_attention(q, k, v, chunk=chunk, window=window)
    return linear(out.reshape(b, s, h * hd), p["wo"])


def _local_kv(k: torch.Tensor, v: torch.Tensor, h_local: int,
              cfg: ArchConfig):
    """The KV heads that this rank's `h_local` query heads read, along
    axis 2 of k/v (..., Kv, hd).  Where the query heads are cut over
    "model" and the KV heads are not (the rules keep a KV projection whole
    when its heads do not divide the axis), rank r's query heads r * h_local
    ... are the group of KV head (r * h_local + i) // (H / Kv); where both
    are cut, or neither, k and v are already this rank's."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h_local == h or k.shape[2] != kv:
        return k, v
    g = h // kv
    first = spmd.current().index("model") * h_local
    if g % h_local == 0 or h_local % g == 0:
        lo, n = first // g, max(1, h_local // g)
        return k.narrow(2, lo, n), v.narrow(2, lo, n)
    idx = (first + torch.arange(h_local, device=k.device)) // g
    return k.index_select(2, idx), v.index_select(2, idx)


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
    hd = cfg.head_dim_
    h = p["wq"].shape[-1] // hd      # this rank's query heads (attn_forward)
    kv = p["wk"].shape[-1] // hd
    q = linear(x, p["wq"], p.get("bq")).reshape(b, h, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, kv, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, kv, hd)
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)  # (B, hd//2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if kv != cfg.n_kv_heads:
        # the cache holds every KV head on every rank of "model"
        k = spmd.all_gather(k, "model", 1)
        v = spmd.all_gather(v, "model", 1)

    # the cache's positions on this rank: all of them, or, where the
    # decode state's rules cut the sequence over some axes, this rank's
    # part of them (a distributed softmax then reads every part)
    local = spmd.current()
    seq_axes = () if local is None else \
        local.kv_seq_axes.get(id(cache["k"]), ())
    cache_len = cache["k"].shape[2]
    lo = 0
    total = cache_len
    if seq_axes:
        lo = local.index(seq_axes) * cache_len
        total = cache_len * local.size(seq_axes)
    slot = pos if window is None else pos % total
    rows = torch.arange(b, device=x.device)
    k = k.to(cache["k"].dtype)
    v = v.to(cache["v"].dtype)
    if seq_axes:
        here = slot - lo
        mine = ((here >= 0) & (here < cache_len))[:, None, None]
        here = torch.clamp(here, 0, cache_len - 1)
        k = torch.where(mine, k, cache["k"][layer_idx, rows, here])
        v = torch.where(mine, v, cache["v"][layer_idx, rows, here])
        slot_here = here
    else:
        slot_here = slot
    cache["k"][layer_idx, rows, slot_here] = k
    cache["v"][layer_idx, rows, slot_here] = v
    k_cache, v_cache = cache["k"][layer_idx], cache["v"][layer_idx]
    k_cache, v_cache = _local_kv(k_cache, v_cache, h, cfg)
    idx = lo + torch.arange(cache_len, device=x.device)
    valid = idx[None, :] <= slot[:, None]
    if window is not None:
        valid = valid | (pos[:, None] >= total)
    out = decode_attention(q, k_cache, v_cache, valid, seq_axes)
    return linear(out.reshape(b, h * hd), p["wo"])


# -- MLA (DeepSeek-V2 multi-head latent attention) -----------------------------

def init_mla(cfg: ArchConfig, reps: int, normal, dtype: torch.dtype,
             device) -> Params:
    """Layer-stacked params (leading `reps` axis) with the reference's
    shapes: the low-rank query (`wq_a`, `q_norm`, `wq_b`) where the config
    has a q_lora_rank, else `wq`; the compressed KV (`wkv_a`, `kv_norm`,
    `wkv_b`) and `wo`."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    p: Params = {}
    if cfg.q_lora_rank:
        p["wq_a"] = normal((reps, d, cfg.q_lora_rank), 0.02, dtype)
        p["q_norm"] = torch.ones((reps, cfg.q_lora_rank), dtype=dtype,
                                 device=device)
        p["wq_b"] = normal((reps, cfg.q_lora_rank, h * (nope + rope_d)),
                           0.02, dtype)
    else:
        p["wq"] = normal((reps, d, h * (nope + rope_d)), 0.02, dtype)
    p["wkv_a"] = normal((reps, d, cfg.kv_lora_rank + rope_d), 0.02, dtype)
    p["kv_norm"] = torch.ones((reps, cfg.kv_lora_rank), dtype=dtype,
                              device=device)
    p["wkv_b"] = normal((reps, cfg.kv_lora_rank, h * (nope + vd)), 0.02,
                        dtype)
    p["wo"] = normal((reps, h * vd, d), 0.02, dtype)
    return p


def _mla_heads(p: Params, cfg: ArchConfig):
    """(p, this rank's heads) of an MLA layer.  In a per-device program
    whose rules cut the heads over "model" (`wq_b` and `wkv_b` by their
    head-major columns, (q_lora, H, nope + rope) and (r, H, nope + vd),
    `wo` by its rows), each rank runs its heads, a contiguous block, and
    the leaves left whole there (`wkv_a`, the norms, and `wq_a` where the
    rules keep its q_lora columns whole) get their gradients, partial from
    each rank's heads, summed over "model"."""
    h = p["wkv_b"].shape[-1] // (cfg.qk_nope_head_dim + cfg.v_head_dim)
    if h != cfg.n_heads:
        whole = ("q_norm", "wkv_a", "kv_norm") + (
            ("wq_a",) if cfg.q_lora_rank and
            p["wq_a"].shape[-1] == cfg.q_lora_rank else ())
        p = {k: (spmd.copy_to(w, "model") if k in whole else w)
             for k, w in p.items()}
    return p, h


def _mla_q(p: Params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor):
    """x (B, S, d), positions broadcastable to (B, S) -> q_nope (B, S, H,
    nope), q_rope (B, S, H, rope) with RoPE applied, over the heads of
    `wq_b` (or `wq`).  Where the rules cut `wq_a`'s q_lora columns over
    "model", its output (B, S, q_lora / tp) is all-gathered before
    `q_norm`, which normalizes the whole row."""
    b, s, _ = x.shape
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q_a = linear(x, p["wq_a"])
        if q_a.shape[-1] != cfg.q_lora_rank:
            # its users run this rank's heads: their gradients are partial
            q_a = spmd.all_gather(q_a, "model", -1, bwd="sum")
        q = linear(rmsnorm(q_a, p["q_norm"], cfg.norm_eps), p["wq_b"])
    else:
        q = linear(x, p["wq"])
    q = q.reshape(b, s, -1, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_cos_sin(positions, rope_d, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_kv(p: Params, x: torch.Tensor, cfg: ArchConfig,
            positions: torch.Tensor):
    """x (B, S, d) -> the compressed KV kv_c (B, S, r), normed, and the
    one shared RoPE key k_rope (B, S, 1, rope)."""
    r = cfg.kv_lora_rank
    kv = linear(x, p["wkv_a"])
    # the slice copied into dense rows, which the RMSNorm kernel takes (a
    # clone: `.contiguous()` of a fake CUDA tensor fails in a CPU capture)
    kv_c = rmsnorm(kv[..., :r].clone(memory_format=torch.contiguous_format),
                   p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return kv_c, apply_rope(kv[..., None, r:], cos, sin)


def mla_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Full-sequence MLA (prefill): the compressed KV decompressed per head,
    the one RoPE key broadcast to all H heads, and `chunked_attention` with
    q/k heads of nope + rope and v heads of v_head_dim (module docstring:
    no kernel takes two head dims).  Its scale, 1/sqrt(q's head dim), is
    the absorbed decode's 1/sqrt(nope + rope).  In a per-device program
    whose rules cut the heads, this rank's heads (`_mla_heads`), and the
    output is this rank's partial sum of `wo`'s rows."""
    b, s, _ = x.shape
    p, h = _mla_heads(p, cfg)
    nope, rope_d, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    kv_c, k_rope = _mla_kv(p, x, cfg, positions)
    kv_up = linear(kv_c, p["wkv_b"]).reshape(b, s, h, nope + vd)
    k_nope, v = kv_up[..., :nope], kv_up[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rope_d)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = chunked_attention(q, k, v, chunk=chunk)
    return linear(out.reshape(b, s, h * vd), p["wo"])


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device) -> Params:
    return {"kv_c": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(p: Params, x: torch.Tensor, cache: Params, pos: torch.Tensor,
               cfg: ArchConfig, layer_idx: int) -> torch.Tensor:
    """Absorbed-projection MLA decode: scores in kv_lora space, O(r) per
    cached token instead of per-head decompression.  x (B, d); pos (B,)
    int, one position per batch slot.  `cache` holds the layer-stacked
    compressed cache (L, B, S, r) and (L, B, S, rope), whole on every
    rank of "model", which writes the new token alike in place at
    (layer_idx, b, pos[b]) (see `attn_decode`) and reads the whole cache
    for its own heads (`_mla_heads`).  Returns y (B, d), this rank's
    partial sum where the heads are cut."""
    b = x.shape[0]
    p, _ = _mla_heads(p, cfg)
    q_nope, q_rope = _mla_q(p, x[:, None], cfg, pos[:, None])
    kv_c, k_rope = _mla_kv(p, x[:, None], cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    cache["kv_c"][layer_idx, rows, pos] = kv_c[:, 0].to(cache["kv_c"].dtype)
    cache["k_rope"][layer_idx, rows, pos] = k_rope[:, 0, 0].to(
        cache["k_rope"].dtype)
    return _mla_decode_core(p, x, cfg, q_nope[:, 0], q_rope[:, 0],
                            cache["kv_c"][layer_idx],
                            cache["k_rope"][layer_idx], pos)


def _mla_decode_core(p: Params, x: torch.Tensor, cfg: ArchConfig,
                     q_nope: torch.Tensor, q_rope: torch.Tensor,
                     kv_cache: torch.Tensor, kr_cache: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """The reference's `_mla_decode_core`, cast for cast: each einsum takes
    its operands in their dtypes and accumulates in f32 (the reference's
    `preferred_element_type=f32`: products of bf16 values are exact in
    f32), `q_c` is rounded to the cache's dtype before the scores, the
    probabilities before the context, the context to x's dtype before W_uv.

    W_uk and W_uv are read from `wkv_b` in the layout `mla_forward`
    decompresses with: (r, H, nope + vd), each head's nope columns then its
    vd columns.  The reference's decode reads the first H * nope columns
    as W_uk (r, H, nope) and the rest as W_uv, another layout, so there
    decode does not continue what prefill computed (2e-2 of the largest
    logit apart at deepseek-v2 smoke).  Here it does; on the reference's
    weights with `wkv_b`'s columns permuted into its decode layout, the
    reference's decode gives this one's numbers
    (`tests/test_torch_mla.py`)."""
    b = x.shape[0]
    nope, rope_d, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    h = p["wkv_b"].shape[-1] // (nope + vd)    # this rank's heads
    r = cfg.kv_lora_rank
    w_b = p["wkv_b"].reshape(r, h, nope + vd)
    # Absorb W_uk into q: q_c (B, H, r)
    w_uk = w_b[..., :nope]
    q_c = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_uk.float())
    scale = 1.0 / math.sqrt(nope + rope_d)
    q_c = q_c.to(kv_cache.dtype)
    scores = (torch.einsum("bhr,bsr->bhs", q_c.float(), kv_cache.float()) +
              torch.einsum("bhd,bsd->bhs",
                           q_rope.to(kr_cache.dtype).float(),
                           kr_cache.float())) * scale
    valid = torch.arange(kv_cache.shape[1], device=x.device)[None, :] <= \
        pos[:, None]
    scores = scores.masked_fill(~valid[:, None, :], _NEG_INF)
    pattn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pattn.to(kv_cache.dtype).float(),
                       kv_cache.float())
    # Absorb W_uv on the way out: (B, H, r) x (r, H, vd) -> (B, H, vd)
    w_uv = w_b[..., nope:]
    out = torch.einsum("bhr,rhv->bhv", ctx.to(x.dtype).float(),
                       w_uv.float())
    return linear(out.reshape(b, h * vd).to(x.dtype), p["wo"])
