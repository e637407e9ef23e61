"""Model assembly (the port of `repro.models.transformer`, dense GQA part).

Layers are described by (mixer, ffn) descriptors, run-length encoded into
groups whose params carry a leading `reps` axis, exactly as in the reference,
so a param tree converts leaf for leaf.  A Python loop over the layers of a
group stands in for `lax.scan`.  This slice runs the ("attn", "mlp")
descriptor; the other mixers and FFNs raise `NotImplementedError`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import attention as attn_mod
from .layers import embed, mlp, rmsnorm, unembed

Params = Dict

_PORTED = ("attn", "mlp")


# -- static layer plan -------------------------------------------------------

def layer_descriptors(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """Per-layer (mixer, ffn) descriptors."""
    out: List[Tuple[str, str]] = []
    for i, kind in enumerate(cfg.block_kinds):
        if kind in ("mlstm", "slstm"):
            out.append((kind, "none"))
            continue
        mixer = "hybrid" if kind == "hybrid" else (
            "mla" if cfg.attention == "mla" else
            ("ssm" if kind == "ssm" else "attn"))
        if cfg.n_experts > 0 and i >= cfg.first_dense_layers:
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "mlp"
        else:
            ffn = "none"
        out.append((mixer, ffn))
    return out


def layer_groups(cfg: ArchConfig) -> List[Tuple[Tuple[str, str], int]]:
    """Run-length encoded descriptors -> [(descriptor, reps)]."""
    groups: List[Tuple[Tuple[str, str], int]] = []
    for d in layer_descriptors(cfg):
        if groups and groups[-1][0] == d:
            groups[-1] = (d, groups[-1][1] + 1)
        else:
            groups.append((d, 1))
    return groups


def _ported_groups(cfg: ArchConfig) -> List[Tuple[Tuple[str, str], int]]:
    groups = layer_groups(cfg)
    for desc, _ in groups:
        if desc != _PORTED:
            raise NotImplementedError(
                f"layer {desc} of {cfg.name} is not ported yet; this slice "
                f"runs {_PORTED} blocks")
    if cfg.attention != "full" or cfg.mlp_kind != "swiglu" or \
            cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name} (attention={cfg.attention!r}, mlp={cfg.mlp_kind!r}, "
            f"frontend={cfg.frontend!r}) is not ported yet; this slice runs "
            f"full GQA attention, a SwiGLU MLP and token inputs")
    return groups


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# -- init --------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Fresh weights with the reference's shapes and init scales
    (`transformer.py::init_params`: normal 0.02 for projections, 1.0 for the
    embedding, zero biases, unit norms).  The numbers differ from
    `jax.random`'s; parity tests convert the reference's own weights with
    `convert.params_from_numpy` instead."""
    dtype = torch_dtype(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * scale).to(device=device, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    params: Params = {"embed": {"table": normal((cfg.vocab_size, d), 1.0)}}
    groups = []
    for desc, reps in _ported_groups(cfg):
        attn = {"wq": normal((reps, d, h * hd), 0.02),
                "wk": normal((reps, d, kv * hd), 0.02),
                "wv": normal((reps, d, kv * hd), 0.02),
                "wo": normal((reps, h * hd, d), 0.02)}
        if cfg.qkv_bias:
            attn.update(bq=zeros((reps, h * hd)), bk=zeros((reps, kv * hd)),
                        bv=zeros((reps, kv * hd)))
        ffn = {"w_gate": normal((reps, d, cfg.d_ff), 0.02),
               "w_up": normal((reps, d, cfg.d_ff), 0.02),
               "w_down": normal((reps, cfg.d_ff, d), 0.02)}
        groups.append({"ln1": ones((reps, d)), "attn": attn,
                       "ln2": ones((reps, d)), "ffn": ffn})
    params["groups"] = groups
    params["final_norm"] = ones((d,))
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size), 0.02)
    return params


def _layer(tree, i: int):
    """Layer `i` of a group-stacked tree (a view, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _logits(params: Params, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(x, params["embed"]["table"], transpose=True)
    else:
        logits = unembed(x, params["head"], transpose=False)
    return logits.float()


# -- forward -----------------------------------------------------------------

def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward. tokens (B, S) int.  Returns (logits (B,S,V) f32,
    aux_loss = 0).  Embedding front-ends (audio, vision) are a later
    slice."""
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for (_, reps), stacked in zip(_ported_groups(cfg), params["groups"]):
        for i in range(reps):
            p = _layer(stacked, i)
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            x = x + attn_mod.attn_forward(p["attn"], h, cfg, positions, chunk)
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp(h, p["ffn"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x, cfg), aux


# -- decode ------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> Params:
    """Per-group layer-stacked KV caches {"kv": {"k", "v"}}, each
    (reps, B, max_len, Kv, hd)."""
    dtype = torch_dtype(cfg)
    groups = []
    for _, reps in _ported_groups(cfg):
        one = attn_mod.init_attn_cache(cfg, batch, max_len, dtype, device)
        groups.append({"kv": {name: buf[None].repeat(reps, 1, 1, 1, 1)
                              for name, buf in one.items()}})
    return {"groups": groups}


def decode_step(params: Params, state: Params, cfg: ArchConfig,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Params]:
    """One decode step. token (B,) int; pos (B,) int, one position per slot
    (a scalar is broadcast to every slot).

    Returns (logits (B, V) f32, state); the caches in `state` are updated in
    place."""
    dtype = torch_dtype(cfg)
    pos = torch.as_tensor(pos, device=token.device).long().expand(
        token.shape[0])
    x = embed(token, params["embed"], dtype)
    for (_, reps), stacked_p, stack in zip(
            _ported_groups(cfg), params["groups"], state["groups"]):
        for i in range(reps):
            p = _layer(stacked_p, i)
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            x = x + attn_mod.attn_decode(p["attn"], h, stack["kv"], pos, cfg,
                                         layer_idx=i)
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp(h, p["ffn"])
    return _logits(params, x, cfg), state
