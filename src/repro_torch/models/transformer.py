"""Model assembly (the port of `repro.models.transformer`: dense GQA and
hybrid attention + SSM blocks).

Layers are described by (mixer, ffn) descriptors, run-length encoded into
groups whose params carry a leading `reps` axis, exactly as in the reference,
so a param tree converts leaf for leaf.  A Python loop over the layers of a
group stands in for `lax.scan`.  The port runs the ("attn", "mlp") and
("hybrid", "mlp") descriptors, with full or sliding-window attention; the
other mixers and FFNs raise `NotImplementedError`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import attention as attn_mod
from . import ssm as ssm_mod
from .layers import embed, mlp, rmsnorm, unembed

Params = Dict

_PORTED = (("attn", "mlp"), ("hybrid", "mlp"))


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
        if desc not in _PORTED:
            raise NotImplementedError(
                f"layer {desc} of {cfg.name} is not ported yet; the port "
                f"runs {_PORTED} blocks")
    if cfg.attention not in ("full", "swa") or cfg.mlp_kind != "swiglu" or \
            cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name} (attention={cfg.attention!r}, mlp={cfg.mlp_kind!r}, "
            f"frontend={cfg.frontend!r}) is not ported yet; the port runs "
            f"full or sliding-window GQA attention, a SwiGLU MLP and token "
            f"inputs")
    return groups


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# -- init --------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Fresh weights with the reference's shapes, dtypes and init scales
    (`transformer.py::init_params`: normal 0.02 for projections, 1.0 for the
    embedding and the SSM's `w_dt`, zero biases, unit norms; `ssm.py::
    init_ssm`: `a_log = log(1..N)`, unit `d_skip`, those three leaves in
    f32).  The numbers differ from `jax.random`'s; parity tests convert the
    reference's own weights with `convert.params_from_numpy` instead."""
    dtype = torch_dtype(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape, scale, out_dtype=dtype):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * scale).to(device=device, dtype=out_dtype)

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
        block = {"ln1": ones((reps, d)), "attn": attn}
        if desc[0] == "hybrid":
            block["ssm"] = ssm_mod.init_ssm(cfg, reps, normal, dtype, device)
        block.update(ln2=ones((reps, d)), ffn=ffn)
        groups.append(block)
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
    for ((mixer, _), reps), stacked in zip(_ported_groups(cfg),
                                           params["groups"]):
        for i in range(reps):
            p = _layer(stacked, i)
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            y = attn_mod.attn_forward(p["attn"], h, cfg, positions, chunk)
            if mixer == "hybrid":
                y = 0.5 * (y + ssm_mod.ssm_forward(p["ssm"], h, cfg))
            x = x + y
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp(h, p["ffn"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x, cfg), aux


# -- decode ------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> Params:
    """Per-group layer-stacked decode state: KV caches {"kv": {"k", "v"}},
    each (reps, B, S, Kv, hd) with S = max_len (a ring of min(max_len,
    window) under SWA), and for hybrid blocks the SSM state {"ssm": {"h"}},
    (reps, B, din, N) f32."""
    dtype = torch_dtype(cfg)
    groups = []
    for (mixer, _), reps in _ported_groups(cfg):
        one = {"kv": attn_mod.init_attn_cache(cfg, batch, max_len, dtype,
                                              device)}
        if mixer == "hybrid":
            one["ssm"] = ssm_mod.init_ssm_state(cfg, batch, device)
        groups.append({kind: {name: buf.expand(reps, *buf.shape).contiguous()
                              for name, buf in leaves.items()}
                       for kind, leaves in one.items()})
    return {"groups": groups}


def decode_step(params: Params, state: Params, cfg: ArchConfig,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Params]:
    """One decode step. token (B,) int; pos (B,) int, one position per slot
    (a scalar is broadcast to every slot).

    Returns (logits (B, V) f32, state); the caches and recurrent states in
    `state` are updated in place."""
    dtype = torch_dtype(cfg)
    pos = torch.as_tensor(pos, device=token.device).long().expand(
        token.shape[0])
    x = embed(token, params["embed"], dtype)
    for ((mixer, _), reps), stacked_p, stack in zip(
            _ported_groups(cfg), params["groups"], state["groups"]):
        for i in range(reps):
            p = _layer(stacked_p, i)
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            y = attn_mod.attn_decode(p["attn"], h, stack["kv"], pos, cfg,
                                     layer_idx=i)
            if mixer == "hybrid":
                # the SSM state is KBs: sliced out and written back whole
                ys, new = ssm_mod.ssm_decode(p["ssm"], h,
                                             _layer(stack["ssm"], i), cfg)
                stack["ssm"]["h"][i] = new["h"]
                y = 0.5 * (y + ys)
            x = x + y
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp(h, p["ffn"])
    return _logits(params, x, cfg), state
