"""Model assembly (the port of `repro.models.transformer`: dense GQA,
hybrid attention + SSM, and xLSTM blocks).

Layers are described by (mixer, ffn) descriptors, run-length encoded into
groups whose params carry a leading `reps` axis, exactly as in the reference,
so a param tree converts leaf for leaf.  A Python loop over the layers of a
group stands in for `lax.scan`, and a checkpoint around each layer for
`jax.checkpoint` of its body under remat.  The port runs the ("attn", "mlp"),
("hybrid", "mlp"), ("mlstm", "none") and ("slstm", "none") descriptors,
with full or sliding-window attention; the other mixers and FFNs raise
`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import attention as attn_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .flags import ModelFlags, flags, get_flags
from .layers import embed, mlp, rmsnorm, unembed

Params = Dict

_PORTED = (("attn", "mlp"), ("hybrid", "mlp"), ("mlstm", "none"),
           ("slstm", "none"))


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
    attends = any(mixer in ("attn", "hybrid") for (mixer, _), _ in groups)
    mlps = any(ffn == "mlp" for (_, ffn), _ in groups)
    if (attends and cfg.attention not in ("full", "swa")) or \
            (mlps and cfg.mlp_kind != "swiglu") or cfg.frontend != "none":
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
    (`transformer.py::_init_block`: `ln1` and the mixer's leaves, `ln2` and
    the FFN's only where the block has an FFN; normal 0.02 for projections,
    1.0 for the embedding and the SSM's `w_dt`, zero biases, unit norms;
    `ssm.py::init_ssm`: `a_log = log(1..N)`, unit `d_skip`, those three
    leaves in f32; `xlstm.py`: `w_if` in f32, `r_gates` at 0.01).  The
    numbers differ from `jax.random`'s; parity tests convert the
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
    for (mixer, ffn), reps in _ported_groups(cfg):
        block = {"ln1": ones((reps, d))}
        if mixer in ("attn", "hybrid"):
            attn = {"wq": normal((reps, d, h * hd), 0.02),
                    "wk": normal((reps, d, kv * hd), 0.02),
                    "wv": normal((reps, d, kv * hd), 0.02),
                    "wo": normal((reps, h * hd, d), 0.02)}
            if cfg.qkv_bias:
                attn.update(bq=zeros((reps, h * hd)),
                            bk=zeros((reps, kv * hd)),
                            bv=zeros((reps, kv * hd)))
            block["attn"] = attn
        if mixer == "hybrid":
            block["ssm"] = ssm_mod.init_ssm(cfg, reps, normal, dtype, device)
        elif mixer == "mlstm":
            block["mlstm"] = xlstm_mod.init_mlstm(cfg, reps, normal, dtype,
                                                  device)
        elif mixer == "slstm":
            block["slstm"] = xlstm_mod.init_slstm(cfg, reps, normal, dtype,
                                                  device)
        if ffn != "none":
            block["ln2"] = ones((reps, d))
            block["ffn"] = {"w_gate": normal((reps, d, cfg.d_ff), 0.02),
                            "w_up": normal((reps, d, cfg.d_ff), 0.02),
                            "w_down": normal((reps, cfg.d_ff, d), 0.02)}
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


def _unbind(tree, reps: int) -> List:
    """The `reps` layers of a group-stacked tree, each a tree of views.
    One `torch.unbind` a leaf: its backward stacks the layers' gradients
    once, where indexing layer by layer (`_layer`) would add one zero-filled
    gradient of the whole stack a layer."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, reps) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(reps)]
    return torch.unbind(tree, 0)


def _logits(params: Params, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(x, params["embed"]["table"], transpose=True)
    else:
        logits = unembed(x, params["head"], transpose=False)
    return logits.float()


def _mixer(p: Params, h: torch.Tensor, mixer: str, cfg: ArchConfig,
           positions: torch.Tensor, chunk: int) -> torch.Tensor:
    """The mixer of one full-sequence block."""
    if mixer == "mlstm":
        return xlstm_mod.mlstm_forward(p["mlstm"], h, cfg)
    if mixer == "slstm":
        return xlstm_mod.slstm_forward(p["slstm"], h, cfg)
    y = attn_mod.attn_forward(p["attn"], h, cfg, positions, chunk)
    if mixer == "hybrid":
        y = 0.5 * (y + ssm_mod.ssm_forward(p["ssm"], h, cfg))
    return y


# -- forward -----------------------------------------------------------------

# the reference's remat policies (`transformer.py::forward`); "group" and
# "full" checkpoint its scan body, which is one layer
REMATS = ("none", "group", "full", "group_save_moe")


def _block(p: Params, x: torch.Tensor, mixer: str, ffn: str,
           cfg: ArchConfig, positions: torch.Tensor,
           chunk: int) -> torch.Tensor:
    """One full-sequence layer."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + _mixer(p, h, mixer, cfg, positions, chunk)
    if ffn != "none":
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(h, p["ffn"])
    return x


def _flagged_block(model_flags: ModelFlags, *args) -> torch.Tensor:
    # the recomputation in the backward runs under the flags of the first
    # pass, whatever is set when the backward runs: the same path, kernels
    # and all
    with flags(**dataclasses.asdict(model_flags)):
        return _block(*args)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            chunk: int = 512,
            remat: str = "group") -> Tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill forward. tokens (B, S) int.  Returns (logits (B,S,V)
    f32, aux_loss = 0).  Embedding front-ends (audio, vision) are a later
    slice.

    `remat` is the reference's policy: "group" and "full" checkpoint each
    layer (`torch.utils.checkpoint`, not reentrant), so the backward runs
    the layer's forward again, kernels included; "none" keeps every
    activation.  It applies only where autograd records (grad mode on and
    a param that requires grad); serving and prefill run the layers as
    they are.  "group_save_moe" waits for the MoE port."""
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r} not in {REMATS}")
    if remat == "group_save_moe":
        raise NotImplementedError(
            "remat='group_save_moe' saves the MoE output, and MoE is not "
            "ported yet")
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    recompute = remat != "none" and records
    model_flags = get_flags()
    for ((mixer, ffn), reps), stacked in zip(_ported_groups(cfg),
                                             params["groups"]):
        # under autograd one unbind a leaf, whose backward is one stack;
        # otherwise each layer's views are taken as the layer runs, so the
        # first layer's launches need not wait for all of them
        layers = (_unbind(stacked, reps) if records else
                  (_layer(stacked, i) for i in range(reps)))
        for layer in layers:
            args = (layer, x, mixer, ffn, cfg, positions, chunk)
            if recompute:
                # the blocks draw no random numbers: no RNG state to keep
                x = checkpoint(_flagged_block, model_flags, *args,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _block(*args)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x, cfg), aux


# -- loss --------------------------------------------------------------------

def loss_fn(params: Params, cfg: ArchConfig, batch: Dict,
            chunk: int = 512, remat: str = "group",
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token NLL over `log_softmax(logits)` plus `aux_weight *
    aux`, as the reference's `loss_fn`.  batch: {"tokens", "labels"} (B, S)
    int; `remat` as `forward`'s."""
    tokens = torch.as_tensor(batch["tokens"])
    logits, aux = forward(params, cfg, tokens, chunk=chunk, remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    # -logp at each label (the reference's take_along_axis), by nll_loss:
    # the same gather, and one a capture of a CUDA program can trace on
    # the CPU (core/torch_frontend)
    nll = F.nll_loss(logp.reshape(-1, logp.shape[-1]),
                     labels.reshape(-1).long(), reduction="none")
    return nll.mean() + aux_weight * aux


# -- decode ------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> Params:
    """Per-group layer-stacked decode state: KV caches {"kv": {"k", "v"}},
    each (reps, B, S, Kv, hd) with S = max_len (a ring of min(max_len,
    window) under SWA); for hybrid blocks also the SSM state {"ssm":
    {"h"}}, (reps, B, din, N) f32; for xLSTM blocks only their recurrent
    state, {"mlstm": {"c", "n", "m"}} or {"slstm": {"c", "n", "h", "m"}},
    f32, with `m` at -1e30."""
    dtype = torch_dtype(cfg)
    groups = []
    for (mixer, _), reps in _ported_groups(cfg):
        if mixer == "mlstm":
            one = {"mlstm": xlstm_mod.init_mlstm_state(cfg, batch, device)}
        elif mixer == "slstm":
            one = {"slstm": xlstm_mod.init_slstm_state(cfg, batch, device)}
        else:
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
    for ((mixer, ffn), reps), stacked_p, stack in zip(
            _ported_groups(cfg), params["groups"], state["groups"]):
        for i in range(reps):
            p = _layer(stacked_p, i)
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            if mixer in ("mlstm", "slstm"):
                # recurrent states are KBs: sliced out, written back whole
                step = xlstm_mod.mlstm_decode if mixer == "mlstm" else \
                    xlstm_mod.slstm_decode
                y, new = step(p[mixer], h, _layer(stack[mixer], i), cfg)
                _write_layer(stack[mixer], new, i)
            else:
                y = attn_mod.attn_decode(p["attn"], h, stack["kv"], pos, cfg,
                                         layer_idx=i)
            if mixer == "hybrid":
                ys, new = ssm_mod.ssm_decode(p["ssm"], h,
                                             _layer(stack["ssm"], i), cfg)
                _write_layer(stack["ssm"], new, i)
                y = 0.5 * (y + ys)
            x = x + y
            if ffn != "none":
                h = rmsnorm(x, p["ln2"], cfg.norm_eps)
                x = x + mlp(h, p["ffn"])
    return _logits(params, x, cfg), state


def _write_layer(stack: Params, new: Params, i: int) -> None:
    """Write one layer's state `new` into layer `i` of the stacked `stack`,
    in place."""
    for name, value in new.items():
        stack[name][i] = value
