"""Model assembly (the port of `repro.models.transformer`).

Layers are described by (mixer, ffn) descriptors, run-length encoded into
groups whose params carry a leading `reps` axis, exactly as in the reference,
so a param tree converts leaf for leaf.  A Python loop over the layers of a
group stands in for `lax.scan`, and a checkpoint around each layer for
`jax.checkpoint` of its body under remat.

Mixers: attn (GQA, full or sliding-window), mla, ssm (Mamba-style), hybrid
(parallel attn + SSM heads), mlstm, slstm.  FFNs: mlp (SwiGLU or GELU), moe
(capacity dispatch), none.  Inputs: tokens, or embeddings (B, S, d_model)
from a modality front-end (audio, vision), as the reference takes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig
from ..core.torch_frontend import capture_functions
from ..parallel import spmd
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .flags import ModelFlags, flags, get_flags
from .layers import embed, init_mlp, mlp, rmsnorm, unembed

Params = Dict

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


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# -- init --------------------------------------------------------------------

# values of the largest leaf `init_params` draws in f32 at once
_DRAW_VALUES = 2 ** 28


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Fresh weights with the reference's shapes, dtypes and init scales
    (`transformer.py::_init_block`: `ln1` and the mixer's leaves, `ln2` and
    the FFN's only where the block has an FFN; normal 0.02 for projections,
    1.0 for the embedding and the SSM's `w_dt`, zero biases, unit norms;
    `ssm.py::init_ssm`: `a_log = log(1..N)`, unit `d_skip`, those three
    leaves in f32; `xlstm.py`: `w_if` in f32, `r_gates` at 0.01; `moe.py`:
    the router in f32).  The numbers differ from `jax.random`'s; parity
    tests convert the reference's own weights with
    `convert.params_from_numpy` instead.

    Each leaf is drawn in f32 and cast, one leaf at a time; a leaf of more
    than 2^28 values is drawn in slices along its first axis (a layer at a
    time for a stack of expert weights), so no f32 copy of the whole leaf
    is held.  On `device="meta"` the leaves are shapes only
    (`weight_bytes`)."""
    dtype = torch_dtype(cfg)
    meta = torch.device(device).type == "meta"
    if generator is None and not meta:
        generator = torch.Generator(device=device).manual_seed(0)

    def draw(shape, scale, out_dtype):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * scale).to(device=device, dtype=out_dtype)

    def normal(shape, scale, out_dtype=dtype):
        if meta:
            return torch.empty(shape, dtype=out_dtype, device=device)
        if math.prod(shape) <= _DRAW_VALUES:
            return draw(shape, scale, out_dtype)
        out = torch.empty(shape, dtype=out_dtype, device=device)
        step = max(1, _DRAW_VALUES // math.prod(shape[1:]))
        for i in range(0, shape[0], step):
            n = min(step, shape[0] - i)
            out[i:i + n] = draw((n,) + tuple(shape[1:]), scale, out_dtype)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    params: Params = {"embed": {"table": normal((cfg.vocab_size, d), 1.0)}}
    groups = []
    for (mixer, ffn), reps in layer_groups(cfg):
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
        elif mixer == "mla":
            block["attn"] = attn_mod.init_mla(cfg, reps, normal, dtype,
                                              device)
        if mixer in ("ssm", "hybrid"):
            block["ssm"] = ssm_mod.init_ssm(cfg, reps, normal, dtype, device)
        elif mixer == "mlstm":
            block["mlstm"] = xlstm_mod.init_mlstm(cfg, reps, normal, dtype,
                                                  device)
        elif mixer == "slstm":
            block["slstm"] = xlstm_mod.init_slstm(cfg, reps, normal, dtype,
                                                  device)
        if ffn != "none":
            block["ln2"] = ones((reps, d))
            if ffn == "moe":
                block["ffn"] = moe_mod.init_moe(cfg, reps, normal, dtype,
                                                device)
            else:
                block["ffn"] = init_mlp(reps, d, cfg.d_ff, cfg.mlp_kind,
                                        normal, dtype)
        groups.append(block)
    params["groups"] = groups
    params["final_norm"] = ones((d,))
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size), 0.02)
    return params


def weight_bytes(cfg: ArchConfig) -> int:
    """Bytes of `init_params(cfg)`'s leaves, counted on shapes alone."""
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(init_params(cfg, device="meta")))


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


def _vocab_split(params: Params, cfg: ArchConfig) -> bool:
    """Whether the head holds only this rank's share of the vocab (a
    per-device program whose rules shard it over "model")."""
    w = params["embed"]["table"] if cfg.tie_embeddings else params["head"]
    return w.shape[0 if cfg.tie_embeddings else 1] != cfg.vocab_size


def _logits(params: Params, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """f32 logits, over this rank's share of the vocab where the head is
    split over "model" (`_vocab_split`)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if _vocab_split(params, cfg):
        x = spmd.copy_to(x, "model")
    if cfg.tie_embeddings:
        logits = unembed(x, params["embed"]["table"], transpose=True)
    else:
        logits = unembed(x, params["head"], transpose=False)
    return logits.float()


def _enter(h: torch.Tensor, sp: bool, tp: bool) -> torch.Tensor:
    """A block's input `h` as a region of a per-device program takes it:
    the whole sequence, gathered over "model" where the residual stream is
    sequence-sharded (`sp`).  `tp`: the region is tensor-parallel, its
    gradients partial over "model" and summed here (Megatron's `f`, or the
    gather's reduce-scatter); otherwise it runs alike on every rank."""
    if sp:
        return spmd.all_gather(h, "model", 1, bwd="sum" if tp else "slice")
    return spmd.copy_to(h, "model") if tp else h


def _exit(y: torch.Tensor, sp: bool, tp: bool) -> torch.Tensor:
    """A region's output back in the residual stream's layout: a
    tensor-parallel region's partial sums summed over "model" (`g`), or
    reduce-scattered along the sequence under `sp`; a region run alike on
    every rank cut to this rank's part of the sequence under `sp`."""
    if sp:
        return spmd.reduce_scatter(y, "model", 1) if tp else \
            spmd.scatter(y, "model", 1)
    return spmd.all_reduce(y, "model") if tp else y


def _replicated(fn, h: torch.Tensor, sp: bool) -> torch.Tensor:
    """A region with no tensor-parallel form (the SSM, xLSTM): its weights
    are whole on every rank, and it runs alike on each."""
    return _exit(fn(_enter(h, sp, False)), sp, False)


def _mixer(p: Params, h: torch.Tensor, mixer: str, cfg: ArchConfig,
           positions: torch.Tensor, chunk: int,
           sp: bool = False) -> torch.Tensor:
    """The mixer of one full-sequence block.  In a per-device program,
    `h` and the result are in the residual stream's layout (`sp`: cut
    along the sequence over "model"); attention (GQA or MLA) whose heads
    the rules shard over "model" runs on this rank's heads."""
    if mixer == "mlstm":
        return _replicated(lambda t: xlstm_mod.mlstm_forward(
            p["mlstm"], t, cfg), h, sp)
    if mixer == "slstm":
        return _replicated(lambda t: xlstm_mod.slstm_forward(
            p["slstm"], t, cfg), h, sp)
    if mixer == "ssm":
        return _replicated(lambda t: ssm_mod.ssm_forward(p["ssm"], t, cfg),
                           h, sp)
    if mixer == "mla":
        tp = _mla_split(p["attn"], cfg)
        return _exit(attn_mod.mla_forward(p["attn"], _enter(h, sp, tp), cfg,
                                          positions, chunk), sp, tp)
    tp = p["attn"]["wq"].shape[-1] != cfg.n_heads * cfg.head_dim_
    y = _exit(attn_mod.attn_forward(p["attn"], _enter(h, sp, tp), cfg,
                                    positions, chunk), sp, tp)
    if mixer == "hybrid":
        y = 0.5 * (y + _replicated(lambda t: ssm_mod.ssm_forward(
            p["ssm"], t, cfg), h, sp))
    return y


def _mla_split(p: Params, cfg: ArchConfig) -> bool:
    """Whether an MLA layer holds only this rank's heads (`wo`'s rows cut
    over "model")."""
    return p["wo"].shape[-2] != cfg.n_heads * cfg.v_head_dim


# -- forward -----------------------------------------------------------------

# the reference's remat policies (`transformer.py::forward`); "group",
# "full" and "group_save_moe" checkpoint its scan body, which is one layer
REMATS = ("none", "group", "full", "group_save_moe")


def _sp_constraint(x: torch.Tensor) -> torch.Tensor:
    """Megatron-style sequence parallelism, as the reference's: between
    blocks the residual stream lives sequence-sharded over "model", so the
    row-parallel projections' all-reduces decompose into reduce-scatter
    (+ all-gather at the next consumer).  The identity unless
    `flags.sequence_parallel` is set and the current mesh has a "model"
    axis dividing the sequence.  On a mesh of one device, the card's own,
    the shard is the whole stream, as the reference's constraint is on one
    device.  In the per-device program of a larger mesh the stream, whole
    on every rank, is cut here to this rank's part of the sequence, and
    `forward` keeps it so from block to block (each region gathers it and
    reduce-scatters back, `_enter` / `_exit`).""" 
    if not _sp_applies(x):
        return x
    if spmd.current() is None or spmd.tp_size() == 1:
        return x
    return spmd.scatter(x, "model", 1)


def _sp_applies(x: torch.Tensor) -> bool:
    """`_sp_constraint`'s condition: the flag, and a current mesh whose
    "model" axis divides the sequence.  A mesh whose per-device program is
    not running (one with no devices, or several devices outside a step on
    them) raises: nothing would shard the stream over it."""
    if not get_flags().sequence_parallel:
        return False
    from ..parallel.context import get_current_mesh
    mesh = get_current_mesh()
    if mesh is None or "model" not in mesh.axis_names or \
            x.ndim != 3 or x.shape[1] % mesh.shape["model"] != 0:
        return False
    if mesh.devices is None:
        raise RuntimeError(
            f"sequence_parallel: the {mesh.shape} mesh has no devices "
            f"behind it; nothing runs its per-device program")
    if mesh.size != 1 and spmd.current() is None:
        raise RuntimeError(
            f"sequence_parallel on the {mesh.shape} mesh outside its "
            f"per-device program (`parallel/spmd.py`)")
    return True


# set while `_moe_out` takes its view: the one op `group_save_moe` saves
_NAMING_MOE_OUT = [False]


def _moe_out(y: torch.Tensor) -> torch.Tensor:
    """The reference's `checkpoint_name(y, "moe_out")`: a view of the MoE
    layer's output (no kernel, no bytes), the op `_save_moe_out` saves."""
    _NAMING_MOE_OUT[0] = True
    try:
        return y.view(y.shape)
    finally:
        _NAMING_MOE_OUT[0] = False


def _save_moe_out(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """`group_save_moe`'s policy, the reference's
    `save_only_these_names("moe_out")`: the MoE output is saved, every
    other op of the layer is recomputed in the backward."""
    return CheckpointPolicy.MUST_SAVE if _NAMING_MOE_OUT[0] else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _save_moe_contexts():
    return create_selective_checkpoint_contexts(_save_moe_out)


def _block(p: Params, x: torch.Tensor, mixer: str, ffn: str,
           cfg: ArchConfig, positions: torch.Tensor, chunk: int,
           name_moe_out: bool = False
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One full-sequence layer.  Returns (x, aux_loss), aux_loss None
    unless the FFN is a MoE, whose output `name_moe_out` names for
    `group_save_moe`."""
    if x.shape[1] == positions.shape[0]:
        x = _sp_constraint(x)
    # in a per-device program under sequence parallelism the stream holds
    # this rank's part of the sequence; a norm's weight then sees tokens
    # that differ from rank to rank, and its gradient is summed over them
    sp = x.shape[1] != positions.shape[0]

    def norm(t, scale):
        return rmsnorm(t, spmd.copy_to(scale, "model") if sp else scale,
                       cfg.norm_eps)

    h = norm(x, p["ln1"])
    x = x + _mixer(p, h, mixer, cfg, positions, chunk, sp)
    aux = None
    if ffn != "none":
        h = norm(x, p["ln2"])
        if ffn == "moe":
            moe_forward = moe_mod.moe_forward_ep if \
                get_flags().moe_impl == "ep_shardmap" else \
                moe_mod.moe_forward
            if sp:
                h = _enter(h, sp, False)
            y, aux = moe_forward(p["ffn"], h, cfg)
            if sp:
                y = _exit(y, sp, False)
            if name_moe_out:
                y = _moe_out(y)
        else:
            tp = p["ffn"]["w_down"].shape[-2] != cfg.d_ff
            y = _exit(mlp(_enter(h, sp, tp), p["ffn"]), sp, tp)
        x = x + y
    return x, aux


def _flagged_block(model_flags: ModelFlags,
                   *args) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    # the recomputation in the backward runs under the flags of the first
    # pass, whatever is set when the backward runs: the same path, kernels
    # and all; and, under a capture, the same views
    with flags(**dataclasses.asdict(model_flags)), capture_functions():
        return _block(*args)


def forward(params: Params, cfg: ArchConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, chunk: int = 512,
            remat: str = "group") -> Tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill forward.  tokens (B, S) int, or embeds (B, S, d_model)
    from a modality front-end, cast to the config's dtype in place of the
    embedding.  Returns (logits (B,S,V) f32, aux_loss): the MoE layers'
    load-balancing losses summed over the layers, 0 without MoE.

    `remat` is the reference's policy: "group" and "full" checkpoint each
    layer (`torch.utils.checkpoint`, not reentrant), so the backward runs
    the layer's forward again, kernels included; "none" keeps every
    activation.  It applies only where autograd records (grad mode on and
    a param that requires grad); serving and prefill run the layers as
    they are.  "group_save_moe" checkpoints a dense layer as "group" does,
    and a MoE layer with a selective checkpoint context
    (`create_selective_checkpoint_contexts`) that saves the layer's MoE
    output (`_moe_out`) and recomputes every other op, the reference's
    `save_only_these_names("moe_out")`.  No gradient of the layer reads
    that output (the residual add's does not), so the backward recomputes
    what "group"'s does, as the reference's compiled step does: its FLOPs
    are "group"'s."""
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r} not in {REMATS}")
    dtype = torch_dtype(cfg)
    if embeds is not None:
        x = embeds.to(dtype)
    else:
        x = embed(tokens, params["embed"], dtype, cfg.vocab_size)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    recompute = remat != "none" and records
    model_flags = get_flags()
    for ((mixer, ffn), reps), stacked in zip(layer_groups(cfg),
                                             params["groups"]):
        # under autograd one unbind a leaf, whose backward is one stack;
        # otherwise each layer's views are taken as the layer runs, so the
        # first layer's launches need not wait for all of them
        layers = (_unbind(stacked, reps) if records else
                  (_layer(stacked, i) for i in range(reps)))
        for layer in layers:
            args = (layer, x, mixer, ffn, cfg, positions, chunk)
            save_moe = remat == "group_save_moe" and ffn == "moe"
            if recompute:
                # the blocks draw no random numbers: no RNG state to keep
                x, layer_aux = checkpoint(
                    _flagged_block, model_flags, *args, save_moe,
                    use_reentrant=False, preserve_rng_state=False,
                    **({"context_fn": _save_moe_contexts} if save_moe
                       else {}))
            else:
                x, layer_aux = _block(*args)
            if ffn == "moe":
                aux = aux + layer_aux
    if x.shape[1] != positions.shape[0]:
        # the stream cut along the sequence (sequence parallelism in a
        # per-device program): the head runs on the whole sequence
        x = spmd.all_gather(x, "model", 1, bwd="slice")
    return _logits(params, x, cfg), aux


# -- loss --------------------------------------------------------------------

def loss_fn(params: Params, cfg: ArchConfig, batch: Dict,
            chunk: int = 512, remat: str = "group",
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token NLL over `log_softmax(logits)` plus `aux_weight *
    aux`, as the reference's `loss_fn`.  batch: {"tokens" (B, S) int or
    "embeds" (B, S, d_model), "labels" (B, S) int}; `remat` as
    `forward`'s."""
    tokens, embeds = batch.get("tokens"), batch.get("embeds")
    logits, aux = forward(
        params, cfg,
        tokens=None if tokens is None else torch.as_tensor(tokens),
        embeds=None if embeds is None else torch.as_tensor(embeds),
        chunk=chunk, remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if _vocab_split(params, cfg):
        nll = _vocab_parallel_nll(logits, labels.long())
    else:
        logp = torch.log_softmax(logits, dim=-1)
        # -logp at each label (the reference's take_along_axis), by
        # nll_loss: the same gather, and one a capture of a CUDA program
        # can trace on the CPU (core/torch_frontend)
        nll = F.nll_loss(logp.reshape(-1, logp.shape[-1]),
                         labels.reshape(-1).long(), reduction="none")
    loss = nll.mean() + aux_weight * aux
    local = spmd.current()
    if local is not None and local.size(local.batch_axes) > 1:
        # this rank's share of the global loss: its batch rows' mean over
        # the shards, the aux term (alike on every shard) likewise
        loss = loss / local.size(local.batch_axes)
    return loss


def _vocab_parallel_nll(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """-log softmax at each label, from logits (..., V / tp) holding this
    rank's share of the vocab: the max, the sum of exponentials and the
    label's logit each summed over "model", so no rank holds the
    vocab-wide logits."""
    v = logits.shape[-1]
    lo = spmd.current().index("model") * v
    m = spmd.all_reduce_max(logits.detach().amax(dim=-1), "model")
    z = logits - m[..., None]
    lse = torch.log(spmd.all_reduce(torch.exp(z).sum(dim=-1), "model"))
    local = labels - lo
    mine = (local >= 0) & (local < v)
    picked = torch.gather(z, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    picked = spmd.all_reduce(picked * mine.to(z.dtype), "model")
    return (lse - picked).reshape(-1)


# -- decode ------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> Params:
    """Per-group layer-stacked decode state: KV caches {"kv": {"k", "v"}},
    each (reps, B, S, Kv, hd) with S = max_len (a ring of min(max_len,
    window) under SWA); MLA's compressed cache {"kv": {"kv_c" (reps, B, S,
    kv_lora), "k_rope" (reps, B, S, qk_rope)}}; for SSM and hybrid blocks
    the SSM state {"ssm": {"h"}}, (reps, B, din, N) f32; for xLSTM blocks
    only their recurrent state, {"mlstm": {"c", "n", "m"}} or {"slstm":
    {"c", "n", "h", "m"}}, f32, with `m` at -1e30."""
    dtype = torch_dtype(cfg)
    groups = []
    for (mixer, _), reps in layer_groups(cfg):
        one = {}
        if mixer in ("attn", "hybrid"):
            one["kv"] = attn_mod.init_attn_cache(cfg, batch, max_len, dtype,
                                                 device)
        elif mixer == "mla":
            one["kv"] = attn_mod.init_mla_cache(cfg, batch, max_len, dtype,
                                                device)
        elif mixer == "mlstm":
            one["mlstm"] = xlstm_mod.init_mlstm_state(cfg, batch, device)
        elif mixer == "slstm":
            one["slstm"] = xlstm_mod.init_slstm_state(cfg, batch, device)
        if mixer in ("ssm", "hybrid"):
            one["ssm"] = ssm_mod.init_ssm_state(cfg, batch, device)
        groups.append({kind: {name: buf.expand(reps, *buf.shape).contiguous()
                              for name, buf in leaves.items()}
                       for kind, leaves in one.items()})
    return {"groups": groups}


def decode_step(params: Params, state: Params, cfg: ArchConfig,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Params]:
    """One decode step. token (B,) int; pos (B,) int, one position per slot,
    or a scalar shared by every slot.

    The MoE layers route as the reference's two decode forms do: with a
    (B,) position each slot alone (the per-slot serve step vmaps a one-slot
    decode, so T = 1 and nothing is dropped); with a scalar position the B
    tokens together, against a capacity of B tokens (the reference's
    `decode_step`, which can drop).

    Returns (logits (B, V) f32, state); the caches and recurrent states in
    `state` are updated in place."""
    dtype = torch_dtype(cfg)
    pos = torch.as_tensor(pos, device=token.device).long()
    per_slot = pos.ndim > 0
    pos = pos.expand(token.shape[0])
    x = embed(token, params["embed"], dtype, cfg.vocab_size)
    for ((mixer, ffn), reps), stacked_p, stack in zip(
            layer_groups(cfg), params["groups"], state["groups"]):
        for i in range(reps):
            p = _layer(stacked_p, i)
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            if mixer in ("mlstm", "slstm"):
                # recurrent states are KBs: sliced out, written back whole
                step = xlstm_mod.mlstm_decode if mixer == "mlstm" else \
                    xlstm_mod.slstm_decode
                y, new = step(p[mixer], h, _layer(stack[mixer], i), cfg)
                _write_layer(stack[mixer], new, i)
            elif mixer == "mla":
                y = attn_mod.mla_decode(p["attn"], h, stack["kv"], pos, cfg,
                                        layer_idx=i)
                y = _exit(y, False, _mla_split(p["attn"], cfg))
            elif mixer in ("attn", "hybrid"):
                y = attn_mod.attn_decode(p["attn"], h, stack["kv"], pos, cfg,
                                         layer_idx=i)
                # this rank's heads' share, in a per-device program whose
                # rules cut them over "model"
                y = _exit(y, False, p["attn"]["wq"].shape[-1] !=
                          cfg.n_heads * cfg.head_dim_)
            if mixer in ("ssm", "hybrid"):
                ys, new = ssm_mod.ssm_decode(p["ssm"], h,
                                             _layer(stack["ssm"], i), cfg)
                _write_layer(stack["ssm"], new, i)
                # this rank's channels' share, where the rules cut them
                ys = _exit(ys, False, p["ssm"]["w_out"].shape[-2] !=
                           cfg.ssm_expand * cfg.d_model)
                y = ys if mixer == "ssm" else 0.5 * (y + ys)
            x = x + y
            if ffn == "moe":
                h = rmsnorm(x, p["ln2"], cfg.norm_eps)
                if per_slot:
                    x = x + moe_mod.moe_forward_slots(p["ffn"], h, cfg)
                else:
                    x = x + moe_mod.moe_forward(p["ffn"], h[:, None],
                                                cfg)[0][:, 0]
            elif ffn == "mlp":
                h = rmsnorm(x, p["ln2"], cfg.norm_eps)
                x = x + _exit(mlp(h, p["ffn"]), False,
                              p["ffn"]["w_down"].shape[-2] != cfg.d_ff)
    return _logits(params, x, cfg), state


def _write_layer(stack: Params, new: Params, i: int) -> None:
    """Write one layer's state `new` into layer `i` of the stacked `stack`,
    in place."""
    for name, value in new.items():
        stack[name][i] = value
