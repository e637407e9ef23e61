"""Mixture-of-Experts with capacity-based sort dispatch (the port of
`repro.models.moe`).

Routing: softmax top-k over f32 router logits, gates renormalised, the
Switch load-balancing aux loss.  Dispatch: the (token, choice) assignments
sorted by expert id (a stable sort, as `jnp.argsort`), each ranked within
its expert; rank >= capacity drops the assignment.  Kept assignments are
added into per-expert capacity buffers (E, C, D), the experts run as
batched products, and the outputs are gathered back and weighted by their
gates.

Every shape is static, as in the reference: no `nonzero`, no boolean-mask
indexing and no `.item()`, so a capture on fake tensors runs the same
code.

Every sum over a repeated index runs in a fixed order, so the forward and
the gradients have the same bits run after run on the card, where an
`index_add` of rows adds them with atomics in an order that changes.  A
token's k contributions meet in ascending expert id, the order in which
the reference's scatter-adds meet them in the sorted list (and apply them
on the CPU): in the combine (`_combine`), and in the backward of the
dispatch's gather (`_GatherTokens`), where each token was gathered k
times.  The two `index_add_`s left repeat no index that carries a
gradient: the dispatch buffer's (`_dispatch_buffer`) repeats only the
clamped row of dropped assignments, which add zeros, and routing's count
of assignments an expert (`route`) has no gradient.

The routing is computed over *groups* of tokens (G, T, D), each group
routed and dispatched on its own against a capacity of its own T.
`moe_forward` is one group of every token, the reference's form.
`moe_forward_slots` is one group a decode slot: the reference's per-slot
serve step vmaps its one-slot decode over the slots, so each slot routes
alone (T = 1, capacity 8, nothing dropped).  Here the slots are one batched
product over (G, E, C, D), so the expert weights are read once a layer,
not once a slot.

`moe_forward_ep` is the reference's shard_map expert parallelism: each
shard of the current mesh routes its own tokens (`_local_dispatch_compute`)
and exchanges them with the expert shards by two all-to-alls over "model"
(`all_to_all_single`, tiled as `jax.lax.all_to_all`), in the per-device
program of the mesh (`parallel/spmd.py`); on the card's own `(1, 1)` mesh
the all-to-alls are the identity; off a mesh it falls back to
`moe_forward`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..parallel import spmd
from .layers import init_mlp, linear, mlp

Params = Dict[str, torch.Tensor]


def init_moe(cfg: ArchConfig, reps: int, normal, dtype: torch.dtype,
             device) -> Params:
    """Layer-stacked params (leading `reps` axis) with the reference's
    shapes: the router (d, E) in f32 whatever the config's dtype, the
    experts' `w_gate`/`w_up` (E, d, ff) and `w_down` (E, ff, d), no
    `w_gate` under GELU, and a shared MLP of width ff * n_shared_experts
    where the config has shared experts."""
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    p: Params = {"router": normal((reps, d, e), 0.02, torch.float32)}
    if cfg.mlp_kind == "swiglu":
        p["w_gate"] = normal((reps, e, d, ff), 0.02, dtype)
    p["w_up"] = normal((reps, e, d, ff), 0.02, dtype)
    p["w_down"] = normal((reps, e, ff, d), 0.02, dtype)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(reps, d, ff * cfg.n_shared_experts,
                               cfg.mlp_kind, normal, dtype)
    return p


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


class Routing(NamedTuple):
    """The routing of G groups of T tokens over E experts (choice k)."""
    probs: torch.Tensor        # (G, T, E) f32 softmax of the router logits
    gates: torch.Tensor        # (G, T, k) f32, renormalised
    expert_ids: torch.Tensor   # (G, T, k) int64, largest probability first
    margin: torch.Tensor       # (G, T) f32: k-th largest probability less
                               # the (k+1)-th, inf where k == E
    aux: torch.Tensor          # (G,) f32 Switch load-balancing loss


def route(p: Params, xf: torch.Tensor, cfg: ArchConfig) -> Routing:
    """xf (G, T, D) -> the routing of each group.  The router's product
    runs in f32 whatever xf's dtype."""
    t, k, e = xf.shape[1], cfg.top_k, cfg.n_experts
    logits = linear(xf.float(), p["router"])                  # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    # `jax.lax.top_k`: largest first, and among equal values the lower
    # index first, which a stable descending sort gives (`torch.topk`
    # makes no promise about ties)
    ranked, ranked_ids = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_vals, expert_ids = ranked[..., :k], ranked_ids[..., :k]
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                    min=1e-9)
    margin = ranked[..., k - 1] - ranked[..., k] if k < e else \
        torch.full(probs.shape[:-1], float("inf"), device=probs.device)

    # Load-balancing auxiliary loss (Switch-style).
    me = probs.mean(dim=1)                                    # (G, E)
    groups = xf.shape[0]
    offsets = torch.arange(groups, device=xf.device)[:, None] * e
    ce = torch.zeros(groups * e, dtype=torch.float32, device=xf.device)
    ce.index_add_(0, (expert_ids.reshape(groups, t * k) + offsets
                      ).reshape(-1),
                  torch.full((groups * t * k,), 1.0 / (t * k),
                             device=xf.device))
    aux = e * (me * ce.reshape(groups, e)).sum(-1)
    return Routing(probs, gates, expert_ids, margin, aux)


class Dispatch(NamedTuple):
    """Where each assignment goes, in the order of the sort by expert."""
    order: torch.Tensor   # (G, T*k) the sort of the flat assignments
    tokens: torch.Tensor  # (G, T*k) the token of each sorted assignment
    keep: torch.Tensor    # (G, T*k) bool: rank within its expert < capacity
    dest: torch.Tensor    # (G, T*k) row of the (E * C) buffer
    pos: torch.Tensor     # (G, T, k) each token's places in the sorted
                          # list, ascending: its experts by ascending id


def dispatch(expert_ids: torch.Tensor, cap: int) -> Dispatch:
    """The reference's sort dispatch, per group: the flat (T*k,)
    assignments sorted by expert id (stable: ties keep token order, as
    `jnp.argsort`), ranked within their expert; rank >= cap drops."""
    groups, t, k = expert_ids.shape
    flat_e = expert_ids.reshape(groups, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    # the reference's flat_tok = repeat(arange(t), k), read in sorted order:
    # flat assignment j is token j // k's
    tokens = torch.div(order, k, rounding_mode="floor")
    # rank within expert = position - first occurrence of that expert id
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(t * k, device=expert_ids.device) - first
    keep = rank < cap
    dest = se * cap + torch.clamp(rank, max=cap - 1)
    # the place of each (token, choice) in the sorted list; sorted per
    # token, it lists the token's assignments by expert id
    pos = torch.empty_like(order).scatter_(
        -1, order, torch.arange(t * k, device=expert_ids.device).expand(
            groups, t * k))
    pos = torch.sort(pos.reshape(groups, t, k), dim=-1).values
    return Dispatch(order, tokens, keep, dest, pos)


def _experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """buf (G, E, C, D) -> each expert's MLP on its rows, (G, E, C, D)."""
    dtype = buf.dtype
    if "w_gate" in p:
        h = F.silu(torch.einsum("gecd,edf->gecf", buf,
                                p["w_gate"].to(dtype)))
        h = h * torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dtype))
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dtype)),
                   approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dtype))


def _dispatch_buffer(x: torch.Tensor, ds: Dispatch, e: int,
                     cap: int) -> torch.Tensor:
    """x (G, T, D) -> each expert's capacity buffer (G, E, C, D): every
    assignment's token added into its expert's buffer row; a dropped one
    adds zeros to the row its rank was clamped to, as the reference's
    masked `.at[dest].add`."""
    groups, t, d = x.shape
    rows = torch.arange(groups, device=x.device)[:, None]
    xs = _GatherTokens.apply(x, ds.tokens, ds.pos)           # (G, T*k, D)
    xs = torch.where(ds.keep[..., None], xs, torch.zeros_like(xs))
    buf = torch.zeros((groups * e * cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, (ds.dest + rows * (e * cap)).reshape(-1),
                   xs.reshape(-1, d))
    return buf.reshape(groups, e, cap, d)


def _take(table: torch.Tensor, n: int, index: torch.Tensor) -> torch.Tensor:
    """Rows `index` (G, ...) of each group's n rows of `table` (G, n, ...,
    D): row r of group g is row g * n + r of the groups' rows laid end to
    end, so the gather is one `index_select`."""
    groups, d = table.shape[0], table.shape[-1]
    rows = torch.arange(groups, device=table.device).reshape(
        (groups,) + (1,) * (index.ndim - 1))
    flat = (index + rows * n).reshape(-1)
    return table.reshape(-1, d).index_select(0, flat).reshape(
        index.shape + (d,))


def _sum_by_token(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """rows (G, T*k, D), one a sorted assignment -> (G, T, D): each token's
    k rows (`Dispatch.pos`) summed one after another in ascending expert
    id, in the rows' dtype; a gather of unique rows, no atomics."""
    t, k = pos.shape[1], pos.shape[2]
    parts = _take(rows, t * k, pos)                          # (G, T, k, D)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    return y


class _GatherTokens(torch.autograd.Function):
    """The dispatch's gather, x (G, T, D) -> its rows `tokens` (G, T*k, D),
    each token k times.  The backward sums a token's k row gradients by
    `_sum_by_token`, in ascending expert id: autograd's own, an
    `index_add` of the rows, adds them with atomics on the card, whose
    order, and so whose bits, change from run to run when k > 2."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, tokens: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(pos)
        return _take(x, x.shape[1], tokens)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (pos,) = ctx.saved_tensors
        return _sum_by_token(grad, pos), None, None


def _combine(out_buf: torch.Tensor, gates: torch.Tensor, ds: Dispatch,
             k: int) -> torch.Tensor:
    """Each token's k expert outputs, gathered back from the buffers
    out_buf (G, E, C, D) and weighted by their gates (G, T, k) -> y (G, T,
    D).  A token's k contributions are summed in a fixed order, in the
    buffers' dtype (`_sum_by_token`): by ascending expert id, the order in
    which the reference's `.at[st].add` meets them in the sorted list (and
    applies them on the CPU).  An `index_add` of the rows would add them
    with atomics on the card, in an order, and to bits, that change from
    run to run.  The gather from the buffers repeats a row only at the
    `dest` of a dropped assignment, whose weight is 0, so its backward adds
    zeros there."""
    groups, e, cap, d = out_buf.shape
    t = gates.shape[1]
    sorted_gates = gates.reshape(groups, t * k).gather(-1, ds.order)
    weight = torch.where(ds.keep, sorted_gates,
                         torch.zeros_like(sorted_gates)).to(out_buf.dtype)
    gathered = _take(out_buf, e * cap, ds.dest) * weight[..., None]
    return _sum_by_token(gathered, ds.pos)


def moe_groups(p: Params, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (G, T, D), each group routed and dispatched on its own -> (y (G,
    T, D), aux (G,))."""
    cap = _capacity(cfg, x.shape[1])
    r = route(p, x, cfg)
    ds = dispatch(r.expert_ids, cap)
    buf = _dispatch_buffer(x, ds, cfg.n_experts, cap)
    y = _combine(_experts(p, buf), r.gates, ds, cfg.top_k)
    if "shared" in p:
        y = y + mlp(x, p["shared"])
    return y, r.aux


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar): every token of the
    batch routed together, the reference's `moe_forward`.  In a per-device
    program whose batch is cut over data axes, the batch's rows are
    gathered from them first, every rank routes them all alike, and keeps
    its own rows of the result (the gradients stay partial over the data
    axes: the gather's backward reduce-scatters, the cut's pads with
    zeros)."""
    local = spmd.current()
    axes = () if local is None else local.batch_axes
    if axes:
        x = spmd.all_gather(x, axes, 0, bwd="sum")
    b, s, d = x.shape
    y, aux = moe_groups(p, x.reshape(1, b * s, d), cfg)
    y = y.reshape(b, s, d)
    if axes:
        y = spmd.scatter(y, axes, 0, bwd="zeros")
    return y, aux[0]


def moe_forward_slots(p: Params, x: torch.Tensor, cfg: ArchConfig
                      ) -> torch.Tensor:
    """x (B, D), one token a decode slot, each slot routed alone (the
    reference's per-slot serve step) -> y (B, D)."""
    y, _ = moe_groups(p, x[:, None], cfg)
    return y[:, 0]


# -- expert parallelism (the reference's shard_map form) -----------------------

def _all_to_all(buf: torch.Tensor, tp: int, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """`jax.lax.all_to_all(buf, "model", split_axis, concat_axis,
    tiled=True)` over a "model" axis of `tp` devices: `buf` split into tp
    parts along `split_axis`, part j sent to device j, the parts received
    laid end to end along `concat_axis`.  On one device that is `buf`
    itself; on more, one `all_to_all_single` over the "model" group of the
    running per-device program (`parallel/spmd.py`)."""
    if tp == 1:
        return buf
    if spmd.tp_size() != tp:
        raise RuntimeError(f"all_to_all over a 'model' axis of {tp} "
                           f"devices outside a per-device program of one")
    return spmd.all_to_all(buf, "model", split_axis, concat_axis)


def _local_dispatch_compute(p: Params, xf: torch.Tensor, cfg: ArchConfig,
                            tp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard body: local routing, all-to-all to expert shards, batched
    expert FFN with *stationary* weights, all-to-all back, local combine.

    xf: local tokens (T_l, D); the expert weights in `p` are the local
    shard (E / tp, D, ff) of a "model" axis of `tp` devices.  Wire traffic
    per device = 2 x the dispatch buffer (~capacity_factor * k * T_l * D
    elements) instead of the global sort's.  Returns (y (T_l, D), aux)."""
    cap = _capacity(cfg, xf.shape[0])
    r = route(p, xf[None], cfg)
    ds = dispatch(r.expert_ids, cap)                 # local sort only
    buf = _dispatch_buffer(xf[None], ds, cfg.n_experts, cap)[0]
    # dispatch: (E, C_l, D) -> (E_local, tp*C_l, D) on the owning shard
    buf = _all_to_all(buf, tp, split_axis=0, concat_axis=1)
    out_buf = _experts(p, buf[None])[0]
    # return: (E_local, tp*C_l, D) -> (E, C_l, D) back on the token shards
    out_buf = _all_to_all(out_buf, tp, split_axis=1, concat_axis=0)
    y = _combine(out_buf[None], r.gates, ds, cfg.top_k)[0]
    return y, r.aux[0]


def moe_forward_ep(p: Params, x: torch.Tensor, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the current mesh (`parallel/context.py`):
    routing stays shard-local, expert weights stay stationary, the only
    collectives are two all-to-alls along the "model" axis.  Off a mesh,
    or where the "model" axis does not divide the experts, it falls back
    to `moe_forward`, as the reference does.

    This is the per-shard body, run by every rank of the per-device
    program of the current mesh (`parallel/spmd.py`) on its own tokens,
    its batch rows, whole over "model" as the reference's `shard_map`
    takes them (`P(dp, None, None)`), and on its own experts, E / tp of
    them; on the card's own `(1, 1)` mesh the all-to-alls and the data
    shards' mean of the aux loss are the identity.  Every rank of "model"
    sends the same buffer, so each expert shard runs its experts on tp
    copies of it and each copy's output goes back to its sender: the
    expert weights' gradient sums the tp copies' and is taken 1 / tp
    times, the one copy's.  A mesh with no devices behind it raises, and
    so does a mesh of several devices outside its per-device program."""
    from ..parallel.context import get_current_mesh

    mesh = get_current_mesh()
    if mesh is None or "model" not in mesh.axis_names or \
            cfg.n_experts % mesh.shape["model"] != 0:
        return moe_forward(p, x, cfg)
    if mesh.devices is None:
        raise RuntimeError(
            f"moe_forward_ep: the {mesh.shape} mesh has no devices behind "
            f"it; nothing runs its per-device program")
    local = spmd.current()
    if mesh.size != 1 and local is None:
        raise RuntimeError(
            f"moe_forward_ep on the {mesh.shape} mesh outside its "
            f"per-device program (`parallel/spmd.py`)")
    tp = mesh.shape["model"]
    if tp > 1:
        p = {k: (spmd.scale_grad(v, 1.0 / tp)
                 if k in ("w_gate", "w_up", "w_down") else v)
             for k, v in p.items()}
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    y, aux = _local_dispatch_compute(p, xf, cfg, tp)
    if "shared" in p:
        y = y + mlp(xf, p["shared"])
    if local is not None and local.batch_axes:
        # the data shards' mean (`jax.lax.pmean`); its users' gradients
        # are partial over the data axes, so its backward sums them
        aux = spmd.all_reduce(aux, local.batch_axes, bwd="sum") / \
            local.size(local.batch_axes)
    return y.reshape(b, s, d), aux
