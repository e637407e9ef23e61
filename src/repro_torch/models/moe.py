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

The routing is computed over *groups* of tokens (G, T, D), each group
routed and dispatched on its own against a capacity of its own T.
`moe_forward` is one group of every token, the reference's form.
`moe_forward_slots` is one group a decode slot: the reference's per-slot
serve step vmaps its one-slot decode over the slots, so each slot routes
alone (T = 1, capacity 8, nothing dropped).  Here the slots are one batched
product over (G, E, C, D), so the expert weights are read once a layer,
not once a slot.

The reference's shard_map expert parallelism (`moe_forward_ep`, with its
per-shard body `_local_dispatch_compute`) needs a mesh; off a mesh it
falls back to `moe_forward`, which is what one card runs.  It waits for the
port of `parallel/`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
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
    return Dispatch(order, tokens, keep, dest)


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


def moe_groups(p: Params, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (G, T, D), each group routed and dispatched on its own -> (y (G,
    T, D), aux (G,))."""
    groups, t, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    cap = _capacity(cfg, t)
    r = route(p, x, cfg)
    ds = dispatch(r.expert_ids, cap)
    # row r of group g is row g * n + r of the groups' rows laid end to
    # end: the gathers below are `index_select`s of those rows
    rows = torch.arange(groups, device=x.device)[:, None]

    def take(table, n, index):
        flat = (index + rows.reshape((groups,) + (1,) * (index.ndim - 1))
                * n).reshape(-1)
        return table.reshape(-1, d).index_select(0, flat).reshape(
            index.shape + (d,))

    # every assignment's token added into its expert's buffer row; a
    # dropped one adds zeros to the row its rank was clamped to, as the
    # reference's masked `.at[dest].add`
    xs = take(x, t, ds.tokens)                                # (G, T*k, D)
    xs = torch.where(ds.keep[..., None], xs, torch.zeros_like(xs))
    buf = torch.zeros((groups * e * cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, (ds.dest + rows * (e * cap)).reshape(-1),
                   xs.reshape(-1, d))
    out_buf = _experts(p, buf.reshape(groups, e, cap, d))

    # Combine: gather back and weight by gates.
    sorted_gates = r.gates.reshape(groups, t * k).gather(-1, ds.order)
    weight = torch.where(ds.keep, sorted_gates,
                         torch.zeros_like(sorted_gates)).to(x.dtype)
    gathered = take(out_buf, e * cap, ds.dest) * weight[..., None]
    # Each token's k contributions are summed in a fixed order, in x's
    # dtype: by ascending expert id, the order in which the reference's
    # `.at[st].add` meets them in the sorted list (and applies them on the
    # CPU).  An `index_add` of the rows would add them with atomics on the
    # card, in an order, and to bits, that change from run to run.  `pos`
    # is the place of each (token, choice) in the sorted list; sorted per
    # token, it lists the token's contributions by expert id.
    pos = torch.empty_like(ds.order).scatter_(
        -1, ds.order, torch.arange(t * k, device=x.device).expand(
            groups, t * k))
    pos = torch.sort(pos.reshape(groups, t, k), dim=-1).values
    parts = take(gathered, t * k, pos)                        # (G, T, k, D)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]

    if "shared" in p:
        y = y + mlp(x, p["shared"])
    return y, r.aux


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar): every token of the
    batch routed together, the reference's `moe_forward`."""
    b, s, d = x.shape
    y, aux = moe_groups(p, x.reshape(1, b * s, d), cfg)
    return y.reshape(b, s, d), aux[0]


def moe_forward_slots(p: Params, x: torch.Tensor, cfg: ArchConfig
                      ) -> torch.Tensor:
    """x (B, D), one token a decode slot, each slot routed alone (the
    reference's per-slot serve step) -> y (B, D)."""
    y, _ = moe_groups(p, x[:, None], cfg)
    return y[:, 0]

