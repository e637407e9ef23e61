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

In a per-device program whose rules cut the expert banks over "model" by
expert (`parallel/spmd.py`), each rank runs the products of its own E /
tp experts only, under either form.  In the global form (`moe_forward`,
`moe_forward_slots`, both decode forms) every rank routes and dispatches
the data-gathered batch alike, against the reference's global capacity,
fills the (E / tp, C, D) buffers of its own experts (every other
assignment is dropped there), runs them, and combines their outputs with
their gates into a partial sum of each token's y; one all-reduce over
"model" sums the ranks' partial sums, with the shared experts' partial
sum (their columns and rows cut as the dense MLP's) added before it.  The
other way open, an all-gather of the (E / tp, C, D) outputs before a whole
combine, would keep one card's sum order on any mesh, but moves the whole
buffer, capacity_factor k T D elements a layer against the all-reduce's
T D, and holds it on every rank: for a deepseek-v2 train_4k layer on the
16x16 mesh (T 65536 tokens a micro-batch, C 3072) 160 x 3072 x 5120 bf16
values, 5.0 GB, against 65536 x 5120, 0.67 GB.  Each rank still sums a
token's contributions in ascending expert id, so a run gives the same
bits run after run; across meshes the partial sums meet in another
order.  Where the batch is cut over data axes, the backward of the expert
products, which every data rank would otherwise run alike on its own
tokens' share of the gradient, runs on the rank's share of the capacity
rows (`_RowSplitExperts`), as the reference's compile splits it.

`moe_forward_ep` is the reference's shard_map expert parallelism: each
shard of the current mesh routes its own tokens (`_local_dispatch_compute`)
and exchanges them with the expert shards by two all-to-alls over "model"
(`all_to_all_single`, tiled as `jax.lax.all_to_all`), in the per-device
program of the mesh (`parallel/spmd.py`); on the card's own `(1, 1)` mesh
the all-to-alls are the identity; off a mesh it falls back to
`moe_forward`.  Its shared experts run whole on every rank, gathered
over "model", as the reference's shard_map takes them.
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


def _act(hg, hu: torch.Tensor) -> torch.Tensor:
    """The experts' hidden activation from the gate's and the up
    projection's outputs (`hg` None under GELU)."""
    if hg is None:
        return F.gelu(hu, approximate="tanh")
    return F.silu(hg) * hu


def _expert_mlp(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """buf (G, E, C, D) -> each of the bank's E experts' MLP on its rows,
    (G, E, C, D)."""
    dtype = buf.dtype
    if "w_gate" in p:
        h = F.silu(torch.einsum("gecd,edf->gecf", buf,
                                p["w_gate"].to(dtype)))
        h = h * torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dtype))
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dtype)),
                   approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dtype))


class _RowSplitExperts(torch.autograd.Function):
    """`_expert_mlp` on a buffer of data-gathered tokens, which every rank
    of the data axes `axes` holds alike (`moe_forward`): the forward whole,
    and the backward on this rank's share of the capacity rows.  The
    outputs' gradient arrives partial over the data axes (each rank's own
    tokens'); it is reduce-scattered over them by rows, so each rank runs
    the backward's products on C / n rows: the weights' gradients are its
    rows' share (partial over the data axes, as every weight's gradient
    is), the buffer's is its rows in zeros.  The reference's compile
    splits this backward over the data axes likewise (by the experts' ff
    columns), and runs its forward whole."""

    @staticmethod
    def forward(ctx, buf, axes, w_gate, w_up, w_down):
        hg = None if w_gate is None else \
            torch.einsum("gecd,edf->gecf", buf, w_gate)
        hu = torch.einsum("gecd,edf->gecf", buf, w_up)
        ctx.axes = axes
        ctx.save_for_backward(buf, hg, hu, w_gate, w_up, w_down)
        return torch.einsum("gecf,efd->gecd", _act(hg, hu), w_down)

    @staticmethod
    def backward(ctx, g):
        buf, hg, hu, w_gate, w_up, w_down = ctx.saved_tensors
        axes = ctx.axes
        g = spmd._raw_reduce_scatter(g, axes, 2)
        buf, hu = spmd._slice(buf, axes, 2), spmd._slice(hu, axes, 2)
        with torch.enable_grad():
            pre = [t.detach().requires_grad_() for t in
                   ([hu] if hg is None else [spmd._slice(hg, axes, 2), hu])]
            h = _act(*([None] + pre if hg is None else pre))
        dh = torch.einsum("gecd,efd->gecf", g, w_down)
        d_pre = torch.autograd.grad(h, pre, dh)
        d_hu = d_pre[-1]
        d_buf = torch.einsum("gecf,edf->gecd", d_hu, w_up)
        grads = [torch.einsum("gecd,gecf->edf", buf, d_hu),
                 torch.einsum("gecf,gecd->efd", h.detach(), g)]
        if hg is not None:
            d_buf = d_buf + torch.einsum("gecf,edf->gecd", d_pre[0], w_gate)
            grads.insert(0, torch.einsum("gecd,gecf->edf", buf, d_pre[0]))
        else:
            grads.insert(0, None)
        return (spmd._pad(d_buf, axes, 2), None) + tuple(grads)


def _experts(p: Params, buf: torch.Tensor,
             data_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """buf (G, E, C, D) -> each of the bank's E experts' MLP on its rows,
    (G, E, C, D).  `data_axes`: the data axes the buffer's tokens were
    gathered over, whose ranks run the products alike; where autograd
    records, the backward is split over them (`_RowSplitExperts`)."""
    local = spmd.current()
    n = 1 if local is None else local.size(data_axes)
    weights = [p.get("w_gate"), p["w_up"], p["w_down"]]
    if n > 1 and buf.shape[2] % n == 0 and torch.is_grad_enabled() and \
            any(w is not None and w.requires_grad for w in weights):
        return _RowSplitExperts.apply(buf, data_axes, *[
            None if w is None else w.to(buf.dtype) for w in weights])
    return _expert_mlp(p, buf)


def _shared(p: Params, x: torch.Tensor, split: bool) -> torch.Tensor:
    """The shared experts' MLP on x: where `split` (the rules cut its
    columns and rows, `_split`), this rank's partial sum over "model", the
    input's gradient summed over "model" on entry, as the dense MLP's
    tensor-parallel form (`transformer._block`)."""
    return mlp(spmd.copy_to(x, "model") if split else x, p)


def _split(p: Params, cfg: ArchConfig) -> Dict[str, bool]:
    """Which of the layer's parts hold only this rank's share, their
    outputs partial sums over "model": the expert banks ("experts", cut
    by expert) and the shared experts' MLP ("shared", by columns and
    rows)."""
    out = {"experts": p["w_up"].shape[-3] != cfg.n_experts}
    if "shared" in p:
        width = (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
        out["shared"] = p["shared"]["w_down"].shape[-2] != width
    return out


def _sum(terms) -> torch.Tensor:
    """The sum of `terms`, (tensor, partial) pairs in order: the partial
    sums over "model" added and summed over it by one all-reduce, then the
    terms alike on every rank added."""
    partial = [t for t, cut in terms if cut]
    y = None
    if partial:
        y = partial[0]
        for t in partial[1:]:
            y = y + t
        y = spmd.all_reduce(y, "model")
    for t, cut in terms:
        if not cut:
            y = t if y is None else y + t
    return y


def _mine(ds: Dispatch, lo: int, n: int, cap: int) -> Dispatch:
    """`ds` restricted to experts lo .. lo + n - 1, their rows of an (n *
    C) buffer: every other assignment is dropped here (its row clamped
    into the buffer, its token added as zeros, its weight 0)."""
    dest = ds.dest - lo * cap
    keep = ds.keep & (dest >= 0) & (dest < n * cap)
    return ds._replace(keep=keep, dest=dest.clamp(0, n * cap - 1))


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


def _routed(p: Params, x: torch.Tensor, cfg: ArchConfig,
            data_axes: Tuple[str, ...] = ()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (G, T, D), each group routed and dispatched on its own -> (the
    routed experts' y (G, T, D), aux (G,)).  Where the banks hold this
    rank's experts only, y is this rank's partial sum over "model" (module
    docstring): its experts' buffers filled from x (whose gradient, partial,
    is summed over "model"), their outputs combined with their gates (the
    gates' gradient likewise), every other assignment dropped here."""
    cap = _capacity(cfg, x.shape[1])
    r = route(p, x, cfg)
    ds = dispatch(r.expert_ids, cap)
    e_local, gates = p["w_up"].shape[-3], r.gates
    if e_local != cfg.n_experts:
        ds = _mine(ds, spmd.current().index("model") * e_local, e_local,
                   cap)
        x, gates = spmd.copy_to(x, "model"), spmd.copy_to(gates, "model")
    buf = _dispatch_buffer(x, ds, e_local, cap)
    return _combine(_experts(p, buf, data_axes), gates, ds,
                    cfg.top_k), r.aux


def moe_groups(p: Params, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (G, T, D), each group routed and dispatched on its own -> (y (G,
    T, D), aux (G,)): the routed experts' output plus the shared
    experts'."""
    split = _split(p, cfg)
    y, aux = _routed(p, x, cfg)
    terms = [(y, split["experts"])]
    if "shared" in p:
        terms.append((_shared(p["shared"], x, split["shared"]),
                      split["shared"]))
    return _sum(terms), aux


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar): every token of the
    batch routed together, the reference's `moe_forward`.  In a per-device
    program whose batch is cut over data axes, the batch's rows are
    gathered from them first, every rank routes them all alike, and keeps
    its own rows of the routed experts' output (the gradients stay
    partial over the data axes: the gather's backward reduce-scatters, the
    cut's pads with zeros); the shared experts, which route nothing, run
    on the rank's own rows, and one all-reduce over "model" sums both
    parts' partial sums of those rows."""
    local = spmd.current()
    b, s, d = x.shape
    if local is None or local.size(local.batch_axes) == 1:
        y, aux = moe_groups(p, x.reshape(1, b * s, d), cfg)
        return y.reshape(b, s, d), aux[0]
    axes = local.batch_axes
    split = _split(p, cfg)
    xg = spmd.all_gather(x, axes, 0, bwd="sum")
    y, aux = _routed(p, xg.reshape(1, -1, d), cfg, axes)
    terms = [(spmd.scatter(y.reshape(xg.shape), axes, 0, bwd="zeros"),
              split["experts"])]
    if "shared" in p:
        terms.append((_shared(p["shared"], x, split["shared"]),
                      split["shared"]))
    return _sum(terms), aux[0]


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
        # the reference's shard_map takes the shared MLP whole (its
        # in_specs `P()`), and every rank runs it alike on its tokens:
        # gathered over "model" here, at the body's boundary, as XLA
        # gathers it there
        width = (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
        shared = {k: (w if w.shape[0 if k == "w_down" else -1] == width
                      else spmd.all_gather(w, "model",
                                           0 if k == "w_down" else -1,
                                           bwd="slice"))
                  for k, w in p["shared"].items()}
        y = y + mlp(xf, shared)
    if local is not None and local.batch_axes:
        # the data shards' mean (`jax.lax.pmean`); its users' gradients
        # are partial over the data axes, so its backward sums them
        aux = spmd.all_reduce(aux, local.batch_axes, bwd="sum") / \
            local.size(local.batch_axes)
    return y.reshape(b, s, d), aux
