"""Train, serve and prefill step builders (the port of
`repro.runtime.steps`).

`make_train_step` returns
    (train_state, batch) -> (train_state, {"loss", "grad_norm", "lr_scale"})
the reference's step: the loss (`models.loss_fn`, which for a MoE config
adds 0.01 times its routers' load-balancing losses summed in f32 over the
layers, a dense layer's being none, as the reference's) and its gradient
by `torch.autograd.grad` (micro-batches summed in the params' dtype by
`core/torch_frontend.loop`, the reference's `lax.scan`, then divided), an
optional bf16 cast and error-feedback int8 compression of the gradients,
global-norm clipping, the warmup-cosine schedule on the state's step, and
AdamW.  The remat policy is the model's (`models/transformer.py::forward`).
The state (`init_train_state`, or the reference's carried across by
`models/convert.py::train_state_from_numpy`):
    {"params", "opt": {"mu", "nu", "master", "count"}, "step"[, "grad_ef"]}
and the step updates its optimizer state in place.

`make_serve_step(cfg, chunk=512, per_slot_pos=False)` is the reference's:
    (params, decode_state, token (B,), pos) -> (next_token, logits, state)
one-token greedy decode, in one of two forms.  `per_slot_pos=False` takes a
0-dim `pos` shared by every slot (MoE layers route the B tokens together,
as the reference's scalar step does, and may drop); `per_slot_pos=True`
takes a (B,) `pos`, one position a slot (each slot's MoE routed alone), the
form `ServeEngine` uses.  A position of the other shape raises.  The
reference vmaps a one-slot step over the batch; here the batch dimension is
written out in `attn_decode`, and the caches are updated in place.

Each step is also the program one rank of a mesh runs on its own shards of
the step's arguments, laid out by `parallel/sharding.py`'s rules (the
specs it is built with): the counterpart of the program XLA's partitioner
writes for each device of the reference's `jax.jit(step, in_shardings=...,
out_shardings=...)`.  It runs so inside `parallel/spmd.local_program`, as
`shard_step` (on the DTensors of `parallel/sharding.py::place`) and the dry
run's capture (`launch/dryrun.py::lower_cell`) run it:

* The weights are read as `spmd.materialize` gives them: gathered over the
  data axes where auto-FSDP cuts them, and over "model" where no layer has
  a tensor-parallel form (`spmd.tensor_parallel_leaf`).
* The train step differentiates this rank's share of the global loss
  (`models/transformer.py::loss_fn`), so each gradient is partial over the
  data axes; it is summed onto the optimizer state's layout (ZeRO-1: a
  reduce-scatter where the optimizer state is cut over the data axes and
  the weight is not, an all-reduce where neither is), compressed (each
  leaf's scale the largest magnitude over its shards), clipped by the
  global norm (each leaf's squares summed over the axes its layout cuts),
  AdamW updates each shard, and the new weights are gathered back to the
  weights' layout.  The reported loss is summed over the data axes.
* The prefill step gathers its logits over "model" (the reference's
  `logits_spec`, `P(dp, None, None)`); the serve step keeps them cut over
  the vocab (`P(dp, "model")`) and takes the greedy token by a
  distributed argmax.  A decode state cut along its positions is read by
  a distributed softmax (GQA caches, `models/attention.py::attn_decode`)
  or gathered for the step and cut back after it (the others).

Outside a per-device program, and on a mesh of one device, every
collective is the identity and the specs are not read.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..configs.base import ArchConfig
from ..core.torch_frontend import loop
from ..models import decode_step as model_decode_step
from ..models import forward, init_params, loss_fn
from ..optim import (
    AdamWConfig,
    GradAccumulator,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_gradients,
    linear_warmup_cosine,
)
from ..parallel import spmd
from ..parallel.context import mesh_context
from ..parallel.sharding import (
    PartitionSpec,
    _at,
    _path_str,
    tree_leaves_with_path,
    tree_map_with_path,
)


@dataclass(frozen=True)
class TrainOptions:
    remat: str = "group"          # none | group | full
    chunk: int = 512              # attention chunk size
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_compression: bool = False
    grad_dtype: str = "f32"       # "bf16" halves the DP all-reduce bytes
    microbatch: int = 1           # accumulation steps


def default_microbatch(cfg: ArchConfig, global_batch: int, seq_len: int,
                       dp_size: int, target_bytes: float = 2e9) -> int:
    """Gradient-accumulation factor keeping layer-boundary activations
    (the tensors kept live across the backward pass under per-layer remat)
    around `target_bytes` per device: B/dp/mb * S * d * 2 bytes * L."""
    per_dev = max(1, global_batch // max(dp_size, 1))
    boundary = per_dev * seq_len * cfg.d_model * 2 * cfg.n_layers
    mb = 1
    while boundary / mb > target_bytes and mb < per_dev:
        mb *= 2
    return mb


def init_train_state(cfg: ArchConfig,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> Dict[str, Any]:
    """Fresh params (`models.init_params`), their AdamW state and step 0."""
    params = init_params(cfg, generator, device)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    options: TrainOptions = TrainOptions(),
                    specs: Optional[Dict[str, Any]] = None):
    """The train step; on a mesh, each rank's program on its shards of the
    state, laid out by `specs` (`train_specs`), and of the batch (rows cut
    over the data axes)."""
    if options.grad_dtype not in ("f32", "bf16"):
        raise ValueError(f"grad_dtype {options.grad_dtype!r} not in "
                         f"('f32', 'bf16')")
    pspecs = None if specs is None else specs["params"]
    ospecs = None if specs is None else specs["opt"]["master"]

    def loss_and_grads(params, batch):
        leaves, spec = tree_flatten(params)
        tracked = [p.detach().requires_grad_() for p in leaves]
        whole = spmd.materialize(spec.unflatten(tracked), pspecs)
        loss = loss_fn(whole, cfg, batch, chunk=options.chunk,
                       remat=options.remat)
        # a leaf the loss does not read (the embedding table of a config
        # fed embeddings) has a zero gradient, as `jax.grad` gives it
        grads = torch.autograd.grad(loss, tracked, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(tracked, grads)]
        return loss.detach(), spec.unflatten(grads)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        local = spmd.current()
        dp = () if local is None else local.dp_axes
        params = state["params"]
        if options.microbatch > 1:
            n = options.microbatch

            def body(acc, mb):
                mb_loss, mb_grads = loss_and_grads(params, mb)
                return acc[0] + mb_loss, tree_map(torch.add, acc[1],
                                                  mb_grads)

            zeros = (torch.zeros((), dtype=torch.float32,
                                 device=state["step"].device),
                     tree_map(torch.zeros_like, params))
            # the reference's lax.scan: one `while` of n trips in a capture
            loss, grads = loop(body, zeros, GradAccumulator(n).stack(batch))
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        else:
            loss, grads = loss_and_grads(params, batch)
        loss = spmd.all_reduce(loss, dp)

        if options.grad_dtype == "bf16":
            # bf16 gradient all-reduce (Megatron-style): halves DP wire
            # bytes; the f32 master update re-upcasts afterwards.
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        flat_g, tspec = tree_flatten(grads)
        flat_p = tspec.flatten_up_to(params)
        pflat, oflat = _flat_specs(pspecs, params), _flat_specs(ospecs,
                                                                params)
        # the gradients summed over the data axes, onto the optimizer
        # state's layout
        opt_g = []
        for g, ps, os_ in zip(flat_g, pflat, oflat):
            if not spmd.sharded_dims(ps, dp):
                cut = spmd.sharded_dims(os_, dp)
                if cut:
                    (d, axes), = cut.items()
                    g = spmd.reduce_scatter(g, axes, d)
                else:
                    g = spmd.all_reduce(g, dp)
            opt_g.append(g)
        grads = tree_unflatten(opt_g, tspec)
        if options.grad_compression:
            grads, new_ef = compress_gradients(
                grads, state.get("grad_ef"), amax=tree_unflatten(
                    [_max_over_shards(s) for s in oflat], tspec))
        grads, gnorm = clip_by_global_norm(
            grads, options.clip_norm,
            total=lambda sq: _sum_over_shards(sq, oflat))
        lr_scale = linear_warmup_cosine(state["step"], options.warmup_steps,
                                        options.total_steps)
        # each weight's shard in the optimizer's layout (a view: only its
        # dtype is read)
        views = [_cut(p, ps, os_, dp) for p, ps, os_ in
                 zip(flat_p, pflat, oflat)]
        new_opt_p, new_opt = adamw_update(
            opt_cfg, grads, state["opt"], tree_unflatten(views, tspec),
            lr_scale)
        new_flat = [_uncut(p, ps, os_, dp) for p, ps, os_ in
                    zip(tspec.flatten_up_to(new_opt_p), pflat, oflat)]
        new_state = {"params": tree_unflatten(new_flat, tspec),
                     "opt": new_opt, "step": state["step"] + 1}
        if options.grad_compression:
            new_state["grad_ef"] = new_ef
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "lr_scale": lr_scale}

    return train_step


def train_specs(rules, state) -> Dict[str, Any]:
    """The train state's specs: params, optimizer (ZeRO-1), step, and the
    gradients' error feedback where the state carries it (the optimizer's
    layout, as the gradients it is added to)."""
    specs = {"params": rules.param_specs(state["params"]),
             "opt": rules.opt_specs(state["opt"], state["params"]),
             "step": PartitionSpec()}
    if "grad_ef" in state:
        specs["grad_ef"] = specs["opt"]["master"]
    return specs


def _flat_specs(specs, tree):
    """Each leaf's spec in `tree`'s order; none cut where `specs` is
    None."""
    return [PartitionSpec() if specs is None else _at(specs, path)
            for path, _ in tree_leaves_with_path(tree)]


def _sharded_axes(spec) -> Tuple[str, ...]:
    """The axes of more than one device that `spec` cuts its leaf over."""
    local = spmd.current()
    if local is None:
        return ()
    axes = [a for d in spmd.sharded_dims(spec, local.mesh.axis_names).values()
            for a in d]
    return tuple(a for a in local.mesh.axis_names
                 if a in axes and local.size(a) > 1)


def _sum_over_shards(sq, specs) -> torch.Tensor:
    """The sum of every leaf's `sq` (its squares summed over its shard),
    each summed over the axes its spec cuts (a leaf whole on an axis
    counts once)."""
    by_axes: Dict[Tuple[str, ...], list] = {}
    for s, spec in zip(sq, specs):
        by_axes.setdefault(_sharded_axes(spec), []).append(s)
    if list(by_axes) in ([], [()]):
        return sum(sq)
    total = 0
    for axes, parts in by_axes.items():
        part = sum(parts)
        total = total + (spmd.all_reduce(part, axes) if axes else part)
    return total


def _max_over_shards(spec) -> Callable[[torch.Tensor], torch.Tensor]:
    """A shard's largest magnitude -> its leaf's, over the axes `spec`
    cuts."""
    axes = _sharded_axes(spec)
    return lambda m: spmd.all_reduce_max(m, axes) if axes else m


def _cut(p: torch.Tensor, pspec, ospec, dp) -> torch.Tensor:
    """The weight shard `p` (by `pspec`) cut to the optimizer's layout."""
    for d, axes in spmd.sharded_dims(ospec, dp).items():
        if d not in spmd.sharded_dims(pspec, dp):
            p = spmd._slice(p, axes, d)
    return p


def _uncut(p: torch.Tensor, pspec, ospec, dp) -> torch.Tensor:
    """A new weight in the optimizer's layout gathered to the weights'."""
    for d, axes in spmd.sharded_dims(ospec, dp).items():
        if d not in spmd.sharded_dims(pspec, dp):
            p = spmd.all_gather(p, axes, d)
    return p


_KV_LEAF = re.compile(r"groups/\d+/kv/[kv]$")


def make_serve_step(cfg: ArchConfig, chunk: int = 512,
                    per_slot_pos: bool = False, pspecs=None, sspecs=None):
    """One-token decode step.  `chunk` is the reference's argument, unused
    by a one-token step there too.  `pos` must be 0-dim unless
    `per_slot_pos`, then of shape (B,).  On a mesh, each rank's program on
    its shards of the params (laid out by `pspecs`) and of the decode
    state (by `sspecs`), for its slots (or all of them, where the batch is
    smaller than the data axes)."""
    def serve_step(params, state, token, pos):
        local = spmd.current()
        shape = tuple(torch.as_tensor(pos).shape)
        want = (token.shape[0],) if per_slot_pos else ()
        if shape != want:
            raise ValueError(
                f"serve_step(per_slot_pos={per_slot_pos}): pos has shape "
                f"{shape}, expected {want}")
        whole = spmd.materialize(params, pspecs, decode=True)
        run_state, gathered = state, []
        if local is not None:
            kv_axes = {}

            def leaf(path, t):
                cut = {d: a for d, a in spmd.sharded_dims(
                    _at(sspecs, path), local.mesh.axis_names).items()
                    if d >= 2}
                if not cut:
                    return t
                if _KV_LEAF.search(_path_str(path)) and list(cut) == [2]:
                    kv_axes[id(t)] = cut[2]
                    return t
                full = t
                for d, axes in cut.items():
                    full = spmd.all_gather(full, axes, d)
                gathered.append((t, full, cut))
                return full

            run_state = tree_map_with_path(leaf, state)
            local.kv_seq_axes = kv_axes
        logits, _ = model_decode_step(whole, run_state, cfg, token, pos)
        for t, full, cut in gathered:
            part = full
            for d, axes in cut.items():
                part = spmd._slice(part, axes, d)
            t.copy_(part)
        if logits.shape[-1] != cfg.vocab_size:  # the head's vocab is cut
            nxt = _argmax_over_vocab(logits)
        else:
            nxt = logits.argmax(dim=-1)
        return nxt.int(), logits, state

    return serve_step


def _argmax_over_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of logits (B, V / tp) cut over "model": each
    rank's best, gathered; the lowest vocab index among equal maxima, as
    `argmax` over the whole vocab."""
    v = logits.shape[-1]
    best, idx = logits.max(dim=-1)
    idx = idx + spmd.current().index("model") * v
    bests = spmd.all_gather(best[:, None], "model", 1)
    idxs = spmd.all_gather(idx[:, None], "model", 1)
    pick = bests.argmax(dim=-1, keepdim=True)
    return torch.gather(idxs, 1, pick)[:, 0]


def make_prefill_step(cfg: ArchConfig, chunk: int = 512, device="cuda",
                      pspecs=None):
    """Full-sequence forward for prefill (logits only).  The batch's
    `tokens` (B, S), or its `embeds` (B, S, d_model) from a modality
    front-end (bf16 in the reference's input specs), are moved to
    `device`.  On a mesh, each rank's program on its shards of the params
    (laid out by `pspecs`) for its batch rows, over the whole vocab."""
    def prefill_step(params, batch):
        whole = spmd.materialize(params, pspecs)
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        logits, _ = forward(
            whole, cfg,
            tokens=None if tokens is None else torch.as_tensor(
                tokens, device=device),
            embeds=None if embeds is None else torch.as_tensor(
                embeds, device=device), chunk=chunk)
        if logits.shape[-1] != cfg.vocab_size:  # the head's vocab is cut
            logits = spmd.all_gather(logits, "model", -1)
        return logits

    return prefill_step


# -- running a per-device program on DTensors --------------------------------

def shard_step(local_fn: Callable, mesh, out_specs, batch_axes=None):
    """`local_fn` run by every rank of `mesh` on the local shards of its
    DTensor arguments (plain tensors pass as they are), its outputs laid
    out as DTensors by `out_specs` (a tree of `PartitionSpec`s the shape
    of what it returns).  `batch_axes`: the axes the batch rows are cut
    over (the data axes by default).  On a mesh with no `DeviceMesh`
    behind it (one device, no process group) `local_fn` runs as it is.  A
    mesh whose ranks exist only in a fake process group runs no step."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import placements
    if mesh.fake:
        raise RuntimeError("shard_step: the mesh's ranks exist only in a "
                           "fake process group; it is for captures only")

    def to_local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def run(*args):
        local_args = tree_map(to_local, args)
        with spmd.program(mesh, batch_axes), mesh_context(mesh):
            out = local_fn(*local_args)
        if mesh.device_mesh is None:
            return out

        def wrap(path, t):
            if not isinstance(t, torch.Tensor):
                return t
            spec = _at(out_specs, path)
            return DTensor.from_local(t, mesh.device_mesh,
                                      placements(spec, mesh),
                                      run_check=False)
        return tree_map_with_path(wrap, out)

    return run
