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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map

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
                    options: TrainOptions = TrainOptions()):
    if options.grad_dtype not in ("f32", "bf16"):
        raise ValueError(f"grad_dtype {options.grad_dtype!r} not in "
                         f"('f32', 'bf16')")

    def loss_and_grads(params, batch):
        leaves, spec = tree_flatten(params)
        tracked = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(spec.unflatten(tracked), cfg, batch,
                       chunk=options.chunk, remat=options.remat)
        # a leaf the loss does not read (the embedding table of a config
        # fed embeddings) has a zero gradient, as `jax.grad` gives it
        grads = torch.autograd.grad(loss, tracked, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(tracked, grads)]
        return loss.detach(), spec.unflatten(grads)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
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

        if options.grad_dtype == "bf16":
            # bf16 gradient all-reduce (Megatron-style): halves DP wire
            # bytes; the f32 master update re-upcasts afterwards.
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        if options.grad_compression:
            grads, new_ef = compress_gradients(grads, state.get("grad_ef"))
        grads, gnorm = clip_by_global_norm(grads, options.clip_norm)
        lr_scale = linear_warmup_cosine(state["step"], options.warmup_steps,
                                        options.total_steps)
        new_params, new_opt = adamw_update(opt_cfg, grads, state["opt"],
                                           params, lr_scale)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if options.grad_compression:
            new_state["grad_ef"] = new_ef
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "lr_scale": lr_scale}

    return train_step


def make_serve_step(cfg: ArchConfig, chunk: int = 512,
                    per_slot_pos: bool = False):
    """One-token decode step.  `chunk` is the reference's argument, unused
    by a one-token step there too.  `pos` must be 0-dim unless
    `per_slot_pos`, then of shape (B,)."""
    def serve_step(params, state, token, pos):
        shape = tuple(torch.as_tensor(pos).shape)
        want = (token.shape[0],) if per_slot_pos else ()
        if shape != want:
            raise ValueError(
                f"serve_step(per_slot_pos={per_slot_pos}): pos has shape "
                f"{shape}, expected {want}")
        logits, state = model_decode_step(params, state, cfg, token, pos)
        return logits.argmax(dim=-1).int(), logits, state

    return serve_step


def make_prefill_step(cfg: ArchConfig, chunk: int = 512, device="cuda"):
    """Full-sequence forward for prefill (logits only).  The batch's
    `tokens` (B, S), or its `embeds` (B, S, d_model) from a modality
    front-end (bf16 in the reference's input specs), are moved to
    `device`."""
    def prefill_step(params, batch):
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        logits, _ = forward(
            params, cfg,
            tokens=None if tokens is None else torch.as_tensor(
                tokens, device=device),
            embeds=None if embeds is None else torch.as_tensor(
                embeds, device=device), chunk=chunk)
        return logits

    return prefill_step
