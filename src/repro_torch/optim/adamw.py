"""AdamW with f32 master weights and moments (the port of
`repro.optim.adamw`).

The state mirrors the param tree leaf for leaf, as the reference's does, so
a train state carries across between the two packages (`models/convert.py::
train_state_from_numpy`) and a checkpoint can restore in either:

  {"mu": tree of f32, "nu": tree of f32, "master": tree of f32,
   "count": int32 scalar tensor}

`adamw_update` writes the reference's arithmetic, `(mu / b1c) / (sqrt(nu /
b2c) + eps)` with decoupled decay on the master and the bias corrections in
f32, and re-casts each param from its master.  It updates `mu`, `nu` and
`master` in place (one leaf at a time, no second copy of the state at full
width) and returns the same state dict with a new `count`; the params it
returns are new tensors, never the master itself.  `torch.optim.AdamW` is
not used: its state is not the reference's, and `lr_scale` here is a
tensor that changes each step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple, Union

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    keep_master: bool = True   # fp32 master copy when params are bf16


def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_flatten(params)[0][0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "master": tree_map(lambda p: p.detach().float().clone(), params)}


def adamw_update(cfg: AdamWConfig, grads, state: Dict[str, Any], params,
                 lr_scale: Union[torch.Tensor, float] = 1.0
                 ) -> Tuple[Any, Dict[str, Any]]:
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=count.device)

    def leaf(g, mu, nu, master, p):
        g = g.float()
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        update = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        master.sub_(lr * (update + cfg.weight_decay * master))
        return master.to(p.dtype, copy=True)

    flat_g, spec = tree_flatten(grads)
    flat = [spec.flatten_up_to(state[k]) for k in ("mu", "nu", "master")]
    flat_p = spec.flatten_up_to(params)
    new_params = tree_unflatten(
        [leaf(g, mu, nu, master, p) for g, mu, nu, master, p in
         zip(flat_g, *flat, flat_p)], spec)
    return new_params, {**state, "count": count}
