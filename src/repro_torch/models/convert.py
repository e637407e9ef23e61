"""Carry weights, train states and decode states across from the JAX
package as numpy.

The caller turns the reference's tree into numpy (`jax.tree.map(np.asarray,
params)`); these functions return the same tree with torch tensors, so both
packages run on the same numbers.  bfloat16 arrives as numpy's `bfloat16`
extension dtype (ml_dtypes) and is reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig


def _tensor(a: np.ndarray, device):
    # a writable copy: the port updates caches in place, and arrays handed
    # over from JAX are read-only views of its buffers
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return _tensor(np.asarray(tree), device)


def params_from_numpy(tree, cfg: ArchConfig, device="cuda"):
    """The reference's param tree (numpy leaves) as the port's params, each
    leaf in the dtype the reference gives it: the config's dtype for most,
    f32 for those the reference keeps in f32 whatever the config says (the
    SSM's `w_dt`, `a_log` and `d_skip`, the mLSTM's `w_if`, the MoE
    router).  Blocks without an FFN (xLSTM) carry no `ln2`/`ffn` leaves, as
    there; MoE blocks carry the experts' stacks and, where the config has
    shared experts, `shared`; MLA blocks their low-rank projections and
    norms under `attn`."""
    table = tree["embed"]["table"]
    if tuple(table.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embedding {tuple(table.shape)} does not match "
                         f"{cfg.name}: ({cfg.vocab_size}, {cfg.d_model})")
    return _tree(tree, device)


def train_state_from_numpy(tree, cfg: ArchConfig, device="cuda"):
    """The reference's whole train state (numpy leaves) as the port's:
    `params` as `params_from_numpy` gives them, the AdamW state `opt`
    (`mu`, `nu` and `master` trees in f32, `count` an int32 scalar), `step`
    and, where the state has one, the error feedback `grad_ef` (f32)."""
    state = {"params": params_from_numpy(tree["params"], cfg, device),
             "opt": _tree(tree["opt"], device),
             "step": _tree(tree["step"], device)}
    if "grad_ef" in tree:
        state["grad_ef"] = _tree(tree["grad_ef"], device)
    return state


def decode_state_from_numpy(tree, device="cuda"):
    """The reference's decode state (numpy leaves) as the port's: KV
    caches, MLA's compressed caches (`kv_c`, `k_rope`), SSM and xLSTM
    recurrent states, each leaf in its own dtype."""
    return _tree(tree, device)
