"""Gradient utilities: clipping, micro-batch accumulation, compression (the
port of `repro.optim.grad`).

`compress_gradients` is the reference's error-feedback int8 compression for
the data-parallel all-reduce: each tensor is quantized to int8 with one f32
scale, and the quantization error is carried into the next step's
gradients.  On one card there is no all-reduce; the round trip still runs,
so a run with `grad_compression=True` computes what the reference computes.

Trees are nests of dicts and lists with tensor leaves, as the params are.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map


def clip_by_global_norm(grads, max_norm: float,
                        total: Callable[[List[torch.Tensor]],
                                        torch.Tensor] = sum
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads scaled to a global L2 norm of at most `max_norm`, the norm
    before).  The norm is taken in f32; each gradient is scaled in f32 and
    cast back to its dtype, as the reference's `(g * scale).astype(g.dtype)`
    promotes a bf16 gradient to the f32 scale.  `total` sums the leaves'
    squared norms (on a mesh, over the shards too)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(total([torch.sum(torch.square(g.float()))
                              for g in leaves]))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


class GradAccumulator:
    """Micro-batch accumulation: `stack` cuts a batch into `n_micro` equal
    micro-batches along a new first axis (the train step's `loop` runs
    over it), `split` into a list of them, `accumulate` averages a gradient function over them (a
    Python loop in place of the reference's `lax.scan`, the sum kept in the
    gradients' dtype)."""

    def __init__(self, n_micro: int):
        self.n_micro = n_micro

    def stack(self, batch) -> Any:
        """`batch` with each leaf reshaped to (n_micro, B // n_micro, ...),
        the reference's reshape before its `lax.scan` over the first
        axis."""
        for x in tree_leaves(batch):
            if x.shape[0] % self.n_micro:
                raise ValueError(f"batch of {x.shape[0]} rows does not split "
                                 f"into {self.n_micro} micro-batches")
        return tree_map(lambda x: x.reshape(
            self.n_micro, x.shape[0] // self.n_micro, *x.shape[1:]), batch)

    def split(self, batch) -> List[Any]:
        """The micro-batches of `batch`, in order: `stack`'s taken along
        its first axis."""
        stacked = self.stack(batch)
        return [tree_map(lambda x, i=i: x[i], stacked)
                for i in range(self.n_micro)]

    @staticmethod
    def accumulate(grad_fn: Callable, params, micro_batches: List[Any]):
        """The mean of `grad_fn(params, mb)` over the micro-batches: the
        first gradient, the others added to it, then divided by their
        count."""
        acc = grad_fn(params, micro_batches[0])
        for mb in micro_batches[1:]:
            acc = tree_map(torch.add, acc, grad_fn(params, mb))
        return tree_map(lambda g: g / len(micro_batches), acc)


def compress_gradients(grads, error_feedback: Optional[Any] = None,
                       amax: Optional[Any] = None) -> Tuple[Any, Any]:
    """Int8 quantization with error feedback.  Returns (the gradients
    dequantized back to their dtypes, the new error feedback in f32); with
    no `error_feedback` the carried error starts at zero.  `amax`, a tree
    of the gradients' structure, maps each leaf's largest magnitude to the
    one its scale takes (on a mesh, the largest over the leaf's shards)."""
    if error_feedback is None:
        error_feedback = tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def leaf(g, ef, top):
        gf = g.float() + ef
        scale = torch.clamp(top(gf.abs().max()), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    flat_g, spec = tree_flatten(grads)
    tops = [lambda m: m] * len(flat_g) if amax is None else \
        spec.flatten_up_to(amax)
    out = [leaf(g, e, top) for g, e, top in
           zip(flat_g, spec.flatten_up_to(error_feedback), tops)]
    return (spec.unflatten([o[0] for o in out]),
            spec.unflatten([o[1] for o in out]))
