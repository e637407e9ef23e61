"""Gradients through the hand-written kernels.

The JAX package has no backward kernel: its models never differentiate a
Pallas kernel, and `jax.grad` of its loss goes through the plain
versions.  `KernelFunction` gives every CUDA kernel of the port that same
gradient:

  forward   launches the kernel through its wrapper (grad mode is off
            inside `torch.autograd.Function.forward`), so the launch
            counters count it as on any other call;
  backward  recomputes the kernel's plain version on the saved inputs under
            `torch.enable_grad()` and returns `torch.autograd.grad` of it.
            For attention that plain version is `chunked_attention` at the
            model's chunk, the function the reference differentiates.

A backward kernel for K1 would be something the reference lacks; it is
ROADMAP B7.  The models reach this through `core.torch_frontend.
kernel_call`, which takes this route only when grad mode is on and an
input requires grad; a wrapper called directly on such an input raises
(`_build.check_no_grad`), so no kernel output is cut off from its inputs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch


class KernelFunction(torch.autograd.Function):
    """`kernel(*tensors, **kwargs)` forward, `plain(*tensors)`'s gradient
    backward.  Every positional input is a tensor; `kwargs` holds the
    kernel's other arguments."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable,
                kwargs: Dict[str, Any], *tensors: torch.Tensor):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[3:])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ctx.plain(*inputs)
            # the plain version may return another dtype than the kernel
            # (the chunkwise mLSTM's is f32); the model casts either alike
            grads = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype)))
        return (None, None, None,
                *(next(grads) if t.requires_grad else None for t in inputs))


def kernel_apply(kernel: Callable, plain: Callable, *tensors: torch.Tensor,
                 **kwargs) -> torch.Tensor:
    """`kernel(*tensors, **kwargs)` with the gradient of `plain(*tensors)`."""
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel.__name__}: the autograd route takes "
                            f"tensors as positional arguments, not "
                            f"{type(t).__name__}")
    return KernelFunction.apply(kernel, plain, kwargs, *tensors)
