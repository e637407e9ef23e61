"""Gradients through the hand kernels: `kernels/autograd.py::KernelFunction`
behind `core.torch_frontend.kernel_call`.

On the card the forward launches the kernel and the backward is the
gradient of its plain version, recomputed on the saved inputs.  Here there
is no card, so:
* `torch.autograd.gradcheck` in f64 holds the route's wiring (inputs
  saved, keyword arguments passed through, a gradient for each input that
  needs one) with a stand-in "kernel" that is the plain function itself,
  at small shapes, for the attention route (causal and windowed GQA) and
  the norm route;
* each of the six wrappers, given CPU tensors, runs its plain version, so
  `kernel_call` on tensors that require grad must give exactly the
  gradient of the plain function the model hands it;
* each `check_*` refuses an input that requires grad while grad mode is
  on, so a wrapper called directly can no longer return a result cut off
  from its inputs (the fault this route repairs: every wrapper wrote into a
  fresh tensor with no `grad_fn`);
* serving, prefill and captures take no autograd route, and a capture of
  `loss_fn` records the same kernel regions as before.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import capture
from repro_torch.core.torch_frontend import kernel_call
from repro_torch.kernels import _build, ops
from repro_torch.kernels.autograd import KernelFunction
from repro_torch.models import init_params, loss_fn
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import chunked_attention


def _attention64(q, k, v, *, causal=True, window=None):
    """Full-matrix GQA attention in the inputs' dtype (f64 here)."""
    groups = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(groups, dim=2) for t in (k, v))
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    pos = torch.arange(s)
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _norm64(x, scale, *, eps=1e-5):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _stand_in(fn, name):
    """`fn` as a kernel: a name, a check and a launch count."""
    def kernel(*args, **kwargs):
        kernel.launches += 1
        return fn(*args, **kwargs)
    kernel.__name__ = name
    kernel.launches = 0
    kernel.check = lambda *a, **k: None
    return kernel


def _rand(seed, *shapes, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(0.5 * rng.standard_normal(s)).to(dtype)
            .requires_grad_() for s in shapes]


@pytest.mark.parametrize("window", [None, 3])
def test_gradcheck_attention_route(window):
    kernel = _stand_in(_attention64, "flash_attention")
    # two q-heads on one KV head, S 6 (window 3 cuts the band)
    q, k, v = _rand(0, (1, 6, 2, 4), (1, 6, 1, 4), (1, 6, 1, 4))

    def route(q, k, v):
        return kernel_call(kernel, q, k, v, causal=True, window=window,
                           plain_fn=functools.partial(_attention64,
                                                      window=window))
    assert torch.autograd.gradcheck(route, (q, k, v))
    launches = kernel.launches
    route(q, k, v).sum().backward()
    # the forward launched once; the backward launched nothing
    assert kernel.launches == launches + 1


def test_gradcheck_norm_route():
    kernel = _stand_in(_norm64, "rmsnorm_pipelined")
    x, scale = _rand(1, (6, 16), (16,))

    def route(x, scale):
        return kernel_call(kernel, x, scale, eps=1e-5,
                           plain_fn=functools.partial(_norm64, eps=1e-5))
    assert torch.autograd.gradcheck(route, (x, scale))


def test_the_route_differentiates_only_the_inputs_that_need_it():
    kernel = _stand_in(_norm64, "rmsnorm_pipelined")
    x, = _rand(2, (6, 16))
    scale = torch.ones(16, dtype=torch.float64)
    out = kernel_call(kernel, x, scale, plain_fn=_norm64)
    assert out.grad_fn is not None and out.grad_fn.name().startswith(
        KernelFunction.__name__)
    (gx,) = torch.autograd.grad(out.sum(), x)
    (want,) = torch.autograd.grad(_norm64(x, scale).sum(), x)
    torch.testing.assert_close(gx, want, rtol=0, atol=0)


def test_a_captured_backward_checks_the_kernel_as_the_route_launches_it():
    """A captured train step reaches each kernel with inputs that autograd
    tracks.  The capture checks them as the autograd route launches the
    wrapper, with grad mode off, so a check that refuses grad-requiring
    inputs (every `check_*`) passes; the region records the plain version,
    and the captured backward its gradient.  On fake CPU tensors: the same
    capture on fake CUDA tensors needs a torch built with CUDA."""
    kernel = _stand_in(_norm64, "rmsnorm_pipelined")
    kernel.check = lambda *a, **k: _build.check_no_grad(kernel.__name__, *a)

    def step(x, scale):
        x = x.detach().requires_grad_()
        out = kernel_call(kernel, x, scale, plain_fn=_norm64)
        (g,) = torch.autograd.grad(out.sum(), x)
        return g
    x, scale = torch.rand((6, 16), dtype=torch.float64), \
        torch.rand(16, dtype=torch.float64)
    with pytest.raises(ValueError, match="requires grad"):
        kernel.check(x.requires_grad_(), scale)
    module = capture(step, x.detach(), scale, device="cpu")
    assert module.kernel_calls == {"rmsnorm_pipelined": 1}
    assert kernel.launches == 0
    forward = sum(1 for i in module.all_instructions()
                  if i.opcode not in ("parameter", "constant"))
    plain = capture(_norm64, x.detach(), scale, device="cpu")
    assert forward > sum(1 for i in plain.all_instructions()
                         if i.opcode not in ("parameter", "constant"))


# -- each wrapper's route, on CPU tensors -------------------------------------

def _mlstm_plain(q, k, v, log_i, log_f):
    return xlstm_mod._mlstm_chunks(q, k, v, log_i, log_f, chunk=8)


ROUTES = {
    # kernel, the plain function the model hands it, input shapes, kwargs
    "flash_attention": (ops.flash_attention, functools.partial(
        chunked_attention, chunk=8, window=None),
        [(2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)], {"causal": True}),
    "flash_attention_window": (ops.flash_attention, functools.partial(
        chunked_attention, chunk=8, window=5),
        [(2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)],
        {"causal": True, "window": 5}),
    "rmsnorm_pipelined": (ops.rmsnorm_pipelined, functools.partial(
        ops.rmsnorm_plain, eps=1e-5), [(12, 32), (32,)], {"eps": 1e-5}),
    "ssm_scan": (ops.ssm_scan, ops.ssm_scan_plain,
                 [(2, 6, 8, 4), (2, 6, 8, 4), (2, 6, 4)], {}),
    "mlstm_chunkwise": (ops.mlstm_chunkwise, _mlstm_plain,
                        [(1, 16, 2, 8)] * 3 + [(1, 16, 2)] * 2,
                        {"chunk": 8}),
    "slstm_scan": (ops.slstm_scan, ops.slstm_scan_plain,
                   [(2, 5, 16), (4, 16)], {}),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_kernel_call_gives_the_plain_gradient(name):
    """f32 CPU tensors: the wrapper's forward (its plain version on the
    CPU), and exactly the gradient of the plain function the model hands
    `kernel_call` for every input."""
    kernel, plain, shapes, kwargs = ROUTES[name]
    inputs = _rand(3, *shapes, dtype=torch.float32)
    if name == "ssm_scan":  # a decay in (0, 1), as the model makes it
        inputs[0] = torch.sigmoid(inputs[0]).detach().requires_grad_()
    rng = np.random.default_rng(4)
    out = kernel_call(kernel, *inputs, plain_fn=plain, **kwargs)
    torch.testing.assert_close(out, kernel(*(t.detach() for t in inputs),
                                           **kwargs), rtol=0, atol=0)
    weight = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32))
    got = torch.autograd.grad((out.float() * weight).sum(), inputs)
    want = torch.autograd.grad((plain(*inputs).float() * weight).sum(),
                               inputs)
    for g, w in zip(got, want):
        assert g is not None
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- wrappers called directly refuse what autograd tracks ---------------------

@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm_pipelined",
                                  "rmsnorm_baseline", "ssm_scan",
                                  "mlstm_chunkwise", "slstm_scan"])
def test_each_check_refuses_an_input_that_requires_grad(name):
    fn = ops.KERNELS[name]
    route = ROUTES["rmsnorm_pipelined" if name == "rmsnorm_baseline"
                   else name]
    args = _rand(5, *route[2], dtype=torch.float32)
    with pytest.raises(ValueError, match=f"{name}: an input requires grad"):
        fn.check(*args)
    # grad mode off: the kernel's own checks speak (CPU tensors)
    with torch.no_grad(), pytest.raises(ValueError, match="device|on cpu"):
        fn.check(*args)


def test_kernel_call_needs_one_form_of_the_plain_version():
    """`plain_fn`, the plain version as a function of the kernel's tensors,
    is required: a capture records it and a gradient differentiates it."""
    x, scale = torch.rand((8, 64)), torch.rand(64)
    with pytest.raises(TypeError, match="plain_fn"):
        kernel_call(ops.rmsnorm_pipelined, x, scale)
    with pytest.raises(TypeError, match="plain"):
        kernel_call(ops.rmsnorm_pipelined, x, scale,
                    plain=functools.partial(ops.rmsnorm_plain, x, scale))
    with pytest.raises(TypeError, match="plain_fn"):
        kernel_call(ops.rmsnorm_pipelined, x.requires_grad_(), scale)


def test_no_autograd_route_without_grad(monkeypatch):
    """Serving and prefill: inputs that need no grad, or grad mode off, call
    the wrapper as before (no `KernelFunction` node)."""
    def never(*args, **kwargs):
        raise AssertionError("no autograd route here")
    monkeypatch.setattr(KernelFunction, "apply", never)
    x, scale = torch.rand((8, 64)), torch.rand(64)
    out = kernel_call(ops.rmsnorm_pipelined, x, scale,
                      plain_fn=ops.rmsnorm_plain)
    assert out.grad_fn is None
    with torch.no_grad():
        kernel_call(ops.rmsnorm_pipelined, x.requires_grad_(), scale,
                    plain_fn=ops.rmsnorm_plain)


@pytest.mark.parametrize("remat", ["none", "group"])
def test_capture_of_the_loss_records_the_same_regions(remat):
    """The kernels' regions in a capture of the smoke loss, whichever remat
    policy: one flash attention a layer and every norm, the plain
    versions' ops inside them (as `tests/test_torch_frontend.py` reads
    them)."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.long),
             "labels": torch.zeros((2, 64), dtype=torch.long)}
    module = capture(lambda p, b: loss_fn(p, cfg, b, chunk=32, remat=remat),
                     params, batch, device="cuda")
    assert module.kernel_calls == {"flash_attention": cfg.n_layers,
                                   "rmsnorm_pipelined": 2 * cfg.n_layers + 1}
    base = capture(lambda p, b: loss_fn(p, cfg, b, chunk=32, remat="none"),
                   params, batch, device="cuda")
    assert [i.op_name for i in module.all_instructions()] == \
        [i.op_name for i in base.all_instructions()]
