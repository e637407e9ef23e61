"""The reference's two SSM forms in the port (`flags.ssm_fused`,
`flags.ssm_pallas`) against the JAX package's, on the same numpy-made
inputs, on the CPU.

* Each of the port's two forms against each of the reference's two, hymba
  smoke layer 0 in f32 at 1e-4, `tests/test_torch_ssm.py::
  test_ssm_forward_f32`'s limit: the same f32 recurrence, scanned within a
  chunk by another tree (doubling here, `associative_scan` there).
* `ssm_scan_chunked` and `ssm_fused_plain`, the plain versions the model
  runs and a capture records, against `ssm_scan_plain`, the exact
  sequential loop, on the same discretized terms at 1e-5 relative to the
  largest output: the products within a chunk are taken in another order.
* One layer's f32 gradients through `kernel_call`'s autograd route (the
  fused entry forward, `ssm_fused_plain` recomputed backward) against
  `jax.grad` of the reference's fused `ssm_forward`, at 1e-4 of each
  gradient's largest value.
* A chunk whose `cumprod(a)` underflows stays finite.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.models import ssm as j_ssm
from repro.models import transformer as jt
from repro.models.flags import flags as j_flags
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import autograd as t_autograd
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import discretize
from repro_torch.models import flags as t_flags_module
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.flags import flags, get_flags, set_flags

FORMS = {"whole": {"ssm_fused": False}, "fused": {"ssm_fused": True},
         "fused_pallas": {"ssm_fused": True, "ssm_pallas": True}}


def _cfgs():
    return (dataclasses.replace(j_smoke(j_get_config("hymba-1.5b")),
                                dtype="float32"),
            dataclasses.replace(smoke_config(get_config("hymba-1.5b")),
                                dtype="float32"))


def _layer0(jcfg, tcfg, seed=0):
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    j_p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       np_params["groups"][0]["ssm"])
    t_p = {k: v[0] for k, v in params_from_numpy(
        np_params, tcfg, "cpu")["groups"][0]["ssm"].items()}
    return j_p, t_p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(port, expect, rel):
    expect = np.asarray(expect, np.float32)
    np.testing.assert_allclose(port.detach().float().numpy(), expect,
                               rtol=0, atol=rel * np.abs(expect).max())


def test_flags_have_the_reference_defaults():
    from repro.models.flags import ModelFlags as JFlags
    got = get_flags()
    assert (got.ssm_fused, got.ssm_pallas) == (JFlags().ssm_fused,
                                               JFlags().ssm_pallas)
    prev = get_flags()
    try:
        assert set_flags(ssm_fused=True).ssm_fused
        assert get_flags().ssm_fused and not get_flags().ssm_pallas
    finally:
        t_flags_module._FLAGS = prev
    assert get_flags() == prev


@pytest.mark.parametrize("j_form", ["whole", "fused", "fused_pallas"])
@pytest.mark.parametrize("t_form", ["whole", "fused", "fused_pallas"])
@pytest.mark.parametrize("s", [64, 256])
def test_each_form_matches_each_reference_form(t_form, j_form, s):
    jcfg, tcfg = _cfgs()
    j_p, t_p = _layer0(jcfg, tcfg)
    x = _x((2, s, jcfg.d_model))
    with j_flags(**FORMS[j_form]):
        expect = j_ssm.ssm_forward(j_p, jnp.asarray(x), jcfg)
    ops.reset_launch_counts()
    with flags(**FORMS[t_form]):
        out = t_ssm.ssm_forward(t_p, torch.from_numpy(x), tcfg)
    assert set(ops.launch_counts().values()) == {0}  # CPU: plain
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-4,
                               rtol=1e-4)


def _terms(seed, b, s, din, n, dt_scale=1.0):
    """The model's discretization of numpy-made xin, w_dt, a_log (log 1..N,
    as `init_ssm` makes it), bsel and csel."""
    rng = np.random.default_rng(seed)
    xin = torch.from_numpy(rng.standard_normal((b, s, din)).astype(
        np.float32))
    w_dt = torch.from_numpy((dt_scale * rng.standard_normal(din)).astype(
        np.float32))
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(
        din, n).contiguous()
    bsel, csel = (torch.from_numpy(rng.standard_normal((b, s, n)).astype(
        np.float32)) for _ in range(2))
    return xin, w_dt, a_log, bsel, csel


@pytest.mark.parametrize("s,chunk", [(256, 128), (300, 128), (64, 16),
                                     (37, 8)])
def test_chunked_forms_match_the_sequential_scan(s, chunk):
    xin, w_dt, a_log, bsel, csel = _terms(3, 2, s, 48, 8)
    a, bx = discretize(xin, w_dt, a_log, bsel)
    want = ops.ssm_scan_plain(a, bx, csel)
    _close(ops.ssm_scan_chunked(a, bx, csel, chunk), want.numpy(), 1e-5)
    _close(ops.ssm_fused_plain(xin, w_dt, a_log, bsel, csel, chunk),
           want.numpy(), 1e-5)
    # the wrapper on CPU tensors is its plain version, launching nothing
    before = ops.ssm_scan_fused.launches
    got = ops.ssm_scan_fused(xin, w_dt, a_log, bsel, csel)
    assert ops.ssm_scan_fused.launches == before
    assert torch.equal(got, ops.ssm_fused_plain(xin, w_dt, a_log, bsel,
                                                csel))


def test_fused_plain_takes_a_strided_bf16_view():
    """The model hands the fused entry `xz[..., :din]` in the config's
    dtype: a view with row stride 2 din, read as f32."""
    xin, w_dt, a_log, bsel, csel = _terms(5, 2, 40, 16, 4)
    xz = torch.cat([xin, torch.randn_like(xin)], dim=-1).to(torch.bfloat16)
    view = xz[..., :16]
    assert view.stride() == (40 * 32, 32, 1)
    got = ops.ssm_scan_fused(view, w_dt, a_log, bsel, csel)
    a, bx = discretize(view.float(), w_dt, a_log, bsel)
    _close(got, ops.ssm_scan_plain(a, bx, csel).numpy(), 1e-5)


def test_a_chunk_whose_cumprod_underflows_stays_finite():
    """dt up to ~50 makes a = exp(-N dt) underflow to 0 in one step, so
    `cumprod(a)` over a chunk is 0 and a closed form dividing by it gives
    inf/NaN; the doubling scan divides by nothing."""
    xin, w_dt, a_log, bsel, csel = _terms(6, 2, 256, 32, 16, dt_scale=20.0)
    a, bx = discretize(xin, w_dt, a_log, bsel)
    assert (torch.cumprod(a[:, :128], dim=1)[:, -1] == 0).float().mean() > .5
    want = ops.ssm_scan_plain(a, bx, csel)
    for got in (ops.ssm_scan_chunked(a, bx, csel),
                ops.ssm_fused_plain(xin, w_dt, a_log, bsel, csel)):
        assert torch.isfinite(got).all()
        _close(got, want.numpy(), 1e-5)


GRAD_LEAVES = ("w_in", "w_dt", "a_log", "w_b", "w_c")


def test_layer_gradients_through_the_fused_route(monkeypatch):
    """The model's fused kernel branch (taken here on CPU tensors by
    patching `_kernel_path`), through `kernel_call`'s autograd route, gives
    the reference's fused-form gradients."""
    jcfg, tcfg = _cfgs()
    j_p, t_p = _layer0(jcfg, tcfg)
    x = _x((2, 256, jcfg.d_model))
    weight = _x((2, 256, jcfg.d_model), seed=2)

    def j_loss(leaves):
        p = dict(j_p, **dict(zip(GRAD_LEAVES, leaves)))
        with j_flags(ssm_fused=True, ssm_pallas=True):
            out = j_ssm.ssm_forward(p, jnp.asarray(x), jcfg)
        return (out * weight).sum()

    want = jax.grad(j_loss)([j_p[k] for k in GRAD_LEAVES])

    routed = []
    apply = t_autograd.KernelFunction.apply

    def counting(kernel, *args):
        routed.append(kernel.__name__)
        return apply(kernel, *args)

    monkeypatch.setattr(t_ssm, "_kernel_path", lambda x: True)
    monkeypatch.setattr(t_autograd.KernelFunction, "apply", counting)
    tracked = {k: v.detach().clone().requires_grad_(k in GRAD_LEAVES)
               for k, v in t_p.items()}
    with flags(ssm_fused=True, ssm_pallas=True):
        out = t_ssm.ssm_forward(tracked, torch.from_numpy(x), tcfg)
    assert routed == ["ssm_scan_fused"]
    got = torch.autograd.grad((out * torch.from_numpy(weight)).sum(),
                              [tracked[k] for k in GRAD_LEAVES])
    for name, g, w in zip(GRAD_LEAVES, got, want):
        assert float(np.abs(np.asarray(w)).max()) > 0, name
        _close(g, w, 1e-4)


def test_the_route_recomputes_the_fused_plain_version():
    """`kernel_call` on the fused entry: the wrapper's forward, the
    gradient of the plain function it is handed, exactly."""
    from repro_torch.core.torch_frontend import kernel_call
    args = [t.requires_grad_() for t in _terms(8, 2, 40, 16, 4)]
    plain = functools.partial(ops.ssm_fused_plain, chunk=16)
    out = kernel_call(ops.ssm_scan_fused, *args, plain_fn=plain)
    weight = torch.from_numpy(_x(tuple(out.shape), seed=9))
    got = torch.autograd.grad((out * weight).sum(), args)
    want = torch.autograd.grad((plain(*args) * weight).sum(), args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
