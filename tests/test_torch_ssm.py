"""Parity of the port's selective scan and SSM mixer with the JAX package's,
on the same numpy-made inputs, on the CPU.

The scan is held against the Pallas kernel in interpret mode and the
sequential jnp oracle at 1e-4, the tolerance of `tests/test_kernels.py::
TestSsmKernel`: the same f32 recurrence, with the readout summed in another
order (and, in the reference model, an associative scan inside each chunk).
bf16 inputs are the input type only; the math is f32 on both sides, so they
are held to the same 1e-4.  The CUDA kernel itself is held against
`ssm_scan_plain` on the card by `tests/test_torch_gpu.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as j_ssm
from repro.models import transformer as jt
from repro.models.flags import flags as j_flags
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import decode_state_from_numpy
from repro_torch.models.convert import params_from_numpy


def _close(port, expect, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


def _scan_inputs(seed, b, s, din, n, dtype):
    """a in (0, 1) as the discretization makes it, bx and c normal."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((b, s, din, n)) + 1.0)))
    bx = rng.standard_normal((b, s, din, n))
    c = rng.standard_normal((b, s, n))
    arrays = [x.astype(np.float32) for x in (a, bx, c)]
    jarr = [jnp.asarray(x).astype(dtype) for x in arrays]
    return jarr, [decode_state_from_numpy(np.asarray(x), "cpu")
                  for x in jarr]


@pytest.mark.parametrize("s,din,n,chunk", [(32, 128, 8, 8),
                                           (64, 256, 16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_matches_pallas_and_ref(s, din, n, chunk, dtype):
    (ja, jbx, jc), (ta, tbx, tc) = _scan_inputs(4, 2, s, din, n, dtype)
    before = tops.ssm_scan.launches
    out = tops.ssm_scan_op(ta, tbx, tc, chunk=chunk)
    assert tops.ssm_scan.launches == before  # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == (2, s, din)
    _close(out, jops.ssm_scan_op(ja, jbx, jc, chunk=chunk, interpret=True),
           1e-4)
    _close(out, jref.ssm_scan_ref(ja, jbx, jc), 1e-4)
    _close(out, tops.ssm_scan_plain(ta, tbx, tc), 0)


def _cfgs(dtype):
    jcfg = dataclasses.replace(j_smoke(j_get_config("hymba-1.5b")),
                               dtype=dtype)
    tcfg = dataclasses.replace(smoke_config(get_config("hymba-1.5b")),
                               dtype=dtype)
    return jcfg, tcfg


def _layer0_ssm(jcfg, tcfg, seed=0):
    """Layer 0's SSM params of a reference hymba smoke model, both ways."""
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    j_p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       np_params["groups"][0]["ssm"])
    t_p = {k: v[0] for k, v in params_from_numpy(
        np_params, tcfg, "cpu")["groups"][0]["ssm"].items()}
    return j_p, t_p


def _x(shape, dtype, seed=1):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(dtype)
    return j, decode_state_from_numpy(np.asarray(j), "cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-5)])
def test_discretize(dtype, tol):
    """The same casts in the same order: dt from f32 xin * w_dt, bsel/csel
    from the linear in the input dtype, then f32."""
    jcfg, tcfg = _cfgs(dtype)
    j_p, t_p = _layer0_ssm(jcfg, tcfg)
    din = jcfg.ssm_expand * jcfg.d_model
    jx, tx = _x((2, 5, din), dtype)
    for port, ref in zip(t_ssm._discretize(t_p, tx),
                         j_ssm._discretize(j_p, jx)):
        assert port.dtype == torch.float32
        _close(port, ref, tol)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("s", [64, 256])
def test_ssm_forward_f32(fused, s):
    """Both forms of the reference (`ssm_fused`), chunked associative scans,
    against the port's plain path, the exact sequential scan."""
    jcfg, tcfg = _cfgs("float32")
    j_p, t_p = _layer0_ssm(jcfg, tcfg)
    jx, tx = _x((2, s, jcfg.d_model), "float32")
    with j_flags(ssm_fused=fused):
        expect = j_ssm.ssm_forward(j_p, jx, jcfg)
    before = tops.ssm_scan.launches
    out = t_ssm.ssm_forward(t_p, tx, tcfg)
    assert tops.ssm_scan.launches == before
    assert out.dtype == torch.float32
    _close(out, expect, 1e-4)


def test_ssm_forward_bf16():
    """bf16 rounds the input and the output projection at the same places
    in both packages: held to 2e-2 of the largest output."""
    jcfg, tcfg = _cfgs("bfloat16")
    j_p, t_p = _layer0_ssm(jcfg, tcfg)
    jx, tx = _x((2, 64, jcfg.d_model), "bfloat16")
    expect = np.asarray(j_ssm.ssm_forward(j_p, jx, jcfg), np.float32)
    out = t_ssm.ssm_forward(t_p, tx, tcfg)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - expect).max() <= \
        2e-2 * np.abs(expect).max()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_ssm_decode(dtype, tol):
    jcfg, tcfg = _cfgs(dtype)
    j_p, t_p = _layer0_ssm(jcfg, tcfg)
    din = jcfg.ssm_expand * jcfg.d_model
    jx, tx = _x((3, jcfg.d_model), dtype)
    jh, th = _x((3, din, jcfg.ssm_state), "float32", seed=2)
    j_y, j_new = j_ssm.ssm_decode(j_p, jx, {"h": jh}, jcfg)
    t_y, t_new = t_ssm.ssm_decode(t_p, tx, {"h": th}, tcfg)
    assert t_y.dtype == tx.dtype and t_new["h"].dtype == torch.float32
    _close(t_y, j_y, tol)
    _close(t_new["h"], j_new["h"], 1e-5)


def test_decode_steps_equal_forward():
    """The O(1) decode recurrence, step by step, equals the prefill scan."""
    _, tcfg = _cfgs("float32")
    t_p = {k: v[0] for k, v in t_ssm.init_ssm(
        tcfg, 1, lambda shape, scale, dt: scale * torch.randn(
            shape, generator=torch.Generator().manual_seed(3)).to(dt),
        torch.float32, "cpu").items()}
    _, tx = _x((2, 40, tcfg.d_model), "float32", seed=4)
    full = t_ssm.ssm_forward(t_p, tx, tcfg)
    state = t_ssm.init_ssm_state(tcfg, 2, "cpu")
    for t in range(40):
        y, state = t_ssm.ssm_decode(t_p, tx[:, t], state, tcfg)
        _close(y, full[:, t].numpy(), 1e-5)


def test_init_ssm_matches_reference_layout():
    jcfg, tcfg = _cfgs("bfloat16")
    j_p = jax.eval_shape(lambda: j_ssm.init_ssm(jax.random.PRNGKey(0), jcfg,
                                                jnp.bfloat16))
    gen = torch.Generator().manual_seed(0)
    t_p = t_ssm.init_ssm(
        tcfg, 2, lambda shape, scale, dt: (scale * torch.randn(
            shape, generator=gen)).to(dt), torch.bfloat16, "cpu")
    assert sorted(t_p) == sorted(j_p)
    for name, leaf in j_p.items():
        assert tuple(t_p[name].shape) == (2,) + tuple(leaf.shape), name
        assert str(t_p[name].dtype).split(".")[1] == str(leaf.dtype), name
    expect = np.asarray(j_ssm.init_ssm(jax.random.PRNGKey(0), jcfg,
                                       jnp.bfloat16)["a_log"])
    _close(t_p["a_log"][1], expect, 1e-6)  # log in two libms: one ulp
    assert torch.all(t_p["d_skip"] == 1)
