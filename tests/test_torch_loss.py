"""The port's `loss_fn` and K3's plain version against the JAX package.

* `loss_fn` on qwen2-0.5b and hymba-1.5b smoke in f32, weights made by the
  reference and carried across with `params_from_numpy`: within 1e-5
  relative (the forward's logits agree to 1e-4 absolute in
  `tests/test_torch_model.py`; the mean NLL over 2 x 64 tokens averages
  those differences).
* `rmsnorm_baseline` (K3) takes CPU tensors to `rmsnorm_plain`, held
  against the reference's Pallas `rmsnorm_baseline` in interpret mode and
  its oracle on ROADMAP B2's grid at f32 1e-5 and bf16 3e-2, the
  tolerances of `tests/test_kernels.py::TestRmsnorm`.
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
from repro.models import transformer as jt
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.models import convert, loss_fn
from repro_torch.models.flags import flags


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b"])
def test_loss_matches_reference_f32(arch):
    jcfg = dataclasses.replace(j_smoke(j_get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="float32")
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    tparams = convert.params_from_numpy(np_params, tcfg, "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, size=(2, 64))
    labels = rng.integers(0, 256, size=(2, 64))
    want = float(jt.loss_fn(params, jcfg, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)},
                            chunk=32))
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    got = loss_fn(tparams, tcfg, batch, chunk=32)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5)
    # CPU tensors take the plain paths whatever the attention switch says
    with flags(attention_impl="plain"):
        assert float(loss_fn(tparams, tcfg, batch, chunk=32)) == float(got)


def test_attention_impl_is_checked():
    with pytest.raises(ValueError, match="attention_impl"):
        with flags(attention_impl="pallas_fused"):
            pass


@pytest.mark.parametrize("r,d", [(32, 128), (64, 256), (8, 512), (8, 896)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_baseline_plain_matches_pallas(r, d, dtype):
    rng = np.random.default_rng(4)
    x = (0.5 * rng.standard_normal((r, d))).astype(np.float32)
    scale = (1.0 + 0.05 * rng.standard_normal(d)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    before = tops.rmsnorm_baseline.launches
    out = tops.rmsnorm_baseline_op(tx, torch.from_numpy(scale))
    assert tops.rmsnorm_baseline.launches == before
    assert out.dtype == tdt
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    for expect in (jops.rmsnorm_baseline_op(jx, jnp.asarray(scale),
                                            block_rows=8, interpret=True),
                   jref.rmsnorm_ref(jx, jnp.asarray(scale))):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(expect, np.float32),
                                   atol=tol, rtol=tol)
