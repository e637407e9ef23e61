"""The port's optimizer (`repro_torch.optim`) against the JAX package's.

* The four cases of `tests/test_substrate.py::TestOptimizer`, ported.
* `adamw_update` fed the same numpy gradients and state as the
  reference's, 3 steps at `lr_scale` 0, 0.5 and 1, f32 and bf16 params:
  params, `mu`, `nu`, `master` and `count` at rel 1e-6 (the same f32
  arithmetic; XLA and PyTorch may round a power or a fused multiply-add
  differently in the last bit, and AdamW's `g / (|g| + eps)` magnifies
  such a bit only where |g| is near eps, which these gradients are not).
  bf16 params are the master rounded, so they are held to one bf16 step.
* `linear_warmup_cosine` at rel 2.4e-7, two f32 steps: the same f32
  arithmetic, but each library rounds the last bit of its cosine its own
  way (one step apart at warmup 0, total 5, step 2);
  `clip_by_global_norm` on f32 and bf16 gradients, `compress_gradients`
  over 3 rounds with the error feedback carried, and `GradAccumulator`:
  rel 1e-6 (sums taken in another order), bf16 to one bf16 step.
* `default_microbatch` equal on a grid of configs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import GradAccumulator as JGradAccumulator
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import compress_gradients as j_compress
from repro.optim import linear_warmup_cosine as j_schedule
from repro.runtime import default_microbatch as j_default_microbatch
from repro_torch.configs import ALL_ARCHS
from repro_torch.optim import (
    AdamWConfig,
    GradAccumulator,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_gradients,
    linear_warmup_cosine,
)
from repro_torch.runtime import default_microbatch

BF16_STEP = 2.0 ** -7  # one bf16 step, relative


def _t(a, dtype=None):
    """numpy -> torch, bf16 taken bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def _close_trees(got, want, rtol, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _close_trees(got[k], want[k], rtol, atol)
        else:
            np.testing.assert_allclose(_np(got[k]), np.asarray(
                want[k], np.float32), rtol=rtol, atol=atol, err_msg=k)


# -- the ported TestOptimizer cases -------------------------------------------

class TestOptimizer:
    def _quad(self):
        params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}

        def loss(p):
            return torch.sum(p["w"] ** 2) + p["b"] ** 2
        return params, loss

    def test_adamw_reduces_loss(self):
        params, loss = self._quad()
        state = adamw_init(params)
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
        l0 = loss(params)
        for _ in range(50):
            leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
            grads = dict(zip(leaves, torch.autograd.grad(
                loss(leaves), list(leaves.values()))))
            params, state = adamw_update(cfg, grads, state, params)
        assert float(loss(params)) < 0.1 * float(l0)

    def test_bf16_params_keep_f32_master(self):
        params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
        state = adamw_init(params)
        assert state["master"]["w"].dtype == torch.float32
        grads = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
        new_p, new_s = adamw_update(AdamWConfig(lr=1e-4), grads, state,
                                    params)
        assert new_p["w"].dtype == torch.bfloat16
        # master moved even though the bf16 delta may round away
        assert float((new_s["master"]["w"] - 1.0).abs().max()) > 0

    def test_clip_global_norm(self):
        grads = {"a": torch.full((10,), 100.0)}
        clipped, gnorm = clip_by_global_norm(grads, 1.0)
        assert float(gnorm) > 100
        norm_after = torch.sqrt(torch.sum(clipped["a"] ** 2))
        assert float(norm_after) == pytest.approx(1.0, rel=1e-4)

    def test_grad_compression_error_feedback(self):
        grads = {"w": torch.tensor([1.0, 1e-4, -0.5])}
        q1, ef = compress_gradients(grads)
        # error feedback carries the quantization residual
        assert ef["w"].shape == (3,)
        q2, ef2 = compress_gradients(grads, ef)
        # two-step average closer to the truth than a single step
        err1 = (q1["w"] - grads["w"]).abs().max()
        avg = (q1["w"] + q2["w"]) / 2
        err2 = (avg - grads["w"]).abs().max()
        assert float(err2) <= float(err1) + 1e-9


# -- against the reference ---------------------------------------------------

def _grad_tree(rng, shapes, scale=1e-2):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (32, 48), "b": (48,), "table": (64, 16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    init = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in init.items()}
    tparams = {k: _t(np.asarray(v)) for k, v in jparams.items()}
    jstate, tstate = j_adamw_init(jparams), adamw_init(tparams)
    jcfg, tcfg = JAdamWConfig(lr=3e-3), AdamWConfig(lr=3e-3)
    for lr_scale in (0.0, 0.5, 1.0):
        grads = _grad_tree(rng, SHAPES)
        jg = {k: jnp.asarray(v).astype(jdt) for k, v in grads.items()}
        tg = {k: _t(np.asarray(v)) for k, v in jg.items()}
        jparams, jstate = j_adamw_update(jcfg, jg, jstate, jparams,
                                         jnp.float32(lr_scale))
        tparams, tstate = adamw_update(tcfg, tg, tstate, tparams,
                                       torch.tensor(lr_scale))
        assert int(tstate["count"]) == int(jstate["count"])
        assert tstate["count"].dtype == torch.int32
        for key in ("mu", "nu", "master"):
            _close_trees(tstate[key], _tree_np(jax.tree.map(np.asarray,
                                                            jstate[key])),
                         rtol=1e-6, atol=1e-12)
            assert all(t.dtype == torch.float32
                       for t in tstate[key].values())
        assert all(tparams[k].dtype == getattr(torch, dtype) for k in SHAPES)
        _close_trees(tparams, jax.tree.map(
            lambda a: np.asarray(a, np.float32), jparams),
            rtol=1e-6 if dtype == "float32" else BF16_STEP)


def test_adamw_update_leaves_the_params_apart_from_the_master():
    """The returned params are new tensors: an f32 param is not the master
    itself, which the next update changes in place."""
    params = {"w": torch.ones(4)}
    state = adamw_init(params)
    new, state = adamw_update(AdamWConfig(), {"w": torch.ones(4)}, state,
                              params)
    before = new["w"].clone()
    adamw_update(AdamWConfig(), {"w": torch.ones(4)}, state, new)
    assert torch.equal(new["w"], before)
    assert torch.equal(params["w"], torch.ones(4))


@pytest.mark.parametrize("warmup,total", [(2, 10), (100, 10_000), (0, 5),
                                          (5, 5)])
def test_linear_warmup_cosine_matches_reference(warmup, total):
    for step in (0, 1, 2, 3, 4, 5, 7, 10, 50, 100, 5_000, 10_000, 20_000):
        want = float(j_schedule(jnp.int32(step), warmup, total))
        got = linear_warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                   warmup, total)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=2.4e-7, abs=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-3, 10.0])  # below and above the clip
def test_clip_by_global_norm_matches_reference(dtype, scale):
    rng = np.random.default_rng(2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    grads = {k: jnp.asarray(v).astype(jdt)
             for k, v in _grad_tree(rng, SHAPES, scale).items()}
    jclipped, jnorm = j_clip(grads, 1.0)
    tclipped, tnorm = clip_by_global_norm(
        {k: _t(np.asarray(v)) for k, v in grads.items()}, 1.0)
    assert tnorm.dtype == torch.float32
    assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
    for k in SHAPES:
        assert tclipped[k].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(
            _np(tclipped[k]), np.asarray(jclipped[k], np.float32),
            rtol=1e-6 if dtype == "float32" else BF16_STEP, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_gradients_matches_reference_over_rounds(dtype):
    rng = np.random.default_rng(3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jef = tef = None
    for _ in range(3):
        grads = {k: jnp.asarray(v).astype(jdt)
                 for k, v in _grad_tree(rng, SHAPES).items()}
        jq, jef = j_compress(grads, jef)
        tq, tef = compress_gradients(
            {k: _t(np.asarray(v)) for k, v in grads.items()}, tef)
        for k in SHAPES:
            assert tq[k].dtype == getattr(torch, dtype)
            assert tef[k].dtype == torch.float32
            # the dequantized values are k * scale, k an int8; the scale
            # agrees to f32 rounding, so each value to 1e-6 of the largest
            top = float(np.abs(np.asarray(jq[k], np.float32)).max())
            np.testing.assert_allclose(
                _np(tq[k]), np.asarray(jq[k], np.float32),
                rtol=0 if dtype == "float32" else BF16_STEP,
                atol=1e-6 * top)
            np.testing.assert_allclose(_np(tef[k]), np.asarray(jef[k]),
                                       atol=1e-6 * top)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_grad_accumulator_matches_reference(n_micro):
    rng = np.random.default_rng(4)
    batch = {"x": rng.standard_normal((8, 5)).astype(np.float32),
             "y": rng.integers(0, 9, (8, 3)).astype(np.int32)}
    w = rng.standard_normal((5, 3)).astype(np.float32)

    def j_grad(p, mb):
        return jax.grad(lambda p: jnp.sum(
            (mb["x"] @ p) * mb["y"].astype(jnp.float32)))(p)

    def t_grad(p, mb):
        leaf = p.clone().requires_grad_()
        return torch.autograd.grad(torch.sum(
            (mb["x"] @ leaf) * mb["y"].float()), leaf)[0]

    jacc = JGradAccumulator(n_micro)
    jmicro = jacc.split(jax.tree.map(jnp.asarray, batch))
    tacc = GradAccumulator(n_micro)
    tmicro = tacc.split({k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(tmicro) == n_micro
    for i, mb in enumerate(tmicro):
        for k in batch:
            np.testing.assert_array_equal(mb[k].numpy(),
                                          np.asarray(jmicro[k][i]))
    want = jacc.accumulate_scan(j_grad, jnp.asarray(w), jmicro)
    got = tacc.accumulate(t_grad, torch.from_numpy(w), tmicro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_grad_accumulator_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="does not split"):
        GradAccumulator(3).split({"x": torch.zeros((8, 2))})


@pytest.mark.parametrize("batch,seq,dp,target", [
    (4, 1024, 1, 2e9), (256, 4096, 8, 2e9), (512, 8192, 1, 1e9),
    (1, 32, 1, 2e9), (64, 2048, 0, 5e8), (8, 4096, 16, 1e6)])
def test_default_microbatch_matches_reference(batch, seq, dp, target):
    for jc, tc in zip(J_ARCHS, ALL_ARCHS):
        assert default_microbatch(tc, batch, seq, dp, target) == \
            j_default_microbatch(jc, batch, seq, dp, target), jc.name
