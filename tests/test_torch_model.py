"""Parity of the port's model, decode and step builders with the JAX
package's on qwen2-0.5b smoke (d_model 64, 4 heads, 2 KV heads, hd 16,
vocab 256, 2 layers), weights made by the reference and carried across with
`params_from_numpy`.

f32 (the smoke config with dtype float32) compares logits at 1e-4: the same
f32 arithmetic through two layers, summed in another order.  The bf16 smoke
config compares at 2e-2 of the largest logit: bf16 rounds the residual
stream at other places in the two frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.models import transformer as jt
from repro.runtime.steps import make_prefill_step as j_prefill_step
from repro.runtime.steps import make_serve_step as j_serve_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.runtime import make_prefill_step, make_serve_step


def _configs(dtype):
    jcfg = dataclasses.replace(j_smoke(j_get_config("qwen2-0.5b")),
                               dtype=dtype)
    tcfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                               dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    """Reference weights with random (not zero) QKV biases, both ways."""
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    attn = np_params["groups"][0]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = (0.1 * rng.standard_normal(attn[b].shape)).astype(
            attn[b].dtype)
    j_params = jax.tree.map(jnp.asarray, np_params)
    return j_params, convert.params_from_numpy(np_params, tcfg, "cpu")


def _close(port, expect, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


def test_forward_f32():
    jcfg, tcfg = _configs("float32")
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens((2, 64))
    j_logits, _ = jt.forward(jp, jcfg, tokens=jnp.asarray(tokens), chunk=32)
    t_logits, aux = tt.forward(tp, tcfg, tokens=torch.from_numpy(tokens),
                               chunk=32)
    assert t_logits.dtype == torch.float32 and float(aux) == 0.0
    _close(t_logits, j_logits, 1e-4)


def test_forward_bf16():
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens((2, 64))
    j_logits = np.asarray(jt.forward(jp, jcfg, tokens=jnp.asarray(tokens),
                                     chunk=32)[0])
    t_logits = tt.forward(tp, tcfg, tokens=torch.from_numpy(tokens),
                          chunk=32)[0].numpy()
    scale = np.abs(j_logits).max()
    assert np.abs(t_logits - j_logits).max() <= 2e-2 * scale
    assert (t_logits.argmax(-1) == j_logits.argmax(-1)).mean() >= 0.99


def test_prefill_step():
    jcfg, tcfg = _configs("float32")
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens((2, 32))
    out = make_prefill_step(tcfg, chunk=16, device="cpu")(
        tp, {"tokens": tokens})
    _close(out, j_prefill_step(jcfg, chunk=16)(
        jp, {"tokens": jnp.asarray(tokens)}), 1e-4)


def _filled_state(jp, jcfg, b, max_len, steps):
    """A reference decode state after `steps` tokens, so caches hold data."""
    state = jt.init_decode_state(jcfg, b, max_len)
    toks = _tokens((steps, b), seed=2)
    for t in range(steps):
        _, state = jt.decode_step(jp, state, jcfg, jnp.asarray(toks[t]),
                                  jnp.asarray(t))
    return state


def test_decode_step_matches_reference():
    jcfg, tcfg = _configs("float32")
    jp, tp = _params(jcfg, tcfg)
    j_state = _filled_state(jp, jcfg, b=3, max_len=16, steps=5)
    t_state = convert.decode_state_from_numpy(
        jax.tree.map(np.asarray, j_state), "cpu")
    token = _tokens((3,), seed=3)
    j_logits, j_new = jt.decode_step(jp, j_state, jcfg, jnp.asarray(token),
                                     jnp.asarray(5))
    t_logits, t_new = tt.decode_step(tp, t_state, tcfg,
                                     torch.from_numpy(token), 5)
    _close(t_logits, j_logits, 1e-4)
    for name in ("k", "v"):
        _close(t_new["groups"][0]["kv"][name],
               j_new["groups"][0]["kv"][name], 1e-5)


def test_serve_step_per_slot_positions():
    jcfg, tcfg = _configs("float32")
    jp, tp = _params(jcfg, tcfg)
    j_state = _filled_state(jp, jcfg, b=3, max_len=16, steps=6)
    t_state = convert.decode_state_from_numpy(
        jax.tree.map(np.asarray, j_state), "cpu")
    token, pos = _tokens((3,), seed=4), np.array([0, 3, 6])
    j_next, j_logits, j_new = j_serve_step(jcfg, per_slot_pos=True)(
        jp, j_state, jnp.asarray(token, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    t_next, t_logits, t_new = make_serve_step(tcfg)(
        tp, t_state, torch.from_numpy(token), torch.from_numpy(pos))
    _close(t_logits, j_logits, 1e-4)
    assert t_next.tolist() == np.asarray(j_next).tolist()
    for name in ("k", "v"):
        _close(t_new["groups"][0]["kv"][name],
               j_new["groups"][0]["kv"][name], 1e-5)


def test_prefill_then_decode_equals_forward():
    _, tcfg = _configs("float32")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens((2, 16), seed=5))
    full, _ = tt.forward(tp, tcfg, tokens=tokens)
    state = tt.init_decode_state(tcfg, 2, 16, "cpu")
    for t in range(16):
        logits, state = tt.decode_step(tp, state, tcfg, tokens[:, t],
                                       torch.full((2,), t))
        _close(logits, full[:, t].numpy(), 1e-4)


def test_init_params_layout_matches_reference():
    jcfg, tcfg = _configs("bfloat16")
    j_shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    j_flat = jax.tree_util.tree_flatten_with_path(j_shapes)[0]
    assert len(j_flat) == len(list(_leaves(tp)))
    for path, leaf in j_flat:
        t = tp
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(t.shape) == tuple(leaf.shape), path
        assert t.dtype == torch.bfloat16
    # init scales of transformer.py::init_params
    wq = tp["groups"][0]["attn"]["wq"].float()
    assert abs(wq.std().item() - 0.02) < 0.002
    assert abs(tp["embed"]["table"].float().std().item() - 1.0) < 0.05
    assert torch.all(tp["groups"][0]["attn"]["bq"] == 0)
    assert torch.all(tp["final_norm"] == 1)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "musicgen-medium",
                                  "phi3.5-moe-42b-a6.6b"])
def test_later_architectures_raise(arch):
    cfg = smoke_config(get_config(arch))
    with pytest.raises(NotImplementedError):
        tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError):
        tt.init_decode_state(cfg, 1, 8, "cpu")
