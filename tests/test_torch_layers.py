"""Parity of the port's layers and attention functions with the JAX
package's, on the same numpy-made inputs, on the CPU.

f32 cases compare at 1e-5 to 1e-4 (the same f32 arithmetic, summed in
another order); bf16 cases at 2e-2 relative (one bf16 rounding of the
output, at other places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.models import attention as j_attn
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as tl
from repro_torch.models.convert import decode_state_from_numpy
from repro_torch.models.convert import params_from_numpy


def _pair(a, dtype="float32"):
    """One numpy array as (jax array, torch tensor) in `dtype`."""
    j = jnp.asarray(a).astype(dtype)
    return j, decode_state_from_numpy(np.asarray(j), "cpu")


def _close(port, expect, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


RNG = np.random.default_rng(0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_rmsnorm(dtype, tol):
    jx, tx = _pair(RNG.standard_normal((3, 5, 96)), dtype)
    js, ts = _pair(1 + 0.1 * RNG.standard_normal(96), dtype)
    out = tl.rmsnorm(tx, ts, 1e-5)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, jl.rmsnorm(jx, js, 1e-5), tol)


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    jx, tx = _pair(RNG.standard_normal((2, 7, 32)))
    jw, tw = _pair(0.1 * RNG.standard_normal((32, 48)))
    jb, tb = _pair(RNG.standard_normal(48)) if bias else (None, None)
    _close(tl.linear(tx, tw, tb), jl.linear(jx, jw, jb), 1e-5)


def test_rope():
    pos = np.array([0, 3, 17, 1023, 40000])
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 64, 1e6)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 64, 1e6)
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    jx, tx = _pair(RNG.standard_normal((5, 14, 64)))
    _close(tl.apply_rope(tx, tc, ts), jl.apply_rope(jx, jc, js), 1e-5)


def test_mlp():
    shapes = {"w_gate": (32, 64), "w_up": (32, 64), "w_down": (64, 32)}
    jp, tp = {}, {}
    for n, shape in shapes.items():
        jp[n], tp[n] = _pair(0.2 * RNG.standard_normal(shape))
    jx, tx = _pair(RNG.standard_normal((4, 32)))
    _close(tl.mlp(tx, tp), jl.mlp(jx, jp), 1e-5)


@pytest.mark.parametrize("transpose", [True, False])
def test_embed_unembed(transpose):
    jt_, tt = _pair(RNG.standard_normal((50, 16)))
    tokens = np.array([[0, 49, 7], [3, 3, 12]])
    jx = jl.embed(jnp.asarray(tokens), {"table": jt_}, jnp.float32)
    tx = tl.embed(torch.from_numpy(tokens), {"table": tt}, torch.float32)
    _close(tx, jx, 0)
    w_np = RNG.standard_normal((50, 16) if transpose else (16, 50))
    jw, tw = _pair(w_np)
    _close(tl.unembed(tx, tw, transpose), jl.unembed(jx, jw, transpose),
           1e-5)


def test_decode_attention():
    jq, tq = _pair(RNG.standard_normal((3, 4, 16)))
    jk, tk = _pair(RNG.standard_normal((3, 10, 2, 16)))
    jv, tv = _pair(RNG.standard_normal((3, 10, 2, 16)))
    mask = np.arange(10)[None, :] <= np.array([0, 4, 9])[:, None]
    out = t_attn.decode_attention(tq, tk, tv, torch.from_numpy(mask))
    _close(out, j_attn.decode_attention(jq, jk, jv, jnp.asarray(mask)),
           1e-5)


def _f32_smoke():
    jcfg = dataclasses.replace(j_smoke(j_get_config("qwen2-0.5b")),
                               dtype="float32")
    tcfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                               dtype="float32")
    return jcfg, tcfg


def _layer0_attn(jcfg, tcfg):
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    # give the zero-initialised QKV biases values so they are exercised
    np_params = jax.tree.map(np.asarray, params)
    attn = np_params["groups"][0]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = (0.1 * RNG.standard_normal(attn[b].shape)).astype(
            np.float32)
    j_layer = jax.tree.map(lambda a: jnp.asarray(a[0]), attn)
    t_layer = {k: v[0] for k, v in params_from_numpy(
        np_params, tcfg, "cpu")["groups"][0]["attn"].items()}
    return j_layer, t_layer


def test_attn_forward():
    jcfg, tcfg = _f32_smoke()
    j_layer, t_layer = _layer0_attn(jcfg, tcfg)
    jx, tx = _pair(RNG.standard_normal((2, 32, jcfg.d_model)))
    out = t_attn.attn_forward(t_layer, tx, tcfg, torch.arange(32), chunk=16)
    _close(out, j_attn.attn_forward(j_layer, jx, jcfg, jnp.arange(32),
                                    chunk=16), 1e-5)


def test_attn_decode_per_slot_positions():
    """Each slot at its own position: the reference decodes each slot alone
    with a scalar position against its own cache row."""
    jcfg, tcfg = _f32_smoke()
    j_layer, t_layer = _layer0_attn(jcfg, tcfg)
    b, s, kv, hd = 3, 12, jcfg.n_kv_heads, jcfg.head_dim_
    cache_np = RNG.standard_normal((2, b, s, kv, hd)).astype(np.float32)
    pos = np.array([0, 5, 11])
    jx, tx = _pair(RNG.standard_normal((b, jcfg.d_model)))
    t_cache = {"k": torch.from_numpy(cache_np.copy()),
               "v": torch.from_numpy(-cache_np)}
    out = t_attn.attn_decode(t_layer, tx, t_cache, torch.from_numpy(pos),
                             tcfg, layer_idx=1)
    for i in range(b):
        j_cache = {"k": jnp.asarray(cache_np[:, i:i + 1]),
                   "v": jnp.asarray(-cache_np[:, i:i + 1])}
        y, new = j_attn.attn_decode(j_layer, jx[i:i + 1], j_cache,
                                    jnp.asarray(pos[i]), jcfg,
                                    layer_idx=jnp.asarray(1))
        _close(out[i:i + 1], y, 1e-5)
        _close(t_cache["k"][:, i], np.asarray(new["k"])[:, 0], 1e-6)
        _close(t_cache["v"][:, i], np.asarray(new["v"])[:, 0], 1e-6)


def test_attn_decode_swa_ring_per_slot_positions():
    """Sliding-window decode against a ring of `window` entries, each slot
    at its own position, some before the ring wraps and some after: the
    reference decodes each slot alone with a scalar position."""
    jcfg, tcfg = _f32_smoke()
    jcfg = dataclasses.replace(jcfg, attention="swa", window=12)
    tcfg = dataclasses.replace(tcfg, attention="swa", window=12)
    j_layer, t_layer = _layer0_attn(jcfg, tcfg)
    cache = t_attn.init_attn_cache(tcfg, 4, 40, torch.float32, "cpu")
    b, s, kv, hd = 4, cache["k"].shape[1], jcfg.n_kv_heads, jcfg.head_dim_
    assert s == 12  # min(max_len, window)
    cache_np = RNG.standard_normal((2, b, s, kv, hd)).astype(np.float32)
    pos = np.array([3, 11, 12, 30])
    jx, tx = _pair(RNG.standard_normal((b, jcfg.d_model)))
    t_cache = {"k": torch.from_numpy(cache_np.copy()),
               "v": torch.from_numpy(-cache_np)}
    out = t_attn.attn_decode(t_layer, tx, t_cache, torch.from_numpy(pos),
                             tcfg, layer_idx=0)
    for i in range(b):
        j_cache = {"k": jnp.asarray(cache_np[:, i:i + 1]),
                   "v": jnp.asarray(-cache_np[:, i:i + 1])}
        y, new = j_attn.attn_decode(j_layer, jx[i:i + 1], j_cache,
                                    jnp.asarray(pos[i]), jcfg,
                                    layer_idx=jnp.asarray(0))
        _close(out[i:i + 1], y, 1e-5)
        _close(t_cache["k"][:, i], np.asarray(new["k"])[:, 0], 1e-6)
        _close(t_cache["v"][:, i], np.asarray(new["v"])[:, 0], 1e-6)


@pytest.mark.parametrize("window", [None, 16])
def test_attn_forward_window(window):
    jcfg, tcfg = _f32_smoke()
    if window:
        jcfg = dataclasses.replace(jcfg, attention="swa", window=window)
        tcfg = dataclasses.replace(tcfg, attention="swa", window=window)
    j_layer, t_layer = _layer0_attn(jcfg, tcfg)
    jx, tx = _pair(RNG.standard_normal((2, 64, jcfg.d_model)))
    out = t_attn.attn_forward(t_layer, tx, tcfg, torch.arange(64), chunk=16)
    _close(out, j_attn.attn_forward(j_layer, jx, jcfg, jnp.arange(64),
                                    chunk=16), 1e-5)


@pytest.mark.parametrize("attention", ["none", "mla"])
def test_later_mixers_raise(attention):
    cfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                              attention=attention)
    x = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(NotImplementedError):
        t_attn.attn_forward({}, x, cfg, torch.arange(8))
