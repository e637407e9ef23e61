"""The port's MLA (`repro_torch.models.attention`: `mla_forward`,
`mla_decode`, `_mla_decode_core`) against the JAX package's, at
deepseek-v2 smoke in f32 (4 heads, q_lora 32, kv_lora 32, nope 16, rope 8,
v 16), with the reference's own weights.

The reference's absorbed decode reads `wkv_b` in another layout than its
prefill decompresses with (W_uk as the first H * nope columns, where
prefill takes each head's nope columns then its v columns), so its decode
does not continue its prefill.  The port's decode reads prefill's layout.
So each decode comparison hands the reference `wkv_b` with its columns
permuted into the reference's decode layout (`decode_layout`): on those
weights the reference's decode computes the port's numbers.

Tolerances: 1e-5 of the largest output, the same f32 arithmetic summed in
another order (products in another association where decode absorbs
W_uk and W_uv).
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
from repro.models import transformer as jt
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as t_attn
from repro_torch.models import convert
from repro_torch.models import transformer as tt

ARCH = "deepseek-v2-236b"
RNG = np.random.default_rng(0)


def _configs(**kw):
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(j_smoke(j_get_config(ARCH)), **kw),
            dataclasses.replace(smoke_config(get_config(ARCH)), **kw))


def decode_layout(w_b, cfg):
    """`wkv_b` (..., r, H * (nope + v)), each head's nope columns then its
    v columns, with its columns in the reference decode's layout: every
    head's nope columns, then every head's v columns."""
    h, nope = cfg.n_heads, cfg.qk_nope_head_dim
    w = np.asarray(w_b)
    per_head = w.reshape(w.shape[:-1] + (h, -1))
    return np.concatenate(
        [per_head[..., :nope].reshape(w.shape[:-1] + (-1,)),
         per_head[..., nope:].reshape(w.shape[:-1] + (-1,))], axis=-1)


def _layer(jcfg, seed=0):
    p = jax.tree.map(np.asarray, j_attn.init_mla(jax.random.PRNGKey(seed),
                                                 jcfg, jnp.float32))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _close(port, expect, rel=1e-5):
    expect = np.asarray(expect, np.float32)
    np.testing.assert_allclose(port.detach().float().numpy(), expect, rtol=0,
                               atol=rel * np.abs(expect).max())


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_forward_matches_reference(q_lora):
    jcfg, tcfg = _configs(**({} if q_lora else {"q_lora_rank": 0}))
    jp, tp = _layer(jcfg)
    assert ("wq_a" in jp) == q_lora and ("wq" in jp) != q_lora
    x = RNG.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    out = t_attn.mla_forward(tp, torch.from_numpy(x), tcfg,
                             torch.arange(32), chunk=16)
    _close(out, j_attn.mla_forward(jax.tree.map(jnp.asarray, jp),
                                   jnp.asarray(x), jcfg, jnp.arange(32),
                                   chunk=16))


def test_mla_decode_per_slot_matches_reference():
    """Layer-stacked caches (2 layers, 3 slots, 16 positions), each slot at
    its own position, against the reference's decode of each slot alone
    (what its per-slot serve step vmaps)."""
    jcfg, tcfg = _configs()
    jp, tp = _layer(jcfg)
    jp_dec = dict(jp, wkv_b=decode_layout(jp["wkv_b"], jcfg))
    n_layers, b, s = 2, 3, 16
    cache = {"kv_c": RNG.standard_normal(
                 (n_layers, b, s, jcfg.kv_lora_rank)).astype(np.float32),
             "k_rope": RNG.standard_normal(
                 (n_layers, b, s, jcfg.qk_rope_head_dim)).astype(np.float32)}
    x = RNG.standard_normal((b, jcfg.d_model)).astype(np.float32)
    pos = np.array([0, 5, 15])
    t_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    y = t_attn.mla_decode(tp, torch.from_numpy(x), t_cache,
                          torch.from_numpy(pos), tcfg, layer_idx=1)
    for slot in range(b):
        j_y, j_cache = j_attn.mla_decode(
            jax.tree.map(jnp.asarray, jp_dec), jnp.asarray(x[slot:slot + 1]),
            {k: jnp.asarray(v[:, slot:slot + 1]) for k, v in cache.items()},
            jnp.asarray(pos[slot]), jcfg, layer_idx=jnp.asarray(1))
        _close(y[slot:slot + 1], j_y)
        for k in cache:
            _close(t_cache[k][:, slot], np.asarray(j_cache[k])[:, 0])


def test_absorbed_decode_continues_prefill():
    """Positions 0..S-1 fed one at a time through the absorbed decode give
    `mla_forward`'s outputs, in the port and, on `wkv_b` in its decode
    layout, in the reference; on the unpermuted weights the reference's
    decode does not."""
    jcfg, tcfg = _configs()
    jp, tp = _layer(jcfg)
    b, s = 2, 16
    x = RNG.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    j_full = j_attn.mla_forward(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(x), jcfg, jnp.arange(s),
                                chunk=16)
    t_full = t_attn.mla_forward(tp, torch.from_numpy(x), tcfg,
                                torch.arange(s), chunk=16)
    _close(t_full, j_full)
    t_cache = {k: v[None] for k, v in t_attn.init_mla_cache(
        tcfg, b, s, torch.float32, "cpu").items()}
    ref = {}
    for name, w_b in (("decode_layout", decode_layout(jp["wkv_b"], jcfg)),
                      ("prefill_layout", jp["wkv_b"])):
        j_params = jax.tree.map(jnp.asarray, dict(jp, wkv_b=w_b))
        j_cache = j_attn.init_mla_cache(jcfg, b, s, jnp.float32)
        ref[name] = []
        for t in range(s):
            y, j_cache = j_attn.mla_decode(j_params, jnp.asarray(x[:, t]),
                                           j_cache, jnp.asarray(t), jcfg)
            ref[name].append(np.asarray(y))
    for t in range(s):
        y = t_attn.mla_decode(tp, torch.from_numpy(x[:, t]), t_cache,
                              torch.full((b,), t), tcfg, layer_idx=0)
        _close(y, t_full[:, t].numpy())
        _close(torch.from_numpy(np.array(ref["decode_layout"][t])),
               j_full[:, t])
    scale = np.abs(np.asarray(j_full)).max()
    off = max(np.abs(ref["prefill_layout"][t] - np.asarray(j_full[:, t]))
              .max() for t in range(s))
    assert off > 1e-3 * scale, off


def test_prefill_then_decode_equals_forward():
    """The whole deepseek-v2 smoke model (an MLA + MLP layer, an MLA + MoE
    layer), per-slot decode against `forward`.  Capacity factor 4: no
    assignment can drop in `forward`'s routing of all 32 tokens, and decode
    routes each slot alone, where none drops (the two routings differ only
    in drops)."""
    _, tcfg = _configs(capacity_factor=4.0)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(RNG.integers(0, 256, (2, 16)))
    full, _ = tt.forward(tp, tcfg, tokens=tokens, chunk=16)
    state = tt.init_decode_state(tcfg, 2, 16, "cpu")
    for t in range(16):
        logits, state = tt.decode_step(tp, state, tcfg, tokens[:, t],
                                       torch.full((2,), t))
        _close(logits, full[:, t].numpy(), 1e-4)


def test_decode_state_converts_with_its_dtypes():
    for dtype in ("bfloat16", "float32"):
        jcfg, tcfg = _configs(dtype=dtype)
        j_state = jt.init_decode_state(jcfg, 2, 8)
        t_state = convert.decode_state_from_numpy(
            jax.tree.map(np.asarray, j_state), "cpu")
        own = tt.init_decode_state(tcfg, 2, 8, "cpu")
        for j_group, t_group, o_group in zip(j_state["groups"],
                                             t_state["groups"],
                                             own["groups"]):
            assert sorted(t_group["kv"]) == sorted(o_group["kv"]) == \
                ["k_rope", "kv_c"]
            for name in ("kv_c", "k_rope"):
                assert t_group["kv"][name].dtype == \
                    o_group["kv"][name].dtype == getattr(torch, dtype)
                assert tuple(t_group["kv"][name].shape) == \
                    tuple(o_group["kv"][name].shape) == \
                    tuple(j_group["kv"][name].shape)
