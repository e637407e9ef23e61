"""Parity of the port's sliding-window and hybrid (attention + SSM) models
with the JAX package's, on hymba-1.5b smoke (d_model 64, 4 heads, 2 KV
heads, hd 16, vocab 256, 2 hybrid layers, window 64, ssm_state 8) and
h2o-danube-3-4b smoke (the same widths, dense SWA layers), weights made by
the reference and carried across with `params_from_numpy`.

Tolerances are those of `tests/test_torch_model.py`: f32 logits at 1e-4
(the same f32 arithmetic through two layers, summed in another order, and
the SSM scanned by doubling within each chunk here against the reference's
associative scan);
bf16 logits at 2e-2 of the largest logit (bf16 rounds the residual stream
at other places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import transformer as jt
from repro.runtime.steps import make_serve_step as j_serve_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.runtime import make_serve_step

ARCHS = ["hymba-1.5b", "h2o-danube-3-4b"]


def _configs(arch, dtype):
    jcfg = dataclasses.replace(j_smoke(j_get_config(arch)), dtype=dtype)
    tcfg = dataclasses.replace(smoke_config(get_config(arch)), dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    return params, np_params, convert.params_from_numpy(np_params, tcfg,
                                                        "cpu")


def _close(port, expect, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_f32(arch):
    """S 128 is twice the smoke window, so the band is exercised."""
    jcfg, tcfg = _configs(arch, "float32")
    jp, _, tp = _params(jcfg, tcfg)
    tokens = _tokens((2, 128))
    j_logits, _ = jt.forward(jp, jcfg, tokens=jnp.asarray(tokens), chunk=32)
    t_logits, aux = tt.forward(tp, tcfg, tokens=torch.from_numpy(tokens),
                               chunk=32)
    assert t_logits.dtype == torch.float32 and float(aux) == 0.0
    _close(t_logits, j_logits, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16(arch):
    jcfg, tcfg = _configs(arch, "bfloat16")
    jp, _, tp = _params(jcfg, tcfg)
    tokens = _tokens((2, 128))
    j_logits = np.asarray(jt.forward(jp, jcfg, tokens=jnp.asarray(tokens),
                                     chunk=32)[0])
    t_logits = tt.forward(tp, tcfg, tokens=torch.from_numpy(tokens),
                          chunk=32)[0].numpy()
    scale = np.abs(j_logits).max()
    assert np.abs(t_logits - j_logits).max() <= 2e-2 * scale
    assert (t_logits.argmax(-1) == j_logits.argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_past_the_window_per_slot(arch):
    """Token by token against the reference's per-slot serve step, three
    slots at different positions, well past the 64-entry ring (max_len 160,
    positions up to 129), comparing logits at every step and the state at
    the end."""
    jcfg, tcfg = _configs(arch, "float32")
    jp, _, tp = _params(jcfg, tcfg)
    b, steps, max_len = 3, 100, 160
    offsets = np.array([0, 7, 30])
    toks = _tokens((steps, b), seed=2)
    j_step = jax.jit(j_serve_step(jcfg, per_slot_pos=True))
    t_step = make_serve_step(tcfg, per_slot_pos=True)
    j_state = jt.init_decode_state(jcfg, b, max_len)
    t_state = tt.init_decode_state(tcfg, b, max_len, "cpu")
    assert t_state["groups"][0]["kv"]["k"].shape[2] == jcfg.window
    for t in range(steps):
        pos = t + offsets
        j_next, j_logits, j_state = j_step(
            jp, j_state, jnp.asarray(toks[t], jnp.int32),
            jnp.asarray(pos, jnp.int32))
        t_next, t_logits, t_state = t_step(
            tp, t_state, torch.from_numpy(toks[t]), torch.from_numpy(pos))
        _close(t_logits, j_logits, 1e-4)
        assert t_next.tolist() == np.asarray(j_next).tolist()
    for j_group, t_group in zip(j_state["groups"], t_state["groups"]):
        assert sorted(t_group) == sorted(j_group)
        for kind in j_group:
            for name in j_group[kind]:
                assert t_group[kind][name].dtype == \
                    convert.decode_state_from_numpy(
                        np.asarray(j_group[kind][name]), "cpu").dtype
                _close(t_group[kind][name], j_group[kind][name], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward_past_the_window(arch):
    """Decode through the ring cache (and the SSM state) gives the prefill
    forward's logits at every position, 96 > the 64-entry ring."""
    _, tcfg = _configs(arch, "float32")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens((2, 96), seed=5))
    full, _ = tt.forward(tp, tcfg, tokens=tokens, chunk=32)
    state = tt.init_decode_state(tcfg, 2, 128, "cpu")
    for t in range(96):
        logits, state = tt.decode_step(tp, state, tcfg, tokens[:, t],
                                       torch.full((2,), t))
        _close(logits, full[:, t].numpy(), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    jcfg, tcfg = _configs(arch, "bfloat16")
    j_shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    j_flat = jax.tree_util.tree_flatten_with_path(j_shapes)[0]
    n_leaves = 0
    for path, leaf in j_flat:
        t = tp
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(t.shape) == tuple(leaf.shape), path
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), path
        n_leaves += 1
    assert n_leaves == sum(1 for _ in _leaves(tp))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_f32_ssm_leaves_survive_conversion():
    """A bf16 hymba tree keeps `a_log`, `w_dt` and `d_skip` in f32, bit for
    bit, as the reference keeps them; the config's leaves go to bf16."""
    jcfg, tcfg = _configs("hymba-1.5b", "bfloat16")
    _, np_params, tp = _params(jcfg, tcfg)
    j_ssm = np_params["groups"][0]["ssm"]
    t_ssm = tp["groups"][0]["ssm"]
    for name in ("a_log", "w_dt", "d_skip"):
        assert j_ssm[name].dtype == np.float32
        assert t_ssm[name].dtype == torch.float32, name
        assert np.array_equal(t_ssm[name].numpy(), j_ssm[name]), name
    assert t_ssm["w_in"].dtype == torch.bfloat16
    assert tp["groups"][0]["attn"]["wq"].dtype == torch.bfloat16


def _prompt(n, seed):
    return [int(t) for t in _tokens((n,), seed=seed)]


def test_reused_slot_leaks_no_ssm_state():
    """A request admitted into the slot a long request just freed yields
    exactly its solo run: the freed slot's SSM state is reset, not carried
    into the next request."""
    _, tcfg = _configs("hymba-1.5b", "float32")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    # At the init scales the recurrent term h.c is about 1e-3 of the skip
    # term, too small to move a greedy token; larger B/C projections make
    # the state carry the SSM's output, so a leaked state shows.
    for name in ("w_b", "w_c"):
        tp["groups"][0]["ssm"][name] *= 50.0

    def run(requests):
        engine = ServeEngine(tcfg, tp, batch_slots=1, max_len=96,
                             device="cpu")
        for r in requests:
            engine.submit(r)
        logits = []
        while engine.active:
            rid = engine.slots[0].request.rid if engine.slots[0].request \
                else engine.queue[0].rid
            engine.tick()
            logits.append((rid, engine.last_logits[0].clone()))
        return [lg for rid, lg in logits if rid == 1]

    long = Request(0, _prompt(6, seed=11), 40)
    late = Request(1, _prompt(1, seed=12), 8)
    after_long = run([long, late])
    solo = Request(1, list(late.prompt), 8)
    alone = run([solo])
    assert long.done and late.done and solo.done
    assert late.generated == solo.generated
    assert len(after_long) == len(alone)
    for got, expect in zip(after_long, alone):
        _close(got, expect.numpy(), 1e-6)


def test_serve_tokens_equal_reference_engine():
    jcfg, tcfg = _configs("hymba-1.5b", "float32")
    jp, _, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, size=int(n))]
               for n in rng.integers(2, 9, size=4)]
    new = [6, 3, 8, 5]
    j_reqs = [JRequest(i, list(p), n) for i, (p, n) in
              enumerate(zip(prompts, new))]
    t_reqs = [Request(i, list(p), n) for i, (p, n) in
              enumerate(zip(prompts, new))]
    j_engine = JServeEngine(jcfg, jp, batch_slots=2, max_len=32)
    t_engine = ServeEngine(tcfg, tp, batch_slots=2, max_len=32,
                           device="cpu")
    for jr, tr in zip(j_reqs, t_reqs):
        j_engine.submit(jr)
        t_engine.submit(tr)
    j_engine.run()
    t_engine.run()
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.done and len(tr.generated) == tr.max_new_tokens
        assert tr.generated == jr.generated, tr.rid
