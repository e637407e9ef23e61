"""Every configuration of the table in the port against the JAX package,
at its smoke size (2 layers, or one block unit; d_model 64) in f32, with
the reference's own weights carried across by `convert.params_from_numpy`:
`forward` over tokens or front-end embeddings, `loss_fn` with the MoE aux
loss, `make_prefill_step` (embeddings in bf16, as the reference's input
specs give them), and `decode_step` in both of its forms, each against its
reference counterpart.  Then the layouts, the two MoE decode forms at 16
slots, and `ServeEngine` for the configurations this slice brought.

Tolerances, each relative to the largest reference value: logits and loss
1e-5 (the same f32 arithmetic summed in another order; the two packages'
smoke logits have measured at most 2.7e-7 apart in absolute terms, on
logits up to 60 where embeddings are tied), decode logits and states 1e-4
(the absorbed MLA decode and per-token products sum in other orders still).

deepseek-v2's decode in the reference reads MLA's `wkv_b` in another
column layout than its prefill (`tests/test_torch_mla.py`): its decode
runs on the weights with those columns permuted (`_reference_decode_
params`), on which it computes the port's numbers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import smoke_config as j_smoke
from repro.models import transformer as jt
from repro.runtime.steps import make_prefill_step as j_prefill_step
from repro.runtime.steps import make_serve_step as j_serve_step
from repro_torch.configs import ALL_ARCHS, get_config, smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import convert, moe
from repro_torch.models import transformer as tt
from repro_torch.runtime import make_prefill_step, make_serve_step
from test_torch_mla import decode_layout

ARCHS = [c.name for c in ALL_ARCHS]
NEW_ARCHS = ["deepseek-v2-236b", "phi3.5-moe-42b-a6.6b", "musicgen-medium",
             "internvl2-2b"]
B, S = 2, 32


def _configs(arch, **kw):
    kw = {"dtype": "float32", **kw}
    jcfg = next(c for c in J_ALL_ARCHS if c.name == arch)
    return (dataclasses.replace(j_smoke(jcfg), **kw),
            dataclasses.replace(smoke_config(get_config(arch)), **kw))


def _params(jcfg, tcfg):
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         "cpu")


def _reference_decode_params(jp, jcfg):
    """The reference's weights with each MLA group's `wkv_b` in its decode
    layout."""
    if jcfg.attention != "mla":
        return jp
    groups = [dict(g, attn=dict(g["attn"], wkv_b=jnp.asarray(decode_layout(
        g["attn"]["wkv_b"], jcfg)))) for g in jp["groups"]]
    return dict(jp, groups=groups)


def _batch(cfg, seed=1, embeds_dtype=np.float32):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.frontend != "none":
        # as `tests/test_archs_smoke.py` makes them
        batch["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.02
                           ).astype(embeds_dtype)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    return batch


def _close(port, expect, rel):
    expect = np.asarray(expect, np.float32)
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float32)
    np.testing.assert_allclose(port, expect, rtol=0,
                               atol=rel * max(np.abs(expect).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(jcfg)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    j_logits, j_aux = jt.forward(jp, jcfg, tokens=j_batch.get("tokens"),
                                 embeds=j_batch.get("embeds"), chunk=16)
    t_logits, t_aux = tt.forward(tp, tcfg, tokens=t_batch.get("tokens"),
                                 embeds=t_batch.get("embeds"), chunk=16)
    _close(t_logits, j_logits, 1e-5)
    if tcfg.n_experts:
        assert float(t_aux) > 0
        np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)
    else:
        assert float(t_aux) == float(j_aux) == 0.0
    _close(tt.loss_fn(tp, tcfg, t_batch, chunk=16),
           jt.loss_fn(jp, jcfg, j_batch, chunk=16), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(jcfg, seed=2)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "embeds" in batch:  # bf16, as `launch/specs.py` gives them
        j_batch["embeds"] = j_batch["embeds"].astype(jnp.bfloat16)
        t_batch["embeds"] = t_batch["embeds"].to(torch.bfloat16)
    expect = j_prefill_step(jcfg, chunk=16)(jp, j_batch)
    got = make_prefill_step(tcfg, chunk=16, device="cpu")(tp, t_batch)
    assert got.dtype == torch.float32 and got.shape == (B, S, jcfg.vocab_size)
    _close(got, expect, 1e-5)


def _filled(jp, jcfg, b, steps, max_len=16, seed=3):
    """A reference decode state after `steps` tokens of every slot."""
    state = jt.init_decode_state(jcfg, b, max_len)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                                (steps, b))
    for t in range(steps):
        _, state = jt.decode_step(jp, state, jcfg, jnp.asarray(toks[t]),
                                  jnp.asarray(t))
    return state


def _states_close(t_state, j_state, rel):
    for t_leaf, j_leaf in zip(tree_leaves(t_state), jax.tree.leaves(j_state)):
        assert tuple(t_leaf.shape) == tuple(j_leaf.shape)
        _close(t_leaf, j_leaf, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_both_forms_match_reference(arch):
    """A scalar position: the reference's `decode_step` (MoE routes the
    batch together).  A position a slot: its per-slot serve step (each
    slot decodes, and routes, alone)."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, tcfg)
    jp_dec = _reference_decode_params(jp, jcfg)
    j_state = _filled(jp_dec, jcfg, b=3, steps=6)
    token = np.random.default_rng(4).integers(0, jcfg.vocab_size, 3)

    t_state = convert.decode_state_from_numpy(
        jax.tree.map(np.asarray, j_state), "cpu")
    j_logits, j_new = jt.decode_step(jp_dec, j_state, jcfg,
                                     jnp.asarray(token), jnp.asarray(6))
    t_logits, t_new = tt.decode_step(tp, t_state, tcfg,
                                     torch.from_numpy(token), 6)
    _close(t_logits, j_logits, 1e-4)
    _states_close(t_new, j_new, 1e-4)

    pos = np.array([6, 2, 0])
    t_state = convert.decode_state_from_numpy(
        jax.tree.map(np.asarray, j_state), "cpu")
    j_next, j_logits, j_new = j_serve_step(jcfg, per_slot_pos=True)(
        jp_dec, j_state, jnp.asarray(token, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    t_next, t_logits, t_new = make_serve_step(tcfg, per_slot_pos=True)(
        tp, t_state, torch.from_numpy(token), torch.from_numpy(pos))
    _close(t_logits, j_logits, 1e-4)
    assert t_next.tolist() == np.asarray(j_next).tolist()
    _states_close(t_new, j_new, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_conversion_match_reference(arch):
    """`init_params` gives the reference's tree leaf for leaf (shapes and
    dtypes, in the config's bf16: the MoE router and the SSM's and mLSTM's
    f32 leaves stay f32), the reference's own weights convert into that
    tree, and `weight_bytes` counts it."""
    jcfg, tcfg = _configs(arch, dtype="bfloat16")
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    converted = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                          tcfg, "cpu")
    j_flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(j_flat) == len(tree_leaves(tp)) == len(tree_leaves(converted))
    for path, leaf in j_flat:
        own, conv = tp, converted
        for key in path:
            k = getattr(key, "key", getattr(key, "idx", None))
            own, conv = own[k], conv[k]
        assert tuple(own.shape) == tuple(conv.shape) == tuple(leaf.shape), \
            path
        assert own.dtype == conv.dtype == {"bfloat16": torch.bfloat16,
                                           "float32": torch.float32}[
            str(leaf.dtype)], path
    assert tt.weight_bytes(tcfg) == sum(t.numel() * t.element_size()
                                        for t in tree_leaves(tp))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_two_moe_decode_forms_at_16_slots(monkeypatch, capacity_factor):
    """phi3.5-moe smoke, 16 slots: the scalar-position form routes the 16
    tokens together against a capacity of 16 tokens, the per-slot form each
    slot alone (capacity 8, one token).  At the config's capacity factor
    1.25 the 16 tokens' capacity is 16, and nothing can drop; at 0.5 it is
    8, and the batch form drops.  Each form equals its reference
    counterpart either way."""
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = _configs(arch, capacity_factor=capacity_factor)
    jp, tp = _params(jcfg, tcfg)
    j_state = _filled(jp, jcfg, b=16, steps=4)
    token = np.random.default_rng(5).integers(0, jcfg.vocab_size, 16)
    kept = []
    dispatch = moe.dispatch

    def recording(expert_ids, cap):
        out = dispatch(expert_ids, cap)
        kept.append(out.keep)
        return out

    monkeypatch.setattr(moe, "dispatch", recording)
    logits = {}
    for form, pos in (("batch", 4), ("slots", np.full(16, 4))):
        t_state = convert.decode_state_from_numpy(
            jax.tree.map(np.asarray, j_state), "cpu")
        kept.clear()
        if form == "batch":
            expect, _ = jt.decode_step(jp, j_state, jcfg, jnp.asarray(token),
                                       jnp.asarray(pos))
        else:
            _, expect, _ = j_serve_step(jcfg, per_slot_pos=True)(
                jp, j_state, jnp.asarray(token, jnp.int32),
                jnp.asarray(pos, jnp.int32))
        got, _ = tt.decode_step(tp, t_state, tcfg, torch.from_numpy(token),
                                pos if form == "batch" else
                                torch.from_numpy(pos))
        _close(got, expect, 1e-4)
        logits[form] = got
        assert [tuple(k.shape) for k in kept] == \
            [(1, 32)] * 2 if form == "batch" else [(16, 2)] * 2
        dropped = sum(int((~k).sum()) for k in kept)
        assert dropped == 0 if form == "slots" or capacity_factor > 1 \
            else dropped > 0, (form, dropped)
    # the two forms differ only where the batch form drops
    gap = (logits["batch"] - logits["slots"]).abs().max().item()
    limit = 1e-5 * logits["slots"].abs().max().item()
    assert (gap > limit) == (capacity_factor < 1), gap


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab,
                                          size=int(rng.integers(2, 9)))]
            for _ in range(n)]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_mid_stream_admission_equals_solo_run(arch):
    """`ServeEngine` on the CPU at smoke size in the config's bf16: a
    request admitted mid-stream into a freed slot gives its solo run's
    tokens."""
    cfg = smoke_config(get_config(arch))
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = t_serve.ServeEngine(cfg, params, batch_slots=3, max_len=64,
                                 device="cpu")
    reqs = [t_serve.Request(i, p, 4 + 4 * i)
            for i, p in enumerate(_prompts(3, cfg.vocab_size))]
    for r in reqs:
        engine.submit(r)
    while not any(r.done for r in reqs):
        engine.tick()
    late = t_serve.Request(99, _prompts(1, cfg.vocab_size, seed=7)[0], 6)
    engine.submit(late)
    engine.tick()
    assert next(s for s in engine.slots if s.request is late).pos == 1
    assert max(s.pos for s in engine.slots if s.request) > 1
    engine.run()
    solo = t_serve.Request(99, list(late.prompt), 6)
    alone = t_serve.ServeEngine(cfg, params, batch_slots=3, max_len=64,
                                device="cpu")
    alone.submit(solo)
    alone.run()
    assert late.done and solo.generated == late.generated


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_main_runs_the_new_configs(arch):
    out = t_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "3"])
    assert sorted(out) == [0, 1, 2] and all(len(t) == 3
                                            for t in out.values())


def test_weights_that_do_not_fit_are_refused():
    """The weights are counted on shapes, nothing allocated: deepseek-v2's
    (439.2 GiB of bf16 at 60 layers) are refused on an 80 GB card and fit
    cut to 4 layers; phi3.5-moe's 41.87 B parameters are 77.99 GiB."""
    card = 85_000_000_000  # about an H100's total_memory (79.2 GiB)
    full = get_config("deepseek-v2-236b")
    with pytest.raises(ValueError, match="bytes of weights"):
        t_serve.check_fits(full, card)
    assert t_serve.check_fits(dataclasses.replace(full, n_layers=4),
                              card) < card
    phi = get_config("phi3.5-moe-42b-a6.6b")
    assert abs(tt.weight_bytes(phi) / 2**30 - 77.99) < 0.01


def test_standalone_ssm_mixer_matches_reference():
    """The ("ssm", "mlp") block, which no configuration of the table uses:
    qwen2-0.5b smoke with every block an SSM mixer (N 8, expand 2),
    forward, loss and both decode forms against the reference."""
    kw = {"block_unit": ("ssm",), "ssm_state": 8, "ssm_expand": 2}
    jcfg, tcfg = _configs("qwen2-0.5b", **kw)
    assert {m for m, _ in tt.layer_descriptors(tcfg)} == {"ssm"}
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(jcfg)
    j_logits, _ = jt.forward(jp, jcfg, tokens=jnp.asarray(batch["tokens"]),
                             chunk=16)
    t_logits, _ = tt.forward(tp, tcfg, tokens=torch.from_numpy(
        batch["tokens"]), chunk=16)
    _close(t_logits, j_logits, 1e-5)
    j_state = _filled(jp, jcfg, b=3, steps=4)
    token = np.random.default_rng(6).integers(0, jcfg.vocab_size, 3)
    for pos in (4, np.array([4, 1, 0])):
        t_state = convert.decode_state_from_numpy(
            jax.tree.map(np.asarray, j_state), "cpu")
        if np.ndim(pos):
            _, expect, j_new = j_serve_step(jcfg, per_slot_pos=True)(
                jp, j_state, jnp.asarray(token, jnp.int32),
                jnp.asarray(pos, jnp.int32))
            got, t_new = tt.decode_step(tp, t_state, tcfg,
                                        torch.from_numpy(token),
                                        torch.from_numpy(pos))
        else:
            expect, j_new = jt.decode_step(jp, j_state, jcfg,
                                           jnp.asarray(token),
                                           jnp.asarray(pos))
            got, t_new = tt.decode_step(tp, t_state, tcfg,
                                        torch.from_numpy(token), pos)
        _close(got, expect, 1e-4)
        _states_close(t_new, j_new, 1e-4)
