"""The port's MoE (`repro_torch.models.moe`) against the JAX package's
`repro.models.moe`, in f32, at phi3.5-moe and deepseek-v2 smoke (4 experts,
top-2, d_model 64, expert width 64; deepseek-v2 with one shared expert),
and with GELU experts.

The reference's routing decisions are read out of its own `moe_forward`:
its jaxpr is evaluated equation by equation and the outputs of `top_k`
(expert ids), `argsort` (the sort), the rank test (keep) and the buffer
row (dest) are kept (`_reference`).

* Exact inputs: one-hot tokens and a router of 0 and -128 entries, so the
  router logits are exact, every probability is 0, 1/4, 1/2 or 1 in both
  packages (exp(0) = 1, exp(-128) underflows to 0), and the tie order
  decides.  Expert ids, the sort, keep, dest and the aux
  loss must be identical, and drops at capacity must happen.  Outputs are
  held at 1e-6 of the largest: the experts' SiLU, GELU and the gates'
  division are the two frameworks' own transcendental code.
* Random inputs: identical decisions, outputs at 1e-5 of the largest (the
  same f32 arithmetic in another order), the smallest top-k margin
  printed.

The capture tests hold the port's front-end to the reference's: the MoE's
scatter-adds are MEMORY_STORE in both (`jaxpr_frontend.py:47`), and the
captured MoE losses diagnose on `nvidia_h100_sxm`.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.core import jaxpr_frontend
from repro.models import moe as j_moe
from repro.models import transformer as jt
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import OpClass, analyze_module, capture
from repro_torch.models import convert
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tt

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"]
# (arch, mlp_kind): both SwiGLU configs, and GELU experts on phi3.5-moe's
# shapes (no config of the table has GELU experts; the code path exists)
CASES = [(MOE_ARCHS[0], "swiglu"), (MOE_ARCHS[1], "swiglu"),
         (MOE_ARCHS[0], "gelu")]


def _configs(arch, mlp_kind="swiglu", **kw):
    jcfg = dataclasses.replace(j_smoke(j_get_config(arch)), dtype="float32",
                               mlp_kind=mlp_kind, **kw)
    tcfg = dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="float32", mlp_kind=mlp_kind, **kw)
    return jcfg, tcfg


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _record(closed, *args):
    """Evaluate a closed jaxpr's top-level equations in order; returns
    [(primitive[:name], outputs)] and the jaxpr's outputs."""
    env = {}

    def read(v):
        return v.val if isinstance(v, jcore.Literal) else env[v]

    for v, a in zip(closed.jaxpr.constvars, closed.consts):
        env[v] = a
    for v, a in zip(closed.jaxpr.invars, args):
        env[v] = a
    rec = []
    for eqn in closed.jaxpr.eqns:
        subfuns, params = eqn.primitive.get_bind_params(eqn.params)
        out = eqn.primitive.bind(*subfuns, *map(read, eqn.invars), **params)
        outs = out if eqn.primitive.multiple_results else [out]
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
        rec.append((f"{eqn.primitive.name}:{eqn.params.get('name', '')}",
                    outs))
    return rec, [read(v) for v in closed.jaxpr.outvars]


def _reference(jp, x, jcfg):
    """The reference's `moe_forward(jp, x)`: y, aux and its decisions."""
    closed = jax.make_jaxpr(lambda p, v: j_moe.moe_forward(p, v, jcfg))(
        jp, x)
    rec, (y, aux) = _record(closed, *jax.tree.leaves((jp, x)))
    names = [n for n, _ in rec]
    at = names.index("jit:searchsorted")
    # rank = iota - first; keep = rank < cap; dest = se * cap + min(rank,
    # cap - 1): `moe.py:75-78`
    assert names[at + 1:at + 7] == ["iota:", "sub:", "lt:", "mul:", "min:",
                                    "add:"], names[at:at + 7]
    return {"y": np.asarray(y), "aux": np.asarray(aux),
            "expert_ids": np.asarray(rec[names.index("top_k:")][1][1]),
            "order": np.asarray(rec[names.index("jit:argsort")][1][0]),
            "keep": np.asarray(rec[at + 3][1][0]),
            "dest": np.asarray(rec[at + 6][1][0])}


def _port(tp, x, tcfg):
    b, s, d = x.shape
    xt = torch.from_numpy(np.asarray(x))
    r = t_moe.route(tp, xt.reshape(1, b * s, d), tcfg)
    ds = t_moe.dispatch(r.expert_ids, t_moe._capacity(tcfg, b * s))
    y, aux = t_moe.moe_forward(tp, xt, tcfg)
    return {"y": y.numpy(), "aux": aux.numpy(),
            "expert_ids": r.expert_ids[0].numpy(),
            "order": ds.order[0].numpy(), "keep": ds.keep[0].numpy(),
            "dest": ds.dest[0].numpy(), "margin": r.margin[0].numpy()}


# router rows of the exact cases: logits 0 or -128 over 4 experts; every probability is 0, 1/4, 1/2 or 1, so the aux loss's
# means are exact too
PATTERNS = np.array([[0, 0, -128, -128],      # a tie of two: {0, 1}
                     [0, -128, 0, -128],      # {0, 2}
                     [-128, 0, -128, 0],      # {1, 3}
                     [0, -128, -128, -128],   # one, then three tied at 0:
                                              # the lowest, 1, with gate 0
                     [0, 0, 0, 0],            # all tied: {0, 1}
                     [-128, -128, 0, 0]],     # {2, 3}
                    np.float32)


def _exact_inputs(jcfg, seed, b=4, s=16):
    """One-hot tokens (pattern j in coordinate j) and a router whose row j
    is PATTERNS[j]; most tokens pick experts 0 and 1, so those overflow
    their capacity.  Expert weights are multiples of 1/16."""
    rng = np.random.default_rng(seed)
    d, e = jcfg.d_model, jcfg.n_experts
    p = jax.tree.map(np.asarray, j_moe.init_moe(jax.random.PRNGKey(seed),
                                                jcfg, jnp.float32))
    p = jax.tree.map(
        lambda a: (rng.integers(-4, 5, size=a.shape) / 16).astype(
            np.float32), p)
    router = np.full((d, e), -128.0, np.float32)
    router[:len(PATTERNS)] = PATTERNS
    p["router"] = router
    which = rng.choice(len(PATTERNS), size=b * s,
                       p=[0.3, 0.2, 0.1, 0.15, 0.15, 0.1])
    x = np.zeros((b * s, d), np.float32)
    x[np.arange(b * s), which] = 1.0
    return p, x.reshape(b, s, d)


@pytest.mark.parametrize("arch,mlp_kind", CASES)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_exact_inputs_identical_decisions(arch, mlp_kind, capacity_factor):
    jcfg, tcfg = _configs(arch, mlp_kind, capacity_factor=capacity_factor)
    p, x = _exact_inputs(jcfg, seed=3)
    ref = _reference(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    port = _port(_to_torch(p), x, tcfg)
    for key in ("expert_ids", "order", "keep", "dest"):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    assert port["aux"] == ref["aux"]
    assert not ref["keep"].all(), "no assignment was dropped at capacity"
    scale = np.abs(ref["y"]).max()
    np.testing.assert_allclose(port["y"], ref["y"], rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("arch,mlp_kind", CASES)
def test_random_inputs_same_decisions(arch, mlp_kind):
    jcfg, tcfg = _configs(arch, mlp_kind)
    p = j_moe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.default_rng(2).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    ref = _reference(p, jnp.asarray(x), jcfg)
    port = _port(_to_torch(jax.tree.map(np.asarray, p)), x, tcfg)
    print(f"{arch} {mlp_kind}: smallest top-{tcfg.top_k} margin "
          f"{port['margin'].min():.3e}")
    for key in ("expert_ids", "order", "keep", "dest"):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    np.testing.assert_allclose(port["aux"], ref["aux"], rtol=1e-6)
    scale = np.abs(ref["y"]).max()
    np.testing.assert_allclose(port["y"], ref["y"], rtol=0,
                               atol=1e-5 * scale)


def test_ties_go_to_the_lower_index():
    """`route` against `jax.lax.top_k` on rows full of ties."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, size=(64, 8)).astype(np.float32) / 4
    vals, ids = jax.lax.top_k(jnp.asarray(probs), 3)
    ranked, ranked_ids = torch.sort(torch.from_numpy(probs), dim=-1,
                                    descending=True, stable=True)
    np.testing.assert_array_equal(ranked_ids[:, :3].numpy(), np.asarray(ids))
    np.testing.assert_array_equal(ranked[:, :3].numpy(), np.asarray(vals))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_forced_routing_reads_gates_at_the_given_ids():
    """`chip_smoke.py::forced_route`, which holds phase 18's two paths to
    the same experts: the gates are read from the routing's own
    probabilities at the forced ids, as `route` reads them at its own."""
    forced_route = _chip_smoke().forced_route
    _, tcfg = _configs(MOE_ARCHS[0])
    jcfg, _ = _configs(MOE_ARCHS[0])
    p = _to_torch(jax.tree.map(np.asarray, j_moe.init_moe(
        jax.random.PRNGKey(1), jcfg, jnp.float32)))
    x = torch.randn((1, 32, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    own = t_moe.route(p, x, tcfg)
    again = forced_route(own, own.expert_ids)
    assert torch.equal(again.gates, own.gates)
    flipped = own.expert_ids.flip(-1)
    forced = forced_route(own, flipped)
    assert torch.equal(forced.expert_ids, flipped)
    torch.testing.assert_close(forced.gates, own.gates.flip(-1))


def test_only_moe_layers_give_an_aux_loss(monkeypatch):
    """A layer whose FFN is not a MoE returns no aux loss (no tensor is made
    for it), and `forward`'s aux is the sum of its MoE layers' own, in
    layer order: deepseek-v2 smoke, one dense layer then one MoE layer."""
    _, tcfg = _configs(MOE_ARCHS[1])
    params = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    real_moe, real_block = t_moe.moe_forward, tt._block
    auxes, blocks = [], []

    def moe(*args):
        y, aux = real_moe(*args)
        auxes.append(aux)
        return y, aux

    def block(p, x, mixer, ffn, *rest):
        out = real_block(p, x, mixer, ffn, *rest)
        blocks.append((ffn, out[1]))
        return out

    monkeypatch.setattr(t_moe, "moe_forward", moe)
    monkeypatch.setattr(tt, "_block", block)
    tokens = torch.randint(0, tcfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, aux = tt.forward(params, tcfg, tokens, remat="none")
    assert [ffn for ffn, _ in blocks] == ["mlp", "moe"]
    assert blocks[0][1] is None and blocks[1][1] is auxes[0]
    assert len(auxes) == 1 and aux.dtype == torch.float32
    assert torch.equal(aux, torch.zeros(()) + auxes[0]) and aux.item() > 0


# -- the capture ---------------------------------------------------------------

def _scatter_adds(module, names):
    """The instructions of `module` named in `names`: by opcode in the
    reference, by aten name in the port, whose capture records every
    scatter with the reference's opcode `scatter`."""
    return [i for comp in module.computations.values()
            for i in comp.instructions
            if i.attributes.get("aten", i.opcode) in names]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capture_classes_scatter_adds_as_the_reference(arch):
    """The same MoE smoke loss through both front-ends: every scatter-add
    is MEMORY_STORE in each, the reference's three a MoE scan body (the
    aux counts, the dispatch, the combine) and the port's two a MoE layer
    (the aux counts, the dispatch: its combine sums in a fixed order, no
    scatter)."""
    jcfg, tcfg = _configs(arch)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   "cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (2, 32))
    batch = {"tokens": tokens, "labels": tokens}
    ref = jaxpr_frontend.from_function(
        lambda p, b: jt.loss_fn(p, jcfg, b, chunk=16), jp,
        {k: jnp.asarray(v) for k, v in batch.items()}, name="loss")
    port = capture(lambda p, b: tt.loss_fn(p, tcfg, b, chunk=16), tp,
                   {k: torch.from_numpy(v) for k, v in batch.items()},
                   device="cuda", name="loss")
    moe_layers = sum(ffn == "moe" for _, ffn in tt.layer_descriptors(tcfg))
    # the reference scans each group's body once (one body for its MoE
    # layers); the port unrolls its layers
    moe_groups = sum(ffn == "moe" for (_, ffn), _ in tt.layer_groups(tcfg))
    ref_adds = _scatter_adds(ref, ("scatter-add", "scatter_add"))
    port_adds = _scatter_adds(port, ("index_add", "scatter_add"))
    assert {i.op_class.value for i in ref_adds} == \
        {i.op_class.value for i in port_adds} == {OpClass.MEMORY_STORE.value}
    assert len(ref_adds) == 3 * moe_groups
    assert len(port_adds) == 2 * moe_layers


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_captured_moe_loss_diagnoses_on_h100(arch):
    _, tcfg = _configs(arch)
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    params = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.long),
             "labels": torch.zeros((2, 64), dtype=torch.long)}
    module = capture(lambda p, b: tt.loss_fn(p, tcfg, b, chunk=32), params,
                     batch, device="cuda", name="loss")
    an = analyze_module(module, "nvidia_h100_sxm")
    assert module.kernel_calls["rmsnorm_pipelined"] == \
        2 * tcfg.n_layers + 1 + 2 * (tcfg.attention == "mla") * \
        tcfg.n_layers
    stores = [i for i in _scatter_adds(module, ("index_add",))
              if i.op_class is OpClass.MEMORY_STORE]
    assert len(stores) == 2 * sum(
        ffn == "moe" for _, ffn in tt.layer_descriptors(tcfg))
    assert an.estimated_step_seconds > 0
    assert an.chains or an.blame.occupancy_blame, \
        "LEO must produce a diagnosis"


def _moe_train_inputs():
    from repro_torch.runtime import TrainOptions
    tcfg = smoke_config(get_config(MOE_ARCHS[0]))
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    params = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, tcfg.vocab_size, (2, 32), generator=gen)
             for k in ("tokens", "labels")}
    return tcfg, params, batch, TrainOptions(chunk=32)


def test_phase22_routing_records():
    """`chip_smoke.py` phase 22's routing records on phi3.5-moe smoke in
    f32: one train-step gradient records each MoE layer's routing twice
    (the forward, then the checkpoint's recomputation), 0 tokens apart;
    against itself a path has no flip and leaves nothing out; a router
    input moved by a small amount flips only tokens whose margin its shift
    explains, and takes that layer's router and the flipped experts out of
    the gate (`leaf_gap` then skips those slices)."""
    cs = _chip_smoke()
    tcfg, params, batch, options = _moe_train_inputs()
    slices = cs.moe_layer_slices(tcfg, tt.layer_groups)
    assert slices == [(0, 0), (0, 1)]
    with cs.recorded_routes(t_moe) as calls:
        _, grads = cs.loss_grads(torch, tt.loss_fn, tcfg, params, batch,
                                 options)
    assert cs.recompute_routing(calls) == [{"calls": 2, "differ": 0}] * 2
    rows, drops = cs.routing_flips(torch, tcfg, calls, calls, slices)
    assert [r["flips"] for r in rows] == [0, 0] and drops == {}

    moved = [dict(c) for c in calls]
    first = next(c for c in moved if "xf" in c)
    gen = torch.Generator().manual_seed(2)
    first["xf"] = first["xf"] + 0.05 * torch.randn(first["xf"].shape,
                                                   generator=gen)
    routed = t_moe.route({"router": first["router"]}, first["xf"], tcfg)
    first["expert_ids"] = routed.expert_ids
    rows, drops = cs.routing_flips(torch, tcfg, moved, calls, slices)
    assert rows[0]["flips"] > 0 and rows[0]["unexplained"] == 0
    assert rows[1]["flips"] == 0
    assert drops["groups/0/ffn/router"] == {(0,)}
    assert drops["groups/0/ffn/w_up"] == {(0, e) for e in rows[0]["experts"]}
    up = grads["groups/0/ffn/w_up"]
    other = up.clone()
    for _, e in drops["groups/0/ffn/w_up"]:
        other[0, e] += 1.0
    assert cs.leaf_gap(torch, other, up, drops["groups/0/ffn/w_up"]) == 0
    assert cs.leaf_gap(torch, other, up) > 0
    assert cs.leaf_gap(torch, None, up) == pytest.approx(1.0)


def test_phase22_profile_split_reaches_each_moe_part():
    """`chip_smoke.py::moe_step_split` on a CPU profile of one train step
    of phi3.5-moe smoke under `annotated_moe` (each op's own CPU time
    standing in for its kernels): routing, dispatch and combine each
    receive time, the dispatch also through its gather's backward, and
    the parts sum to the whole."""
    from torch.profiler import ProfilerActivity, profile
    from types import SimpleNamespace
    from repro_torch.runtime import init_train_state, make_train_step
    cs = _chip_smoke()
    tcfg, _, batch, options = _moe_train_inputs()
    state = init_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(tcfg, options=options)
    with cs.annotated_moe(torch, t_moe), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    assert t_moe.route.__name__ == "route"  # restored

    def own(e):
        return [SimpleNamespace(name=e.name, duration=e.self_cpu_time_total)
                ] if not e.cpu_children else []
    events = prof.events()
    split = cs.moe_step_split(events, own)
    assert all(split[part] > 0 for part in ("routing", "dispatch",
                                            "combine", "other"))
    whole = sum(k.duration for e in events for k in own(e)) / 1e3
    assert sum(split.values()) == pytest.approx(whole)

    def under_gather_backward(e):
        while e is not None:
            if "_GatherTokensBackward" in e.name:
                return True
            e = e.cpu_parent
        return False
    gather = sum(k.duration for e in events if under_gather_backward(e)
                 for k in own(e))
    assert gather > 0 and split["dispatch"] * 1e3 >= gather
