"""The port's train step (`repro_torch.runtime.make_train_step`) against the
reference's, `jax.jit(make_train_step(...))` under no mesh (the reference's
`launch/train.py` fails on this tree, ROADMAP C-watch 1).

qwen2-0.5b smoke in f32 under four option sets, and the two MoE smoke
configs (phi3.5-moe, deepseek-v2 with its dense first layer) under the
default options and two micro-batches, their loss carrying the routers'
aux loss at the reference's weight 0.01 (in bf16 the two packages'
gradients differ by up to 1.7e-2 of a leaf's largest, too far for a
parity test), both packages starting from the reference's train state
carried across by `train_state_from_numpy`, 3 steps on the same numpy
batches with warmup 2, so `lr_scale` reads 0, 0.5 and 1 and the last two
steps move the params.
Tolerances:
* loss and `grad_norm` rel 1e-5, as `tests/test_torch_loss.py` holds the
  loss (the same f32 forward, sums in another order);
* `lr_scale` 1e-7 (f32 arithmetic on exact inputs);
* params, `mu`, `nu`, `master` and `grad_ef` after the 3 steps at 1e-4
  absolute.  The gradients agree to 7.4e-7 of each leaf's largest, but
  AdamW's `g / (|g| + eps)` magnifies a rounding difference where |g| is
  near eps: fed each package's f32 gradients, the reference's own
  `adamw_update` moves params apart by up to 3.46e-5 in 3 steps at lr
  3e-3.  These steps run at lr 1e-3 and read at most 1.7e-5 (with
  compression, where an int8 step can flip).  `tests/test_torch_optim.py`
  holds the optimizer itself at rel 1e-6 on shared gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import TrainOptions as JTrainOptions
from repro.runtime import init_train_state as j_init_train_state
from repro.runtime import make_train_step as j_make_train_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import layers, loss_fn, train_state_from_numpy
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import (
    TrainOptions,
    init_train_state,
    make_train_step,
)

ARCH = "qwen2-0.5b"
STEPS = 3
LR = 1e-3
OPTIONS = {"default": {}, "microbatch": {"microbatch": 2},
           "bf16_grads": {"grad_dtype": "bf16"},
           "compression": {"grad_compression": True}}
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"]
# (arch, option set): qwen2-0.5b's cases keep their option set's name
STEP_CASES = [pytest.param(ARCH, name, id=name) for name in sorted(OPTIONS)] \
    + [pytest.param(arch, name, id=f"{arch}-{name}") for arch in MOE_ARCHS
       for name in ("default", "microbatch")]


def _configs(dtype="float32", arch=ARCH):
    return (dataclasses.replace(j_smoke(j_get_config(arch)), dtype=dtype),
            dataclasses.replace(smoke_config(get_config(arch)), dtype=dtype))


def _batches(n, b=4, s=64, vocab=256, seed=1):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
            for _ in range(n)]


def _flat(tree, prefix=""):
    """{path: f64 numpy} of a nest of dicts and lists, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().float().numpy()
        yield prefix, np.asarray(tree, np.float64)


@pytest.mark.parametrize("arch,name", STEP_CASES)
def test_train_step_matches_reference(arch, name):
    """Measured largest gaps over the 3 steps (printed; `pytest -s`), loss
    / grad norm relative and the state absolute: qwen2-0.5b default 1.2e-7
    / 1.2e-7 / 2.2e-7; phi3.5-moe default 1.7e-7 / 6.0e-8 / 1.2e-7,
    microbatch 1.7e-7 / 1.2e-7 / 2.4e-7; deepseek-v2 default 2.6e-7 / 0 /
    1.2e-7, microbatch 8.6e-8 / 0 / 1.2e-7."""
    jcfg, tcfg = _configs(arch=arch)
    kw = dict(warmup_steps=2, total_steps=10, chunk=32, **OPTIONS[name])
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                    "cpu")
    jstep = jax.jit(j_make_train_step(jcfg, JAdamWConfig(lr=LR),
                                      JTrainOptions(**kw)))
    tstep = make_train_step(tcfg, AdamWConfig(lr=LR), TrainOptions(**kw))
    rel = {"loss": 0.0, "grad_norm": 0.0}
    for i, batch in enumerate(_batches(STEPS, vocab=tcfg.vocab_size)):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for k in rel:
            rel[k] = max(rel[k], abs(float(tm[k]) / float(jm[k]) - 1))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5), i
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5), i
        assert float(tm["lr_scale"]) == pytest.approx(
            float(jm["lr_scale"]), abs=1e-7), i
        assert tm["loss"].dtype == tm["grad_norm"].dtype == torch.float32
    assert float(jm["lr_scale"]) == 1.0  # the steps left warmup
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS
    assert tstate["step"].dtype == torch.int32
    assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"])
    keys = ["params", "opt"] + (["grad_ef"] if "grad_ef" in jstate else [])
    assert sorted(k for k in tstate if k != "step") == sorted(keys)
    want = dict(_flat(jax.tree.map(np.asarray, {k: jstate[k]
                                                for k in keys})))
    got = dict(_flat({k: tstate[k] for k in keys}))
    assert got.keys() == want.keys()
    print(f"{arch} {name}: loss {rel['loss']:.1e}, grad norm "
          f"{rel['grad_norm']:.1e} relative; state "
          f"{max(np.abs(got[p] - want[p]).max() for p in want):.1e}")
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-4, err_msg=path)


def test_train_state_mirrors_reference():
    """`init_train_state` gives the reference's tree: the same paths,
    shapes and dtypes (bf16 params, f32 `mu`, `nu`, `master`, int32
    `count` and `step`)."""
    jcfg, tcfg = _configs("bfloat16")
    jstate = jax.tree.map(np.asarray, j_init_train_state(
        jax.random.PRNGKey(0), jcfg))
    tstate = init_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")

    def spec(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from spec(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from spec(v, f"{prefix}/{i}")
        else:
            dtype = str(tree.dtype).replace("torch.", "")
            yield prefix, (tuple(tree.shape), dtype)
    assert dict(spec(tstate)) == dict(spec(jstate))
    carried = train_state_from_numpy(jstate, tcfg, "cpu")
    assert dict(spec(carried)) == dict(spec(jstate))


def _grads(tcfg, params, batch, remat):
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    tracked = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(spec.unflatten(tracked), tcfg, batch, chunk=32,
                   remat=remat)
    return loss, torch.autograd.grad(loss, tracked)


@pytest.mark.parametrize("remat", ["group", "full"])
def test_remat_gives_the_gradients_of_no_remat(remat, monkeypatch):
    """Each layer checkpointed: the same loss and gradients, bit for bit,
    as keeping every activation; the backward runs each layer's forward
    again, both of its norms included (2 x 2L + 1 norms, as the card's K2
    count reads under remat)."""
    jcfg, tcfg = _configs()
    params = train_state_from_numpy(jax.tree.map(np.asarray, (
        j_init_train_state(jax.random.PRNGKey(0), jcfg))), tcfg,
        "cpu")["params"]
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    calls = []
    real = layers.rmsnorm_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(layers, "rmsnorm_plain", counted)
    want_loss, want = _grads(tcfg, params, batch, "none")
    assert len(calls) == 2 * tcfg.n_layers + 1
    calls.clear()
    loss, got = _grads(tcfg, params, batch, remat)
    assert len(calls) == 2 * (2 * tcfg.n_layers) + 1
    assert torch.equal(loss, want_loss)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_remat_applies_only_where_autograd_records(monkeypatch):
    """Serving and prefill (no param requires grad) and `torch.no_grad`
    run each layer once whatever the policy."""
    _, tcfg = _configs()
    params = init_train_state(tcfg, torch.Generator().manual_seed(0),
                              "cpu")["params"]
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    calls = []
    real = layers.rmsnorm_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(layers, "rmsnorm_plain", counted)
    loss_fn(params, tcfg, batch, chunk=32, remat="full")
    tracked = {**params, "final_norm": params["final_norm"].clone(
    ).requires_grad_()}
    with torch.no_grad():
        loss_fn(tracked, tcfg, batch, chunk=32, remat="full")
    assert len(calls) == 2 * (2 * tcfg.n_layers + 1)


@pytest.mark.parametrize("remat", ["none", "group"])
def test_stacked_params_are_unbound_once_under_autograd(remat):
    """Under autograd each layer-stacked leaf reaches its layers through one
    `unbind` (its backward is one stack), not one index a layer (each
    index's backward fills a gradient of the whole stack, and the L of them
    are added)."""
    _, tcfg = _configs()
    params = init_train_state(tcfg, torch.Generator().manual_seed(0),
                              "cpu")["params"]
    tracked = jax.tree.map(lambda t: t.detach().requires_grad_(), params)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, b=1,
                                                         s=16)[0].items()}
    loss = loss_fn(tracked, tcfg, batch, chunk=16, remat=remat)
    stacked = {id(t) for group in tracked["groups"]
               for t in jax.tree.leaves(group)}
    reached = {}  # id of a stacked leaf -> names of the nodes that feed it
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for child, _ in node.next_functions:
            var = getattr(child, "variable", None)
            if var is not None and id(var) in stacked:
                reached.setdefault(id(var), []).append(node.name())
            todo.append(child)
    if remat == "none":
        assert len(reached) == len(stacked)
        assert all(names == ["UnbindBackward0"]
                   for names in reached.values()), reached
    else:
        # the checkpointed layers take their views from unbind nodes too;
        # nothing selects a layer from a stacked leaf
        assert all(set(names) == {"UnbindBackward0"}
                   for names in reached.values()), reached


def test_remat_policies_are_the_references():
    """The reference's four policies run; on a config with no MoE layer
    "group_save_moe" is "group" (every layer checkpointed whole), to the
    bit; a policy the reference does not have raises."""
    _, tcfg = _configs()
    params = init_train_state(tcfg, torch.Generator().manual_seed(0),
                              "cpu")["params"]
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    loss, got = _grads(tcfg, params, batch, "group_save_moe")
    want_loss, want = _grads(tcfg, params, batch, "group")
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="remat"):
        loss_fn(params, tcfg, batch, remat="layer")



@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_group_save_moe_gradients_match_reference(arch):
    """`remat="group_save_moe"` on the MoE smoke configs in f32, from the
    reference's weights: the loss and every f32 gradient against the
    reference's `jax.jit(jax.value_and_grad(loss_fn(..., remat=
    "group_save_moe")))` under no mesh (C-watch 1), the loss at rel 1e-5
    and each gradient leaf within 1e-5 of its largest value (the same f32
    arithmetic in another order, as the train step's tests above hold it;
    measured 5.7e-7 and 6.3e-7); and against the port's own "group",
    within 1e-6 of each leaf's largest (the same ops: no gradient reads
    the saved MoE output)."""
    jcfg = dataclasses.replace(j_smoke(j_get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    batch = {k: v % tcfg.vocab_size for k, v in _batches(1, b=2, s=32)[
        0].items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, b, chunk=32,
                               remat="group_save_moe")))(
        jp, jax.tree.map(jnp.asarray, batch))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _grads(tcfg, params, t_batch, "group_save_moe")
    group_loss, group = _grads(tcfg, params, t_batch, "group")
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    assert float(loss) == pytest.approx(float(group_loss), rel=1e-6)
    spec = torch.utils._pytree.tree_flatten(params)[1]
    want = dict(_flat(jax.tree.map(np.asarray, j_grads)))
    got = dict(_flat(spec.unflatten(list(grads))))
    same = dict(_flat(spec.unflatten(list(group))))
    assert got.keys() == want.keys() == same.keys()
    for path in want:
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-5 * scale, err_msg=path)
        np.testing.assert_allclose(got[path], same[path], rtol=0,
                                   atol=1e-6 * scale, err_msg=path)


def test_train_step_lowers_a_held_loss():
    """A few bf16 steps on the port's own synthetic stream lower the loss
    of a held batch (the CPU counterpart of `chip_smoke.py` phase 15)."""
    from repro_torch.data import (DataPipeline, SyntheticConfig,
                                  SyntheticTokenDataset)
    _, tcfg = _configs("bfloat16")
    state = init_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    pipe = DataPipeline(SyntheticTokenDataset(SyntheticConfig(
        tcfg.vocab_size, 32)), 4, device="cpu")
    held = pipe.device_batch(10_000)
    before = float(loss_fn(state["params"], tcfg, held, chunk=16))
    step = make_train_step(tcfg, AdamWConfig(lr=3e-3), TrainOptions(
        warmup_steps=2, total_steps=8, chunk=16))
    batches = pipe(0)
    try:
        for _ in range(8):
            state, metrics = step(state, next(batches))
            assert np.isfinite(float(metrics["loss"]))
    finally:
        batches.close()
    assert float(loss_fn(state["params"], tcfg, held, chunk=16)) < before


def test_grad_dtype_is_checked():
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="grad_dtype"):
        make_train_step(tcfg, AdamWConfig(), TrainOptions(grad_dtype="fp8"))


@pytest.mark.parametrize("k", [2, 6])
def test_dispatch_gather_backward_sums_in_expert_order(k):
    """The dispatch's gather (`moe._GatherTokens`, each token gathered k
    times) in f32 on 2 groups of 96 tokens over 16 experts, capacity 4k
    (some assignments dropped): its gradient equals, bit for bit, each
    token's k row gradients summed one after another in ascending expert
    id, written out here; it equals autograd's own backward of the same
    `index_select` and the reference's `jax.grad` through its `xf[st]`
    (`repro/models/moe.py`'s dispatch gather, st the sorted tokens) within
    f32 rounding, 1e-6 of the largest gradient (a sum of k values in
    another order); and the MoE layer's graph holds it."""
    from repro_torch.models import moe as t_moe
    groups, t, e, d, cap = 2, 96, 16, 8, 4 * k
    rng = np.random.default_rng(k)
    ids = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(t)])
                    for _ in range(groups)])
    ds = t_moe.dispatch(torch.from_numpy(ids), cap)
    assert not bool(ds.keep.all())
    x = rng.standard_normal((groups, t, d)).astype(np.float32)
    cot = rng.standard_normal((groups, t * k, d)).astype(np.float32)

    def grad(gather):
        xt = torch.from_numpy(x).requires_grad_()
        return torch.autograd.grad(gather(xt), xt, torch.from_numpy(cot))[
            0].numpy()
    got = grad(lambda xt: t_moe._GatherTokens.apply(xt, ds.tokens, ds.pos))
    plain = grad(lambda xt: t_moe._take(xt, t, ds.tokens))

    tokens = ds.tokens.numpy()
    sorted_ids = np.take_along_axis(ids.reshape(groups, t * k),
                                    ds.order.numpy(), -1)
    want = np.zeros_like(x)
    for g in range(groups):
        for tok in range(t):
            rows = [int(np.flatnonzero((tokens[g] == tok) &
                                       (sorted_ids[g] == ex))[0])
                    for ex in sorted(ids[g, tok])]
            acc = cot[g, rows[0]]
            for r in rows[1:]:
                acc = acc + cot[g, r]
            want[g, tok] = acc
    assert np.array_equal(got, want)

    ref = np.stack([np.asarray(jax.grad(
        lambda xf, st=tokens[g], c=cot[g]: jnp.sum(xf[st] * c))(
            jnp.asarray(x[g]))) for g in range(groups)])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)

    cfg = dataclasses.replace(smoke_config(get_config(
        "deepseek-v2-236b")), dtype="float32", top_k=k, n_experts=e,
        d_model=d)
    p = {name: v[0] for name, v in t_moe.init_moe(
        cfg, 1, lambda shape, scale, dtype: scale * torch.randn(shape),
        torch.float32, "cpu").items() if isinstance(v, torch.Tensor)}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = t_moe.moe_groups(p, xt, cfg)
    seen, todo = set(), [y.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and node not in seen:
            seen.add(node)
            todo += [child for child, _ in node.next_functions]
    assert "_GatherTokensBackward" in {node.name() for node in seen}
