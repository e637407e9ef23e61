"""The per-device program of a mesh (`repro_torch.runtime.steps`) run on
four ranks: four spawned `gloo` processes on the CPU, joined by a
`FileStore` under the test's `tmp_path`, each spawn with its own timeout.

* qwen2-0.5b smoke in f32, one train step on `(2, 2)` and `(1, 4)`
  ("data", "model") meshes, the state placed by the sharding rules
  (`parallel/sharding.py::place`) and gathered back (`gather`): the loss,
  the grad norm and every leaf of the new state against the port's
  one-device step on the same state and batch, and the loss and grad norm
  against the reference's `jax.jit(make_train_step)` from the same
  weights (the reference's own init, carried across).  The `(1, 4)` mesh
  cuts the 4 query heads 4 ways and keeps the 2 KV heads whole (each rank
  reads its query head's group), and runs with `sequence_parallel` and two
  micro-batches.
* phi3.5-moe smoke in f32 under `moe_impl="ep_shardmap"` and
  `sequence_parallel`: two all-to-alls a MoE layer over "model".  The
  expert-parallel form routes each data shard's tokens on their own, with
  the capacity and the load-balancing loss of that shard, and averages
  the shards' aux losses (the reference's `pmean`): on `(2, 2)` that is the
  one-device step over two micro-batches, one a data shard, and the
  reference's jitted step with `microbatch=2`; on `(1, 4)` the one-device
  step over the whole batch.  Two runs give the same bits.
* On `(2, 2)` under `sequence_parallel`: hymba-1.5b smoke (hybrid
  attention and SSM; the SSM has no tensor-parallel form and runs alike
  on every rank of "model" on the whole sequence,
  `models/transformer.py::_replicated`) and deepseek-v2 smoke (MLA on a
  rank's heads, and a MoE under the default `global` form routed over the
  whole batch, its tokens gathered over "data", each rank running its own
  experts and its columns of the shared experts), each against the
  one-device step on the same state and batch, two runs the same bits.
  phi3.5-moe smoke under `global` on `(2, 2)`: a train step (each rank's
  experts, the backward of their products split over "data" by capacity
  rows) and a serve step in each decode form (per-slot positions, each
  slot routed alone, and a shared position, the batch routed together),
  against the one-device steps, two runs the same bits; and one hymba
  decode step of a single slot,
  its sliding-window caches' positions and its SSM state cut over "data"
  (the caches read by the distributed softmax, the SSM state gathered for
  the step and cut back after it), against the one-device serve step.
* `launch/train.py --model-parallel 2` on four ranks: two steps saved,
  then restored and run to three, continue the uninterrupted three steps'
  losses bit for bit; only rank 0 prints, and `--analyze` captures rank
  0's per-device step.

Tolerances: loss rel 1e-6 and grad norm rel 1e-5 against the one-device
step (the same f32 arithmetic with the sums of the shards' partial
products in another order; `tests/test_torch_train.py` holds the port to
the reference at 1e-5), each state leaf within 1e-5 (one AdamW step of lr
3e-4 from zero moments moves each weight by lr g / (|g| + 1e-8): a
gradient near 1e-8 turns an f32 rounding of g into up to 3e-6 of the
weight's step); against the reference, rel 1e-5.  The four ranks are
spawned once for the module, one process group running every case (both
meshes are built on it), with one timeout.
"""
import dataclasses
import os
import queue
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

LR_STEP = 3          # the state's step: past the warmup, lr_scale 1
WARMUP = 2
B, S, CHUNK = 4, 32, 16
TIMEOUT = 150        # seconds the spawn may take


def _cfg(arch):
    from repro_torch.configs import get_config, smoke_config
    return dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="float32")


def _options(mb, **kw):
    from repro_torch.runtime import TrainOptions
    return TrainOptions(microbatch=mb, chunk=CHUNK, warmup_steps=WARMUP,
                        **kw)


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S))
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def _state(arch, numpy_state):
    from repro_torch.models import train_state_from_numpy
    state = train_state_from_numpy(numpy_state, _cfg(arch), "cpu")
    state["step"] = torch.tensor(LR_STEP, dtype=torch.int32)
    return state


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_numpy(tree):
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.detach().float().numpy().copy(), tree)


def _rank_steps(mp_size, cases):
    """For each case (arch, flags, mb, numpy state, batch), the sharded
    train step on the (4 / mp_size, mp_size) mesh, run twice: each run's
    gathered state and metrics."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.flags import flags
    from repro_torch.parallel.sharding import (
        PartitionSpec,
        ShardingRules,
        gather,
        place,
    )
    from repro_torch.runtime.steps import (
        make_train_step,
        shard_step,
        train_specs,
    )
    results = []
    for arch, model_flags, mb, nstate, batch in cases:
        cfg = _cfg(arch)
        with flags(**model_flags):
            mesh = make_host_mesh(mp_size, device="cpu")
            rules = ShardingRules(mesh, cfg)
            specs = train_specs(rules, _state(arch, nstate))
            step = shard_step(
                make_train_step(cfg, options=_options(mb), specs=specs),
                mesh, (specs, {k: PartitionSpec() for k in
                               ("loss", "grad_norm", "lr_scale")}))
            bspecs = {k: PartitionSpec(rules.dp_spec, None) for k in batch}
            runs = []
            for _ in range(2):
                # the step updates the optimizer state in place: a fresh
                # state a run
                new, metrics = step(place(_state(arch, nstate), specs, mesh),
                                    place(_torch_batch(batch), bspecs, mesh))
                # the new state's shards are laid out as a step takes them
                # (the kernels refuse non-contiguous inputs on the card)
                assert all(t.to_local().is_contiguous()
                           for t in _leaves_of(new))
                runs.append((_to_numpy(gather(new)),
                             {k: float(v.full_tensor())
                              for k, v in metrics.items()}))
        results.append(runs)
    return results


def _compressed_state(nstate):
    """The qwen2 smoke state with its error feedback at zero."""
    from torch.utils._pytree import tree_map
    state = _state(Q_ARCH, nstate)
    state["grad_ef"] = tree_map(
        lambda t: torch.zeros_like(t, dtype=torch.float32), state["params"])
    return state


def _rank_compressed(nstate, batch):
    """qwen2 smoke f32 under `grad_compression` on the (2, 2) mesh, two
    steps (the second adds the first's error feedback): the gathered state
    and metrics of each."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import (
        PartitionSpec,
        ShardingRules,
        gather,
        place,
    )
    from repro_torch.runtime.steps import (
        make_train_step,
        shard_step,
        train_specs,
    )
    cfg = _cfg(Q_ARCH)
    mesh = make_host_mesh(2, device="cpu")
    rules = ShardingRules(mesh, cfg)
    state = _compressed_state(nstate)
    specs = train_specs(rules, state)
    step = shard_step(make_train_step(cfg, options=_options(
        1, grad_compression=True), specs=specs), mesh, (specs, {
            k: PartitionSpec() for k in ("loss", "grad_norm", "lr_scale")}))
    bspecs = {k: PartitionSpec(rules.dp_spec, None) for k in batch}
    state, out = place(state, specs, mesh), []
    for _ in range(2):
        state, metrics = step(state, place(_torch_batch(batch), bspecs,
                                           mesh))
        out.append((_to_numpy(gather(state)),
                    {k: float(v.full_tensor()) for k, v in metrics.items()}))
    return out


def _serve_inputs():
    """qwen2 smoke f32 weights, a prefill batch, and a one-slot decode
    state of 64 positions whose first 6 hold random keys and values."""
    from repro_torch.models import init_decode_state, init_params
    cfg = _cfg(Q_ARCH)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    tokens = torch.from_numpy(_batch(256, seed=3)["tokens"])
    state = init_decode_state(cfg, 1, 64, device="cpu")
    for group in state["groups"]:
        for buf in group["kv"].values():
            buf[:, :, :6] = torch.randn(buf[:, :, :6].shape, generator=gen)
    return cfg, params, tokens, state


def _rank_serve(mp_size):
    """Prefill (rows cut over "data") and one decode step of a single
    slot (its KV positions cut over "data", read by the distributed
    softmax) by their per-device programs on the (4 / mp_size, mp_size)
    mesh: the logits and the new state, whole."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import (
        PartitionSpec,
        ShardingRules,
        gather,
        place,
    )
    from repro_torch.runtime.steps import (
        make_prefill_step,
        make_serve_step,
        shard_step,
    )
    cfg, params, tokens, state = _serve_inputs()
    mesh = make_host_mesh(mp_size, device="cpu")
    rules = ShardingRules(mesh, cfg)
    pspecs = rules.param_specs(params)
    prefill_shape = ShapeConfig("p", S, B, "prefill")
    prefill = shard_step(make_prefill_step(cfg, chunk=CHUNK, device="cpu",
                                           pspecs=pspecs),
                         mesh, rules.logits_spec(prefill_shape))
    logits = prefill(place(params, pspecs, mesh), place(
        {"tokens": tokens}, {"tokens": PartitionSpec(rules.dp_spec, None)},
        mesh)).full_tensor()
    shape = ShapeConfig("d", 64, 1, "decode")
    sspecs = rules.decode_state_specs(state, shape)
    serve = shard_step(make_serve_step(cfg, pspecs=pspecs, sspecs=sspecs),
                       mesh,
                       (PartitionSpec(None), rules.logits_spec(shape),
                        sspecs), batch_axes=())
    token, step_logits, new = serve(
        place(params, pspecs, mesh), place(state, sspecs, mesh),
        torch.tensor([7]), torch.tensor(6))
    from repro_torch.parallel.sharding import tree_leaves_with_path
    kv_axes = sorted({a for path, spec in tree_leaves_with_path(sspecs)
                      if "kv" in path for e in spec if e is not None
                      for a in ((e,) if isinstance(e, str) else e)})
    return (logits.numpy(), token.full_tensor().numpy(),
            step_logits.full_tensor().numpy(), _to_numpy(gather(new)),
            kv_axes)


def _hybrid_serve_inputs():
    """hymba smoke f32 weights and a one-slot decode state of 64
    positions, every buffer random."""
    from repro_torch.models import init_decode_state, init_params
    cfg = _cfg(H_ARCH)
    gen = torch.Generator().manual_seed(4)
    params = init_params(cfg, gen, "cpu")
    state = init_decode_state(cfg, 1, 64, device="cpu")
    for buf in _leaves_of(state):
        if buf.is_floating_point():
            buf.copy_(torch.randn(buf.shape, generator=gen))
    return cfg, params, state


def _rank_hybrid_serve():
    """One hymba decode step of a single slot on the (2, 2) mesh (every
    rank serves it): the token, the logits and the new state, whole, and
    the decode state's leaves the rules cut past their batch dimension."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import (
        PartitionSpec,
        ShardingRules,
        gather,
        place,
        tree_leaves_with_path,
    )
    from repro_torch.runtime.steps import make_serve_step, shard_step
    cfg, params, state = _hybrid_serve_inputs()
    mesh = make_host_mesh(2, device="cpu")
    rules = ShardingRules(mesh, cfg)
    pspecs = rules.param_specs(params)
    shape = ShapeConfig("d", 64, 1, "decode")
    sspecs = rules.decode_state_specs(state, shape)
    serve = shard_step(make_serve_step(cfg, pspecs=pspecs, sspecs=sspecs),
                       mesh, (PartitionSpec(None), rules.logits_spec(shape),
                              sspecs), batch_axes=())
    token, logits, new = serve(
        place(params, pspecs, mesh), place(state, sspecs, mesh),
        torch.tensor([7]), torch.tensor(6))
    cut = sorted(path for path, spec in tree_leaves_with_path(sspecs)
                 if any(e is not None for e in list(spec)[2:]))
    return (token.full_tensor().numpy(), logits.full_tensor().numpy(),
            _to_numpy(gather(new)), cut)


def _moe_serve_inputs():
    """phi3.5-moe smoke f32 weights and a 4-slot decode state of 64
    positions whose first 6 hold random keys and values."""
    from repro_torch.models import init_decode_state, init_params
    cfg = _cfg(M_ARCH)
    gen = torch.Generator().manual_seed(7)
    params = init_params(cfg, gen, "cpu")
    state = init_decode_state(cfg, 4, 64, device="cpu")
    for group in state["groups"]:
        for buf in group["kv"].values():
            buf[:, :, :6] = torch.randn(buf[:, :, :6].shape, generator=gen)
    return cfg, params, state


MOE_TOKENS, MOE_POS = [7, 11, 200, 3], {"slots": [6, 4, 5, 6], "shared": 6}


def _rank_moe_serve():
    """phi3.5-moe's serve step under `global` on the (2, 2) mesh, the 4
    slots cut over "data", in each decode form, each run twice from the
    same state: the tokens, the logits and the new state, whole."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import (
        PartitionSpec,
        ShardingRules,
        gather,
        place,
    )
    from repro_torch.runtime.steps import make_serve_step, shard_step
    cfg, params, _ = _moe_serve_inputs()
    mesh = make_host_mesh(2, device="cpu")
    rules = ShardingRules(mesh, cfg)
    pspecs = rules.param_specs(params)
    shape = ShapeConfig("d", 64, 4, "decode")
    out = {}
    for form, pos in MOE_POS.items():
        sspecs = rules.decode_state_specs(_moe_serve_inputs()[2], shape)
        serve = shard_step(make_serve_step(
            cfg, per_slot_pos=form == "slots", pspecs=pspecs,
            sspecs=sspecs), mesh, (PartitionSpec(rules.dp_spec),
                                   rules.logits_spec(shape), sspecs))
        runs = []
        for _ in range(2):
            token, logits, new = serve(
                place(params, pspecs, mesh),
                place(_moe_serve_inputs()[2], sspecs, mesh),
                place(torch.tensor(MOE_TOKENS),
                      PartitionSpec(rules.dp_spec), mesh),
                place(torch.tensor(pos), PartitionSpec(
                    rules.dp_spec) if form == "slots" else PartitionSpec(),
                    mesh))
            runs.append((token.full_tensor().numpy(),
                         logits.full_tensor().numpy(),
                         _to_numpy(gather(new))))
        out[form] = runs
    return out


def _leaves_of(tree):
    from torch.utils._pytree import tree_leaves
    return tree_leaves(tree)


def _rank_driver(ckpt):
    """`train --model-parallel 2`: 3 steps uninterrupted, then 2 saved,
    then restored to 3 with `--analyze`."""
    import contextlib
    import io

    from repro_torch.launch import train
    common = ["--smoke", "--device", "cpu", "--model-parallel", "2",
              "--batch", "4", "--seq", "32"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        whole = train.main(common + ["--steps", "3"])
        train.main(common + ["--steps", "2", "--checkpoint-dir", ckpt])
        resumed = train.main(common + ["--steps", "3", "--restore",
                                       "--analyze", "--checkpoint-dir",
                                       ckpt])
    return ([h["loss"] for h in whole["history"]],
            [h["loss"] for h in resumed["history"]],
            resumed.get("leo_step_seconds"), printed.getvalue())


def _rank(rank, path, jobs, compressed, ckpt, out):
    """One of the four ranks: every case on each mesh, then the driver."""
    import torch.distributed as dist
    torch.set_num_threads(1)  # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=4)
    try:
        steps = {mesh: (_rank_steps(mp_size, cases), _rank_serve(mp_size))
                 for mesh, (mp_size, cases) in jobs.items()}
        steps["hybrid_serve"] = _rank_hybrid_serve()
        steps["moe_serve"] = _rank_moe_serve()
        steps["compressed"] = _rank_compressed(*compressed)
        driver = _rank_driver(ckpt)
        out.put((rank, steps if rank == 0 else None, driver))
    finally:
        dist.destroy_process_group()


def _spawn(jobs, compressed, ckpt, tmp_path):
    """Four spawned ranks of one `gloo` group, joined by a `FileStore`;
    each rank's result, by rank."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    path = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank, args=(r, path, jobs, compressed,
                                             ckpt, out))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + TIMEOUT
        got = []
        while len(got) < len(procs):
            assert time.monotonic() < deadline, "the ranks timed out"
            assert not any(p.exitcode not in (None, 0) for p in procs), \
                [p.exitcode for p in procs]  # a rank failed: see its stderr
            try:
                got.append(out.get(timeout=1.0))
            except queue.Empty:
                pass
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            assert p.exitcode == 0, p.exitcode
        return sorted(got, key=lambda r: r[0])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()


def _reference_state(arch):
    import jax
    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_config as j_smoke
    from repro.runtime import init_train_state as j_init_train_state
    jcfg = dataclasses.replace(j_smoke(j_get_config(arch)), dtype="float32")
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    return jcfg, jstate, jax.tree.map(np.asarray, jstate)


def _reference_metrics(jcfg, jstate, batch, mb):
    import jax
    import jax.numpy as jnp
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.runtime import TrainOptions as JTrainOptions
    from repro.runtime import make_train_step as j_make_train_step
    step = jax.jit(j_make_train_step(jcfg, JAdamWConfig(), JTrainOptions(
        microbatch=mb, chunk=CHUNK, warmup_steps=WARMUP)))
    _, m = step(jstate, jax.tree.map(jnp.asarray, {
        k: v.astype(np.int32) for k, v in batch.items()}))
    return float(m["loss"]), float(m["grad_norm"])


def _one_device(arch, model_flags, mb, nstate, batch):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.flags import flags
    from repro_torch.parallel.context import mesh_context
    from repro_torch.runtime import make_train_step
    with flags(**model_flags), \
            mesh_context(make_host_mesh(1, device="cpu")):
        new, m = make_train_step(_cfg(arch), options=_options(mb))(
            _state(arch, nstate), _torch_batch(batch))
    return _to_numpy(new), {k: float(v) for k, v in m.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _hold(got, want):
    (gstate, gm), (wstate, wm) = got, want
    assert gm["loss"] == pytest.approx(wm["loss"], rel=1e-6)
    assert gm["grad_norm"] == pytest.approx(wm["grad_norm"], rel=1e-5)
    assert gm["lr_scale"] == wm["lr_scale"] == 1.0
    want_leaves = dict(_leaves(wstate))
    for path, leaf in _leaves(gstate):
        np.testing.assert_allclose(leaf, want_leaves[path], rtol=0,
                                   atol=1e-5, err_msg=path)


MESHES = {"2x2": 2, "1x4": 4}
Q_ARCH, M_ARCH = "qwen2-0.5b", "phi3.5-moe-42b-a6.6b"
M_FLAGS = {"moe_impl": "ep_shardmap", "sequence_parallel": True}
# (2, 2) only: the mixers `_replicated` runs, under sequence parallelism
H_ARCH, D_ARCH = "hymba-1.5b", "deepseek-v2-236b"
R_FLAGS = {"sequence_parallel": True}


def _q_case(mp_size):
    """(flags, micro-batches) of the qwen2 case on a mesh."""
    return ({"sequence_parallel": True}, 2) if mp_size == 4 else ({}, 1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    refs = {arch: _reference_state(arch)
            for arch in (Q_ARCH, M_ARCH, H_ARCH, D_ARCH)}
    batches = {Q_ARCH: _batch(256), M_ARCH: _batch(256, seed=2),
               H_ARCH: _batch(256, seed=5), D_ARCH: _batch(256, seed=6)}
    jobs = {}
    for mesh, mp_size in MESHES.items():
        q_flags, q_mb = _q_case(mp_size)
        jobs[mesh] = (mp_size, [
            (Q_ARCH, q_flags, q_mb, refs[Q_ARCH][2], batches[Q_ARCH]),
            (M_ARCH, M_FLAGS, 1, refs[M_ARCH][2], batches[M_ARCH])])
    jobs["2x2"][1].extend(
        (arch, R_FLAGS, 1, refs[arch][2], batches[arch])
        for arch in (H_ARCH, D_ARCH))
    jobs["2x2"][1].append((M_ARCH, {}, 1, refs[M_ARCH][2], batches[M_ARCH]))
    got = _spawn(jobs, (refs[Q_ARCH][2], batches[Q_ARCH]),
                 str(tmp / "ckpt"), tmp)
    return {"steps": got[0][1], "driver": [r[2] for r in got],
            "refs": refs, "batches": batches, "ckpt": tmp / "ckpt"}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_steps_on_four_ranks(mesh, ranks):
    mp_size = MESHES[mesh]
    dp = 4 // mp_size
    q_runs, m_runs = ranks["steps"][mesh][0][:2]
    q_flags, q_mb = _q_case(mp_size)
    (q_cfg, q_jstate, q_state), (m_cfg, m_jstate, m_state) = \
        ranks["refs"][Q_ARCH], ranks["refs"][M_ARCH]
    q_batch, m_batch = ranks["batches"][Q_ARCH], ranks["batches"][M_ARCH]

    # qwen2: the one-device step, and the reference's jitted step
    _hold(q_runs[0], _one_device(Q_ARCH, {}, q_mb, q_state, q_batch))
    ref_loss, ref_gnorm = _reference_metrics(q_cfg, q_jstate, q_batch, q_mb)
    assert q_runs[0][1]["loss"] == pytest.approx(ref_loss, rel=1e-5)
    assert q_runs[0][1]["grad_norm"] == pytest.approx(ref_gnorm, rel=1e-5)

    # phi3.5-moe, expert-parallel: a routing a data shard
    _hold(m_runs[0], _one_device(M_ARCH, M_FLAGS, dp, m_state, m_batch))
    ref_loss, ref_gnorm = _reference_metrics(m_cfg, m_jstate, m_batch, dp)
    assert m_runs[0][1]["loss"] == pytest.approx(ref_loss, rel=1e-5)
    assert m_runs[0][1]["grad_norm"] == pytest.approx(ref_gnorm, rel=1e-5)
    # two runs, the same bits
    for runs in (q_runs, m_runs):
        assert runs[0][1] == runs[1][1]
        second = dict(_leaves(runs[1][0]))
        for path, leaf in _leaves(runs[0][0]):
            assert np.array_equal(leaf, second[path]), path


@pytest.mark.parametrize("arch", [H_ARCH, D_ARCH])
def test_replicated_mixers_on_four_ranks(arch, ranks):
    """hymba (attention, and the SSM run alike on every rank of "model")
    and deepseek-v2 (MLA on a rank's heads, the MoE's experts and shared
    columns on a rank's) on (2, 2) under `sequence_parallel`, against the
    one-device step; two runs the same bits."""
    runs = ranks["steps"]["2x2"][0][2 + [H_ARCH, D_ARCH].index(arch)]
    _hold(runs[0], _one_device(arch, R_FLAGS, 1, ranks["refs"][arch][2],
                               ranks["batches"][arch]))
    assert runs[0][1] == runs[1][1]
    second = dict(_leaves(runs[1][0]))
    for path, leaf in _leaves(runs[0][0]):
        assert np.array_equal(leaf, second[path]), path


def test_moe_global_form_on_four_ranks(ranks):
    """phi3.5-moe under `global` on (2, 2): the train step (each rank's
    experts, the backward of their products split over "data") against
    the one-device step at `_hold`'s tolerances, and a serve step in each
    decode form against the one-device serve step: the greedy tokens
    equal, the logits within 1e-5 of their largest, the new state within
    1e-6 of each leaf's largest (the qwen2 decode's tolerances below);
    two runs the same bits."""
    from repro_torch.runtime import make_serve_step
    runs = ranks["steps"]["2x2"][0][4]
    _hold(runs[0], _one_device(M_ARCH, {}, 1, ranks["refs"][M_ARCH][2],
                               ranks["batches"][M_ARCH]))
    assert runs[0][1] == runs[1][1]
    second = dict(_leaves(runs[1][0]))
    for path, leaf in _leaves(runs[0][0]):
        assert np.array_equal(leaf, second[path]), path
    for form, pos in MOE_POS.items():
        cfg, params, want_state = _moe_serve_inputs()
        want_token, want_logits, want_state = make_serve_step(
            cfg, per_slot_pos=form == "slots")(
            params, want_state, torch.tensor(MOE_TOKENS), torch.tensor(pos))
        want_logits = want_logits.numpy()
        want_leaves = dict(_leaves(_to_numpy(want_state)))
        (token, logits, state), again = ranks["steps"]["moe_serve"][form]
        assert np.array_equal(token, want_token.numpy()), form
        np.testing.assert_allclose(logits, want_logits, rtol=0,
                                   atol=1e-5 * np.abs(want_logits).max())
        for path, leaf in _leaves(state):
            np.testing.assert_allclose(leaf, want_leaves[path], rtol=0,
                                       atol=1e-6 * np.abs(leaf).max(),
                                       err_msg=path)
        assert np.array_equal(token, again[0])
        assert np.array_equal(logits, again[1])
        for (path, leaf), (_, leaf2) in zip(_leaves(state),
                                            _leaves(again[2])):
            assert np.array_equal(leaf, leaf2), path


def test_hybrid_decode_state_is_cut_back(ranks):
    """hymba's decode step on (2, 2), one slot: the greedy token, the
    logits within 1e-5 of their largest and the new state within 1e-6 of
    each leaf's largest (the tolerances of the qwen2 decode below) against
    the one-device serve step; the rules cut the state's SSM and cache
    leaves past their batch dimension (the SSM state gathered for the step
    and cut back after it)."""
    from repro_torch.runtime import make_serve_step
    token, logits, state, cut = ranks["steps"]["hybrid_serve"]
    cfg, params, want_state = _hybrid_serve_inputs()
    want_token, want_logits, want_state = make_serve_step(cfg)(
        params, want_state, torch.tensor([7]), torch.tensor(6))
    want_logits = want_logits.numpy()
    assert np.array_equal(token, want_token.numpy())
    np.testing.assert_allclose(logits, want_logits, rtol=0,
                               atol=1e-5 * np.abs(want_logits).max())
    want_leaves = dict(_leaves(_to_numpy(want_state)))
    for path, leaf in _leaves(state):
        np.testing.assert_allclose(leaf, want_leaves[path], rtol=0,
                                   atol=1e-6 * max(np.abs(leaf).max(), 1),
                                   err_msg=path)
    assert any("ssm" in p for p in cut), cut


def test_compressed_gradients_on_four_ranks(ranks):
    """`grad_compression` on (2, 2), two steps (the second adds the
    first's error feedback, laid out as the optimizer state), against the
    one-device steps: loss rel 1e-6, grad norm rel 1e-5, every weight and
    moment within 1e-5.  The error feedback too, but for at most 8
    elements of the state: the gradients' f32 sums in another order can
    round an element lying on a half step of the int8 grid to the
    neighbouring value, which moves its error feedback by one step, the
    leaf's largest magnitude over 127 (at most 4x the leaf's largest error
    feedback, which is half a step at most and near it)."""
    from repro_torch.runtime import make_train_step
    nstate, batch = ranks["refs"][Q_ARCH][2], ranks["batches"][Q_ARCH]
    step = make_train_step(_cfg(Q_ARCH), options=_options(
        1, grad_compression=True))
    state = _compressed_state(nstate)
    for gstate, gm in ranks["steps"]["compressed"]:
        state, m = step(state, _torch_batch(batch))
        assert gm["loss"] == pytest.approx(float(m["loss"]), rel=1e-6)
        assert gm["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                                rel=1e-5)
        want = dict(_leaves(_to_numpy(state)))
        flipped = 0
        for path, leaf in _leaves(gstate):
            gap = np.abs(leaf - want[path])
            if path.startswith("/grad_ef/"):
                off = gap > 1e-5
                flipped += int(off.sum())
                assert np.all(gap[off] <= 4 * np.abs(want[path]).max()), \
                    path
            else:
                assert gap.max() <= 1e-5, (path, gap.max())
        assert flipped <= 8


def test_model_parallel_driver_saves_and_resumes(ranks):
    for rank, (whole, resumed, leo, printed) in enumerate(ranks["driver"]):
        assert len(whole) == 3 and len(resumed) == 1
        assert resumed == whole[2:]          # bit for bit
        if rank == 0:
            assert leo and leo > 0 and "restored from step 2" in printed
        else:
            assert leo is None and printed == ""   # only rank 0 prints
    assert sorted(os.listdir(ranks["ckpt"])) == [
        "LATEST", "step_00000002", "step_00000003"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_and_decode_on_four_ranks(mesh, ranks):
    """qwen2 smoke f32: the prefill's logits (gathered over the vocab, the
    reference's `P(dp, None, None)`) and one decode step of a single slot
    whose KV positions the decode rules cut over "data" (the batch is
    smaller than the data axis: a distributed softmax reads them), against
    the one-device steps: logits within 1e-5 of their largest (the same
    f32 arithmetic, the softmax's sums split over ranks), the greedy
    token equal, the caches within 1e-6 of their largest (one token
    written, by the rank that holds its position; its key and value come
    from a rank's columns of the projections, which BLAS sums in the
    order of that width)."""
    from repro_torch.runtime import make_prefill_step, make_serve_step
    logits, token, step_logits, state, kv_axes = ranks["steps"][mesh][1]
    cfg, params, tokens, want_state = _serve_inputs()
    want = make_prefill_step(cfg, chunk=CHUNK, device="cpu")(
        params, {"tokens": tokens}).numpy()
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    want_token, want_logits, want_state = make_serve_step(cfg)(
        params, want_state, torch.tensor([7]), torch.tensor(6))
    want_logits = want_logits.numpy()
    np.testing.assert_allclose(step_logits, want_logits, rtol=0,
                               atol=1e-5 * np.abs(want_logits).max())
    assert np.array_equal(token, want_token.numpy())
    want_leaves = dict(_leaves(_to_numpy(want_state)))
    for path, leaf in _leaves(state):
        np.testing.assert_allclose(leaf, want_leaves[path], rtol=0,
                                   atol=1e-6 * np.abs(leaf).max(),
                                   err_msg=path)
    assert "data" in kv_axes  # the cache's positions were cut
