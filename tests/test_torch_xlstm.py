"""Parity of the port's xLSTM with the JAX package's, on the same numpy-made
inputs, on the CPU: the plain versions of the chunkwise mLSTM (K5) and sLSTM
scan (K6) kernels, the two mixers, and xlstm-125m smoke (d_model 64, 4
heads of 16, vocab 256, 4 layers: 3 mLSTM and 1 sLSTM) through `forward`,
`loss_fn`, decode and the serve engine, weights made by the reference and
carried across with `params_from_numpy`.

Tolerances, with their reasons:
* f32 at 1e-4, the reference kernel tests' tolerance
  (`tests/test_kernels.py::TestMlstmKernel`, `TestSlstmKernel`): the same f32
  recurrences, the chunkwise form against the step-by-step one and sums
  taken in other orders;
* bf16 at 2e-2 (of the largest logit for a model): bf16 rounds inputs,
  outputs and the residual stream at other places in the two frameworks.

The reference's mLSTM decode clamps its denominator at 1.0, where its
prefill clamps at exp(-m) (ROADMAP C-watch 2), so decode is held against the
reference's decode, never against prefill.  The CUDA kernels themselves are
held against these plain versions on the card by `tests/test_torch_gpu.py`.
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
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import transformer as jt
from repro.models import xlstm as jx
from repro_torch.configs import get_config, smoke_config
import repro_torch.kernels.slstm_scan as k6
from repro_torch.core import analyze_module, capture
from repro_torch.core.torch_frontend import kernel_call
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.models import xlstm as tx

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _close(port, expect, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


def _both(arrays, dtype):
    """numpy f32 arrays rounded once to `dtype`, as JAX and torch arrays."""
    jarr = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    return jarr, [convert.decode_state_from_numpy(np.asarray(a), "cpu")
                  for a in jarr]


# -- the kernels' plain versions ----------------------------------------------

def _mlstm_inputs(seed, b, s, h, hd, dtype):
    """The reference kernel test's distribution: normal q, k / sqrt(hd), v
    and log_i; log_f = log_sigmoid(normal + 2).  Gates stay f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, hd)) for _ in range(3))
    k = k / hd ** 0.5
    log_i = rng.standard_normal((b, s, h))
    log_f = -np.logaddexp(0.0, -(rng.standard_normal((b, s, h)) + 2.0))
    (jq, jk, jv), (tq, tk, tv) = _both(
        [a.astype(np.float32) for a in (q, k, v)], dtype)
    (jli, jlf), (tli, tlf) = _both(
        [a.astype(np.float32) for a in (log_i, log_f)], "float32")
    return (jq, jk, jv, jli, jlf), (tq, tk, tv, tli, tlf)


@pytest.mark.parametrize("s,h,hd,chunk", [
    (64, 2, 32, 16), (128, 1, 64, 32),   # the reference grid
    (256, 1, 192, 128),                  # xlstm-125m's head dim and chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_plain_matches_pallas_and_ref(s, h, hd, chunk, dtype):
    jargs, targs = _mlstm_inputs(3, 2, s, h, hd, dtype)
    before = tops.mlstm_chunkwise.launches
    out = tops.mlstm_chunkwise_op(*targs, chunk=chunk)
    assert tops.mlstm_chunkwise.launches == before  # CPU: the plain version
    assert out.dtype == targs[0].dtype and out.shape == targs[0].shape
    tol = TOL[dtype]
    _close(out, jops.mlstm_chunkwise_op(*jargs, chunk=chunk, interpret=True),
           tol)
    _close(out, jref.mlstm_ref(*jargs), tol)
    # the chunkwise form the model hands a capture as K5's region
    _close(tx._mlstm_chunks(*targs, chunk).to(out.dtype), out.float(), tol)


@pytest.mark.parametrize("s,d,chunk", [(32, 64, 8), (64, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_plain_matches_pallas_and_ref(s, d, chunk, dtype):
    """The reference kernel test's distribution: normal xg, r at 0.1."""
    rng = np.random.default_rng(5)
    xg = rng.standard_normal((2, s, 4 * d)).astype(np.float32)
    r = (0.1 * rng.standard_normal((d, 4 * d))).astype(np.float32)
    (jxg, jr), (txg, tr) = _both([xg, r], dtype)
    before = tops.slstm_scan.launches
    out = tops.slstm_scan_op(txg, tr)
    assert tops.slstm_scan.launches == before
    assert out.dtype == txg.dtype and out.shape == (2, s, d)
    tol = TOL[dtype]
    _close(out, jops.slstm_scan_op(jxg, jr, chunk=chunk, interpret=True),
           tol)
    _close(out, jref.slstm_scan_ref(jxg, jr), tol)



@pytest.mark.parametrize("sms,d,takes", [
    (132, 1024, True), (66, 1024, False),
    (132, 1320, True), (132, 1321, False),  # the widest D on 132 SMs
])
def test_slstm_check_spreads_d_over_the_devices_sms(monkeypatch, sms, d,
                                                     takes):
    """K6 gives a block ceil(D / SMs) units, whose columns of r sit in its
    shared memory (in f32, whatever the inputs' dtype) beside at least one
    row of h: D 1024 fits on 132 SMs (8 units, 128 KiB of r) and not on 66
    (16 units, 256 KiB); the widest D on 132 SMs is 1320 (10 units, 206
    KiB), where the first design of the kernel took 1204.  The check reads the SM count of the
    device, as the launch does; here it runs inside a capture, as
    `kernel_call` runs it."""
    monkeypatch.setattr(k6, "_sm_count", lambda device: sms)
    xg, r = torch.rand((1, 2, 4 * d)), torch.rand((d, 4 * d))

    def scan(a, b):
        return kernel_call(tops.slstm_scan, a, b,
                           plain_fn=tops.slstm_scan_plain)
    if takes:
        module = capture(scan, xg, r, device="cuda")
        assert module.kernel_calls == {"slstm_scan": 1}
    else:
        with pytest.raises(ValueError, match=f"slstm_scan: D={d}"):
            capture(scan, xg, r, device="cuda")

# -- the mixers ---------------------------------------------------------------

def _configs(dtype):
    jcfg = dataclasses.replace(j_smoke(j_get_config("xlstm-125m")),
                               dtype=dtype)
    tcfg = dataclasses.replace(smoke_config(get_config("xlstm-125m")),
                               dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    return params, np_params, convert.params_from_numpy(np_params, tcfg,
                                                        "cpu")


def _layer0(np_params, group, kind):
    """Layer 0 of group `group`'s `kind` mixer, as JAX and torch trees."""
    tree = np_params["groups"][group][kind]
    return ({k: jnp.asarray(v[0]) for k, v in tree.items()},
            {k: convert.decode_state_from_numpy(v[0], "cpu")
             for k, v in tree.items()})


def _x(dtype, b=2, s=64, d=64, seed=7):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)
    (jx_,), (tx_,) = _both([x], dtype)
    return jx_, tx_


def _scaled_close(port, expect, dtype):
    expect = np.asarray(expect, np.float32)
    if dtype == "float32":
        _close(port, expect, 1e-4)
    else:
        scale = np.abs(expect).max()
        assert np.abs(port.float().numpy() - expect).max() <= 2e-2 * scale


@pytest.mark.parametrize("chunk", [16, 128])  # 4 chunks of 16; one of 64
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_forward_matches_reference(chunk, dtype):
    jcfg, tcfg = _configs(dtype)
    _, np_params, _ = _params(jcfg, tcfg)
    jp, tp = _layer0(np_params, 0, "mlstm")
    jx_, tx_ = _x(dtype)
    out = tx.mlstm_forward(tp, tx_, tcfg, chunk=chunk)
    assert out.dtype == tx_.dtype
    _scaled_close(out, jx.mlstm_forward(jp, jx_, jcfg, chunk=chunk), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_matches_reference(dtype):
    jcfg, tcfg = _configs(dtype)
    _, np_params, _ = _params(jcfg, tcfg)
    jp, tp = _layer0(np_params, 1, "slstm")
    jx_, tx_ = _x(dtype)
    out = tx.slstm_forward(tp, tx_, tcfg)
    assert out.dtype == tx_.dtype
    _scaled_close(out, jx.slstm_forward(jp, jx_, jcfg), dtype)


def test_mlstm_forward_refuses_a_ragged_sequence():
    """S 200 is no multiple of the chunk min(128, 200): the reference
    asserts, the port raises."""
    jcfg, tcfg = _configs("float32")
    _, np_params, _ = _params(jcfg, tcfg)
    jp, tp = _layer0(np_params, 0, "mlstm")
    jx_, tx_ = _x("float32", s=200)
    with pytest.raises(AssertionError):
        jx.mlstm_forward(jp, jx_, jcfg)
    with pytest.raises(ValueError, match="chunk"):
        tx.mlstm_forward(tp, tx_, tcfg)


def _decode_steps(step_j, step_t, jp, tp, jcfg, tcfg, j_state, t_state,
                  steps=6):
    """Token by token through both packages' decode of one mixer; returns
    the largest gap of the outputs and the states at the end."""
    xs = np.random.default_rng(9).standard_normal(
        (steps, 2, jcfg.d_model)).astype(np.float32)
    gap = 0.0
    for t in range(steps):
        (jx_,), (tx_,) = _both([xs[t]], "float32")
        jy, j_state = step_j(jp, jx_, j_state, jcfg)
        ty, t_state = step_t(tp, tx_, t_state, tcfg)
        _close(ty, jy, 1e-4)
        gap = max(gap, float(np.abs(ty.numpy() - np.asarray(jy)).max()))
    for name in j_state:
        _close(t_state[name], j_state[name], 1e-4)
    return gap


def test_mlstm_decode_matches_reference_decode():
    jcfg, tcfg = _configs("float32")
    _, np_params, _ = _params(jcfg, tcfg)
    jp, tp = _layer0(np_params, 0, "mlstm")
    j_state = jx.init_mlstm_state(jcfg, 2)
    t_state = tx.init_mlstm_state(tcfg, 2, "cpu")
    assert float(t_state["m"].max()) == np.float32(-1e30)
    _decode_steps(jx.mlstm_decode, tx.mlstm_decode, jp, tp, jcfg, tcfg,
                  j_state, t_state)


def test_mlstm_decode_keeps_the_reference_clamp():
    """With |q . n| below 1 the reference's decode (clamp 1.0) and prefill
    (clamp exp(-m)) disagree; the port's decode disagrees with its prefill
    by the same amount: it mirrors the clamp, it does not fix it.  Gate
    weights 20x the init scale make the input gates, and so m, large, and
    exp(-m) far from 1."""
    jcfg, tcfg = _configs("float32")
    _, np_params, _ = _params(jcfg, tcfg)
    mixer = np_params["groups"][0]["mlstm"]
    mixer["w_if"] = 20.0 * mixer["w_if"]
    jp, tp = _layer0(np_params, 0, "mlstm")
    x = np.random.default_rng(10).standard_normal((1, 8, jcfg.d_model)
                                                  ).astype(np.float32)
    (jx_,), (tx_,) = _both([x], "float32")
    j_state = jx.init_mlstm_state(jcfg, 1)
    t_state = tx.init_mlstm_state(tcfg, 1, "cpu")
    j_dec, t_dec = [], []
    for t in range(8):
        jy, j_state = jx.mlstm_decode(jp, jx_[:, t], j_state, jcfg)
        ty, t_state = tx.mlstm_decode(tp, tx_[:, t], t_state, tcfg)
        j_dec.append(np.asarray(jy))
        t_dec.append(ty.numpy())
    j_prefill = np.asarray(jx.mlstm_forward(jp, jx_, jcfg))
    j_gap = np.abs(np.stack(j_dec, 1) - j_prefill).max()
    t_gap = np.abs(np.stack(t_dec, 1) -
                   tx.mlstm_forward(tp, tx_, tcfg).numpy()).max()
    # decode departs from prefill by a large share of the output ...
    assert j_gap > 0.1 * np.abs(j_prefill).max()
    # ... in both packages alike
    assert t_gap == pytest.approx(j_gap, rel=1e-3)


def test_slstm_decode_matches_reference_decode():
    jcfg, tcfg = _configs("float32")
    _, np_params, _ = _params(jcfg, tcfg)
    jp, tp = _layer0(np_params, 1, "slstm")
    _decode_steps(jx.slstm_decode, tx.slstm_decode, jp, tp, jcfg, tcfg,
                  jx.init_slstm_state(jcfg, 2),
                  tx.init_slstm_state(tcfg, 2, "cpu"))


# -- xlstm-125m smoke ---------------------------------------------------------

def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    """S 256: two of the mLSTM's chunks of 128."""
    jcfg, tcfg = _configs(dtype)
    jp, _, tp = _params(jcfg, tcfg)
    tokens = _tokens((2, 256))
    j_logits, _ = jt.forward(jp, jcfg, tokens=jnp.asarray(tokens))
    t_logits, aux = tt.forward(tp, tcfg, tokens=torch.from_numpy(tokens))
    assert t_logits.dtype == torch.float32 and float(aux) == 0.0
    _scaled_close(t_logits, j_logits, dtype)
    if dtype == "bfloat16":
        assert (t_logits.numpy().argmax(-1) ==
                np.asarray(j_logits).argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_reference(dtype):
    jcfg, tcfg = _configs(dtype)
    jp, _, tp = _params(jcfg, tcfg)
    batch = {"tokens": _tokens((2, 64)), "labels": _tokens((2, 64), seed=2)}
    j_loss = float(jt.loss_fn(jp, jcfg, jax.tree.map(jnp.asarray, batch)))
    t_loss = float(tt.loss_fn(tp, tcfg, batch))
    assert t_loss == pytest.approx(j_loss, rel=TOL[dtype] / 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype):
    """Eight decode steps of two slots through every layer; logits at every
    step and the recurrent states at the end."""
    jcfg, tcfg = _configs(dtype)
    jp, _, tp = _params(jcfg, tcfg)
    j_state = jt.init_decode_state(jcfg, 2, 16)
    t_state = tt.init_decode_state(tcfg, 2, 16, "cpu")
    toks = _tokens((8, 2), seed=3)
    for t in range(8):
        j_logits, j_state = jt.decode_step(jp, j_state, jcfg,
                                           jnp.asarray(toks[t]),
                                           jnp.asarray(t))
        t_logits, t_state = tt.decode_step(tp, t_state, tcfg,
                                           torch.from_numpy(toks[t]), t)
        _scaled_close(t_logits, j_logits, dtype)
    for j_group, t_group in zip(j_state["groups"], t_state["groups"]):
        assert sorted(t_group) == sorted(j_group)
        for kind in j_group:
            for name in j_group[kind]:
                assert t_group[kind][name].dtype == torch.float32
                _close(t_group[kind][name], j_group[kind][name],
                       TOL[dtype])


def test_init_params_layout_matches_reference():
    """`ln1` and the mixer's leaves, no `ln2`/`ffn` (the blocks have no
    FFN); `w_if` f32 in a bf16 model, as the reference keeps it."""
    jcfg, tcfg = _configs("bfloat16")
    j_shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    j_flat = jax.tree_util.tree_flatten_with_path(j_shapes)[0]
    for path, leaf in j_flat:
        t = tp
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(t.shape) == tuple(leaf.shape), path
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), path
    assert len(j_flat) == len(list(_leaves(tp)))
    assert sorted(tp["groups"][0]) == ["ln1", "mlstm"]
    assert sorted(tp["groups"][1]) == ["ln1", "slstm"]
    r = tp["groups"][1]["slstm"]["r_gates"].float()
    assert abs(r.std().item() - 0.01) < 0.001


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_f32_gate_weights_survive_conversion():
    jcfg, tcfg = _configs("bfloat16")
    _, np_params, tp = _params(jcfg, tcfg)
    j_w = np_params["groups"][0]["mlstm"]["w_if"]
    t_w = tp["groups"][0]["mlstm"]["w_if"]
    assert j_w.dtype == np.float32 and t_w.dtype == torch.float32
    assert np.array_equal(t_w.numpy(), j_w)
    assert tp["groups"][0]["mlstm"]["wq"].dtype == torch.bfloat16


# -- serving ------------------------------------------------------------------

def _prompt(n, seed):
    return [int(t) for t in _tokens((n,), seed=seed)]


def _reused_slot_logits(monkeypatch, reset):
    """Logits of a request admitted into the one slot a long request just
    freed, and of the same request alone.  `reset`: "engine" (every state
    leaf of the slot) or "kv" (the KV caches only, none in xLSTM)."""
    _, tcfg = _configs("float32")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    # At the init scales the carried state moves the logits little; larger
    # query/key and recurrent projections make each mixer's state carry its
    # output, so a leaked state shows.
    for group in tp["groups"]:
        if "mlstm" in group:
            for name in ("wq", "wk"):
                group["mlstm"][name] *= 10.0
        else:
            group["slstm"]["r_gates"] *= 50.0
    if reset == "kv":
        def kv_only(self, idx):
            for group, fresh in zip(self.state["groups"],
                                    self._fresh_state["groups"]):
                for name, buf in group.get("kv", {}).items():
                    buf[:, idx] = fresh["kv"][name][:, 0]
        monkeypatch.setattr(ServeEngine, "_reset_slot_state", kv_only)

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

    late = Request(1, _prompt(2, seed=12), 8)
    after_long = run([Request(0, _prompt(6, seed=11), 30), late])
    solo = Request(1, list(late.prompt), 8)
    alone = run([solo])
    assert late.done and solo.done and len(after_long) == len(alone)
    return torch.stack(after_long), torch.stack(alone)


def test_reused_slot_leaks_no_xlstm_state(monkeypatch):
    """The engine resets every state leaf of a reused slot (`m` back to
    -1e30): the late request's logits equal its solo run's."""
    got, expect = _reused_slot_logits(monkeypatch, "engine")
    _close(got, expect.numpy(), 1e-6)


def test_kv_only_reset_leaks_xlstm_state(monkeypatch):
    """The same run under a reset of the KV caches only: the long request's
    mLSTM and sLSTM states leak into the late one, and its logits move by
    more than 1000 times the tolerance above (it reads 2.9e-3
    on logits of about 0.5)."""
    got, expect = _reused_slot_logits(monkeypatch, "kv")
    assert (got - expect).abs().max().item() > 1e3 * 1e-6


def test_serve_tokens_equal_reference_engine():
    jcfg, tcfg = _configs("float32")
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


# -- capture ------------------------------------------------------------------

def test_capture_marks_each_recurrence_as_a_kernel_region():
    """The CUDA program of the smoke loss, captured on the CPU: each mLSTM
    and sLSTM layer is one region of its kernel (the chunkwise and the
    stepping plain forms), with the FLOPs of the plain program."""
    _, tcfg = _configs("float32")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.long),
             "labels": torch.zeros((2, 64), dtype=torch.long)}

    def loss(p, b):
        return tt.loss_fn(p, tcfg, b)
    kernel = capture(loss, tp, batch, device="cuda")
    plain = capture(loss, tp, batch)
    assert kernel.kernel_calls == {"rmsnorm_pipelined": 8,
                                   "mlstm_chunkwise": 3, "slstm_scan": 1}
    assert plain.kernel_calls == {}
    flops = [sum(i.flops for i in m.all_instructions())
             for m in (plain, kernel)]
    assert flops[1] == pytest.approx(flops[0], rel=1e-6)
    assert analyze_module(kernel, "nvidia_h100_sxm").chains
