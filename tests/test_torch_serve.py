"""The port's continuous-batching `ServeEngine` against the JAX package's,
on qwen2-0.5b smoke in f32 with the reference's weights: the same requests
give the same greedy tokens, token for token."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import transformer as jt
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import Request, ServeEngine, main
from repro_torch.models import convert


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_smoke(j_get_config("qwen2-0.5b")),
                               dtype="float32")
    tcfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                               dtype="float32")
    j_params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    t_params = convert.params_from_numpy(
        jax.tree.map(np.asarray, j_params), tcfg, "cpu")
    return jcfg, tcfg, j_params, t_params


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 256,
                                          size=int(rng.integers(2, 9)))]
            for _ in range(n)]


def test_tokens_equal_reference_engine(setup):
    jcfg, tcfg, j_params, t_params = setup
    prompts = _prompts(5)
    new = [6, 3, 8, 5, 4]
    j_reqs = [JRequest(i, list(p), n) for i, (p, n) in
              enumerate(zip(prompts, new))]
    t_reqs = [Request(i, list(p), n) for i, (p, n) in
              enumerate(zip(prompts, new))]
    j_engine = JServeEngine(jcfg, j_params, batch_slots=2, max_len=32)
    t_engine = ServeEngine(tcfg, t_params, batch_slots=2, max_len=32,
                           device="cpu")
    for jr, tr in zip(j_reqs, t_reqs):
        j_engine.submit(jr)
        t_engine.submit(tr)
    j_engine.run()
    t_engine.run()
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.done and len(tr.generated) == tr.max_new_tokens
        assert tr.generated == jr.generated, tr.rid


def test_mid_stream_admission_equals_solo_run(setup):
    """`examples/serve_demo.py`'s assertion on the port."""
    _, tcfg, _, t_params = setup
    engine = ServeEngine(tcfg, t_params, batch_slots=3, max_len=64,
                         device="cpu")
    reqs = [Request(i, p, 6 + 6 * i) for i, p in enumerate(_prompts(3))]
    for r in reqs:
        engine.submit(r)
    while not any(r.done for r in reqs):
        engine.tick()
    late = Request(99, _prompts(1, seed=7)[0], 8)
    engine.submit(late)
    engine.tick()
    late_slot = next(s for s in engine.slots if s.request is late)
    assert late_slot.pos == 1
    assert max(s.pos for s in engine.slots if s.request) > 1
    engine.run()
    assert all(r.done and len(r.generated) == r.max_new_tokens
               for r in reqs + [late])

    solo_engine = ServeEngine(tcfg, t_params, batch_slots=3, max_len=64,
                              device="cpu")
    solo = Request(99, list(late.prompt), 8)
    solo_engine.submit(solo)
    solo_engine.run()
    assert solo.generated == late.generated


def test_admission_zeroes_the_slot(setup):
    _, tcfg, _, t_params = setup
    engine = ServeEngine(tcfg, t_params, batch_slots=2, max_len=16,
                         device="cpu")
    for buf in engine.state["groups"][0]["kv"].values():
        buf.fill_(1.0)
    engine.submit(Request(0, [1, 2], 1))
    engine.tick()  # admits into slot 0; every slot writes its position 0
    k = engine.state["groups"][0]["kv"]["k"]
    assert torch.all(k[:, 0, 1:] == 0)
    assert torch.all(k[:, 1, 1:] == 1)  # the idle slot was not reset


def test_main_smoke_on_cpu():
    out = main(["--smoke", "--device", "cpu", "--requests", "3", "--slots",
                "2", "--max-new", "4", "--max-len", "32"])
    assert len(out) == 3 and all(len(t) == 4 for t in out.values())
