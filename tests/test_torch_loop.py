"""The capture's loop region (`repro_torch.core.torch_frontend.loop`): the
train step's micro-batches, the reference's `lax.scan`, captured as one
`while` whose body holds the first trip, on the CPU.

* qwen2-0.5b smoke's train step at 4 micro-batches, captured with the loop
  and unrolled (`capture(..., loops=False)`): trip-aware FLOPs
  (`Module.total_flops`), trip-aware bytes (`roofline._trip_aware_bytes`)
  and the kernel regions are equal exactly, the costs being sums of whole
  numbers far below 2**53.  The norms take the kernel route through a
  stand-in kernel (a CPU tensor takes the plain path), so the regions are
  counted.  The looped Module holds one `while` of `trip_count` 4, LEO's
  `diagnose` runs on it, and the dependency graph follows the accumulator
  across the back edge (a LOOP_CARRIED edge into the body).
* A loop whose second trip differs from the first (another shape, another
  op, a carry that changes shape) raises; a capture runs two trips of a
  loop of 256; outside a capture, and with `loops=False`, `loop` is the
  Python loop.
"""
import dataclasses
import functools

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import LeoService, capture, get_backend
from repro_torch.core.depgraph import build_dependency_graph
from repro_torch.core.isa import EdgeKind
from repro_torch.core.roofline import _trip_aware_bytes
from repro_torch.core.torch_frontend import kernel_call, loop
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.models import transformer
from repro_torch.runtime import TrainOptions, init_train_state, \
    make_train_step

MICRO = 4


def _stand_in_norm(x, scale, eps=1e-5):
    """`layers.rmsnorm` on the kernel route, a stand-in kernel named as K2
    that only a capture reaches (it records the plain version's region)."""
    def kernel(*args, **kwargs):
        raise AssertionError("a capture launches nothing")
    kernel.__name__ = "rmsnorm_pipelined"
    kernel.check = lambda *args, **kwargs: None
    rows = x.reshape(-1, x.shape[-1])
    return kernel_call(kernel, rows, scale, eps=eps,
                       plain_fn=functools.partial(rmsnorm_plain, eps=eps)
                       ).reshape(x.shape)


@pytest.fixture(scope="module")
def step_and_args():
    cfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                              dtype="float32")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2 * MICRO, 32),
                              generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, options=TrainOptions(microbatch=MICRO,
                                                     chunk=16))
    return cfg, step, (state, batch)


@pytest.fixture(scope="module")
def modules(step_and_args):
    cfg, step, args = step_and_args
    patch = pytest.MonkeyPatch()
    patch.setattr(transformer, "rmsnorm", _stand_in_norm)
    try:
        return {loops: capture(step, *args, device="cpu", loops=loops)
                for loops in (True, False)}
    finally:
        patch.undo()


def _whiles(module):
    return [i for i in module.all_instructions() if i.opcode == "while"]


def test_loop_costs_what_the_unrolled_trips_cost(step_and_args, modules):
    cfg = step_and_args[0]
    looped, unrolled = modules[True], modules[False]
    assert looped.total_flops() == unrolled.total_flops() > 0
    assert _trip_aware_bytes(looped) == _trip_aware_bytes(unrolled) > 0
    # every norm of every trip, forward and recomputed in the backward
    # ("group" remat), and the final norm
    norms = MICRO * (4 * cfg.n_layers + 1)
    assert looped.kernel_calls == unrolled.kernel_calls == {
        "rmsnorm_pipelined": norms}
    assert sum(1 for _ in looped.all_instructions()) < \
        sum(1 for _ in unrolled.all_instructions())


def test_loop_is_one_while_of_its_trips(step_and_args, modules):
    state, batch = step_and_args[2]
    looped, unrolled = modules[True], modules[False]
    assert not _whiles(unrolled) and len(unrolled.computations) == 1
    (w,) = _whiles(looped)
    assert w.trip_count == MICRO and w.computation == looped.entry
    (body,) = w.called_computations
    comp = looped.computations[body]
    assert comp.kind == "loop_body" and comp.parent_op == w.qualified_name
    (param,) = comp.parameters
    root = comp.root
    assert root.opcode == "tuple" and root.shape == param.shape == w.shape
    init = looped.entry_computation.get(w.operands[0])
    assert init.opcode == "tuple" and init.shape == w.shape
    # the carry first: the loss, then one gradient a param leaf; then the
    # values read from outside in the order first read, the stacked
    # micro-batches (MICRO, 2, 32) and each param leaf
    shapes = [tuple(t.shape) for t in tree_leaves(state["params"])]
    slots = [s.dims for s in w.shape.elements]
    assert slots[0] == () and slots[1:1 + len(shapes)] == shapes
    assert sorted(slots[1 + len(shapes):]) == sorted(
        shapes + [(MICRO, 2, 32)] * len(batch))
    # what follows the loop reads the last carry from the while
    reads = [i for i in looped.entry_computation.instructions
             if i.opcode == "get-tuple-element" and i.operands == (w.name,)]
    assert [int(i.attributes["index"]) for i in reads] == \
        list(range(len(reads))) and reads
    # the body's kernel regions are one trip's
    marked = sum(1 for i in comp.instructions
                 if "rmsnorm_pipelined" in i.op_name)
    assert marked and marked * MICRO == sum(
        1 for i in unrolled.all_instructions()
        if "rmsnorm_pipelined" in i.op_name)


def test_leo_diagnoses_the_loop_and_follows_its_carry(modules):
    looped = modules[True]
    body = _whiles(looped)[0].called_computations[0]
    graph = build_dependency_graph(looped, get_backend("nvidia_h100_sxm").hw)
    carried = [e for e in graph.edges if e.kind is EdgeKind.LOOP_CARRIED]
    assert carried and all(e.consumer.startswith(body + "::")
                           for e in carried)
    diagnosis = LeoService().diagnose(looped, backend="nvidia_h100_sxm")
    assert diagnosis.estimated_step_seconds > 0
    assert diagnosis.to_dict()["top_stalls"]


def _changing_body(change):
    """A body whose second trip differs from its first as `change` says."""
    trips = []

    def body(c, x):
        trips.append(x)
        later = len(trips) > 1
        if change == "shape" and later:
            return c + x[:2].sum()
        if change == "op" and later:
            return c - x
        if change == "carry":
            return torch.cat([c, x])
        return c + x
    return body


@pytest.mark.parametrize("change", ["shape", "op", "carry"])
def test_a_trip_that_differs_raises(change):
    body = _changing_body(change)
    with pytest.raises(RuntimeError, match="loop: "):
        capture(lambda c, xs: loop(body, c, xs), torch.zeros(4),
                torch.ones(3, 4), device="cpu")


def test_a_capture_runs_two_trips_of_a_long_loop():
    """A `while` of 256 trips costs two trips of capture: the first is
    recorded, the second checked, the rest do not run; the regions count
    every trip."""
    calls = []

    def body(c, x):
        calls.append(x.shape)
        return _stand_in_norm(c + x, torch.ones(4))

    module = capture(lambda c, xs: loop(body, c, xs), torch.zeros(2, 4),
                     torch.ones(256, 2, 4), device="cpu")
    (w,) = _whiles(module)
    assert w.trip_count == 256 and len(calls) == 2
    assert module.kernel_calls == {"rmsnorm_pipelined": 256}
    unrolled = capture(lambda c, xs: loop(body, c, xs), torch.zeros(2, 4),
                       torch.ones(256, 2, 4), device="cpu", loops=False)
    assert module.total_flops() == unrolled.total_flops() > 0
    assert module.kernel_calls == unrolled.kernel_calls


def test_outside_a_capture_loop_is_the_python_loop():
    xs = {"a": torch.arange(12.0).reshape(3, 4),
          "b": torch.arange(3.0)}
    out = loop(lambda c, x: (c[0] + x["a"], c[1] * 2 + x["b"]),
               (torch.zeros(4), torch.zeros(())), xs)
    assert torch.equal(out[0], xs["a"].sum(0))
    assert out[1].item() == 0 * 4 + 1 * 2 + 2 * 1
    with pytest.raises(ValueError, match="leading axes"):
        loop(lambda c, x: c, torch.zeros(()), (torch.ones(3),
                                               torch.ones(2)))
    # loops=False records each trip in line; a trip that differs is then
    # recorded as it is
    unrolled = capture(lambda c, xs: loop(_changing_body("op"), c, xs),
                       torch.zeros(4), torch.ones(3, 4), device="cpu",
                       loops=False)
    ops = [i.opcode for i in unrolled.all_instructions()]
    assert "while" not in ops and ops.count("add") == 1 and \
        ops.count("sub") == 2
