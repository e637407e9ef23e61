"""The port's fault handling (`repro_torch.runtime.fault`, a copy of
`repro.runtime.fault`: pure Python, no tensors) against the original.

Each of the reference's `TestFaultTolerance` cases runs on both modules
with the same scripted clock; the copy's decisions (failed hosts,
stragglers, mesh plans, recovery events) must equal the original's and the
values the reference's tests expect.
"""
import dataclasses
from pathlib import Path

import pytest

import repro.runtime.fault as ref
import repro_torch.runtime.fault as port
from repro_torch.runtime import (
    ElasticController,
    FaultTolerantLoop,
    HeartbeatMonitor,
    MeshPlan,
    StragglerPolicy,
)

ROOT = Path(__file__).resolve().parent.parent


def failure_detection(m):
    t = [0.0]
    mon = m.HeartbeatMonitor(4, timeout=10.0, clock=lambda: t[0])
    for h in range(4):
        mon.heartbeat(h, 1)
    t[0] = 5.0
    for h in range(3):
        mon.heartbeat(h, 2)
    early = mon.failed_hosts()
    t[0] = 14.0  # host 3 silent for 14s (> 10); hosts 0-2 for 9s
    return {"at_5s": early, "at_14s": mon.failed_hosts()}


def straggler_detection(m):
    t = [0.0]
    mon = m.HeartbeatMonitor(4, straggler_factor=2.0, clock=lambda: t[0])
    for step in (1, 2, 3):
        for h in range(4):
            t[0] = step * 1.0 + (3.0 * step if h == 3 else 0.0)
            mon.heartbeat(h, step)
    return {"stragglers": mon.stragglers(),
            "step_seconds": [st.step_seconds for st in mon.hosts.values()],
            "flag": m.StragglerPolicy("flag").act(mon.stragglers()),
            "wait": m.StragglerPolicy().act(mon.stragglers())}


def elastic_plan_keeps_tp(m):
    ctl = m.ElasticController(devices_per_host=8, model_parallel=16)
    plan = ctl.plan(surviving_hosts=list(range(30)), failed=[30, 31])
    return {"plan": dataclasses.asdict(plan), "devices": plan.devices}


def loop_recovers_from_failure(m):
    t = [0.0]
    mon = m.HeartbeatMonitor(4, timeout=5.0, clock=lambda: t[0])
    ctl = m.ElasticController(devices_per_host=4, model_parallel=2)
    recovered = {}

    def recover(plan):
        recovered["plan"] = plan
        return {"restored": True}, 17

    loop = m.FaultTolerantLoop(mon, ctl, recover)
    for h in range(4):
        mon.heartbeat(h, 1)
    t[0] = 20.0
    for h in range(3):
        mon.heartbeat(h, 2)
    state, step, note = loop.check_and_recover({"restored": False}, 2)
    return {"state": state, "step": step, "note": note,
            "plan": dataclasses.asdict(recovered["plan"]),
            "events": [(e.step, e.reason, dataclasses.asdict(e.plan))
                       for e in loop.events],
            "hosts_left": sorted(mon.hosts)}


EXPECTED = {
    failure_detection: lambda d: d["at_5s"] == [] and d["at_14s"] == [3],
    straggler_detection: lambda d: 3 in d["stragglers"] and
    d["flag"] == f"stragglers detected: {d['stragglers']}" and
    d["wait"] is None,
    elastic_plan_keeps_tp: lambda d: d["plan"]["model"] == 16 and
    d["plan"]["data"] == 8 and d["devices"] <= 240,
    loop_recovers_from_failure: lambda d: d["state"]["restored"] and
    d["step"] == 17 and d["plan"]["model"] == 2 and
    "3" in d["events"][0][1] and d["hosts_left"] == [0, 1, 2],
}


@pytest.mark.parametrize("case", list(EXPECTED), ids=lambda f: f.__name__)
def test_decisions_equal_the_reference(case):
    got, want = case(port), case(ref)
    assert got == want
    assert EXPECTED[case](got)


def test_the_copy_is_verbatim_and_exported():
    assert (ROOT / "src/repro_torch/runtime/fault.py").read_text() == \
        (ROOT / "src/repro/runtime/fault.py").read_text()
    assert (ElasticController, FaultTolerantLoop, HeartbeatMonitor,
            MeshPlan, StragglerPolicy) == (
        port.ElasticController, port.FaultTolerantLoop,
        port.HeartbeatMonitor, port.MeshPlan, port.StragglerPolicy)


def test_elastic_plan_refuses_fewer_devices_than_model_parallel():
    for m in (port, ref):
        with pytest.raises(RuntimeError, match="model_parallel=16"):
            m.ElasticController(devices_per_host=4,
                                model_parallel=16).plan([0, 1, 2], [3])
