"""Fault tolerance at scale: heartbeats, stragglers, elastic re-meshing.

Single-process simulation of the multi-host control plane (this container
has one host); the interfaces mirror what `jax.distributed` + a cluster
coordinator provide on real pods, and all decision logic (what to do, when)
is host-side Python that transfers unchanged:

* `HeartbeatMonitor` — per-host step heartbeats with an injectable clock;
  declares hosts *straggling* (> `straggler_factor` x median step time) or
  *failed* (no heartbeat for `timeout`).
* `StragglerPolicy` — what the loop does about stragglers: "wait" (default
  synchronous SPMD behavior), or "flag" (surface for ops tooling).
* `ElasticController` — given surviving host count, picks the largest valid
  (data x model) mesh <= survivors (keeping TP intact, shrinking DP),
  yielding the resharding plan; recovery = restore latest checkpoint with
  the new mesh's shardings (`CheckpointManager.restore_latest(shardings=…)`)
  and resume from the checkpointed step (the data pipeline is stateless
  beyond the step index).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class HostStatus:
    host: int
    last_step: int = -1
    last_seen: float = 0.0
    step_seconds: float = 0.0


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout: float = 60.0,
                 straggler_factor: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.clock = clock
        self.hosts: Dict[int, HostStatus] = {
            h: HostStatus(host=h) for h in range(n_hosts)}

    def heartbeat(self, host: int, step: int) -> None:
        now = self.clock()
        st = self.hosts[host]
        if st.last_step >= 0 and step > st.last_step:
            dt = (now - st.last_seen) / max(step - st.last_step, 1)
            st.step_seconds = 0.5 * st.step_seconds + 0.5 * dt \
                if st.step_seconds else dt
        st.last_step = step
        st.last_seen = now

    def failed_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if st.last_step >= 0 and now - st.last_seen > self.timeout]

    def stragglers(self) -> List[int]:
        times = sorted(st.step_seconds for st in self.hosts.values()
                       if st.step_seconds > 0)
        if not times:
            return []
        median = times[len(times) // 2]
        if median <= 0:
            return []
        return [h for h, st in self.hosts.items()
                if st.step_seconds > self.straggler_factor * median]


@dataclass(frozen=True)
class StragglerPolicy:
    mode: str = "wait"   # wait | flag

    def act(self, stragglers: List[int]) -> Optional[str]:
        if not stragglers:
            return None
        if self.mode == "flag":
            return f"stragglers detected: {stragglers}"
        return None  # synchronous SPMD waits by construction


@dataclass
class MeshPlan:
    data: int
    model: int
    dropped_hosts: Tuple[int, ...] = ()

    @property
    def devices(self) -> int:
        return self.data * self.model


class ElasticController:
    """Pick the largest valid mesh after failures; drive recovery."""

    def __init__(self, devices_per_host: int, model_parallel: int):
        self.devices_per_host = devices_per_host
        self.model_parallel = model_parallel

    def plan(self, surviving_hosts: List[int], failed: List[int]) -> MeshPlan:
        devices = len(surviving_hosts) * self.devices_per_host
        tp = self.model_parallel
        if devices < tp:
            raise RuntimeError(
                f"cannot keep model_parallel={tp} with {devices} devices")
        dp = devices // tp
        # largest power-of-two DP for stable collectives
        p = 1
        while p * 2 <= dp:
            p *= 2
        return MeshPlan(data=p, model=tp, dropped_hosts=tuple(failed))


@dataclass
class RecoveryEvent:
    step: int
    reason: str
    plan: MeshPlan


class FaultTolerantLoop:
    """Wraps a step function with detection + recovery orchestration.

    `recover_fn(plan) -> (state, step)` rebuilds mesh/shardings and restores
    the latest checkpoint; used by launch/train.py and unit-tested with
    injected failures.
    """

    def __init__(self, monitor: HeartbeatMonitor,
                 controller: ElasticController,
                 recover_fn: Callable[[MeshPlan], Tuple[object, int]],
                 straggler_policy: StragglerPolicy = StragglerPolicy()):
        self.monitor = monitor
        self.controller = controller
        self.recover_fn = recover_fn
        self.straggler_policy = straggler_policy
        self.events: List[RecoveryEvent] = []

    def check_and_recover(self, state, step: int):
        failed = self.monitor.failed_hosts()
        if failed:
            surviving = [h for h in self.monitor.hosts if h not in failed]
            plan = self.controller.plan(surviving, failed)
            state, step = self.recover_fn(plan)
            self.events.append(RecoveryEvent(
                step=step, reason=f"hosts failed: {failed}", plan=plan))
            for h in failed:
                del self.monitor.hosts[h]
        note = self.straggler_policy.act(self.monitor.stragglers())
        return state, step, note
