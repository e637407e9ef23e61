"""Blame attribution (§III-D, Eq. 1) with self-blame subcategories.

After pruning, each stalled instruction j distributes its stall cycles S_j
over surviving incoming dependencies with four multiplicative factors:

    blame_i = S_j * (Rd_i * Re_i * Ri_i * Rm_i) / sum_k(Rd_k * Re_k * Ri_k * Rm_k)

  Rd (distance)   = d_min / d_i       — closer producers hide less latency
  Re (efficiency) = e_min / e_i       — inefficient producers blamed more
  Ri (issue)      = n_i / sum_k n_k   — frequently-executed producers blamed more
  Rm (match)      = stall-category match: the edge's dependency type weighted
                    by the consumer's hardware-reported stall breakdown
                    (LEO's extension over GPA's three factors).

When no dependency survives pruning the stall self-blames with a diagnostic
subcategory derived from the dominant stall class and the instruction's own
character (memory latency / compute saturation / synchronization overhead /
collective wait / instruction fetch / indirect addressing).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .depgraph import DependencyGraph, Edge
from .hwmodel import HardwareModel
from .isa import EdgeKind, Instruction, OpClass, StallClass
from .sampler import StallProfile

_EPS = 1e-12
_MATCH_FLOOR = 0.05  # keep a floor so a single factor cannot zero an edge


def edge_stall_classes(edge: Edge, producer: Instruction) -> Tuple[StallClass, ...]:
    """Which observed stall classes this dependency type can explain."""
    if edge.kind.is_sync:
        if producer.comm_bytes > 0 or producer.op_class is OpClass.COLLECTIVE:
            return (StallClass.COLLECTIVE_WAIT, StallClass.SYNC_WAIT,
                    StallClass.SYNC_RESOURCE, StallClass.MEM_DEP)
        return (StallClass.SYNC_WAIT, StallClass.SYNC_RESOURCE,
                StallClass.MEM_DEP)
    cls = producer.op_class
    if cls in (OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE,
               OpClass.DATA_MOVEMENT, OpClass.PARAMETER, OpClass.CONSTANT):
        return (StallClass.MEM_DEP,)
    if cls is OpClass.COLLECTIVE or (cls is OpClass.SYNC_SET and
                                     producer.comm_bytes > 0):
        return (StallClass.COLLECTIVE_WAIT, StallClass.SYNC_WAIT)
    if cls in (OpClass.SYNC_SET, OpClass.SYNC_WAIT):
        return (StallClass.SYNC_WAIT, StallClass.SYNC_RESOURCE,
                StallClass.MEM_DEP)
    return (StallClass.EXEC_DEP,)


def producer_efficiency(instr: Instruction, hw: HardwareModel) -> float:
    """Fraction of the producer's occupancy that is useful resource time.

    Setup/overhead-dominated ops (tiny DMAs, skinny matmuls, per-element
    gathers) score low and attract blame — the analogue of "uncoalesced
    accesses receive more blame"."""
    useful = hw.latency_seconds(instr) * hw.clock_hz
    total = useful + hw.issue_overhead_cycles + (
        hw.dma_setup_cycles if instr.is_memory or
        instr.op_class is OpClass.DATA_MOVEMENT else 0.0)
    if total <= 0:
        return 1.0
    eff = useful / total
    # Sub-lane-width memory rows are additionally penalized (uncoalesced
    # analogue: HBM moves >=256B granules regardless of the useful payload).
    if instr.is_memory and instr.shape.dims:
        row = instr.shape.dims[-1] * max(instr.shape.byte_size //
                                         max(instr.shape.num_elements, 1), 1)
        eff *= min(1.0, row / 256.0)
    return max(eff, _EPS)


@dataclass
class BlameEntry:
    producer: str
    consumer: str
    kind: EdgeKind
    cycles: float
    factors: Dict[str, float] = field(default_factory=dict)


@dataclass
class SelfBlame:
    qualified: str
    cycles: float
    subcategory: str


@dataclass
class SyncResourceBlame:
    """One §III-E resource-oversubscription event: `consumer` serialized on
    physical instance `resource` (pool `pool`) still held by `holder`."""

    consumer: str
    resource: str      # concrete instance, e.g. "B3" / "vmcnt" / "$5"
    pool: str          # pool name, e.g. "named_barrier"
    holder: str        # qualified instruction that held the instance
    cycles: float


@dataclass
class SchedulerContentionBlame:
    """One issue-port arbitration loss: `consumer` was data-ready but queue
    `queue`'s issue slot was still occupied by `holder` — charged as
    `not_selected` (different execution pipe: the scheduler picked other
    work) or `pipe_busy` (same pipe: the functional unit is saturated)."""

    consumer: str
    holder: str        # qualified instruction occupying the issue slot
    queue: int         # issue queue index
    pipe: str          # consumer's execution-pipe family (mxu/vpu/lsu/...)
    stall_class: str   # "not_selected" | "pipe_busy"
    cycles: float


@dataclass
class OccupancyLimitedBlame:
    """One failed-latency-hiding event: `consumer` stalled on `blocker` and
    the co-resident waves of queue `queue` ran out of issue credit mid-wait
    — `hidden` cycles were covered, `exposed` cycles leaked through as
    `StallClass.OCCUPANCY_LIMITED`."""

    consumer: str
    blocker: str       # qualified producer whose latency leaked through
    queue: int         # issue queue index
    stall_class: str   # original hideable class ("mem_dep", "sync_wait", ...)
    hidden_cycles: float
    exposed_cycles: float

    @property
    def cycles(self) -> float:
        return self.exposed_cycles


@dataclass
class BlameResult:
    entries: List[BlameEntry] = field(default_factory=list)
    by_producer: Dict[str, float] = field(default_factory=dict)
    self_blame: List[SelfBlame] = field(default_factory=list)
    # Occupancy diagnosis: instructions that dominate the issue stream
    # without dependency stalls (a lone memory-bound kernel has nothing to
    # wait on — the bottleneck is itself).  Kept separate from self_blame so
    # stall-cycle conservation (sum(entries)+sum(self)==total stalls) holds.
    occupancy_blame: List[SelfBlame] = field(default_factory=list)
    # SYNC_RESOURCE evidence channel: scoreboard oversubscription events
    # naming the exact resource instance consumed.  Evidence *about* stall
    # cycles already attributed through entries/self_blame (the same cycles
    # viewed through the resource lens), so conservation still holds.
    sync_resource: List[SyncResourceBlame] = field(default_factory=list)
    # Scheduler-contention evidence channel: issue-port arbitration events
    # from the multi-stream sampler (NOT_SELECTED / PIPE_BUSY cycles viewed
    # through the queue lens); same conservation caveat as sync_resource.
    scheduler_contention: List[SchedulerContentionBlame] = \
        field(default_factory=list)
    # Failed-latency-hiding evidence channel: OCCUPANCY_LIMITED events from
    # the multi-wave sampler (partially-hidden stalls viewed through the
    # wave-residency lens); same conservation caveat as sync_resource.
    occupancy_limited: List[OccupancyLimitedBlame] = \
        field(default_factory=list)

    @property
    def total_attributed(self) -> float:
        return sum(self.by_producer.values())

    def top_root_causes(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.by_producer.items(), key=lambda kv: -kv[1])[:n]

    def contributions_to(self, consumer: str) -> List[BlameEntry]:
        return sorted((e for e in self.entries if e.consumer == consumer),
                      key=lambda e: -e.cycles)


_SELF_SUBCATEGORY = {
    StallClass.MEM_DEP: "memory latency",
    StallClass.EXEC_DEP: "compute saturation",
    StallClass.SYNC_WAIT: "synchronization overhead",
    StallClass.SYNC_RESOURCE: "sync resource exhaustion",
    StallClass.COLLECTIVE_WAIT: "collective wait",
    StallClass.FETCH: "instruction fetch",
    StallClass.PIPE_BUSY: "pipeline contention",
    StallClass.NOT_SELECTED: "scheduler contention",
    StallClass.OCCUPANCY_LIMITED: "occupancy limited",
}


def _self_subcategory(instr: Optional[Instruction],
                      dominant: StallClass) -> str:
    if instr is not None and instr.opcode in ("gather", "dynamic-slice",
                                              "scatter",
                                              "dynamic-update-slice"):
        return "indirect addressing"
    return _SELF_SUBCATEGORY.get(dominant, "unclassified")


class BlameAttributor:
    def __init__(self, graph: DependencyGraph, profile: StallProfile,
                 hw: HardwareModel):
        self.graph = graph
        self.profile = profile
        self.hw = hw

    def run(self) -> BlameResult:
        result = BlameResult()
        for qualified, rec in self.profile.records.items():
            if rec.latency_samples <= 0:
                continue
            edges = self.graph.deps_of(qualified, alive_only=True)
            consumer = self.graph.instruction(qualified)
            if not edges:
                result.self_blame.append(SelfBlame(
                    qualified=qualified, cycles=rec.latency_samples,
                    subcategory=_self_subcategory(consumer,
                                                  rec.dominant_stall)))
                continue
            self._attribute(result, qualified, rec.latency_samples, edges)
        self._occupancy_blame(result)
        self._sync_resource_blame(result)
        self._scheduler_contention_blame(result)
        self._occupancy_limited_blame(result)
        return result

    def _occupancy_limited_blame(self, result: BlameResult) -> None:
        """Surface failed-latency-hiding events as a typed evidence channel
        naming the stalled consumer, its producer, and the hidden/exposed
        split (only present under a multi-wave OccupancyModel)."""
        pressure = getattr(self.profile, "occupancy_pressure", None)
        if pressure is None:
            return
        for ev in getattr(pressure, "events", []):
            w = ev.get("weight", 1.0)
            result.occupancy_limited.append(OccupancyLimitedBlame(
                consumer=ev["consumer"], blocker=ev.get("blocker") or "",
                queue=ev.get("queue", 0), stall_class=ev["stall_class"],
                hidden_cycles=ev["hidden_cycles"] * w,
                exposed_cycles=ev["exposed_cycles"] * w))
        result.occupancy_limited.sort(key=lambda b: -b.cycles)

    def _scheduler_contention_blame(self, result: BlameResult) -> None:
        """Surface issue-port arbitration events as a typed evidence
        channel naming the queue and the occupying instruction."""
        pressure = getattr(self.profile, "issue_pressure", None)
        if pressure is None:
            return
        for ev in getattr(pressure, "events", []):
            result.scheduler_contention.append(SchedulerContentionBlame(
                consumer=ev["consumer"], holder=ev.get("holder") or "",
                queue=ev.get("queue", 0), pipe=ev.get("pipe", ""),
                stall_class=ev["stall_class"],
                cycles=ev["stall_cycles"] * ev.get("weight", 1.0)))
        result.scheduler_contention.sort(key=lambda b: -b.cycles)

    def _sync_resource_blame(self, result: BlameResult) -> None:
        """Surface scoreboard oversubscription events (§III-E) as a typed
        evidence channel naming the exact resource instance consumed."""
        pressure = getattr(self.profile, "sync_pressure", None)
        if pressure is None:
            return
        for pool in pressure.pools:
            for ev in pool.get("events", []):
                result.sync_resource.append(SyncResourceBlame(
                    consumer=ev["consumer"], resource=ev["instance"],
                    pool=pool["pool"], holder=ev.get("holder") or "",
                    cycles=ev["stall_cycles"] * ev.get("weight", 1.0)))
        result.sync_resource.sort(key=lambda b: -b.cycles)

    def _occupancy_blame(self, result: BlameResult) -> None:
        """Diagnose issue-stream dominators with no dependency stalls."""
        makespan = max(self.profile.makespan_cycles, 1.0)
        for qualified, rec in self.profile.records.items():
            if rec.latency_samples > 0 or rec.total_samples < 0.15 * makespan:
                continue
            instr = self.graph.instruction(qualified)
            if instr is None or instr.op_class in (
                    OpClass.CONTROL, OpClass.TUPLE, OpClass.PARAMETER,
                    OpClass.CONSTANT):
                continue  # control wrappers absorb their body's occupancy
            sub = self._occupancy_subcategory(instr)
            result.occupancy_blame.append(SelfBlame(
                qualified=qualified, cycles=rec.total_samples,
                subcategory=sub))
        result.occupancy_blame.sort(key=lambda s: -s.cycles)

    def _occupancy_subcategory(self, instr: Instruction) -> str:
        if instr.opcode in ("gather", "dynamic-slice", "scatter",
                            "dynamic-update-slice"):
            return "indirect addressing"
        if instr.opcode == "fusion":
            for cname in instr.called_computations:
                callee = self.graph.module.computations.get(cname)
                if callee is None:
                    continue
                if any(i.opcode in ("gather", "scatter")
                       for i in callee.instructions):
                    return "indirect addressing"
        mem_s = self.hw.memory_seconds(instr)
        comp_s = self.hw.compute_seconds(instr)
        coll_s = self.hw.collective_seconds(instr)
        best = max(mem_s, comp_s, coll_s)
        if best == coll_s and coll_s > 0:
            return "collective wait"
        if best == mem_s and mem_s > 0:
            return "memory latency"
        return "compute saturation"

    def _attribute(self, result: BlameResult, consumer_q: str, s_j: float,
                   edges: List[Edge]) -> None:
        rec = self.profile.records.get(consumer_q)
        dists, effs, issues, matches = [], [], [], []
        producers: List[Optional[Instruction]] = []
        for e in edges:
            producer = self.graph.instruction(e.producer)
            producers.append(producer)
            dists.append(max(e.avg_instr_distance, 1.0))
            effs.append(producer_efficiency(producer, self.hw)
                        if producer is not None else 1.0)
            prec = self.profile.records.get(e.producer)
            issues.append(prec.exec_count if prec is not None else 0.0)
            if rec is not None and producer is not None:
                m = sum(rec.stall_fraction(c)
                        for c in edge_stall_classes(e, producer))
                matches.append(max(m, _MATCH_FLOOR))
            else:
                matches.append(1.0)

        d_min = min(dists)
        e_min = min(effs)
        n_sum = sum(issues) or 1.0
        weights = []
        for d, eff, n, m in zip(dists, effs, issues, matches):
            rd = d_min / d
            re_ = e_min / eff
            ri = (n / n_sum) if n_sum > 0 else 1.0 / len(edges)
            weights.append(rd * re_ * ri * m)
        wsum = sum(weights)
        if wsum <= _EPS:
            weights = [1.0] * len(edges)
            wsum = float(len(edges))
        for e, producer, w, d, eff, n, m in zip(
                edges, producers, weights, dists, effs, issues, matches):
            cycles = s_j * w / wsum
            if cycles <= 0:
                continue
            result.entries.append(BlameEntry(
                producer=e.producer, consumer=consumer_q, kind=e.kind,
                cycles=cycles,
                factors={"dist": d_min / d, "eff": e_min / eff,
                         "issue": n / n_sum, "match": m}))
            result.by_producer[e.producer] = \
                result.by_producer.get(e.producer, 0.0) + cycles


def attribute_blame(graph: DependencyGraph, profile: StallProfile,
                    hw: HardwareModel) -> BlameResult:
    return BlameAttributor(graph, profile, hw).run()
