"""Virtual PC sampling: a deterministic in-order issue simulator.

The paper consumes hardware PC-sampling stall profiles (CUPTI / ROCprofiler /
Level Zero).  This container is CPU-only with the TPU as *target*, so LEO's
input profile is produced by an analytical simulator that plays the role of
the sampling hardware:

* instructions issue in program order; each occupies the issue slot for its
  throughput cost (`hw.issue_cycles`) and produces its result after its
  roofline latency (`hw.latency_cycles`);
* HBM traffic, async copies and async collective starts retire early and
  complete in the background — the TPU analogue of latency hiding — so their
  latency is only *exposed* when a consumer catches up with them;
* when an instruction cannot issue because an operand (or synchronization
  source) is not ready, the gap is recorded as *latency samples* against
  that instruction, classified by the blocking producer's class into the
  unified stall taxonomy (§II-D);
* while-loops are simulated with a warm-up pass then a steady-state pass in
  which loop-carried operands become available at (previous-iteration
  completion − body makespan), and per-op statistics scale by trip count.

The records mimic NVIDIA's two-level counters: ``total_samples`` (issue +
stall occupancy, "samples") and ``latency_samples`` (stall-only).  The
resulting profile is *shared ground truth* with `roofline.py` — the same
hardware model produces the roofline terms, the stall profile, and the
makespan used as estimated step time by the benchmark harness.

On real hardware, `StallProfile` can instead be populated from measured
xplane/profiler data — everything downstream of this interface is unchanged
(the paper's modular "hpcanalysis" boundary).

Multi-stream issue (the GPA-style scheduler model): each backend's
:class:`~repro.core.hwmodel.IssueModel` declares K concurrent issue queues
of a given width plus a scheduler policy (static ``round_robin`` vs
work-conserving ``greedy_oldest``).  Independently-schedulable instructions
interleave across queues, each queue drives its own per-queue view of the
backend's :class:`~repro.core.backends.SyncScoreboard` (pools replicate or
stay device-global per their declared scope), and *issue-port contention*
— an instruction whose operands are ready but whose queue is still
occupied — is charged as `StallClass.NOT_SELECTED` (occupant on a
different execution pipe: the arbiter picked other work) or
`StallClass.PIPE_BUSY` (occupant on the same pipe: the functional unit
itself is saturated).  With one single-width queue there is no
arbitration, so the model degenerates *byte-identically* to the in-order
single-stream simulator — the parity anchor for all pre-multi-stream
goldens.

Known simplifications (mirroring paper §Limitations): branch probabilities
are not modeled (all `conditional` branches simulate as executed); on a
``queues=1, width=1`` backend (the TPUs' in-order VLIW stream) the
`not_selected`/`pipe_busy` buckets stay structurally empty.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .hwmodel import (HardwareModel, IssueModel, OccupancyModel,
                      SINGLE_ISSUE, SINGLE_WAVE)
from .isa import Instruction, Module, OpClass, StallClass, SyncKind

#: Issue-port contention events retained per report (aggregate counters
#: keep accumulating past the cap), mirroring the sync scoreboard's cap.
_MAX_ISSUE_EVENTS = 64

#: Stall classes co-resident waves can hide (dependence/sync waits — the
#: machine switches to another wave while this one waits on a producer).
#: Scheduler-contention classes are NOT hideable: another wave would lose
#: the same arbitration, so `not_selected`/`pipe_busy` keep their class.
_HIDEABLE_STALLS = frozenset({
    StallClass.MEM_DEP, StallClass.EXEC_DEP, StallClass.COLLECTIVE_WAIT,
    StallClass.SYNC_WAIT,
})

#: Execution-pipe families used to split port contention into
#: `pipe_busy` (same pipe saturated) vs `not_selected` (arbitration loss).
_PIPE_OF = {
    OpClass.MATMUL: "mxu",
    OpClass.COMPUTE: "vpu",
    OpClass.REDUCE: "vpu",
    OpClass.FUSION: "vpu",
    OpClass.MEMORY_LOAD: "lsu",
    OpClass.MEMORY_STORE: "lsu",
    OpClass.DATA_MOVEMENT: "lsu",
    OpClass.SYNC_SET: "lsu",
    OpClass.SYNC_WAIT: "lsu",
    OpClass.COLLECTIVE: "ici",
}


def pipe_of(instr: Instruction) -> str:
    """Execution-pipe family an instruction occupies."""
    return _PIPE_OF.get(instr.op_class, "ctl")


def classify_blocker(consumer: Instruction,
                     blocker: Optional[Instruction]) -> StallClass:
    if blocker is None:
        return StallClass.NONE
    cls = blocker.op_class
    if cls in (OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE,
               OpClass.DATA_MOVEMENT, OpClass.PARAMETER, OpClass.CONSTANT):
        return StallClass.MEM_DEP
    if cls is OpClass.COLLECTIVE:
        return StallClass.COLLECTIVE_WAIT
    if cls is OpClass.SYNC_SET:
        return StallClass.COLLECTIVE_WAIT if blocker.comm_bytes > 0 \
            else StallClass.MEM_DEP
    if cls in (OpClass.SYNC_WAIT, OpClass.TUPLE, OpClass.CONTROL):
        return StallClass.SYNC_WAIT
    return StallClass.EXEC_DEP


@dataclass
class PCSampleRecord:
    qualified: str
    total_samples: float = 0.0     # issue occupancy + stalls (NVIDIA "samples")
    latency_samples: float = 0.0   # stall-only ("latency samples")
    stall_breakdown: Dict[StallClass, float] = field(default_factory=dict)
    exec_count: float = 0.0
    blockers: Dict[str, float] = field(default_factory=dict)  # qualified -> cycles

    def add_stall(self, cls: StallClass, cycles: float,
                  blocker: Optional[str]) -> None:
        if cycles <= 0:
            return
        self.latency_samples += cycles
        self.stall_breakdown[cls] = self.stall_breakdown.get(cls, 0.0) + cycles
        if blocker:
            self.blockers[blocker] = self.blockers.get(blocker, 0.0) + cycles

    @property
    def dominant_stall(self) -> StallClass:
        if not self.stall_breakdown:
            return StallClass.NONE
        return max(self.stall_breakdown.items(), key=lambda kv: kv[1])[0]

    def stall_fraction(self, cls: StallClass) -> float:
        if self.latency_samples <= 0:
            return 0.0
        return self.stall_breakdown.get(cls, 0.0) / self.latency_samples


@dataclass
class IssuePressureReport:
    """Per-queue issue-port pressure (JSON-pure, Diagnosis-embeddable).

    The scheduler-contention counterpart of
    :class:`~repro.core.backends.SyncPressureReport`: per queue, how much
    work it issued, how long it was occupied, and how many cycles ready
    instructions spent losing arbitration (`not_selected`) or waiting on a
    saturated execution pipe (`pipe_busy`), plus capped per-event detail
    naming the blocking occupant.
    """

    queues: int = 1
    width: int = 1
    policy: str = "round_robin"
    per_queue: List[Dict[str, Any]] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def not_selected_cycles(self) -> float:
        return sum(q.get("not_selected_cycles", 0.0) for q in self.per_queue)

    @property
    def pipe_busy_cycles(self) -> float:
        return sum(q.get("pipe_busy_cycles", 0.0) for q in self.per_queue)

    @property
    def contention_cycles(self) -> float:
        return self.not_selected_cycles + self.pipe_busy_cycles

    @property
    def contended(self) -> bool:
        return self.contention_cycles > 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "queues": self.queues,
            "width": self.width,
            "policy": self.policy,
            "contended": self.contended,
            "contention_cycles": self.contention_cycles,
            "not_selected_cycles": self.not_selected_cycles,
            "pipe_busy_cycles": self.pipe_busy_cycles,
            "per_queue": self.per_queue,
            "events": self.events,
        }


class _IssueState:
    """Mutable per-run collector behind an :class:`IssuePressureReport`."""

    def __init__(self, issue: IssueModel):
        self.issue = issue
        k = issue.queues
        self.issued = [0.0] * k
        self.busy_cycles = [0.0] * k
        self.not_selected = [0.0] * k
        self.pipe_busy = [0.0] * k
        self.events: List[Dict[str, Any]] = []

    def note_issue(self, queue: int, weight: float, cost: float) -> None:
        self.issued[queue] += weight
        self.busy_cycles[queue] += weight * cost

    def note_contention(self, queue: int, cls: StallClass, cycles: float,
                        weight: float, consumer: str, holder: Optional[str],
                        pipe: str, at: float) -> None:
        if cls is StallClass.PIPE_BUSY:
            self.pipe_busy[queue] += cycles * weight
        else:
            self.not_selected[queue] += cycles * weight
        if len(self.events) < _MAX_ISSUE_EVENTS:
            self.events.append({
                "consumer": consumer, "holder": holder or "",
                "queue": queue, "pipe": pipe, "stall_class": cls.value,
                "stall_cycles": cycles, "at": at, "weight": weight,
            })

    def report(self) -> IssuePressureReport:
        return IssuePressureReport(
            queues=self.issue.queues, width=self.issue.width,
            policy=self.issue.policy,
            per_queue=[{
                "queue": i,
                "issued": self.issued[i],
                "busy_cycles": self.busy_cycles[i],
                "not_selected_cycles": self.not_selected[i],
                "pipe_busy_cycles": self.pipe_busy[i],
            } for i in range(self.issue.queues)],
            events=list(self.events))


@dataclass
class OccupancyPressureReport:
    """Per-queue latency-hiding pressure (JSON-pure, Diagnosis-embeddable).

    The wave-residency counterpart of :class:`IssuePressureReport`: per
    issue queue, how many hideable stall cycles co-resident waves covered
    (``hidden_cycles``), how many leaked through (``exposed_cycles``), and
    how many of the leaked cycles were *partially* hidden — the
    `StallClass.OCCUPANCY_LIMITED` signature of latency hiding that ran
    out of waves (``occupancy_limited_cycles``) — plus capped per-event
    detail naming the stalled consumer and its producer.
    """

    waves: int = 1
    limiter: str = "none"
    window_cycles: float = 0.0
    per_queue: List[Dict[str, Any]] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def hidden_cycles(self) -> float:
        return sum(q.get("hidden_cycles", 0.0) for q in self.per_queue)

    @property
    def exposed_cycles(self) -> float:
        return sum(q.get("exposed_cycles", 0.0) for q in self.per_queue)

    @property
    def occupancy_limited_cycles(self) -> float:
        return sum(q.get("occupancy_limited_cycles", 0.0)
                   for q in self.per_queue)

    @property
    def hidden_fraction(self) -> float:
        """Fraction of hideable stall cycles co-resident waves covered."""
        total = self.hidden_cycles + self.exposed_cycles
        return self.hidden_cycles / total if total > 0 else 0.0

    @property
    def limited(self) -> bool:
        """True when latency hiding ran out of waves mid-stall."""
        return self.occupancy_limited_cycles > 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "waves": self.waves,
            "limiter": self.limiter,
            "window_cycles": self.window_cycles,
            "limited": self.limited,
            "hidden_cycles": self.hidden_cycles,
            "exposed_cycles": self.exposed_cycles,
            "occupancy_limited_cycles": self.occupancy_limited_cycles,
            "hidden_fraction": self.hidden_fraction,
            "per_queue": self.per_queue,
            "events": self.events,
        }


class _OccState:
    """Mutable per-run collector behind an :class:`OccupancyPressureReport`.

    Credit-based analytical hiding: every issued instruction banks
    ``(W-1) * issue_cost`` cycles of co-resident-wave issue capacity on its
    queue (capped at ``(W-1) * window_cycles`` — each sibling wave only has
    so much independent work), and a hideable stall first drains that bank
    before charging the machine.  Single-pass, so native-W analysis costs
    the same as the W=1 sampler.
    """

    def __init__(self, occ: OccupancyModel, queues: int):
        self.occ = occ
        self.queues = queues
        self.credit = [0.0] * queues
        self.hidden = [0.0] * queues
        self.exposed = [0.0] * queues
        self.limited = [0.0] * queues
        self.events: List[Dict[str, Any]] = []
        self._cap = (occ.waves - 1) * occ.window_cycles

    def note_issue(self, queue: int, cost: float) -> None:
        if cost <= 0:
            return
        self.credit[queue] = min(
            self.credit[queue] + (self.occ.waves - 1) * cost, self._cap)

    def absorb(self, queue: int, stall: float, weight: float, consumer: str,
               blocker: Optional[str], cls: StallClass,
               at: float) -> Tuple[float, float]:
        """Drain hiding credit against one stall; returns (hidden, exposed)
        in unweighted cycles."""
        hidden = min(stall, self.credit[queue])
        self.credit[queue] -= hidden
        exposed = stall - hidden
        self.hidden[queue] += hidden * weight
        self.exposed[queue] += exposed * weight
        if hidden > 0 and exposed > 0:
            # partial hiding: the OCCUPANCY_LIMITED signature
            self.limited[queue] += exposed * weight
            if len(self.events) < _MAX_ISSUE_EVENTS:
                self.events.append({
                    "consumer": consumer, "blocker": blocker or "",
                    "queue": queue, "stall_class": cls.value,
                    "hidden_cycles": hidden, "exposed_cycles": exposed,
                    "at": at, "weight": weight,
                })
        return hidden, exposed

    def report(self) -> OccupancyPressureReport:
        return OccupancyPressureReport(
            waves=self.occ.waves, limiter=self.occ.limiter,
            window_cycles=self.occ.window_cycles,
            per_queue=[{
                "queue": i,
                "hidden_cycles": self.hidden[i],
                "exposed_cycles": self.exposed[i],
                "occupancy_limited_cycles": self.limited[i],
            } for i in range(self.queues)],
            events=list(self.events))


class _Ports:
    """Issue slots of one simulated computation activation: K queues of
    `width` slots each, every slot tracking when it frees and what
    occupies it.  One activation's ports are independent of its callees'
    (a `call`/`while` op occupies its caller's slot for the whole body)."""

    def __init__(self, issue: IssueModel, t0: float):
        self.issue = issue
        n = issue.queues * issue.width
        self.free = [t0] * n
        self.occupant: List[Optional[str]] = [None] * n
        self.pipe: List[Optional[str]] = [None] * n
        self._rr = 0

    def pick(self) -> int:
        """Choose a slot per the scheduler policy; returns its index."""
        w = self.issue.width
        if self.issue.policy == "greedy_oldest":
            # work-conserving: the earliest-freeing slot anywhere
            return min(range(len(self.free)), key=lambda i: (self.free[i], i))
        # static round-robin queue assignment; earliest slot within it
        q = self._rr % self.issue.queues
        self._rr += 1
        base = q * w
        return min(range(base, base + w), key=lambda i: (self.free[i], i))

    def queue_of(self, slot: int) -> int:
        return slot // self.issue.width

    def occupy(self, slot: int, until: float, qualified: str,
               pipe: str) -> None:
        self.free[slot] = until
        self.occupant[slot] = qualified
        self.pipe[slot] = pipe


@dataclass
class StallProfile:
    hw_name: str
    records: Dict[str, PCSampleRecord] = field(default_factory=dict)
    makespan_cycles: float = 0.0
    clock_hz: float = 1e9
    # Per-pool §III-E resource pressure (SyncPressureReport) when the
    # profile was produced by a sampler driving a SyncModel scoreboard;
    # None for measured profiles and sync-less backends.
    sync_pressure: Optional[object] = None
    # Per-queue issue-port pressure (IssuePressureReport) when produced by
    # the virtual sampler; None for measured profiles.
    issue_pressure: Optional[object] = None
    # Per-queue latency-hiding pressure (OccupancyPressureReport) when the
    # profile was produced under a multi-wave OccupancyModel; None for
    # measured profiles and for W=1 runs (keeping single-wave profile
    # fingerprints byte-identical to the pre-occupancy sampler).
    occupancy_pressure: Optional[object] = None
    # (SyncKind, computation, tag) -> concrete resource instance actually
    # assigned by the sampler's scoreboard; consumed by the sync_edges
    # pass so static edge annotations name the same hardware the dynamic
    # SYNC_RESOURCE events blame.  None for measured profiles.
    sync_assignment: Optional[Dict] = None

    @property
    def makespan_seconds(self) -> float:
        return self.makespan_cycles / self.clock_hz

    @property
    def total_stall_cycles(self) -> float:
        return sum(r.latency_samples for r in self.records.values())

    def record(self, qualified: str) -> PCSampleRecord:
        if qualified not in self.records:
            self.records[qualified] = PCSampleRecord(qualified=qualified)
        return self.records[qualified]

    def top_stalled(self, n: int = 10) -> List[PCSampleRecord]:
        return sorted((r for r in self.records.values()
                       if r.latency_samples > 0),
                      key=lambda r: -r.latency_samples)[:n]


# Computation kinds that are not independently scheduled streams: their cost
# is folded into the calling op (fusions) or they are scalar glue (reduce
# combiners, loop conditions).
_SKIP_KINDS = ("fusion", "reduce", "loop_cond")


class VirtualSampler:
    def __init__(self, module: Module, hw: HardwareModel, sync=None):
        self.module = module
        self.hw = hw
        self.issue: IssueModel = getattr(hw, "issue", SINGLE_ISSUE) \
            or SINGLE_ISSUE
        self.occupancy: OccupancyModel = getattr(hw, "occupancy",
                                                 SINGLE_WAVE) or SINGLE_WAVE
        # Optional backend SyncModel (duck-typed to avoid an import cycle
        # with repro.core.backends).  Two behaviors: the async_collectives
        # knob (vendors whose collectives block the issuing queue, e.g.
        # queue-ordered oneCCL, pay the transfer latency at *issue*), and —
        # when the model carries resource pools — a stateful scoreboard
        # that serializes oversubscribed sync resources (§III-E): an async
        # start with every barrier slot / waitcnt counter / SWSB token in
        # flight inherits the oldest holder's remaining latency, recorded
        # as SYNC_RESOURCE stall cycles.  Under a multi-queue issue model
        # the scoreboard replicates queue-scoped pools per queue.
        self.sync = sync
        self.scoreboard = None
        if sync is not None and hasattr(sync, "scoreboard") \
                and getattr(sync, "pools", ()):
            self.scoreboard = sync.scoreboard(
                realloc_cycles=getattr(hw, "sync_realloc_cycles", 0.0),
                queues=self.issue.queues, waves=self.occupancy.waves)
        self._istate = _IssueState(self.issue)
        # Latency-hiding credit tracker; None at W=1 so the single-wave
        # path is bit-for-bit the pre-occupancy sampler.
        self._wavestate: Optional[_OccState] = (
            _OccState(self.occupancy, self.issue.queues)
            if self.occupancy.multi_wave else None)
        self._assignment: Dict[Tuple[SyncKind, str, str], str] = {}

    # -- public ---------------------------------------------------------------

    def run(self) -> StallProfile:
        profile = StallProfile(hw_name=self.hw.name, clock_hz=self.hw.clock_hz)
        entry = self.module.entry_computation
        makespan = self._simulate(entry, 0.0, {}, 1.0, profile, depth=0,
                                  board=self.scoreboard)
        if self._wavestate is not None:
            # Multi-wave makespan: hidden stall cycles are covered by
            # co-resident wave issue, so they compress the critical path —
            # floored by raw/W (waves can at best W-fold overlap the
            # program) and by the busiest queue's issue occupancy (work
            # that must be issued cannot be hidden).
            occ_report = self._wavestate.report()
            profile.occupancy_pressure = occ_report
            busy_floor = max(self._istate.busy_cycles, default=0.0)
            makespan = max(makespan - occ_report.hidden_cycles,
                           makespan / self.occupancy.waves, busy_floor)
        profile.makespan_cycles = makespan
        if self.scoreboard is not None:
            profile.sync_pressure = self.scoreboard.report()
            profile.sync_assignment = dict(self._assignment)
        profile.issue_pressure = self._istate.report()
        self._seed_unsampled(profile)
        return profile

    # -- simulation -------------------------------------------------------------

    def _simulate(self, comp, t0: float, env: Dict[str, float], mult: float,
                  profile: StallProfile, depth: int,
                  loop_ctx: Optional[Dict[int, float]] = None,
                  board=None) -> float:
        """Simulate one computation; returns its end time (cycles)."""
        if depth > 32:
            return t0
        local_env = env
        params = {p.name: p for p in comp.parameters}
        ports = _Ports(self.issue, t0)
        multi = self.issue.multi_stream
        end = t0
        for instr in comp.instructions:
            q = instr.qualified_name
            if instr.op_class in (OpClass.PARAMETER, OpClass.CONSTANT):
                local_env[q] = t0
                rec = profile.record(q)
                rec.exec_count += mult
                continue

            ready, blocker = self._ready_time(comp, instr, local_env, params,
                                              loop_ctx, t0)
            slot = ports.pick()
            pf = ports.free[slot]
            data_ready = max(pf, ready)
            qidx = ports.queue_of(slot)
            res_ready, res_blocker, acquired = self._acquire_sync(
                board, instr, q, data_ready, mult, queue=qidx)
            issue_at = max(data_ready, res_ready)
            rec = profile.record(q)
            rec.exec_count += mult
            issue_cost = self._issue_cycles(instr, env, profile, issue_at,
                                            mult, depth, board)
            # Stall anatomy: data wait (measured from when the issue slot
            # freed — the single-stream convention), issue-port contention
            # (data ready, slot busy; only meaningful with >1 port: a lone
            # in-order stream has no arbiter to lose), and sync-resource
            # serialization on top.
            data_stall = max(0.0, ready - pf)
            port_stall = max(0.0, pf - ready) if multi else 0.0
            res_stall = issue_at - data_ready
            wstate = self._wavestate
            if data_stall > 0:
                cls = classify_blocker(instr, blocker)
                bname = blocker.qualified_name if blocker else None
                if wstate is not None and cls in _HIDEABLE_STALLS:
                    # Co-resident waves absorb the wait from banked issue
                    # credit; a fully-hidden stall charges nothing, a
                    # partially-hidden one reclassifies its exposed tail
                    # as OCCUPANCY_LIMITED (hiding ran out of waves).
                    hidden, data_stall = wstate.absorb(
                        qidx, data_stall, mult, consumer=q, blocker=bname,
                        cls=cls, at=ready)
                    if hidden > 0 and data_stall > 0:
                        cls = StallClass.OCCUPANCY_LIMITED
                if data_stall > 0:
                    rec.add_stall(cls, mult * data_stall, bname)
            if port_stall > 0:
                pipe = pipe_of(instr)
                occupant = ports.occupant[slot]
                cls = StallClass.PIPE_BUSY if ports.pipe[slot] == pipe \
                    else StallClass.NOT_SELECTED
                rec.add_stall(cls, mult * port_stall, occupant)
                self._istate.note_contention(qidx, cls, port_stall, mult,
                                             consumer=q, holder=occupant,
                                             pipe=pipe, at=ready)
            if res_stall > 0:
                res_cls = StallClass.SYNC_RESOURCE
                if wstate is not None:
                    hidden, res_stall = wstate.absorb(
                        qidx, res_stall, mult, consumer=q,
                        blocker=res_blocker, cls=res_cls, at=data_ready)
                    if hidden > 0 and res_stall > 0:
                        res_cls = StallClass.OCCUPANCY_LIMITED
                if res_stall > 0:
                    rec.add_stall(res_cls, mult * res_stall, res_blocker)
            rec.total_samples += mult * (data_stall + port_stall + res_stall
                                         + issue_cost)
            completion = issue_at + self._latency_cycles(instr, env, profile,
                                                         issue_at, mult,
                                                         depth)
            local_env[q] = completion
            for kind, tag in acquired:
                board.complete(kind, tag, completion)
            ports.occupy(slot, issue_at + issue_cost, q, pipe_of(instr))
            # Control ops' issue_cost is their simulated body's makespan;
            # the body's own instructions already charge their queues'
            # occupancy, so the wrapper records an issue event but no
            # busy cycles (otherwise per-queue busy would double-count
            # and could exceed the makespan on loop-heavy programs).
            queue_cost = 0.0 \
                if instr.opcode in ("while", "call", "conditional") \
                else issue_cost
            self._istate.note_issue(qidx, mult, queue_cost)
            if wstate is not None:
                # Each issued instruction banks (W-1) x its cost of
                # co-resident-wave issue capacity on this queue (control
                # ops excluded: their bodies' instructions already bank).
                wstate.note_issue(qidx, queue_cost)
            end = max(end, issue_at + issue_cost)
        return end

    def _acquire_sync(self, board, instr: Instruction, q: str, now: float,
                      mult: float, queue: int = 0):
        """Retire waited resources and claim set ones on the scoreboard.

        Returns (resource_ready, blocking holder qualified-name or None,
        [(kind, tag)] acquired — their completion is noted once known)."""
        si = instr.sync
        if board is None or si.kind is None:
            return now, None, ()
        # Tags are computation-scoped: identifiers are instruction/value
        # names, which are only unique within their computation — without
        # the scope, same-named sync ops in different computations would
        # alias one allocation.
        scope = instr.computation
        for tag in si.waits:
            board.retire(si.kind, f"{scope}::{tag}", drain_to=si.counter)
        res_ready, res_blocker = now, None
        acquired = []
        for tag in si.sets:
            scoped = f"{scope}::{tag}"
            acq = board.acquire(si.kind, scoped, consumer=q, now=now,
                                weight=mult, queue=queue)
            if acq is None:
                continue
            acquired.append((si.kind, scoped))
            self._assignment[(si.kind, scope, tag)] = acq.instance
            if acq.available_at > res_ready:
                res_ready = acq.available_at
                res_blocker = acq.evicted_holder
        return res_ready, res_blocker, acquired

    def _ready_time(self, comp, instr: Instruction, env: Dict[str, float],
                    params: Dict[str, Instruction],
                    loop_ctx: Optional[Dict[int, float]],
                    t0: float) -> Tuple[float, Optional[Instruction]]:
        ready = t0
        blocker: Optional[Instruction] = None

        def consider(name: str, time: float) -> None:
            nonlocal ready, blocker
            if time > ready:
                ready = time
                blocker = comp.get(name) or self.module.find(name)

        # Loop-carried values: gte(state_param, i) in steady state.
        if loop_ctx is not None and instr.opcode == "get-tuple-element" and \
                instr.operands and instr.operands[0] in params:
            slot = int(instr.attributes.get("index", 0))
            if slot in loop_ctx:
                carried = loop_ctx[slot]
                if carried > ready:
                    ready = carried
                    blocker = self._slot_def(comp, slot)
                return ready, blocker

        for op in instr.operands:
            q = f"{comp.name}::{op}"
            consider(op, env.get(q, t0))
        # Synchronization waits (barrier / waitcnt semantics).
        for waited in instr.sync.waits:
            q = f"{comp.name}::{waited}"
            consider(waited, env.get(q, t0))
        return ready, blocker

    def _slot_def(self, comp, slot: int) -> Optional[Instruction]:
        root = comp.root
        if root is not None and root.opcode == "tuple" and \
                slot < len(root.operands):
            return comp.get(root.operands[slot])
        return root

    def _issue_cycles(self, instr: Instruction, env, profile, issue_at, mult,
                      depth, board=None) -> float:
        if instr.opcode == "while":
            return self._simulate_while(instr, env, profile, issue_at, mult,
                                        depth, board)
        if instr.opcode in ("call", "conditional"):
            return self._simulate_called(instr, env, profile, issue_at, mult,
                                         depth, board)
        if instr.op_class is OpClass.COLLECTIVE and self.sync is not None \
                and not getattr(self.sync, "async_collectives", True):
            return self.hw.latency_cycles(instr)
        return self.hw.issue_cycles(instr)

    def _latency_cycles(self, instr: Instruction, env, profile, issue_at,
                        mult, depth) -> float:
        if instr.opcode in ("while", "call", "conditional"):
            # completion == end of the simulated body; issue_cycles covered it
            return self._last_control_cost
        return self.hw.latency_cycles(instr)

    _last_control_cost: float = 0.0

    def _simulate_called(self, instr: Instruction, env, profile, issue_at,
                         mult, depth, board=None) -> float:
        end = issue_at
        for cname in instr.called_computations:
            callee = self.module.computations.get(cname)
            if callee is None or callee.kind in _SKIP_KINDS:
                continue
            sub_end = self._simulate(callee, issue_at, env, mult, profile,
                                     depth + 1, board=board)
            end = max(end, sub_end)
        self._last_control_cost = end - issue_at
        return end - issue_at

    def _simulate_while(self, instr: Instruction, env, profile, issue_at,
                        mult, depth, board=None) -> float:
        body = None
        for cname in instr.called_computations:
            c = self.module.computations.get(cname)
            if c is not None and c.kind == "loop_body":
                body = c
        if body is None:
            self._last_control_cost = 0.0
            return 0.0
        trips = max(1, instr.trip_count)

        # Pass A (warm-up): no loop-carried availability info.  Runs on a
        # forked scoreboard and a scratch issue-pressure collector so
        # warm-up allocations/contention cannot pollute the steady-state
        # pressure stats.
        warm = StallProfile(hw_name=self.hw.name, clock_hz=self.hw.clock_hz)
        env_a: Dict[str, float] = {}
        saved_istate = self._istate
        saved_wavestate = self._wavestate
        self._istate = _IssueState(self.issue)
        if saved_wavestate is not None:
            self._wavestate = _OccState(self.occupancy, self.issue.queues)
        try:
            end_a = self._simulate(body, issue_at, env_a, 1.0, warm,
                                   depth + 1, loop_ctx={},
                                   board=board.fork() if board is not None
                                   else None)
        finally:
            self._istate = saved_istate
            self._wavestate = saved_wavestate
        makespan_a = max(end_a - issue_at, 1.0)

        # Steady-state loop context: slot value available at
        # (producer completion in previous iteration) - body makespan.
        loop_ctx: Dict[int, float] = {}
        root = body.root
        if root is not None and root.opcode == "tuple":
            for slot, opname in enumerate(root.operands):
                q = f"{body.name}::{opname}"
                if q in env_a:
                    loop_ctx[slot] = env_a[q] - makespan_a

        # Pass B (steady state), recorded with weight mult * trips.
        env_b: Dict[str, float] = {}
        end_b = self._simulate(body, issue_at, env_b, mult * trips, profile,
                               depth + 1, loop_ctx=loop_ctx, board=board)
        makespan_b = max(end_b - issue_at, 1.0)
        self._last_control_cost = trips * makespan_b
        return self._last_control_cost

    def _seed_unsampled(self, profile: StallProfile) -> None:
        """Retain unsampled producers (paper §III-B): every instruction gets
        a record so address-generation chains can receive blame.  Fusion- and
        combiner-inner instructions execute as part of their caller, so they
        inherit its execution multiplier (Stage-4 pruning must not discard
        them as dead)."""
        mults = self._execution_multipliers()
        for instr in self.module.all_instructions():
            rec = profile.record(instr.qualified_name)
            if rec.exec_count == 0:
                comp = self.module.computations.get(instr.computation)
                if comp is not None and comp.kind in _SKIP_KINDS:
                    rec.exec_count = mults.get(instr.computation, 1.0)

    def _execution_multipliers(self) -> Dict[str, float]:
        mults: Dict[str, float] = {}

        def visit(comp_name: str, mult: float, depth: int) -> None:
            if depth > 16 or comp_name not in self.module.computations:
                return
            mults[comp_name] = max(mults.get(comp_name, 0.0), mult)
            for instr in self.module.computations[comp_name].instructions:
                inner = mult * (instr.trip_count if instr.opcode == "while"
                                else 1)
                for callee in instr.called_computations:
                    visit(callee, inner, depth + 1)

        if self.module.entry:
            visit(self.module.entry, 1.0, 0)
        return mults


def sample(module: Module, hw: HardwareModel) -> StallProfile:
    return VirtualSampler(module, hw).run()
