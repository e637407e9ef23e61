"""Evidence-pattern matchers mapping LEO diagnoses to candidate mutations.

The paper's case study 1 shows the same kernel wants *different* fixes per
vendor: contended named barriers on NVIDIA-class parts want batched
``bar.sync``, two oversubscribed waitcnt counters on AMD-class parts want
coalesced ``s_waitcnt``, and an Intel-class part whose 16 SBIDs never
contend wants issue-side restructuring instead.  Each :class:`Rule` here
encodes one such evidence pattern -> advice mapping:

  * ``matches(evidence)``    — does the diagnosed pressure shape fit?
  * ``candidates(evidence)`` — concrete :class:`Mutation` counterfactuals
    for the what-if engine to price;
  * ``phrase(evidence)``     — the advice text in the *vendor's* language
    (barriers vs waitcnt vs SBIDs), falling back to unified phrasing for
    vendors without a native entry.

Rules never rank themselves; :mod:`repro_torch.advisor.advisor` replays every
candidate and ranks by modeled speedup x confidence, GPA-style.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..core.backends import Backend
from ..core.isa import StallClass
from ..core.sampler import StallProfile
from .whatif import (
    CoalesceSyncTags,
    Mutation,
    ResizePool,
    ScaleLatency,
    SetIssue,
    SetOccupancy,
    TreeReduceChain,
)

__all__ = ["Evidence", "Rule", "RULES", "rule_by_name", "match_rules"]


@dataclass
class Evidence:
    """Everything a matcher may inspect, pre-digested from one analysis."""

    backend: Backend
    profile: StallProfile
    blame: Optional[object] = None      # BlameResult when the full pipeline ran

    # -- sync-resource evidence -----------------------------------------------

    def contended_pools(self) -> List[Dict[str, Any]]:
        sp = self.profile.sync_pressure
        if sp is None:
            return []
        return [p for p in sp.pools if p.get("evictions", 0) > 0]

    def pools_of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [p for p in self.contended_pools() if p.get("kind") == kind]

    # -- issue-fabric evidence ------------------------------------------------

    @property
    def issue(self):
        return self.backend.issue

    @property
    def not_selected_cycles(self) -> float:
        ip = self.profile.issue_pressure
        return ip.not_selected_cycles if ip is not None else 0.0

    @property
    def pipe_busy_cycles(self) -> float:
        ip = self.profile.issue_pressure
        return ip.pipe_busy_cycles if ip is not None else 0.0

    # -- wave-occupancy evidence ----------------------------------------------

    @property
    def native_occupancy(self):
        from ..core.hwmodel import SINGLE_WAVE
        return getattr(self.backend, "native_occupancy", None) or SINGLE_WAVE

    @property
    def occupancy_engaged(self) -> bool:
        """True when this analysis already modeled multi-wave residency."""
        return self.backend.occupancy.multi_wave

    @property
    def occupancy_limited_cycles(self) -> float:
        op = getattr(self.profile, "occupancy_pressure", None)
        return op.occupancy_limited_cycles if op is not None else 0.0

    @property
    def hidden_fraction(self) -> float:
        op = getattr(self.profile, "occupancy_pressure", None)
        return op.hidden_fraction if op is not None else 0.0

    # -- stall anatomy --------------------------------------------------------

    def stall_cycles(self, cls: StallClass) -> float:
        return sum(r.stall_breakdown.get(cls, 0.0)
                   for r in self.profile.records.values())

    @property
    def total_stall_cycles(self) -> float:
        return self.profile.total_stall_cycles

    def stall_share(self, cls: StallClass) -> float:
        total = self.total_stall_cycles
        return self.stall_cycles(cls) / total if total > 0 else 0.0

    def _count_starts(self) -> int:
        # profile records carry qualified names only; count *-start records
        return sum(1 for q in self.profile.records
                   if "-start" in q.rsplit("::", 1)[-1])

    def lines(self) -> List[str]:
        """Human-readable evidence summary attached to every Advice."""
        out: List[str] = []
        for p in self.contended_pools():
            out.append(
                f"pool {p['pool']!r} ({p['kind']}, {p.get('scope', '?')}-"
                f"scoped, capacity {p['capacity']}): {p['evictions']} "
                f"evictions, {p['contention_cycles']:.0f} contention "
                f"cycles, peak {p['peak_in_flight']} in flight")
        ip = self.profile.issue_pressure
        if ip is not None and ip.contended:
            out.append(
                f"issue fabric {self.issue.queues}x{self.issue.width} "
                f"({self.issue.policy}): not_selected "
                f"{ip.not_selected_cycles:.0f}, pipe_busy "
                f"{ip.pipe_busy_cycles:.0f} cycles")
        mem = self.stall_cycles(StallClass.MEM_DEP)
        if mem > 0:
            out.append(f"mem_dep stalls: {mem:.0f} cycles "
                       f"({self.stall_share(StallClass.MEM_DEP):.0%} of "
                       f"all stalls)")
        sync_res = self.stall_cycles(StallClass.SYNC_RESOURCE)
        if sync_res > 0:
            out.append(f"sync_resource stalls: {sync_res:.0f} cycles")
        op = getattr(self.profile, "occupancy_pressure", None)
        if op is not None:
            out.append(
                f"wave occupancy {op.waves}w ({op.limiter}-limited): "
                f"{op.hidden_cycles:.0f} cycles hidden "
                f"({op.hidden_fraction:.0%}), {op.exposed_cycles:.0f} "
                f"exposed past the resident waves")
        return out


@dataclass(frozen=True)
class Rule:
    """One evidence pattern -> candidate-mutation mapping."""

    name: str
    summary: str                        # unified (vendor-neutral) phrasing
    confidence: float                   # prior in (0, 1]; ranks with speedup
    matches: Callable[[Evidence], bool] = field(repr=False)
    candidates: Callable[[Evidence], List[Mutation]] = field(repr=False)
    #: vendor -> native phrasing; key is ``Backend.vendor``.
    vendor_phrasing: Dict[str, str] = field(default_factory=dict)

    def phrase(self, backend: Backend) -> str:
        return self.vendor_phrasing.get(backend.vendor, self.summary)


# -- matchers -----------------------------------------------------------------

def _m_barrier_storm(ev: Evidence) -> bool:
    """Device-scoped barrier/token pool at peak capacity with evictions."""
    return any(p.get("scope") == "device" for p in
               ev.pools_of_kind("barrier") + ev.pools_of_kind("token"))


def _coalesce_group(ev: Evidence, pool: Dict[str, Any]) -> int:
    """Group size that fits the storm back into the pool: enough async
    starts per shared identifier that distinct live tags <= what the part
    actually has (replicated per queue for queue-scoped pools)."""
    starts = max(1, ev._count_starts())
    effective = pool["capacity"]
    if pool.get("scope") == "queue":
        effective *= max(1, pool.get("queues", 1))
    return max(2, -(-starts // max(1, effective)))   # ceil div


def _grow_capacity(pool: Dict[str, Any]) -> int:
    """The grow-counterfactual target: peak live + every eviction is an
    upper bound on concurrent demand (peak_in_flight saturates at
    capacity, so it alone cannot size the grow)."""
    return pool["capacity"] + max(1, pool["evictions"])


def _c_batch_barriers(ev: Evidence) -> List[Mutation]:
    out: List[Mutation] = []
    for p in ev.contended_pools():
        if p.get("scope") == "device":
            out.append(CoalesceSyncTags(group=_coalesce_group(ev, p)))
            out.append(ResizePool(pool=p["pool"],
                                  capacity=_grow_capacity(p)))
    out.append(CoalesceSyncTags(group=2))
    return out


def _m_waitcnt_storm(ev: Evidence) -> bool:
    return bool(ev.pools_of_kind("waitcnt"))


def _c_coalesce_waits(ev: Evidence) -> List[Mutation]:
    out: List[Mutation] = []
    for p in ev.pools_of_kind("waitcnt"):
        out.append(CoalesceSyncTags(group=_coalesce_group(ev, p)))
        out.append(ResizePool(pool=p["pool"], capacity=_grow_capacity(p)))
    out.append(CoalesceSyncTags(group=2))
    return out


def _m_token_recycle(ev: Evidence) -> bool:
    """Queue-scoped token/SBID pool oversubscribed."""
    return any(p.get("scope") == "queue" for p in ev.pools_of_kind("token"))


def _c_recycle_tokens(ev: Evidence) -> List[Mutation]:
    out: List[Mutation] = []
    for p in ev.pools_of_kind("token"):
        if p.get("scope") == "queue":
            out.append(CoalesceSyncTags(group=_coalesce_group(ev, p)))
            out.append(ResizePool(pool=p["pool"],
                                  capacity=_grow_capacity(p)))
    return out


def _m_rebalance(ev: Evidence) -> bool:
    return (ev.issue.policy == "greedy_oldest"
            and ev.not_selected_cycles > 0
            and ev.not_selected_cycles >= ev.pipe_busy_cycles)


def _c_rebalance(ev: Evidence) -> List[Mutation]:
    q = ev.issue.queues
    out: List[Mutation] = [SetIssue(policy="round_robin"),
                           SetIssue(queues=max(2, q * 2)),
                           SetIssue(width=ev.issue.width + 1)]
    if ev.native_occupancy.multi_wave and not ev.occupancy_engaged:
        # more resident waves = more arbitration choices; priced jointly
        # with the sync-pool sharing it costs (never assumed to win)
        out.append(SetOccupancy())
    return out


def _m_pipe_pressure(ev: Evidence) -> bool:
    return (ev.pipe_busy_cycles > 0
            and ev.pipe_busy_cycles > ev.not_selected_cycles)


def _c_pipe_pressure(ev: Evidence) -> List[Mutation]:
    return [SetIssue(width=ev.issue.width * 2),
            SetIssue(policy="greedy_oldest")
            if ev.issue.policy == "round_robin"
            else SetIssue(policy="round_robin")]


def _m_raise_occupancy(ev: Evidence) -> bool:
    """Latency hiding is under-provisioned: either residency is not
    engaged while hideable latency dominates on a part that has wave
    slots to spend, or it IS engaged and stalls still leak past the
    resident waves (OCCUPANCY_LIMITED present)."""
    if not ev.native_occupancy.multi_wave:
        return False            # single-wave parts have no residency knob
    if ev.occupancy_engaged:
        return ev.occupancy_limited_cycles > 0
    # Mirror what the sampler's wave credit can actually absorb: the
    # _HIDEABLE_STALLS dependence waits plus SYNC_RESOURCE (the sampler
    # drains credit against resource serialization too).  Scheduler
    # contention (PIPE_BUSY / NOT_SELECTED) stays out — another wave
    # loses the same arbitration.
    hideable = (ev.stall_share(StallClass.MEM_DEP)
                + ev.stall_share(StallClass.EXEC_DEP)
                + ev.stall_share(StallClass.COLLECTIVE_WAIT)
                + ev.stall_share(StallClass.SYNC_WAIT)
                + ev.stall_share(StallClass.SYNC_RESOURCE))
    return hideable >= 0.25


def _c_raise_occupancy(ev: Evidence) -> List[Mutation]:
    native = ev.native_occupancy
    if ev.occupancy_engaged:
        cur = ev.backend.occupancy
        return [SetOccupancy(waves=cur.waves * 2),
                SetOccupancy(window_cycles=cur.window_cycles * 2)]
    return [SetOccupancy(),     # engage at the part's native residency
            SetOccupancy(waves=max(2, native.waves // 2))]


def _m_exposed_memory(ev: Evidence) -> bool:
    """Memory latency dominates while sync resources are NOT the problem:
    the copies fit the part's scoreboards, their latency is just exposed
    at the consumers — prefetch / software-pipeline territory."""
    if ev.contended_pools():
        return False
    return (ev.stall_share(StallClass.MEM_DEP) >= 0.15
            and ev._count_starts() > 0)


def _c_exposed_memory(ev: Evidence) -> List[Mutation]:
    return [ScaleLatency(hw_field="hbm_bw", factor=2.0),
            ScaleLatency(hw_field="dma_setup_cycles", factor=0.5)]


def _m_serial_chain(ev: Evidence) -> bool:
    """A wide, uncontended issue fabric starved by serial dependence
    chains: every sync scoreboard has slack (no evictions), the part has
    real issue width, and exec_dep dominates the stall anatomy — the
    bottleneck is issue-side program shape, not resources."""
    if ev.contended_pools():
        return False
    return (ev.issue.ports >= 4
            and ev.stall_share(StallClass.EXEC_DEP) >= 0.4)


def _c_serial_chain(ev: Evidence) -> List[Mutation]:
    return [TreeReduceChain(min_length=4),
            SetIssue(width=ev.issue.width * 2)]


#: The rule catalog, in match-check order (ranking is by replay outcome,
#: not catalog position).
RULES: List[Rule] = [
    Rule(
        name="batch_sync_allocations",
        summary=("reduce in-flight async copies: guard groups of transfers "
                 "with one synchronization point (batch barriers)"),
        confidence=0.9,
        matches=_m_barrier_storm,
        candidates=_c_batch_barriers,
        vendor_phrasing={
            "nvidia": ("named barriers B1-B6 are device-shared and "
                       "oversubscribed: batch bar.sync — guard groups of "
                       "cp.async transfers with one barrier instead of one "
                       "each"),
            "amd": ("s_barrier is device-shared and oversubscribed: batch "
                    "barrier use across wavefronts"),
            "intel": ("named barriers (nbar) are oversubscribed: batch "
                      "barrier signals across async transfers"),
        },
    ),
    Rule(
        name="coalesce_outstanding_waits",
        summary=("coalesce counter-style waits: drain several outstanding "
                 "transfers per wait instead of one wait per transfer"),
        confidence=0.9,
        matches=_m_waitcnt_storm,
        candidates=_c_coalesce_waits,
        vendor_phrasing={
            "amd": ("vmcnt/lgkmcnt counters are oversubscribed: coalesce "
                    "s_waitcnt — issue groups of global loads, then one "
                    "s_waitcnt(vmcnt <= N) drains the group"),
            "nvidia": ("commit-group depth exceeded: batch cp.async.commit_"
                       "group and wait on groups, not single copies"),
        },
    ),
    Rule(
        name="recycle_scoreboard_tokens",
        summary=("recycle in-order scoreboard tokens: reuse one token "
                 "across dependent async ops instead of allocating fresh"),
        confidence=0.85,
        matches=_m_token_recycle,
        candidates=_c_recycle_tokens,
        vendor_phrasing={
            "intel": ("SWSB SBIDs ($0-$15) are oversubscribed on a vector "
                      "engine: reuse one SBID across grouped sends ({$N.dst} "
                      "on the group's last consumer)"),
        },
    ),
    Rule(
        name="rebalance_issue_queues",
        summary=("rebalance independent chains across issue queues: ready "
                 "work keeps losing greedy-oldest arbitration"),
        confidence=0.75,
        matches=_m_rebalance,
        candidates=_c_rebalance,
        vendor_phrasing={
            "nvidia": ("warps lose scheduler arbitration (not_selected): "
                       "spread independent chains across warps/schedulers, "
                       "or raise occupancy — cap registers with "
                       "__launch_bounds__ / -maxrregcount so more warps "
                       "fit the register file and greedy-oldest has "
                       "choices"),
        },
    ),
    Rule(
        name="raise_occupancy",
        summary=("raise wave residency: co-resident waves would hide the "
                 "exposed latency the single wave keeps eating — lower "
                 "per-wave resource usage so more waves fit"),
        confidence=0.8,
        matches=_m_raise_occupancy,
        candidates=_c_raise_occupancy,
        vendor_phrasing={
            "nvidia": ("raise resident warps per SM: cap the register "
                       "budget with __launch_bounds__(threads, minBlocks) "
                       "or -maxrregcount so more warps fit the register "
                       "file; the priced counterfactual also charges the "
                       "shared named-barrier cost extra warps bring"),
            "amd": ("raise waves-per-EU: trim VGPR/LDS usage (or pin "
                    "amdgpu-waves-per-eu) so more wavefronts occupy the "
                    "wavefront slots and hide vmcnt latency"),
            "intel": ("raise thread residency per Xe vector engine: "
                      "compile for the small-GRF mode so the full 8 "
                      "hardware threads stay resident instead of the "
                      "large-GRF half"),
        },
    ),
    Rule(
        name="spread_same_pipe_work",
        summary=("interleave work across execution pipes: one pipe is "
                 "saturated while others idle (pipe_busy-heavy)"),
        confidence=0.7,
        matches=_m_pipe_pressure,
        candidates=_c_pipe_pressure,
        vendor_phrasing={
            "amd": ("one SIMD's pipe is saturated: interleave VALU and MFMA "
                    "work so the round-robin rotation finds mixed-pipe "
                    "instructions"),
            "intel": ("a shared execution pipe is saturated: co-issue "
                      "different-pipe instructions on the paired ALUs"),
        },
    ),
    Rule(
        name="expose_ilp_tree_reduce",
        summary=("expose instruction-level parallelism: the issue fabric "
                 "is idle behind a serial dependence chain — restructure "
                 "reductions as balanced trees"),
        confidence=0.8,
        matches=_m_serial_chain,
        candidates=_c_serial_chain,
        vendor_phrasing={
            "intel": ("16 SBIDs uncontended and the 8x2 issue fabric is "
                      "starved by one serial chain: tree-reduce so "
                      "independent adds co-issue across vector engines "
                      "(issue-side, not a sync problem)"),
            "nvidia": ("schedulers are starved by a serial dependence "
                       "chain: tree-reduce so independent warps make "
                       "progress"),
            "amd": ("SIMD rotation is starved by a serial dependence "
                    "chain: tree-reduce so every SIMD sees ready work"),
        },
    ),
    Rule(
        name="prefetch_software_pipeline",
        summary=("prefetch / software-pipeline: transfer latency is exposed "
                 "at consumers although sync resources are uncontended — "
                 "issue copies earlier and overlap compute with the tail"),
        confidence=0.8,
        matches=_m_exposed_memory,
        candidates=_c_exposed_memory,
        vendor_phrasing={
            "intel": ("16 SBIDs are uncontended — the bottleneck is issue-"
                      "side: software-pipeline the consumer chain so "
                      "prefetched transfers overlap compute (double-buffer "
                      "in SLM)"),
            "nvidia": ("prefetch with cp.async into a double buffer and "
                       "software-pipeline the consumer loop"),
            "amd": ("prefetch with global_load_dword into a second buffer "
                    "and software-pipeline the MFMA loop"),
        },
    ),
]


def rule_by_name(name: str) -> Rule:
    for r in RULES:
        if r.name == name:
            return r
    raise KeyError(f"unknown rule {name!r}; known: {[r.name for r in RULES]}")


def match_rules(evidence: Evidence,
                rules: Optional[List[Rule]] = None) -> List[Rule]:
    """Every rule whose evidence pattern fits this diagnosis."""
    return [r for r in (rules if rules is not None else RULES)
            if r.matches(evidence)]
