"""Counterfactual what-if replay over the LEO model stack.

The paper's payoff is not the diagnosis but the *optimization it guides*
(§case studies: 1.73x-1.82x geomean from LEO-guided fixes).  This module
supplies the estimate-backed half of that loop, GPA-style: a declarative
:class:`Mutation` describes one candidate change to the modeled world —
grow a :class:`SyncResourcePool`, switch the :class:`IssueModel`, scale a
latency class, batch or pipeline an async-copy chain, relax a sync edge —
and :class:`WhatIfEngine` replays the *same* program through the mutated
model and reports the modeled cycle delta.

Everything here is a pure function of ``(module, backend, mutation)``:
mutations clone via ``dataclasses.replace`` / :func:`clone_module` and
never touch the originals, and the replayed :class:`VirtualSampler` is fully
deterministic — the :class:`Identity` mutation reproduces the baseline
:class:`StallProfile` byte-for-byte (asserted by
:func:`profile_fingerprint` equality in tests and goldens).
"""
from __future__ import annotations

import copy
import hashlib
import pickle
import json
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Any, Dict, List, Optional, Tuple

from ..core.backends import Backend
from ..core.hwmodel import IssueModel, OccupancyModel
from ..core.isa import Instruction, Module, OpClass
from ..core.sampler import StallClass, StallProfile, VirtualSampler


def clone_module(module: Module) -> Module:
    """Deep-clone a parsed module without sharing any mutable state.

    A pickle round-trip: ~5x faster than ``copy.deepcopy`` on the plain
    dataclass graph a :class:`Module` is (every mutation pays one clone
    per replay, so this is the what-if engine's hot path), and equality
    by the module's own ``__eq__`` is preserved exactly."""
    return pickle.loads(pickle.dumps(module, pickle.HIGHEST_PROTOCOL))


__all__ = [
    "Mutation",
    "Identity",
    "ResizePool",
    "SetIssue",
    "SetOccupancy",
    "ScaleLatency",
    "CoalesceSyncTags",
    "PipelineAsyncChain",
    "clone_module",
    "TreeReduceChain",
    "RelaxSyncEdge",
    "Compose",
    "WhatIfResult",
    "WhatIfEngine",
    "mutation_from_dict",
    "profile_fingerprint",
    "sync_resource_stall_cycles",
]

#: HardwareModel fields ScaleLatency may touch — numeric latency/bandwidth
#: classes only, never structural fields (name/issue/clock identity).
SCALABLE_FIELDS = (
    "hbm_bw", "dma_setup_cycles", "sync_realloc_cycles",
    "issue_overhead_cycles", "peak_flops_bf16", "peak_flops_f32",
    "collective_setup_cycles",
)


@dataclass(frozen=True)
class Mutation:
    """One declarative counterfactual edit to the modeled world.

    Subclasses override :meth:`apply_backend` (hardware/sync/issue edits)
    and/or :meth:`apply_module` (program edits).  Both must be pure:
    return clones, never mutate the argument."""

    @property
    def kind(self) -> str:
        return type(self).__name__

    def apply_backend(self, backend: Backend) -> Backend:
        return backend

    def apply_module(self, module: Module) -> Module:
        return module

    def describe(self) -> str:
        return self.kind

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind}
        out.update({k: v for k, v in self.__dict__.items()})
        return out


def _rename(backend: Backend, suffix: str) -> Backend:
    """Derived backends get distinct names (the `with_issue` convention)
    so name-keyed session/service caches can never alias a mutant with
    the real part."""
    return _dc_replace(backend, name=f"{backend.name}~{suffix}")


@dataclass(frozen=True)
class Identity(Mutation):
    """The null mutation: replay must be byte-identical to baseline."""

    def describe(self) -> str:
        return "identity (baseline replay)"


@dataclass(frozen=True)
class ResizePool(Mutation):
    """Grow or shrink one named :class:`SyncResourcePool` to ``capacity``.

    Growing answers the counterfactual "would more barriers / waitcnt
    counters / SBIDs help?" — the modeled speedup quantifies how much of
    the makespan is §III-E oldest-(M-N) serialization on that pool, which
    is exactly what a software fix (batching syncs) can claw back."""

    pool: str = ""
    capacity: int = 1

    def apply_backend(self, backend: Backend) -> Backend:
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        pools = []
        hit = False
        for p in backend.sync.pools:
            if p.name != self.pool:
                pools.append(p)
                continue
            hit = True
            if self.capacity <= p.capacity:
                instances = p.instances[:self.capacity]
            else:
                extra = tuple(f"{p.name}[{i}]"
                              for i in range(p.capacity, self.capacity))
                instances = p.instances + extra
            pools.append(_dc_replace(p, instances=instances))
        if not hit:
            raise KeyError(
                f"backend {backend.name!r} has no sync pool {self.pool!r}; "
                f"pools: {[p.name for p in backend.sync.pools]}")
        sync = _dc_replace(backend.sync, pools=tuple(pools))
        return _dc_replace(_rename(backend, f"pool.{self.pool}x{self.capacity}"),
                           sync=sync)

    def describe(self) -> str:
        return f"resize sync pool {self.pool!r} to capacity {self.capacity}"


@dataclass(frozen=True)
class SetIssue(Mutation):
    """Swap the issue fabric: any of queues/width/policy, rest inherited."""

    queues: Optional[int] = None
    width: Optional[int] = None
    policy: Optional[str] = None

    def apply_backend(self, backend: Backend) -> Backend:
        cur = backend.issue
        issue = IssueModel(
            queues=self.queues if self.queues is not None else cur.queues,
            width=self.width if self.width is not None else cur.width,
            policy=self.policy if self.policy is not None else cur.policy)
        return backend.with_issue(issue)

    def describe(self) -> str:
        parts = [f"{k}={v}" for k, v in (("queues", self.queues),
                                         ("width", self.width),
                                         ("policy", self.policy))
                 if v is not None]
        return "set issue " + ", ".join(parts or ["(unchanged)"])


@dataclass(frozen=True)
class SetOccupancy(Mutation):
    """Engage or re-size the wave-occupancy model: W resident waves per
    issue queue hiding each other's latency.

    With no arguments, engages the backend's *native* residency
    (``Backend.native_occupancy`` — what the vendor's launch knobs give
    an unconstrained kernel); explicit fields override.  This is the
    counterfactual behind "raise occupancy" advice: the modeled speedup
    prices how much of the exposed latency co-resident waves would
    actually hide — which is NOT always positive, because W waves also
    share the device-scoped sync pools (a copy storm that fits 6
    barriers at W=1 fights over 6//8 of them at W=8)."""

    waves: Optional[int] = None
    limiter: Optional[str] = None
    window_cycles: Optional[float] = None

    def apply_backend(self, backend: Backend) -> Backend:
        cur = backend.occupancy if backend.occupancy.multi_wave \
            else backend.native_occupancy
        occ = OccupancyModel(
            waves=self.waves if self.waves is not None else cur.waves,
            limiter=self.limiter if self.limiter is not None
            else cur.limiter,
            window_cycles=self.window_cycles
            if self.window_cycles is not None else cur.window_cycles)
        return backend.with_occupancy(occ)

    def describe(self) -> str:
        parts = [f"{k}={v}" for k, v in (("waves", self.waves),
                                         ("limiter", self.limiter),
                                         ("window_cycles",
                                          self.window_cycles))
                 if v is not None]
        return "set occupancy " + ", ".join(parts or ["(native residency)"])


@dataclass(frozen=True)
class ScaleLatency(Mutation):
    """Scale one numeric latency/bandwidth class of the HardwareModel.

    ``ScaleLatency("hbm_bw", 2.0)`` models "hide half the exposed memory
    latency" (prefetch / double-buffering); ``("sync_realloc_cycles",
    0.5)`` models a cheaper barrier re-arm, and so on."""

    hw_field: str = ""
    factor: float = 1.0

    def apply_backend(self, backend: Backend) -> Backend:
        if self.hw_field not in SCALABLE_FIELDS:
            raise KeyError(
                f"{self.hw_field!r} is not a scalable latency class; "
                f"known: {SCALABLE_FIELDS}")
        if self.factor <= 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")
        cur = getattr(backend.hw, self.hw_field)
        hw = _dc_replace(backend.hw, **{self.hw_field: cur * self.factor})
        return _dc_replace(_rename(backend, f"{self.hw_field}x{self.factor:g}"),
                           hw=hw)

    def describe(self) -> str:
        return f"scale hw.{self.hw_field} by {self.factor:g}x"


def _sync_starts(comp) -> List[Instruction]:
    """Async-start ops that claim a sync resource, in program order."""
    return [i for i in comp.instructions
            if i.sync.sets and i.op_class is OpClass.SYNC_SET]


@dataclass(frozen=True)
class CoalesceSyncTags(Mutation):
    """Batch barriers: guard groups of ``group`` async starts with ONE
    sync identifier instead of one each.

    This is the software fix the §III-E rule points at: a re-armed live
    identifier is a free counter-style increment on the same physical
    instance (no allocation), so a 12-copy storm that oversubscribes 6
    named barriers fits comfortably once copies share tags pairwise.
    Data dependencies ride the operand edges and are untouched — only the
    resource accounting changes."""

    group: int = 2

    def apply_module(self, module: Module) -> Module:
        if self.group < 1:
            raise ValueError(f"group must be >= 1, got {self.group}")
        if self.group == 1:
            return module
        mod = clone_module(module)
        for comp in mod.computations.values():
            starts = _sync_starts(comp)
            remap: Dict[str, str] = {}
            for i, instr in enumerate(starts):
                leader = starts[(i // self.group) * self.group]
                for tag in instr.sync.sets:
                    remap[tag] = leader.name
            if not remap:
                continue
            for instr in comp.instructions:
                si = instr.sync
                if si.kind is None:
                    continue
                sets = tuple(remap.get(t, t) for t in si.sets)
                waits = tuple(remap.get(t, t) for t in si.waits)
                if sets != si.sets or waits != si.waits:
                    instr.sync = _dc_replace(si, sets=sets, waits=waits)
        return mod

    def describe(self) -> str:
        return (f"batch sync: share one identifier across groups of "
                f"{self.group} async starts")


@dataclass(frozen=True)
class PipelineAsyncChain(Mutation):
    """Software-pipeline an async chain to at most ``window`` starts in
    flight: starts beyond the window are sunk to just before their first
    consumer.  Bounds resource pressure at the cost of overlap — what-if
    replay decides whether that trade wins on a given part."""

    window: int = 4

    def apply_module(self, module: Module) -> Module:
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        mod = clone_module(module)
        for comp in mod.computations.values():
            starts = _sync_starts(comp)
            if len(starts) <= self.window:
                continue
            instrs = list(comp.instructions)
            for s in starts[self.window:]:
                consumer = None
                for other in instrs:
                    if other is s:
                        continue
                    if s.name in other.operands or s.name in other.sync.waits:
                        consumer = other
                        break
                if consumer is None:
                    continue
                instrs.remove(s)
                instrs.insert(instrs.index(consumer), s)
            for idx, instr in enumerate(instrs):
                instr.index = idx
            comp.instructions = instrs
        return mod

    def describe(self) -> str:
        return f"pipeline async chain: <= {self.window} starts in flight"


#: Binary elementwise opcodes safe to rebalance associatively.
_ASSOCIATIVE_OPCODES = ("add", "multiply", "maximum", "minimum",
                        "and", "or", "xor")


@dataclass(frozen=True)
class TreeReduceChain(Mutation):
    """Rebalance serial associative reduction chains into balanced trees.

    ``c1 = add(x0, x1); c2 = add(c1, x2); ...`` is one long dependence
    chain — a wide issue fabric sits idle behind it.  The tree shape
    computes the same value in ``ceil(log2)`` levels of independent ops,
    which is exactly the "issue-side" restructuring an uncontended part
    (Intel-class: 16 SBIDs free, 8x2 ports starved) wants.  Only maximal
    chains of length >= ``min_length`` whose leaves all precede the chain
    in program order are rewired; instruction count and names never
    change, so downstream consumers and profile records stay stable."""

    min_length: int = 4

    def apply_module(self, module: Module) -> Module:
        mod = clone_module(module)
        for comp in mod.computations.values():
            self._rebalance_comp(comp)
        return mod

    def _rebalance_comp(self, comp) -> None:
        users: Dict[str, List[Instruction]] = {}
        for instr in comp.instructions:
            for op in set(instr.operands):
                users.setdefault(op, []).append(instr)

        def chainable(instr: Instruction) -> bool:
            return (instr.opcode in _ASSOCIATIVE_OPCODES
                    and len(instr.operands) == 2)

        def chain_pred(instr: Instruction) -> Optional[Instruction]:
            for op in instr.operands:
                prev = comp.get(op)
                if prev is not None and chainable(prev) \
                        and prev.opcode == instr.opcode \
                        and len(users.get(prev.name, ())) == 1:
                    return prev
            return None

        in_chain: set = set()
        for instr in comp.instructions:
            if not chainable(instr) or instr.name in in_chain \
                    or chain_pred(instr) is not None:
                continue
            # walk the successors: the single same-opcode user
            nodes = [instr]
            while True:
                nxt = [u for u in users.get(nodes[-1].name, ())
                       if chainable(u) and u.opcode == instr.opcode
                       and chain_pred(u) is nodes[-1]]
                if len(nxt) != 1 or len(users.get(nodes[-1].name, ())) != 1:
                    break
                nodes.append(nxt[0])
            if len(nodes) < self.min_length:
                continue
            # leaves: both operands of the head, plus each later node's
            # non-chain operand, in chain order
            leaves = list(nodes[0].operands)
            for prev, node in zip(nodes, nodes[1:]):
                leaves.extend(op for op in node.operands
                              if op != prev.name)
            if len(leaves) != len(nodes) + 1:
                continue    # irregular shape (e.g. squaring); leave it
            first_idx = min(n.index for n in nodes)
            leaf_instrs = [comp.get(l) for l in leaves]
            if any(l is None or l.index >= first_idx for l in leaf_instrs):
                continue    # a leaf defined mid-chain: unsafe to rewire
            in_chain.update(n.name for n in nodes)
            # pair values level by level, reusing the chain's own nodes
            # in program order — the last node keeps computing the root,
            # so every downstream consumer is untouched
            vals = leaves
            k = 0
            while len(vals) > 1:
                level: List[str] = []
                for i in range(0, len(vals) - 1, 2):
                    node = nodes[k]
                    k += 1
                    node.operands = (vals[i], vals[i + 1])
                    level.append(node.name)
                if len(vals) % 2:
                    level.append(vals[-1])
                vals = level

    def describe(self) -> str:
        return (f"tree-reduce serial chains (length >= {self.min_length}) "
                f"into balanced reductions")


@dataclass(frozen=True)
class RelaxSyncEdge(Mutation):
    """Drop the sync-wait edges of instructions whose name contains
    ``match`` (models removing a redundant wait, e.g. over-conservative
    token threading).  Data operands still order the program."""

    match: str = ""

    def apply_module(self, module: Module) -> Module:
        mod = clone_module(module)
        for comp in mod.computations.values():
            for instr in comp.instructions:
                if self.match and self.match not in instr.name:
                    continue
                if instr.sync.waits:
                    instr.sync = _dc_replace(instr.sync, waits=(),
                                             counter=None)
        return mod

    def describe(self) -> str:
        return f"relax sync waits on instructions matching {self.match!r}"


@dataclass(frozen=True)
class Compose(Mutation):
    """Apply several mutations as ONE candidate and price them jointly.

    Stacked fixes do not add linearly — coalescing sync tags can erase
    the serialization a pool resize would have bought, and pipelining a
    chain changes which tags are live to coalesce.  A single joint
    replay through the composed world is the only honest price.  Parts
    apply in order (program edits chain, backend edits chain), so
    ``Compose((a, b))`` models "do a, then b"."""

    parts: Tuple[Mutation, ...] = ()

    def apply_backend(self, backend: Backend) -> Backend:
        for part in self.parts:
            backend = part.apply_backend(backend)
        return backend

    def apply_module(self, module: Module) -> Module:
        for part in self.parts:
            module = part.apply_module(module)
        return module

    def describe(self) -> str:
        if not self.parts:
            return "compose (empty)"
        return "stack: " + " + ".join(p.describe() for p in self.parts)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind,
                "parts": [p.to_dict() for p in self.parts]}


_MUTATION_KINDS = {
    cls.__name__: cls
    for cls in (Identity, ResizePool, SetIssue, SetOccupancy, ScaleLatency,
                CoalesceSyncTags, PipelineAsyncChain, TreeReduceChain,
                RelaxSyncEdge, Compose)
}


def mutation_from_dict(data: Dict[str, Any]) -> Mutation:
    """Inverse of ``Mutation.to_dict`` (wire/JSON round-trips)."""
    data = dict(data)
    kind = data.pop("kind", None)
    try:
        cls = _MUTATION_KINDS[kind]
    except KeyError:
        raise KeyError(f"unknown mutation kind {kind!r}; "
                       f"known: {sorted(_MUTATION_KINDS)}") from None
    if cls is Compose:
        return Compose(parts=tuple(mutation_from_dict(p)
                                   for p in data.get("parts", ())))
    return cls(**data)


# -- deterministic profile identity -------------------------------------------

def _canonical_profile(profile: StallProfile) -> Dict[str, Any]:
    records = {}
    for q, rec in sorted(profile.records.items()):
        records[q] = {
            "total_samples": rec.total_samples,
            "latency_samples": rec.latency_samples,
            "exec_count": rec.exec_count,
            "stall_breakdown": {cls.value: cyc for cls, cyc in
                                sorted(rec.stall_breakdown.items(),
                                       key=lambda kv: kv[0].value)},
            "blockers": dict(sorted(rec.blockers.items())),
        }
    out: Dict[str, Any] = {
        "hw_name": profile.hw_name,
        "makespan_cycles": profile.makespan_cycles,
        "clock_hz": profile.clock_hz,
        "records": records,
    }
    for name in ("sync_pressure", "issue_pressure", "occupancy_pressure"):
        report = getattr(profile, name, None)
        if report is not None and hasattr(report, "to_dict"):
            out[name] = report.to_dict()
    return out


def profile_fingerprint(profile: StallProfile) -> str:
    """Content hash of everything a StallProfile asserts; two profiles
    with equal fingerprints are byte-identical for golden purposes."""
    blob = json.dumps(_canonical_profile(profile), sort_keys=True,
                      separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def sync_resource_stall_cycles(profile: StallProfile) -> float:
    """Total §III-E serialization cycles across the profile."""
    return sum(rec.stall_breakdown.get(StallClass.SYNC_RESOURCE, 0.0)
               for rec in profile.records.values())


# -- the replay engine --------------------------------------------------------

@dataclass
class WhatIfResult:
    """Modeled outcome of replaying one mutation."""

    mutation: Mutation
    backend_name: str
    baseline_makespan_cycles: float
    mutated_makespan_cycles: float
    profile: StallProfile = field(repr=False, default=None)  # type: ignore

    @property
    def delta_cycles(self) -> float:
        """Positive = the mutation removed cycles."""
        return self.baseline_makespan_cycles - self.mutated_makespan_cycles

    @property
    def modeled_speedup(self) -> float:
        if self.mutated_makespan_cycles <= 0:
            return 1.0
        return self.baseline_makespan_cycles / self.mutated_makespan_cycles

    def to_dict(self) -> Dict[str, Any]:
        return {
            "mutation": self.mutation.to_dict(),
            "backend": self.backend_name,
            "baseline_makespan_cycles": self.baseline_makespan_cycles,
            "mutated_makespan_cycles": self.mutated_makespan_cycles,
            "delta_cycles": self.delta_cycles,
            "modeled_speedup": self.modeled_speedup,
        }


class WhatIfEngine:
    """Replay ``(module, backend)`` under mutations; memoizes the baseline.

    ``replays`` counts every sampler run (baseline included) — the
    advisor's bench lane and the hillclimb evaluation budget both read
    it, so nothing gets to hide simulation work."""

    def __init__(self, module: Module, backend: Backend):
        self.module = module
        self.backend = backend
        self.replays = 0
        self._baseline: Optional[StallProfile] = None

    def _run(self, module: Module, backend: Backend) -> StallProfile:
        self.replays += 1
        return VirtualSampler(module, backend.hw, sync=backend.sync).run()

    def baseline(self) -> StallProfile:
        if self._baseline is None:
            self._baseline = self._run(self.module, self.backend)
        return self._baseline

    def replay(self, mutation: Mutation) -> WhatIfResult:
        base = self.baseline()
        mutated = self._run(mutation.apply_module(self.module),
                            mutation.apply_backend(self.backend))
        return WhatIfResult(
            mutation=mutation,
            backend_name=self.backend.name,
            baseline_makespan_cycles=base.makespan_cycles,
            mutated_makespan_cycles=mutated.makespan_cycles,
            profile=mutated)
