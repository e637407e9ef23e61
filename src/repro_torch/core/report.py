"""Typed diagnosis schema + diagnostic-context formats (paper §IV).

The serving-grade result object is :class:`Diagnosis` — a versioned,
JSON-round-trippable snapshot of one LEO analysis that survives without
the in-memory ``LeoAnalysis`` (module, graphs, profile) it came from, so
it can be cached on disk, shipped over a queue, and handed to humans or
LLM agents:

    diag = Diagnosis.from_analysis(analysis)
    diag.to_json()                 # lossless: Diagnosis.from_json round-trips
    diag.to_markdown()             # human-readable report
    diag.to_llm_context("C+L(S)", code=src)   # §IV agent context

Three context levels for downstream optimizers (human, LLM, or the
deterministic rule-engine used by the Table-V benchmark analogue):

  C       — code only;
  C+S     — code plus raw per-instruction stall counts (what vendor
            profilers give you);
  C+L(S)  — code plus LEO's full root-cause analysis: ranked dependency
            chains with blame attribution, scope (cross-layer) paths,
            quantified cycles, and actionable recommendations.

The recommendation rules map root-cause *patterns* to concrete
transformations with machine-readable action ids, so the paper's claim —
"structured dependency chains guide optimization better than raw metrics" —
is testable here: the rule engine can act on C+L(S) but can only guess from
C+S (it sees symptoms without causes).

The pre-service free functions (``structured_report``, ``recommendations``,
``diagnostic_context``, ``save_json``) remain as deprecation shims that
delegate to :class:`Diagnosis`, so their output is byte-identical to the
methods they wrap (asserted in ``tests/test_service.py``).
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .passes import LeoAnalysis
from .isa import EdgeKind, Instruction, OpClass, StallClass

#: Version stamped into every serialized Diagnosis / AnalyzeRequest; readers
#: reject (treat as cache miss) payloads from a newer schema generation.
#: v2 added the ``sync_resources`` section (§III-E finite sync-resource
#: pressure); v3 added the ``issue_pressure`` section (multi-stream
#: issue-queue / scheduler-contention pressure); v4 added the ``advice``
#: section (ranked what-if-replayed optimization advice from
#: ``repro.advisor``); v5 added the ``rewrites`` section (applied,
#: equivalence-checked HLO rewrites from ``repro.rewrite`` with
#: predicted-vs-realized speedups); v6 added the ``occupancy`` section
#: (wave-residency / failed-latency-hiding pressure from the multi-wave
#: sampler).  Older payloads are still readable — ``from_dict`` migrates
#: them with explicit "not recorded" defaults, so a warm disk cache
#: survives each bump.
SCHEMA_VERSION = 6

#: Oldest payload generation ``Diagnosis.from_dict`` can migrate forward.
MIN_SCHEMA_VERSION = 1

#: The ``sync_resources`` default filled into migrated pre-v2 payloads.
SYNC_RESOURCES_NOT_RECORDED = {
    "recorded": False,
    "note": "not recorded (schema version 1 payload)",
}

#: The ``issue_pressure`` default filled into migrated pre-v3 payloads.
ISSUE_PRESSURE_NOT_RECORDED = {
    "recorded": False,
    "note": "not recorded (pre-v3 schema payload)",
}

#: The ``advice`` default: migrated pre-v4 payloads AND v4 diagnoses whose
#: request did not opt into the advisor (``advise=False`` skips the what-if
#: replays) — one constant, so both paths serialize identically and the
#: wire inverse-migration test can compare them byte-for-byte.
ADVICE_NOT_RECORDED = {
    "recorded": False,
    "note": "not recorded (advisor not run, or pre-v4 schema payload)",
}

#: The ``rewrites`` default: migrated pre-v5 payloads AND v5 diagnoses
#: whose request did not opt into the rewrite loop (``rewrite=False``
#: skips the transform + re-analysis) — one constant, so both paths
#: serialize identically (same contract as ``ADVICE_NOT_RECORDED``).
REWRITES_NOT_RECORDED = {
    "recorded": False,
    "note": "not recorded (rewrite loop not run, or pre-v5 schema payload)",
}

#: The ``occupancy`` default: migrated pre-v6 payloads AND v6 diagnoses
#: analyzed at W=1 (``occupancy=False`` requests keep the single-wave
#: sampler, which carries no residency pressure) — one constant, so both
#: paths serialize identically (same contract as ``ADVICE_NOT_RECORDED``).
OCCUPANCY_NOT_RECORDED = {
    "recorded": False,
    "note": "not recorded (single-wave analysis, or pre-v6 schema payload)",
}


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro.core.report.{old} is deprecated; use {new} instead "
        f"(shim slated for removal two releases after the LeoService API "
        f"landed — see docs/api.md)",
        DeprecationWarning, stacklevel=3)


@dataclass
class Recommendation:
    action: str          # machine-readable id (rule engine key)
    target: str          # qualified instruction name
    scope: str           # op_name scope of the target
    reason: str          # human-readable explanation
    est_cycles: float    # blame cycles addressed by this action

    def to_dict(self) -> Dict[str, Any]:
        return {"action": self.action, "target": self.target,
                "scope": self.scope, "reason": self.reason,
                "est_cycles": self.est_cycles}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Recommendation":
        return cls(action=data["action"], target=data["target"],
                   scope=data["scope"], reason=data["reason"],
                   est_cycles=data["est_cycles"])


_COLLECTIVE_OPS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute"}


def _build_recommendations(analysis: LeoAnalysis, limit: int = 8
                           ) -> List[Recommendation]:
    recs: List[Recommendation] = []
    seen_actions = set()

    def add(action: str, target: str, scope: str, reason: str,
            cycles: float) -> None:
        key = (action, scope.rsplit("/", 1)[0] if scope else target)
        if key in seen_actions:
            return
        seen_actions.add(key)
        recs.append(Recommendation(action=action, target=target, scope=scope,
                                   reason=reason, est_cycles=cycles))

    for qualified, cycles in analysis.blame.top_root_causes(24):
        instr = analysis.module.find(qualified)
        if instr is None:
            continue
        base = instr.opcode.replace("-start", "")
        scope = instr.op_name
        if base in _COLLECTIVE_OPS:
            if instr.comm_bytes > 0:
                add("overlap_or_reshard_collective", qualified, scope,
                    f"{base} moves {instr.comm_bytes/2**20:.1f} MiB over ICI "
                    f"per chip and blocks consumers; reshard to eliminate it "
                    f"or overlap it with compute.", cycles)
        elif instr.opcode in ("gather", "dynamic-slice"):
            add("coalesce_or_tile_gather", qualified, scope,
                "Indirect/strided load dominates stalls; restructure layout "
                "or tile the accessed table into VMEM.", cycles)
        elif instr.op_class is OpClass.PARAMETER:
            add("cache_weights_vmem", qualified, scope,
                "Streaming this operand from HBM bounds the consumer; raise "
                "arithmetic intensity (fuse consumers / cache in VMEM / "
                "re-tile).", cycles)
        elif instr.op_class is OpClass.MATMUL:
            add("increase_matmul_intensity", qualified, scope,
                "Dependent matmul chain limits ILP; enlarge tiles, batch "
                "small matmuls, or break the serial chain.", cycles)
        elif instr.op_class in (OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE,
                                OpClass.DATA_MOVEMENT):
            add("prefetch_or_double_buffer", qualified, scope,
                "Exposed copy/load latency; issue the transfer earlier or "
                "double-buffer.", cycles)
        elif instr.op_class is OpClass.FUSION and instr.bytes_read > 0 and \
                instr.flops / max(instr.bytes_read + instr.bytes_written,
                                  1.0) < 2.0:
            add("refuse_or_remat", qualified, scope,
                "Low-arithmetic-intensity fused loop is HBM-bound; refuse "
                "with producers/consumers or change remat policy.", cycles)

    # Loop-carried serialization pattern.
    carried = [e for e in analysis.graph.alive_edges
               if e.kind is EdgeKind.LOOP_CARRIED]
    if carried:
        carried_blame = sum(analysis.blame.by_producer.get(e.producer, 0.0)
                            for e in carried)
        if carried_blame > 0.05 * max(analysis.profile.total_stall_cycles, 1):
            e0 = max(carried, key=lambda e:
                     analysis.blame.by_producer.get(e.producer, 0.0))
            instr = analysis.module.find(e0.producer)
            add("pipeline_loop_iterations", e0.producer,
                instr.op_name if instr else "",
                "Loop-carried dependency serializes iterations; software-"
                "pipeline or widen the recurrence.", carried_blame)

    diagnosed = list(analysis.blame.self_blame) + \
        list(getattr(analysis.blame, "occupancy_blame", []))
    for s in sorted(diagnosed, key=lambda s: -s.cycles)[:4]:
        instr = analysis.module.find(s.qualified)
        scope = instr.op_name if instr else ""
        if s.subcategory == "memory latency":
            add("tile_into_vmem", s.qualified, scope,
                "Self-blamed memory latency with no producer to indict; the "
                "access itself is the bottleneck — tile into VMEM.",
                s.cycles)
        elif s.subcategory == "compute saturation":
            add("already_compute_bound", s.qualified, scope,
                "Compute-saturated: optimization headroom is limited "
                "(reduce FLOPs or change precision).", s.cycles)
        elif s.subcategory == "indirect addressing":
            add("coalesce_or_tile_gather", s.qualified, scope,
                "Indirect addressing self-stall.", s.cycles)

    recs.sort(key=lambda r: -r.est_cycles)
    return recs[:limit]


# --------------------------------------------------------------------------
# Diagnosis — the versioned, serializable analysis result.
# --------------------------------------------------------------------------

@dataclass
class Diagnosis:
    """Self-contained, JSON-pure snapshot of one analysis.

    Every field is built from plain JSON types (str/int/float/list/dict/
    None) except ``recommendations`` (a list of :class:`Recommendation`),
    so ``Diagnosis.from_json(d.to_json()) == d`` holds exactly (property-
    tested with hypothesis in ``tests/test_service.py``).
    """

    backend: str = ""
    module_name: str = ""
    estimated_step_seconds: float = 0.0
    total_stall_cycles: float = 0.0
    coverage_before: float = 0.0
    coverage_after: float = 0.0
    pruning: Dict[str, Any] = field(default_factory=dict)
    top_stalls: List[Dict[str, Any]] = field(default_factory=list)
    chains: List[Dict[str, Any]] = field(default_factory=list)
    root_causes: List[Dict[str, Any]] = field(default_factory=list)
    self_blame: List[Dict[str, Any]] = field(default_factory=list)
    recommendations: List[Recommendation] = field(default_factory=list)
    vendor: Optional[str] = None
    stall_taxonomy: Optional[Dict[str, str]] = None
    # §III-E finite sync-resource pressure (schema v2): per-pool capacity /
    # peak-in-flight / oversubscription events naming concrete resource
    # instances, or {"recorded": False, ...} when the analysis carried none.
    sync_resources: Dict[str, Any] = field(
        default_factory=lambda: dict(SYNC_RESOURCES_NOT_RECORDED))
    # Multi-stream issue-queue pressure (schema v3): the backend's
    # IssueModel (queues/width/policy), per-queue occupancy, and
    # scheduler-contention (not_selected / pipe_busy) cycles + events, or
    # {"recorded": False, ...} when the analysis carried none (measured
    # profiles, pre-v3 payloads).
    issue_pressure: Dict[str, Any] = field(
        default_factory=lambda: dict(ISSUE_PRESSURE_NOT_RECORDED))
    # Ranked optimization advice (schema v4): what-if-replayed candidate
    # mutations from `repro.advisor` with modeled speedups and vendor-
    # native phrasing, or {"recorded": False, ...} when the advisor was
    # not run (advise=False requests, measured profiles, pre-v4 payloads).
    advice: Dict[str, Any] = field(
        default_factory=lambda: dict(ADVICE_NOT_RECORDED))
    # Applied HLO rewrites (schema v5): equivalence-checked transforms
    # from `repro.rewrite` with predicted-vs-realized speedups per the
    # re-analyzed rewritten text, or {"recorded": False, ...} when the
    # rewrite loop was not run (rewrite=False requests, pre-v5 payloads).
    rewrites: Dict[str, Any] = field(
        default_factory=lambda: dict(REWRITES_NOT_RECORDED))
    # Wave-residency pressure (schema v6): the OccupancyModel the sampler
    # ran under (waves/limiter/window), hidden-vs-exposed stall accounting
    # per issue queue, and failed-latency-hiding (OCCUPANCY_LIMITED) blame
    # events, or {"recorded": False, ...} for W=1 analyses and pre-v6
    # payloads.
    occupancy: Dict[str, Any] = field(
        default_factory=lambda: dict(OCCUPANCY_NOT_RECORDED))
    schema_version: int = SCHEMA_VERSION

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_analysis(cls, analysis: LeoAnalysis, max_chains: int = 5,
                      max_stalls: int = 15) -> "Diagnosis":
        # max_stalls=15 preserves the legacy C+S context fidelity (its
        # shim rendered top_stalled(15)); the report dict consequently
        # carries 15 stall records where the pre-schema one carried 10 —
        # an additive change under the versioned schema.
        chains = []
        for chain in analysis.chains[:max_chains]:
            chains.append({
                "stall_cycles": chain.total_stall_cycles,
                "links": [{
                    "instruction": l.qualified,
                    "opcode": l.opcode,
                    "edge": l.edge_kind.value if l.edge_kind else None,
                    "blame_cycles": l.blame_cycles,
                    "scope": l.op_name,
                    "source": l.source,
                } for l in chain.links],
                "text": chain.describe(),
            })
        backend = analysis.backend
        stalls = []
        for rec in analysis.profile.top_stalled(max_stalls):
            instr = analysis.module.find(rec.qualified)
            entry = {
                "instruction": rec.qualified,
                "opcode": instr.opcode if instr else "?",
                "scope": instr.op_name if instr else "",
                "latency_samples": rec.latency_samples,
                "total_samples": rec.total_samples,
                "breakdown": {k.value: v
                              for k, v in rec.stall_breakdown.items()},
            }
            if backend is not None:
                # the same counters in the vendor profiler's own vocabulary
                # (CUPTI / rocprofiler / Level Zero / xplane), for agents
                # that cross-check against native tool output
                entry["native_breakdown"] = {
                    backend.native_stall_name(k): v
                    for k, v in rec.stall_breakdown.items()}
            stalls.append(entry)
        sync_resources: Dict[str, Any] = dict(SYNC_RESOURCES_NOT_RECORDED)
        pressure = getattr(analysis, "sync_pressure", None)
        if pressure is not None:
            sync_resources = {"recorded": True}
            sync_resources.update(pressure.to_dict())
            sync_resources["blame"] = [
                {"consumer": b.consumer, "resource": b.resource,
                 "pool": b.pool, "holder": b.holder, "cycles": b.cycles}
                for b in getattr(analysis.blame, "sync_resource", [])[:10]]
        issue_pressure: Dict[str, Any] = dict(ISSUE_PRESSURE_NOT_RECORDED)
        ipressure = getattr(analysis, "issue_pressure", None)
        if ipressure is not None:
            issue_pressure = {"recorded": True}
            issue_pressure.update(ipressure.to_dict())
            issue_pressure["blame"] = [
                {"consumer": b.consumer, "holder": b.holder,
                 "queue": b.queue, "pipe": b.pipe,
                 "stall_class": b.stall_class, "cycles": b.cycles}
                for b in getattr(analysis.blame,
                                 "scheduler_contention", [])[:10]]
        occupancy: Dict[str, Any] = dict(OCCUPANCY_NOT_RECORDED)
        opressure = getattr(analysis, "occupancy_pressure", None)
        if opressure is not None:
            occupancy = {"recorded": True}
            occupancy.update(opressure.to_dict())
            occupancy["blame"] = [
                {"consumer": b.consumer, "blocker": b.blocker,
                 "queue": b.queue, "stall_class": b.stall_class,
                 "hidden_cycles": b.hidden_cycles,
                 "exposed_cycles": b.exposed_cycles}
                for b in getattr(analysis.blame,
                                 "occupancy_limited", [])[:10]]
        return cls(
            backend=analysis.hw.name,
            module_name=analysis.module.name,
            estimated_step_seconds=analysis.estimated_step_seconds,
            total_stall_cycles=analysis.profile.total_stall_cycles,
            coverage_before=analysis.coverage_before.coverage,
            coverage_after=analysis.coverage_after.coverage,
            pruning={
                "initial_edges": analysis.prune_stats.initial_edges,
                "pruned": dict(analysis.prune_stats.pruned_by_stage),
                "surviving": analysis.prune_stats.surviving_edges,
            },
            top_stalls=stalls,
            chains=chains,
            root_causes=[
                {"instruction": q, "blame_cycles": c,
                 "scope": (analysis.module.find(q).op_name
                           if analysis.module.find(q) else "")}
                for q, c in analysis.blame.top_root_causes(10)],
            self_blame=[
                {"instruction": s.qualified, "cycles": s.cycles,
                 "subcategory": s.subcategory}
                for s in analysis.blame.self_blame[:10]],
            recommendations=_build_recommendations(analysis),
            vendor=backend.vendor if backend is not None else None,
            stall_taxonomy=(backend.taxonomy_table()
                            if backend is not None else None),
            sync_resources=sync_resources,
            issue_pressure=issue_pressure,
            occupancy=occupancy,
        )

    # -- serialization ---------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """The structured C+L(S) payload (superset of the legacy
        ``structured_report`` dict; ``vendor``/``stall_taxonomy`` are
        omitted when the analysis carried no Backend descriptor, matching
        the legacy shape)."""
        out: Dict[str, Any] = {
            "schema_version": self.schema_version,
            "backend": self.backend,
            "module": self.module_name,
        }
        if self.vendor is not None:
            out["vendor"] = self.vendor
        if self.stall_taxonomy is not None:
            out["stall_taxonomy"] = dict(self.stall_taxonomy)
        out.update({
            "estimated_step_seconds": self.estimated_step_seconds,
            "total_stall_cycles": self.total_stall_cycles,
            "single_dependency_coverage": {
                "before": self.coverage_before,
                "after": self.coverage_after,
            },
            "pruning": self.pruning,
            "top_stalls": self.top_stalls,
            "root_cause_chains": self.chains,
            "root_causes": self.root_causes,
            "self_blame": self.self_blame,
            "sync_resources": self.sync_resources,
            "issue_pressure": self.issue_pressure,
            "advice": self.advice,
            "rewrites": self.rewrites,
            "occupancy": self.occupancy,
            "recommendations": [r.to_dict() for r in self.recommendations],
        })
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Diagnosis":
        version = data.get("schema_version", 0)
        if not (MIN_SCHEMA_VERSION <= version <= SCHEMA_VERSION):
            raise ValueError(
                f"Diagnosis schema_version {version} outside supported "
                f"range [{MIN_SCHEMA_VERSION}, {SCHEMA_VERSION}]")
        # Graceful migration: v1 payloads (pre-sync_resources), v2
        # payloads (pre-issue_pressure), v3 payloads (pre-advice), v4
        # payloads (pre-rewrites) and v5 payloads (pre-occupancy) read
        # fine — a warm disk cache survives each schema bump with an
        # explicit "not recorded" default instead of a reject.
        sync_resources = data.get("sync_resources")
        if sync_resources is None:
            sync_resources = dict(SYNC_RESOURCES_NOT_RECORDED)
        issue_pressure = data.get("issue_pressure")
        if issue_pressure is None:
            issue_pressure = dict(ISSUE_PRESSURE_NOT_RECORDED)
        advice = data.get("advice")
        if advice is None:
            advice = dict(ADVICE_NOT_RECORDED)
        rewrites = data.get("rewrites")
        if rewrites is None:
            rewrites = dict(REWRITES_NOT_RECORDED)
        occupancy = data.get("occupancy")
        if occupancy is None:
            occupancy = dict(OCCUPANCY_NOT_RECORDED)
        cov = data.get("single_dependency_coverage", {})
        return cls(
            backend=data["backend"],
            module_name=data["module"],
            estimated_step_seconds=data["estimated_step_seconds"],
            total_stall_cycles=data["total_stall_cycles"],
            coverage_before=cov.get("before", 0.0),
            coverage_after=cov.get("after", 0.0),
            pruning=data.get("pruning", {}),
            top_stalls=data.get("top_stalls", []),
            chains=data.get("root_cause_chains", []),
            root_causes=data.get("root_causes", []),
            self_blame=data.get("self_blame", []),
            recommendations=[Recommendation.from_dict(r)
                             for r in data.get("recommendations", [])],
            vendor=data.get("vendor"),
            stall_taxonomy=data.get("stall_taxonomy"),
            sync_resources=sync_resources,
            issue_pressure=issue_pressure,
            advice=advice,
            rewrites=rewrites,
            occupancy=occupancy,
            schema_version=SCHEMA_VERSION,
        )

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    def copy(self) -> "Diagnosis":
        """Deep copy via the (lossless) JSON round-trip — used by the
        service caches so caller-side mutation cannot poison a cached or
        disk-persisted entry.  (The dict round-trip would alias the
        nested lists/dicts; serializing breaks every reference.)"""
        return Diagnosis.from_json(self.to_json())

    @classmethod
    def from_json(cls, payload: str) -> "Diagnosis":
        return cls.from_dict(json.loads(payload))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))

    # -- presentation ----------------------------------------------------------

    def _sync_resource_lines(self) -> List[str]:
        """Human-readable §III-E resource-pressure lines ("barrier slots
        6/6 in flight at peak") shared by the markdown and LLM views."""
        sr = self.sync_resources or {}
        if not sr.get("recorded"):
            return []
        lines: List[str] = []
        for pool in sr.get("pools", []):
            if not pool.get("acquisitions"):
                continue
            line = (f"{pool.get('label', pool.get('pool', '?'))}: peak "
                    f"{pool.get('peak_in_flight', 0)}/"
                    f"{pool.get('capacity', 0)} in flight")
            if pool.get("evictions"):
                line += (f", {pool['evictions']} oversubscription event(s)"
                         f", {pool.get('contention_cycles', 0.0):,.0f} "
                         f"serialized stall cycles")
            lines.append(line)
        for b in sr.get("blame", [])[:3]:
            lines.append(
                f"`{b['consumer']}` serialized on {b['pool']} instance "
                f"`{b['resource']}` held by `{b['holder']}` "
                f"({b['cycles']:,.0f} cycles)")
        return lines

    def _issue_pressure_lines(self) -> List[str]:
        """Human-readable scheduler-contention lines ("4 issue queues,
        12,345 not_selected cycles") shared by markdown and LLM views."""
        ip = self.issue_pressure or {}
        if not ip.get("recorded") or not ip.get("contended"):
            return []
        lines = [
            f"{ip.get('queues', 1)} issue queue(s) x width "
            f"{ip.get('width', 1)} ({ip.get('policy', '?')}): "
            f"{ip.get('not_selected_cycles', 0.0):,.0f} not_selected + "
            f"{ip.get('pipe_busy_cycles', 0.0):,.0f} pipe_busy stall cycles"
        ]
        for q in ip.get("per_queue", []):
            contention = (q.get("not_selected_cycles", 0.0)
                          + q.get("pipe_busy_cycles", 0.0))
            if contention > 0:
                lines.append(
                    f"queue {q['queue']}: {q.get('issued', 0.0):,.0f} issues"
                    f", {contention:,.0f} contention cycles")
        for b in ip.get("blame", [])[:3]:
            lines.append(
                f"`{b['consumer']}` lost queue {b['queue']} arbitration to "
                f"`{b['holder']}` ({b['stall_class']}, "
                f"{b['cycles']:,.0f} cycles)")
        return lines

    def _advice_lines(self, top_k: int = 5) -> List[str]:
        """Human-readable ranked-advice lines ("1.32x batch bar.sync …")
        shared by the markdown and LLM views; empty when not recorded."""
        adv = self.advice or {}
        if not adv.get("recorded"):
            return []
        lines: List[str] = []
        for item in adv.get("items", [])[:top_k]:
            mut = item.get("mutation", {})
            mut_bits = ", ".join(f"{k}={v}" for k, v in mut.items()
                                 if k != "kind" and v is not None)
            lines.append(
                f"**{item.get('modeled_speedup', 0.0):.2f}x modeled** "
                f"[{item.get('rule', '?')}] {item.get('description', '')} "
                f"(what-if: {mut.get('kind', '?')}"
                + (f" {mut_bits}" if mut_bits else "")
                + f"; confidence {item.get('confidence', 0.0):.2f})")
        return lines

    def _occupancy_lines(self) -> List[str]:
        """Human-readable wave-residency lines ("8 resident waves, 54% of
        hideable latency covered") shared by markdown and LLM views."""
        occ = self.occupancy or {}
        if not occ.get("recorded"):
            return []
        lines = [
            f"{occ.get('waves', 1)} resident wave(s) per queue "
            f"({occ.get('limiter', 'none')}-limited, "
            f"{occ.get('window_cycles', 0.0):,.0f}-cycle hiding window): "
            f"{occ.get('hidden_cycles', 0.0):,.0f} stall cycles hidden, "
            f"{occ.get('exposed_cycles', 0.0):,.0f} exposed "
            f"({occ.get('hidden_fraction', 0.0):.0%} hidden)"
        ]
        if occ.get("limited"):
            lines.append(
                f"latency hiding ran out of waves: "
                f"{occ.get('occupancy_limited_cycles', 0.0):,.0f} "
                f"occupancy-limited stall cycles leaked through")
        for q in occ.get("per_queue", []):
            if q.get("hidden_cycles", 0.0) or q.get("exposed_cycles", 0.0):
                lines.append(
                    f"queue {q['queue']}: {q.get('hidden_cycles', 0.0):,.0f}"
                    f" hidden / {q.get('exposed_cycles', 0.0):,.0f} exposed"
                    f" cycles")
        for b in occ.get("blame", [])[:3]:
            lines.append(
                f"`{b['consumer']}` outran queue {b['queue']}'s waves "
                f"waiting on `{b['blocker']}` ({b['stall_class']}: "
                f"{b['hidden_cycles']:,.0f} hidden, "
                f"{b['exposed_cycles']:,.0f} exposed cycles)")
        return lines

    def _rewrite_lines(self, top_k: int = 5) -> List[str]:
        """Human-readable applied-rewrite lines ("1.32x realized (100% of
        predicted) CoalesceSyncTags …") shared by the markdown and LLM
        views; empty when not recorded."""
        rw = self.rewrites or {}
        if not rw.get("recorded"):
            return []
        lines: List[str] = []
        for item in rw.get("items", [])[:top_k]:
            mut = item.get("mutation", {})
            lines.append(
                f"**{item.get('realized_speedup', 0.0):.2f}x realized** "
                f"({item.get('realized_fraction', 0.0):.0%} of the "
                f"{item.get('predicted_speedup', 0.0):.2f}x predicted) "
                f"[{item.get('rule', '?')}, {item.get('source', '?')}] "
                f"{mut.get('kind', '?')} — certificate: "
                f"{item.get('certificate', {}).get('declared', '?')}")
        for s in rw.get("skipped", [])[:3]:
            refusal = s.get("refusal", {})
            lines.append(
                f"skipped [{s.get('rule', '?')}]: "
                f"{refusal.get('code', '?')} — {refusal.get('reason', '')}")
        return lines

    def to_markdown(self) -> str:
        """Human-readable report (the profiler-UI rendering)."""
        lines = [
            f"# LEO diagnosis — `{self.module_name}` on `{self.backend}`",
            "",
            f"- estimated step time: "
            f"**{self.estimated_step_seconds*1e3:.3f} ms**",
            f"- total stall cycles: {self.total_stall_cycles:,.0f}",
            f"- single-dependency coverage: {self.coverage_before:.0%} -> "
            f"{self.coverage_after:.0%} after sync/prune",
            f"- edges: {self.pruning.get('initial_edges', 0)} -> "
            f"{self.pruning.get('surviving', 0)} after pruning",
        ]
        if self.vendor:
            lines.append(f"- vendor: {self.vendor}")
        if self.root_causes:
            lines += ["", "## Top root causes", ""]
            for rc in self.root_causes[:5]:
                lines.append(f"1. `{rc['instruction']}` — "
                             f"{rc['blame_cycles']:,.0f} blamed cycles"
                             + (f" (scope `{rc['scope']}`)"
                                if rc.get("scope") else ""))
        if self.chains:
            lines += ["", "## Ranked dependency chains", ""]
            for i, chain in enumerate(self.chains):
                lines.append(f"### Chain {i+1} "
                             f"({chain['stall_cycles']:,.0f} stall cycles)")
                lines += ["```", chain.get("text", ""), "```"]
        sync_lines = self._sync_resource_lines()
        if sync_lines:
            lines += ["", "## Sync-resource pressure (§III-E)", ""]
            lines += [f"- {l}" for l in sync_lines]
        issue_lines = self._issue_pressure_lines()
        if issue_lines:
            lines += ["", "## Issue-queue contention", ""]
            lines += [f"- {l}" for l in issue_lines]
        occ_lines = self._occupancy_lines()
        if occ_lines:
            lines += ["", "## Wave occupancy (latency hiding)", ""]
            lines += [f"- {l}" for l in occ_lines]
        advice_lines = self._advice_lines()
        if advice_lines:
            lines += ["", "## Optimization advice (what-if replayed)", ""]
            lines += [f"- {l}" for l in advice_lines]
        rewrite_lines = self._rewrite_lines()
        if rewrite_lines:
            lines += ["", "## Applied rewrites (predicted vs realized)", ""]
            lines += [f"- {l}" for l in rewrite_lines]
        if self.recommendations:
            lines += ["", "## Recommendations", ""]
            for r in self.recommendations:
                lines.append(f"- **{r.action}** at `{r.target}`: {r.reason} "
                             f"(~{r.est_cycles:,.0f} cycles)")
        return "\n".join(lines) + "\n"

    def to_llm_context(self, level: str, code: str = "") -> str:
        """§IV diagnostic-context payloads (C / C+S / C+L(S) / C+L(S,A)
        — the last appends the ranked what-if-replayed advice)."""
        if level == "C":
            return _context_c(code)
        if level == "C+S":
            lines = [_context_c(code), "### Raw stall counts (PC sampling)"]
            for s in self.top_stalls:
                brk = ", ".join(f"{k}={v:,.0f}"
                                for k, v in s["breakdown"].items())
                lines.append(f"- `{s['instruction']}` [{s['opcode']}]: "
                             f"{s['latency_samples']:,.0f} stall cycles "
                             f"({brk})")
            return "\n".join(lines) + "\n"
        if level in ("C+L(S)", "C+L(S,A)"):
            lines = [_context_c(code), "### LEO root-cause analysis"]
            lines.append(f"Estimated step time: "
                         f"{self.estimated_step_seconds*1e3:.3f} ms on "
                         f"{self.backend}")
            lines.append("#### Ranked dependency chains "
                         "(symptom -> root cause)")
            for i, chain in enumerate(self.chains):
                lines.append(f"Chain {i+1} "
                             f"({chain['stall_cycles']:,.0f} stall cycles):")
                lines.append(chain.get("text", ""))
            sync_lines = self._sync_resource_lines()
            if sync_lines:
                lines.append("#### Vendor sync-resource pressure")
                lines += [f"- {l}" for l in sync_lines]
            issue_lines = self._issue_pressure_lines()
            if issue_lines:
                lines.append("#### Issue-queue (scheduler) contention")
                lines += [f"- {l}" for l in issue_lines]
            occ_lines = self._occupancy_lines()
            if occ_lines:
                lines.append("#### Wave occupancy (latency hiding)")
                lines += [f"- {l}" for l in occ_lines]
            lines.append("#### Recommendations")
            for r in self.recommendations:
                lines.append(f"- [{r.action}] {r.reason} "
                             f"(~{r.est_cycles:,.0f} cycles at `{r.target}`"
                             f"{', scope ' + r.scope if r.scope else ''})")
            if level == "C+L(S,A)":
                advice_lines = self._advice_lines()
                lines.append("#### Ranked optimization advice "
                             "(what-if replayed)")
                if advice_lines:
                    lines += [f"- {l}" for l in advice_lines]
                else:
                    lines.append("- (advice not recorded: the request did "
                                 "not run the advisor)")
                rewrite_lines = self._rewrite_lines()
                if rewrite_lines:
                    lines.append("#### Applied rewrites "
                                 "(predicted vs realized)")
                    lines += [f"- {l}" for l in rewrite_lines]
            return "\n".join(lines) + "\n"
        raise ValueError(f"unknown context level {level!r}")


def _context_c(code: str) -> str:
    return f"### Kernel source\n```\n{code}\n```\n"


# --------------------------------------------------------------------------
# Deprecation shims — byte-identical delegates to Diagnosis.
# --------------------------------------------------------------------------

def recommendations(analysis: LeoAnalysis, limit: int = 8
                    ) -> List[Recommendation]:
    """Deprecated: use ``Diagnosis.from_analysis(analysis).recommendations``."""
    _deprecated("recommendations", "Diagnosis.from_analysis(...).recommendations")
    return _build_recommendations(analysis, limit)


def structured_report(analysis: LeoAnalysis, max_chains: int = 5) -> dict:
    """Deprecated: use ``Diagnosis.from_analysis(analysis).to_dict()``."""
    _deprecated("structured_report", "Diagnosis.from_analysis(...).to_dict()")
    return Diagnosis.from_analysis(analysis, max_chains=max_chains).to_dict()


def context_c(code: str) -> str:
    """Deprecated: use ``Diagnosis.to_llm_context('C', code=...)``."""
    return _context_c(code)


def context_cs(code: str, analysis: LeoAnalysis) -> str:
    """Deprecated: use ``Diagnosis.to_llm_context('C+S', code=...)``."""
    return Diagnosis.from_analysis(analysis).to_llm_context("C+S", code=code)


def context_cls(code: str, analysis: LeoAnalysis) -> str:
    """Deprecated: use ``Diagnosis.to_llm_context('C+L(S)', code=...)``."""
    return Diagnosis.from_analysis(analysis).to_llm_context("C+L(S)",
                                                            code=code)


def diagnostic_context(level: str, code: str,
                       analysis: Optional[LeoAnalysis] = None) -> str:
    """Deprecated: use ``Diagnosis.to_llm_context(level, code=...)``."""
    _deprecated("diagnostic_context", "Diagnosis.to_llm_context(level, code)")
    if level == "C":
        return _context_c(code)
    if analysis is None:
        raise ValueError("levels C+S and C+L(S) require an analysis")
    if level in ("C+S", "C+L(S)"):
        return Diagnosis.from_analysis(analysis).to_llm_context(level,
                                                                code=code)
    raise ValueError(f"unknown context level {level!r}")


def save_json(analysis: LeoAnalysis, path: str) -> None:
    """Deprecated: use ``Diagnosis.from_analysis(analysis).save(path)``."""
    _deprecated("save_json", "Diagnosis.from_analysis(...).save(path)")
    with open(path, "w") as f:
        json.dump(Diagnosis.from_analysis(analysis).to_dict(), f, indent=2)
