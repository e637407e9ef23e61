"""Composable analysis-pass pipeline (the redesigned core API).

The seed inlined LEO's phases into one monolithic ``analyze_module``; here
each phase is a named, reorderable, individually-testable
:class:`AnalysisPass` that reads/writes a shared :class:`AnalysisContext`:

    sample -> depgraph -> coverage_before -> sync_edges -> prune
           -> coverage_after -> blame -> chains -> cct

A :class:`Pipeline` validates data-flow order (a pass may only require what
an earlier pass provides), times every pass, and records per-pass stats.
``Pipeline`` instances are immutable; ``with_pass`` / ``without`` /
``replaced`` / ``reordered`` derive variants, so third parties insert
custom passes without editing core files — the same extension contract the
backend registry gives vendors.

:class:`LeoAnalysis` (the result object every benchmark and report consumes)
lives here; ``repro.core.analyzer`` re-exports it and keeps the legacy
``analyze_*`` functions as thin shims over :func:`default_pipeline`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .backends import Backend, BackendLike, resolve_backend
from .blame import BlameResult, attribute_blame
from .cct import CCTNode, build_cct
from .coverage import CoverageReport, single_dependency_coverage
from .depgraph import DependencyGraph, build_dependency_graph
from .hwmodel import HardwareModel
from .isa import Module
from .pruning import PruneStats, prune
from .sampler import StallProfile, VirtualSampler
from .slicing import StallChain, top_chains
from .sync_trace import add_sync_edges


# --------------------------------------------------------------------------
# Result object (moved from analyzer.py; analyzer re-exports it).
# --------------------------------------------------------------------------

@dataclass
class LeoAnalysis:
    module: Module
    hw: HardwareModel
    profile: StallProfile
    graph: DependencyGraph
    prune_stats: PruneStats
    blame: BlameResult
    chains: List[StallChain]
    coverage_before: CoverageReport
    coverage_after: CoverageReport
    cct: CCTNode
    sync_edges_added: int = 0
    analysis_seconds: float = 0.0
    backend: Optional[Backend] = None
    pass_seconds: Dict[str, float] = field(default_factory=dict)
    # Per-pool §III-E sync-resource pressure (SyncPressureReport): dynamic
    # scoreboard stats from the sampler merged with per-instance sync-edge
    # counts from the sync_edges pass; None when the pipeline ran without
    # the sync_edges pass or the backend declares no resource pools.
    sync_pressure: Optional[Any] = None
    # Per-queue issue-port pressure (IssuePressureReport) from the
    # sampler's multi-stream issue model; None for measured profiles.
    issue_pressure: Optional[Any] = None
    # Per-queue latency-hiding pressure (OccupancyPressureReport) from the
    # sampler's multi-wave occupancy model; None for measured profiles and
    # for W=1 runs.
    occupancy_pressure: Optional[Any] = None

    @property
    def estimated_step_seconds(self) -> float:
        return self.profile.makespan_seconds

    def top_root_causes(self, n: int = 10):
        return self.blame.top_root_causes(n)

    def summary(self) -> str:
        lines = [
            f"LEO analysis [{self.hw.name}] module={self.module.name}",
            f"  instructions={sum(len(c.instructions) for c in self.module.computations.values())}"
            f" edges={self.prune_stats.initial_edges}"
            f" (+{self.sync_edges_added} sync)"
            f" -> {self.prune_stats.surviving_edges} after pruning "
            f"{dict(self.prune_stats.pruned_by_stage)}",
            f"  est. step time: {self.estimated_step_seconds*1e3:.3f} ms, "
            f"total stall cycles: {self.profile.total_stall_cycles:,.0f}",
            f"  single-dep coverage: {self.coverage_before.coverage:.0%} -> "
            f"{self.coverage_after.coverage:.0%}",
            "  top root causes:",
        ]
        for q, cycles in self.top_root_causes(5):
            instr = self.module.find(q)
            where = instr.op_name if instr is not None else ""
            lines.append(f"    {cycles:14,.0f} cyc  {q}  [{where}]")
        if self.blame.self_blame:
            top_self = sorted(self.blame.self_blame, key=lambda s: -s.cycles)[:3]
            lines.append("  self-blame:")
            for s in top_self:
                lines.append(f"    {s.cycles:14,.0f} cyc  {s.qualified}  "
                             f"({s.subcategory})")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Shared pass state.
# --------------------------------------------------------------------------

#: Context fields available before any pass runs.
_INITIAL_FIELDS = ("module", "backend", "options")


@dataclass
class PassStat:
    name: str
    seconds: float
    provided: Tuple[str, ...]


@dataclass
class AnalysisContext:
    """Mutable state threaded through the pipeline.

    Passes read the fields named in their ``requires`` and fill the fields
    named in their ``provides``; ``options`` carries tuning knobs
    (``n_chains``, ``prune_unexecuted``); ``cache`` is an optional
    session-owned object giving passes memoized artifacts (see
    ``LeoSession``).
    """

    module: Module
    backend: Backend
    options: Dict[str, Any] = field(default_factory=dict)
    profile: Optional[StallProfile] = None
    graph: Optional[DependencyGraph] = None
    coverage_before: Optional[CoverageReport] = None
    coverage_after: Optional[CoverageReport] = None
    sync_edges_added: Optional[int] = None
    sync_pressure: Optional[Any] = None
    prune_stats: Optional[PruneStats] = None
    blame: Optional[BlameResult] = None
    chains: Optional[List[StallChain]] = None
    cct: Optional[CCTNode] = None
    pass_stats: List[PassStat] = field(default_factory=list)
    cache: Optional[Any] = None       # session cache hook (duck-typed)
    module_key: Optional[str] = None  # content hash when session-managed

    @property
    def hw(self) -> HardwareModel:
        return self.backend.hw

    def provided(self, name: str) -> bool:
        return getattr(self, name, None) is not None

    def to_analysis(self, analysis_seconds: float = 0.0) -> LeoAnalysis:
        missing = [f for f in ("profile", "graph", "prune_stats", "blame",
                               "chains", "coverage_before", "coverage_after",
                               "cct") if not self.provided(f)]
        if missing:
            raise IncompletePipelineError(
                f"pipeline finished without providing {missing}; add the "
                f"passes that produce them or consume the context directly")
        return LeoAnalysis(
            module=self.module, hw=self.hw, profile=self.profile,
            graph=self.graph, prune_stats=self.prune_stats, blame=self.blame,
            chains=self.chains, coverage_before=self.coverage_before,
            coverage_after=self.coverage_after, cct=self.cct,
            sync_edges_added=self.sync_edges_added or 0,
            analysis_seconds=analysis_seconds, backend=self.backend,
            pass_seconds={s.name: s.seconds for s in self.pass_stats},
            sync_pressure=self.sync_pressure,
            issue_pressure=getattr(self.profile, "issue_pressure", None),
            occupancy_pressure=getattr(self.profile, "occupancy_pressure",
                                       None))


class PipelineOrderError(ValueError):
    """A pass requires a field no earlier pass (or initial state) provides."""


class IncompletePipelineError(ValueError):
    """`to_analysis` called on a context missing required artifacts."""


# --------------------------------------------------------------------------
# Pass objects.
# --------------------------------------------------------------------------

class AnalysisPass:
    """One named pipeline stage.

    Subclasses declare ``name``, data-flow contracts (``requires`` /
    ``provides`` — AnalysisContext field names), and implement ``run``.
    """

    name: str = "<unnamed>"
    requires: Tuple[str, ...] = ()
    provides: Tuple[str, ...] = ()

    def run(self, ctx: AnalysisContext) -> None:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class SamplePass(AnalysisPass):
    """Phase 1: virtual PC sampling (skipped when a measured profile was
    supplied — the paper's real-hardware input path)."""

    name = "sample"
    provides = ("profile",)

    def run(self, ctx: AnalysisContext) -> None:
        if ctx.profile is None:
            ctx.profile = VirtualSampler(ctx.module, ctx.hw,
                                         sync=ctx.backend.sync).run()


class DepGraphPass(AnalysisPass):
    """Phase 3a: CCT dependency graph from SSA/region dataflow."""

    name = "depgraph"
    provides = ("graph",)

    def run(self, ctx: AnalysisContext) -> None:
        if ctx.cache is not None and ctx.module_key is not None:
            ctx.graph = ctx.cache.graph_for(ctx.module_key, ctx.module,
                                            ctx.backend)
        else:
            ctx.graph = build_dependency_graph(ctx.module, ctx.hw)


class CoverageSnapshotPass(AnalysisPass):
    """Single-dependency coverage of the graph *as it stands now* — placed
    twice in the default pipeline (before sync/prune, and after)."""

    requires = ("graph",)

    def __init__(self, label: str):
        if label not in ("before", "after"):
            raise ValueError(f"coverage snapshot label must be "
                             f"'before'/'after', got {label!r}")
        self.label = label
        self.name = f"coverage_{label}"
        self.provides = (f"coverage_{label}",)

    def run(self, ctx: AnalysisContext) -> None:
        setattr(ctx, f"coverage_{self.label}",
                single_dependency_coverage(ctx.graph))


class SyncEdgesPass(AnalysisPass):
    """Phase 3b: §III-E synchronization edges (barrier / waitcnt / token).

    With a backend ``SyncModel``, every sync edge is annotated with the
    concrete resource instance it consumed, and the pass exports
    ``sync_pressure``: the sampler's dynamic scoreboard report (peak
    in-flight, oversubscription events) extended with per-instance
    sync-edge counts."""

    name = "sync_edges"
    requires = ("graph",)
    provides = ("sync_edges_added", "sync_pressure")

    def run(self, ctx: AnalysisContext) -> None:
        sync = getattr(ctx.backend, "sync", None)
        assignment = getattr(ctx.profile, "sync_assignment", None) \
            if ctx.profile is not None else None
        queues = getattr(ctx.backend, "issue", None)
        ctx.sync_edges_added = add_sync_edges(
            ctx.graph, sync=sync, assignment=assignment,
            queues=queues.queues if queues is not None else 1)
        ctx.sync_pressure = self._pressure_report(ctx, sync)

    def _pressure_report(self, ctx: AnalysisContext, sync):
        if sync is None or not getattr(sync, "pools", ()):
            return None
        report = getattr(ctx.profile, "sync_pressure", None) \
            if ctx.profile is not None else None
        if report is None:
            # measured profile (or sample pass removed): static-only view,
            # minted at the backend's queue count so its instance
            # namespace matches the q-prefixed edge annotations
            issue = getattr(ctx.backend, "issue", None)
            report = sync.scoreboard(
                queues=issue.queues if issue is not None else 1).report()
        by_instance: Dict[str, int] = {}
        for e in ctx.graph.edges:
            if e.kind.is_sync and e.resource is not None:
                by_instance[e.resource] = by_instance.get(e.resource, 0) + 1
        for pool in report.pools:
            pool["edges_per_instance"] = {
                inst: by_instance[inst] for inst in pool["instances"]
                if inst in by_instance}
        return report


class PrunePass(AnalysisPass):
    """Phase 4: four-stage pruning (opcode/barrier/latency/execution)."""

    name = "prune"
    requires = ("graph", "profile")
    provides = ("prune_stats",)

    def run(self, ctx: AnalysisContext) -> None:
        ctx.prune_stats = prune(
            ctx.graph, ctx.profile, ctx.hw,
            prune_unexecuted=ctx.options.get("prune_unexecuted", True))


class BlamePass(AnalysisPass):
    """Phase 5: inverse-distance four-factor blame attribution."""

    name = "blame"
    requires = ("graph", "profile")
    provides = ("blame",)

    def run(self, ctx: AnalysisContext) -> None:
        ctx.blame = attribute_blame(ctx.graph, ctx.profile, ctx.hw)


class ChainsPass(AnalysisPass):
    """Backward slicing: ranked symptom->root-cause dependency chains."""

    name = "chains"
    requires = ("graph", "profile", "blame")
    provides = ("chains",)

    def run(self, ctx: AnalysisContext) -> None:
        ctx.chains = top_chains(ctx.graph, ctx.profile, ctx.blame,
                                n=ctx.options.get("n_chains", 5))


class CCTPass(AnalysisPass):
    """Calling-context tree with per-scope stall aggregation."""

    name = "cct"
    requires = ("profile",)
    provides = ("cct",)

    def run(self, ctx: AnalysisContext) -> None:
        ctx.cct = build_cct(ctx.module, ctx.profile)


# --------------------------------------------------------------------------
# Pipeline.
# --------------------------------------------------------------------------

#: hook signatures: on_pass_start(pass_, ctx); on_pass_end(pass_, ctx, secs)
PassStartHook = Callable[[AnalysisPass, AnalysisContext], None]
PassEndHook = Callable[[AnalysisPass, AnalysisContext, float], None]


class Pipeline:
    """An ordered, validated sequence of analysis passes."""

    def __init__(self, passes: Sequence[AnalysisPass],
                 on_pass_start: Optional[PassStartHook] = None,
                 on_pass_end: Optional[PassEndHook] = None):
        names = [p.name for p in passes]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate pass names: {sorted(dupes)}")
        self.passes: Tuple[AnalysisPass, ...] = tuple(passes)
        self.on_pass_start = on_pass_start
        self.on_pass_end = on_pass_end
        self._validate()

    # -- construction helpers (all return new Pipelines) ---------------------

    def _derive(self, passes: Sequence[AnalysisPass]) -> "Pipeline":
        return Pipeline(passes, self.on_pass_start, self.on_pass_end)

    def with_pass(self, pass_: AnalysisPass, *, before: Optional[str] = None,
                  after: Optional[str] = None) -> "Pipeline":
        if (before is None) == (after is None):
            raise ValueError("specify exactly one of before=/after=")
        anchor = before if before is not None else after
        idx = self.index(anchor)
        at = idx if before is not None else idx + 1
        return self._derive(self.passes[:at] + (pass_,) + self.passes[at:])

    def without(self, name: str) -> "Pipeline":
        idx = self.index(name)
        return self._derive(self.passes[:idx] + self.passes[idx + 1:])

    def replaced(self, name: str, pass_: AnalysisPass) -> "Pipeline":
        idx = self.index(name)
        return self._derive(self.passes[:idx] + (pass_,)
                            + self.passes[idx + 1:])

    def reordered(self, names: Sequence[str]) -> "Pipeline":
        if sorted(names) != sorted(p.name for p in self.passes):
            raise ValueError(
                f"reorder must permute exactly {[p.name for p in self.passes]}")
        by_name = {p.name: p for p in self.passes}
        return self._derive([by_name[n] for n in names])

    def index(self, name: str) -> int:
        for i, p in enumerate(self.passes):
            if p.name == name:
                return i
        raise KeyError(f"no pass named {name!r}; have "
                       f"{[p.name for p in self.passes]}")

    @property
    def names(self) -> List[str]:
        return [p.name for p in self.passes]

    # -- validation / execution ----------------------------------------------

    def _validate(self) -> None:
        available = set(_INITIAL_FIELDS)
        for p in self.passes:
            missing = [r for r in p.requires if r not in available]
            if missing:
                raise PipelineOrderError(
                    f"pass {p.name!r} requires {missing} but only "
                    f"{sorted(available)} are available at its position")
            available.update(p.provides)

    def run(self, module: Module, backend: BackendLike,
            profile: Optional[StallProfile] = None,
            cache: Optional[Any] = None,
            module_key: Optional[str] = None,
            **options: Any) -> AnalysisContext:
        ctx = AnalysisContext(module=module,
                              backend=resolve_backend(backend),
                              options=dict(options), profile=profile,
                              cache=cache, module_key=module_key)
        for p in self.passes:
            if self.on_pass_start is not None:
                self.on_pass_start(p, ctx)
            t0 = time.perf_counter()
            p.run(ctx)
            dt = time.perf_counter() - t0
            ctx.pass_stats.append(PassStat(name=p.name, seconds=dt,
                                           provided=p.provides))
            if self.on_pass_end is not None:
                self.on_pass_end(p, ctx, dt)
        return ctx

    def analyze(self, module: Module, backend: BackendLike,
                profile: Optional[StallProfile] = None,
                **options: Any) -> LeoAnalysis:
        t0 = time.perf_counter()
        ctx = self.run(module, backend, profile=profile, **options)
        return ctx.to_analysis(analysis_seconds=time.perf_counter() - t0)

    def __repr__(self) -> str:
        return f"Pipeline({' -> '.join(self.names)})"


def default_pipeline(on_pass_start: Optional[PassStartHook] = None,
                     on_pass_end: Optional[PassEndHook] = None) -> Pipeline:
    """The paper's 5-phase workflow as the canonical pass sequence."""
    return Pipeline([
        SamplePass(),
        DepGraphPass(),
        CoverageSnapshotPass("before"),
        SyncEdgesPass(),
        PrunePass(),
        CoverageSnapshotPass("after"),
        BlamePass(),
        ChainsPass(),
        CCTPass(),
    ], on_pass_start=on_pass_start, on_pass_end=on_pass_end)


#: Shared default instance used by the legacy shims and new sessions.
DEFAULT_PIPELINE = default_pipeline()
