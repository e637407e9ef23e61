"""The closed loop: diagnose -> advise -> transform -> verify.

:class:`RewriteLoop` is the subsystem's top layer.  Given a program and
a backend it (1) runs the advisor, (2) lowers each top-k advice
mutation to an equivalence-checked HLO rewrite via
:func:`repro_torch.rewrite.rewriters.apply_rewrite`, (3) **re-analyzes the
rewritten text through the real pipeline** — the same parse -> sample
path any consumer of the text would take, not the advisor's in-memory
replay — and (4) reports predicted-vs-realized speedup per rewrite.

Advice whose mutation is hardware-side (e.g. AMD's "grow the waitcnt
counter pool") cannot be lowered directly; the loop falls back to the
*same rule's* program-rewritable candidates (a pool that cannot grow in
silicon is exactly what tag coalescing fixes in software), prices the
fallback with its own what-if replay, and records the original typed
refusal alongside (``source="rule_fallback"``).

When two or more distinct program rewrites applied, the loop also
prices and applies them *stacked* through ``Advisor.compose`` — one
joint replay, one composed rewrite, one realized number
(``source="stacked"``).

``realized_fraction`` is the headline honesty metric: the share of the
*predicted* gain the re-analyzed rewrite actually delivers
(``(realized-1)/(predicted-1)``).  The rewrite-divergence golden pins
it >= 0.8 per GPU vendor on the 48-copy storm; fractions above 1.0
happen when the re-parse re-derives cheaper costs than the advisor's
in-memory mutant carried (the text is the truth, the replay the
estimate).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from ..advisor.advisor import Advice, Advisor, AdvisorReport
from ..advisor.rules import Evidence, rule_by_name
from ..advisor.whatif import Compose, Mutation, WhatIfEngine
from ..core.backends import Backend, BackendLike, resolve_backend
from ..core.hlo_parser import parse_hlo
from ..core.isa import Module
from ..core.sampler import StallProfile, VirtualSampler
from .rewriters import NotApplicable, RewriteResult, apply_rewrite, \
    is_rewritable

__all__ = ["RewriteOutcome", "RewriteReport", "RewriteLoop",
           "rewrites_section"]


@dataclass
class RewriteOutcome:
    """One advice item carried through transform + verify."""

    rule: str
    source: str                     # "advice" | "rule_fallback" | "stacked"
    mutation: Dict[str, Any]        # the mutation actually applied
    description: str
    predicted_speedup: float
    predicted_makespan_cycles: float
    realized_speedup: float
    realized_makespan_cycles: float
    certificate: Dict[str, Any]
    hlo_sha256: str
    hlo_bytes: int
    #: the original advice's typed refusal when source == "rule_fallback"
    refusal: Optional[Dict[str, Any]] = None

    @property
    def realized_fraction(self) -> float:
        """Share of the predicted gain the re-analysis delivered."""
        if self.predicted_speedup <= 1.0:
            return 1.0
        return (self.realized_speedup - 1.0) / (self.predicted_speedup - 1.0)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "rule": self.rule,
            "source": self.source,
            "mutation": dict(self.mutation),
            "description": self.description,
            "predicted_speedup": self.predicted_speedup,
            "predicted_makespan_cycles": self.predicted_makespan_cycles,
            "realized_speedup": self.realized_speedup,
            "realized_makespan_cycles": self.realized_makespan_cycles,
            "realized_fraction": self.realized_fraction,
            "certificate": dict(self.certificate),
            "hlo_sha256": self.hlo_sha256,
            "hlo_bytes": self.hlo_bytes,
        }
        if self.refusal is not None:
            out["refusal"] = dict(self.refusal)
        return out


@dataclass
class RewriteReport:
    """Full rewrite-loop outcome for one ``(program, backend)`` pair."""

    backend: str
    baseline_makespan_cycles: float
    top_k: int
    outcomes: List[RewriteOutcome] = field(default_factory=list)
    #: advice that could not be lowered at all (typed refusals)
    skipped: List[Dict[str, Any]] = field(default_factory=list)
    rewrite_seconds: float = 0.0

    @property
    def best(self) -> Optional[RewriteOutcome]:
        if not self.outcomes:
            return None
        return max(self.outcomes, key=lambda o: o.realized_speedup)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "backend": self.backend,
            "baseline_makespan_cycles": self.baseline_makespan_cycles,
            "top_k": self.top_k,
            "outcomes": [o.to_dict() for o in self.outcomes],
            "skipped": [dict(s) for s in self.skipped],
            "rewrite_seconds": self.rewrite_seconds,
        }


class RewriteLoop:
    """Apply the advisor's top-k advice as verified HLO rewrites.

    ``advisor`` defaults to a stock :class:`Advisor`; ``top_k`` bounds
    how many advice items get lowered (and how many program rewrites the
    stacked candidate may compose)."""

    def __init__(self, advisor: Optional[Advisor] = None, *,
                 top_k: int = 2):
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.advisor = advisor if advisor is not None else Advisor()
        self.top_k = top_k

    # -- verify ---------------------------------------------------------------

    @staticmethod
    def _realize(result: RewriteResult, backend: Backend,
                 hints: Optional[dict],
                 session: Optional[Any]) -> float:
        """Makespan of the rewritten *text* through the real pipeline —
        via the session (cached, full pass stack) when one is supplied,
        else a direct parse-free sampler run on the re-parsed module
        (identical by the round-trip guarantee)."""
        if session is not None:
            analysis = session.analyze(result.hlo_text, backend=backend,
                                       hints=hints)
            return analysis.profile.makespan_cycles
        profile = VirtualSampler(result.module, backend.hw,
                                 sync=backend.sync).run()
        return profile.makespan_cycles

    # -- fallback -------------------------------------------------------------

    def _fallback(self, module: Module, advice: Advice,
                  evidence: Evidence, engine: WhatIfEngine,
                  hints: Optional[dict]):
        """Best program-rewritable candidate of the advice's own rule,
        priced by replay.  Returns ``(whatif_result, rewrite_result)`` or
        ``None`` when the rule offers nothing rewritable here."""
        try:
            rule = rule_by_name(advice.rule)
        except KeyError:
            return None
        # price every rewritable candidate first (a replay is one cheap
        # sampler run), then pay the expensive emit + re-parse + certify
        # of apply_rewrite only for the best one that actually applies
        priced = [engine.replay(cand) for cand in rule.candidates(evidence)
                  if is_rewritable(cand)]
        priced.sort(key=lambda r: -r.modeled_speedup)
        for result in priced:
            try:
                rewritten = apply_rewrite(module, result.mutation,
                                          hints=hints)
            except NotApplicable:
                continue
            return result, rewritten
        return None

    # -- the loop -------------------------------------------------------------

    def run(self, program: Union[str, Module], backend: BackendLike, *,
            hints: Optional[dict] = None,
            profile: Optional[StallProfile] = None,
            blame: Optional[object] = None,
            advisor_report: Optional[AdvisorReport] = None,
            session: Optional[Any] = None) -> RewriteReport:
        """Close the loop once.  ``session`` (a ``LeoSession`` /
        ``LeoService``-owned session) routes verification through the
        cached full pipeline; ``profile``/``blame``/``advisor_report``
        let a caller that already diagnosed skip re-paying those runs."""
        t0 = time.perf_counter()
        b = resolve_backend(backend)
        module = parse_hlo(program, hints) if isinstance(program, str) \
            else program
        if profile is None:
            profile = VirtualSampler(module, b.hw, sync=b.sync).run()
        if advisor_report is None:
            advisor_report = self.advisor.report(module, b, profile=profile,
                                                 blame=blame)
        evidence = Evidence(backend=b, profile=profile, blame=blame)
        engine = WhatIfEngine(module, b)
        engine._baseline = profile
        baseline = advisor_report.baseline_makespan_cycles

        report = RewriteReport(backend=b.name,
                               baseline_makespan_cycles=baseline,
                               top_k=self.top_k)
        applied_parts: List[Mutation] = []
        applied_keys: set = set()
        for advice in advisor_report.advice[:self.top_k]:
            mutation = advice.to_mutation()
            refusal: Optional[Dict[str, Any]] = None
            try:
                rewritten = apply_rewrite(module, mutation, hints=hints)
                source = "advice"
                predicted = advice.modeled_speedup
            except NotApplicable as refused:
                fallback = self._fallback(module, advice, evidence,
                                          engine, hints)
                if fallback is None:
                    report.skipped.append({
                        "rule": advice.rule,
                        "mutation": dict(advice.mutation),
                        "refusal": refused.to_dict(),
                    })
                    continue
                priced, rewritten = fallback
                mutation = priced.mutation
                source = "rule_fallback"
                predicted = priced.modeled_speedup
                refusal = refused.to_dict()
            realized_makespan = self._realize(rewritten, b, hints, session)
            realized = baseline / realized_makespan \
                if realized_makespan > 0 else 1.0
            report.outcomes.append(RewriteOutcome(
                rule=advice.rule,
                source=source,
                mutation=rewritten.mutation,
                description=advice.description,
                predicted_speedup=predicted,
                predicted_makespan_cycles=baseline / predicted
                if predicted > 0 else baseline,
                realized_speedup=realized,
                realized_makespan_cycles=realized_makespan,
                certificate=rewritten.certificate.to_dict(),
                hlo_sha256=hashlib.sha256(
                    rewritten.hlo_text.encode("utf-8")).hexdigest(),
                hlo_bytes=len(rewritten.hlo_text),
                refusal=refusal,
            ))
            key = repr(sorted(rewritten.mutation.items(), key=str))
            if rewritten.changed and key not in applied_keys:
                applied_keys.add(key)
                applied_parts.append(mutation)

        if len(applied_parts) >= 2:
            self._run_stacked(module, b, hints, profile, advisor_report,
                              applied_parts, session, report)
        report.rewrite_seconds = time.perf_counter() - t0
        return report

    def _run_stacked(self, module: Module, backend: Backend,
                     hints: Optional[dict], profile: StallProfile,
                     advisor_report: AdvisorReport,
                     parts: List[Mutation], session: Optional[Any],
                     report: RewriteReport) -> None:
        """Price the applied rewrites jointly (one ``Advisor.compose``
        replay), apply them stacked, and verify the composition."""
        composed_report = self.advisor.compose(
            module, backend, report=advisor_report, mutations=parts,
            profile=profile)
        composed = next((a for a in composed_report.advice
                         if a.mutation.get("kind") == "Compose"), None)
        if composed is None:
            return      # joint replay priced the stack at <= 1.0x
        try:
            rewritten = apply_rewrite(module, Compose(parts=tuple(parts)),
                                      hints=hints)
        except NotApplicable as refused:
            report.skipped.append({
                "rule": composed.rule,
                "mutation": dict(composed.mutation),
                "refusal": refused.to_dict(),
            })
            return
        realized_makespan = self._realize(rewritten, backend, hints, session)
        baseline = report.baseline_makespan_cycles
        report.outcomes.append(RewriteOutcome(
            rule=composed.rule,
            source="stacked",
            mutation=rewritten.mutation,
            description=composed.description,
            predicted_speedup=composed.modeled_speedup,
            predicted_makespan_cycles=baseline / composed.modeled_speedup
            if composed.modeled_speedup > 0 else baseline,
            realized_speedup=baseline / realized_makespan
            if realized_makespan > 0 else 1.0,
            realized_makespan_cycles=realized_makespan,
            certificate=rewritten.certificate.to_dict(),
            hlo_sha256=hashlib.sha256(
                rewritten.hlo_text.encode("utf-8")).hexdigest(),
            hlo_bytes=len(rewritten.hlo_text),
        ))


def rewrites_section(report: RewriteReport) -> Dict[str, Any]:
    """The JSON-pure Diagnosis-v5 ``rewrites`` section for a ran loop
    (contrast :data:`repro_torch.core.report.REWRITES_NOT_RECORDED`)."""
    return {
        "recorded": True,
        "count": len(report.outcomes),
        "items": [o.to_dict() for o in report.outcomes],
        "skipped": [dict(s) for s in report.skipped],
        "baseline_makespan_cycles": report.baseline_makespan_cycles,
        "top_k": report.top_k,
    }
