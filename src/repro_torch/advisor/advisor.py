"""The optimization advisor: matched rules, priced by what-if replay.

Ties the two lower layers together, GPA-style (estimate-backed
optimizers): :func:`repro_torch.advisor.rules.match_rules` proposes candidate
:class:`Mutation`s from the diagnosed evidence, the
:class:`~repro_torch.advisor.whatif.WhatIfEngine` replays each one through the
virtual sampler, and every matched rule becomes one typed :class:`Advice`
carrying its best candidate's modeled speedup.  Advice ranks by
``modeled_speedup x confidence`` so a confident rule with a priced-in
2x counterfactual outranks a speculative one with 2.1x.

The advice list lands in ``Diagnosis`` schema v4 as the JSON-pure
``advice`` section (see :data:`repro_torch.core.report.ADVICE_NOT_RECORDED` for
the not-run / pre-v4 default) and renders through
``Diagnosis.to_markdown`` / ``to_llm_context("C+L(S,A)")``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.backends import Backend
from ..core.isa import Module
from ..core.sampler import StallProfile
from .rules import RULES, Evidence, Rule, match_rules
from .whatif import Compose, Mutation, WhatIfEngine, mutation_from_dict

__all__ = ["Advice", "AdvisorReport", "Advisor", "advice_section"]


@dataclass
class Advice:
    """One ranked recommendation: rule + priced mutation + evidence."""

    rule: str                       # Rule.name
    mutation: Dict[str, Any]        # Mutation.to_dict() of the best candidate
    description: str                # vendor-native phrasing
    modeled_speedup: float
    modeled_delta_cycles: float
    confidence: float
    evidence: List[str] = field(default_factory=list)

    @property
    def score(self) -> float:
        return self.modeled_speedup * self.confidence

    def to_mutation(self) -> Mutation:
        return mutation_from_dict(self.mutation)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "mutation": dict(self.mutation),
            "description": self.description,
            "modeled_speedup": self.modeled_speedup,
            "modeled_delta_cycles": self.modeled_delta_cycles,
            "confidence": self.confidence,
            "score": self.score,
            "evidence": list(self.evidence),
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Advice":
        return cls(
            rule=data["rule"],
            mutation=dict(data["mutation"]),
            description=data["description"],
            modeled_speedup=float(data["modeled_speedup"]),
            modeled_delta_cycles=float(data["modeled_delta_cycles"]),
            confidence=float(data["confidence"]),
            evidence=list(data.get("evidence", ())),
        )


@dataclass
class AdvisorReport:
    """Full advisor outcome for one ``(module, backend)`` pair."""

    backend: str
    advice: List[Advice]
    baseline_makespan_cycles: float
    rules_matched: int
    candidates_replayed: int
    advisor_seconds: float

    @property
    def top(self) -> Optional[Advice]:
        return self.advice[0] if self.advice else None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "backend": self.backend,
            "advice": [a.to_dict() for a in self.advice],
            "baseline_makespan_cycles": self.baseline_makespan_cycles,
            "rules_matched": self.rules_matched,
            "candidates_replayed": self.candidates_replayed,
            "advisor_seconds": self.advisor_seconds,
        }


class Advisor:
    """Match rules against evidence, price candidates, rank advice.

    ``max_candidates_per_rule`` bounds replay cost (the bench lane gates
    advise=True at < 3x plain pipeline time); ``min_speedup`` drops
    candidates whose counterfactual does not move the makespan at all
    (an unpriced rule is noise, not advice)."""

    def __init__(self, rules: Optional[List[Rule]] = None, *,
                 max_candidates_per_rule: int = 3,
                 min_speedup: float = 1.0 + 1e-9):
        self.rules = list(rules) if rules is not None else list(RULES)
        self.max_candidates_per_rule = max_candidates_per_rule
        self.min_speedup = min_speedup

    def report(self, module: Module, backend: Backend, *,
               profile: Optional[StallProfile] = None,
               blame: Optional[object] = None) -> AdvisorReport:
        t0 = time.perf_counter()
        engine = WhatIfEngine(module, backend)
        if profile is None:
            profile = engine.baseline()
        else:
            # reuse the pipeline's profile: the advisor must not re-pay
            # the baseline sampler run the diagnosis already did
            engine._baseline = profile
        evidence = Evidence(backend=backend, profile=profile, blame=blame)
        ev_lines = evidence.lines()
        matched = match_rules(evidence, self.rules)
        advice: List[Advice] = []
        replayed = 0
        for rule in matched:
            best = None
            for mutation in rule.candidates(evidence)[
                    :self.max_candidates_per_rule]:
                result = engine.replay(mutation)
                replayed += 1
                if best is None or \
                        result.modeled_speedup > best.modeled_speedup:
                    best = result
            if best is None or best.modeled_speedup < self.min_speedup:
                continue
            advice.append(Advice(
                rule=rule.name,
                mutation=best.mutation.to_dict(),
                description=rule.phrase(backend),
                modeled_speedup=best.modeled_speedup,
                modeled_delta_cycles=best.delta_cycles,
                confidence=rule.confidence,
                evidence=ev_lines,
            ))
        advice.sort(key=lambda a: (-a.score, a.rule))
        return AdvisorReport(
            backend=backend.name,
            advice=advice,
            baseline_makespan_cycles=engine.baseline().makespan_cycles,
            rules_matched=len(matched),
            candidates_replayed=replayed,
            advisor_seconds=time.perf_counter() - t0,
        )

    def advise(self, module: Module, backend: Backend, *,
               profile: Optional[StallProfile] = None,
               blame: Optional[object] = None) -> List[Advice]:
        return self.report(module, backend, profile=profile,
                           blame=blame).advice

    def compose(self, module: Module, backend: Backend, *,
                top_k: int = 2,
                profile: Optional[StallProfile] = None,
                blame: Optional[object] = None,
                report: Optional[AdvisorReport] = None,
                mutations: Optional[List[Mutation]] = None) -> AdvisorReport:
        """Price the top-k advice *stacked* and rank the composed
        candidate alongside the singles.

        Stacked fixes do not add linearly (coalescing tags can erase the
        serialization a pool resize would have bought), so the composed
        :class:`~repro_torch.advisor.whatif.Compose` gets exactly ONE joint
        what-if replay through the fully-mutated world — never a sum of
        per-part deltas.  Pass ``report`` to extend an advisor run you
        already paid for, and ``mutations`` to stack an explicit list
        (the rewrite loop does, with its applied program rewrites)
        instead of the top-k advice mutations.  Returns a new
        :class:`AdvisorReport`; the input ``report`` is not mutated."""
        t0 = time.perf_counter()
        if report is None:
            report = self.report(module, backend, profile=profile,
                                 blame=blame)
        if mutations is not None:
            parts = list(mutations)
            stacked = [a for a in report.advice
                       if any(a.mutation == p.to_dict() for p in parts)]
        else:
            stacked = report.advice[:top_k]
            parts = [a.to_mutation() for a in stacked]
        if len(parts) < 2:
            # nothing to stack: composing 0-1 mutations is the single
            return report
        engine = WhatIfEngine(module, backend)
        if profile is not None:
            engine._baseline = profile
        composed = Compose(parts=tuple(parts))
        result = engine.replay(composed)
        rule_name = "compose(" + "+".join(
            a.rule for a in stacked) + ")" if stacked else "compose"
        advice = list(report.advice)
        if result.modeled_speedup >= self.min_speedup:
            advice.append(Advice(
                rule=rule_name,
                mutation=composed.to_dict(),
                description="stacked: " + "; ".join(
                    p.describe() for p in parts),
                modeled_speedup=result.modeled_speedup,
                modeled_delta_cycles=result.delta_cycles,
                confidence=min((a.confidence for a in stacked), default=0.5),
                evidence=[f"joint replay of {len(parts)} stacked "
                          f"mutations (one sampler run, not a sum of "
                          f"per-part deltas)"],
            ))
        advice.sort(key=lambda a: (-a.score, a.rule))
        return AdvisorReport(
            backend=report.backend,
            advice=advice,
            baseline_makespan_cycles=report.baseline_makespan_cycles,
            rules_matched=report.rules_matched,
            candidates_replayed=report.candidates_replayed + engine.replays,
            advisor_seconds=report.advisor_seconds
            + (time.perf_counter() - t0),
        )


def advice_section(advice: List[Advice],
                   report: Optional[AdvisorReport] = None) -> Dict[str, Any]:
    """The JSON-pure Diagnosis-v4 ``advice`` section for a ran advisor
    (contrast :data:`repro_torch.core.report.ADVICE_NOT_RECORDED`)."""
    out: Dict[str, Any] = {
        "recorded": True,
        "count": len(advice),
        "items": [a.to_dict() for a in advice],
    }
    if report is not None:
        out["rules_matched"] = report.rules_matched
        out["candidates_replayed"] = report.candidates_replayed
        out["baseline_makespan_cycles"] = report.baseline_makespan_cycles
    return out
