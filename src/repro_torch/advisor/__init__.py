"""`repro_torch.advisor` — what-if replay + cross-vendor optimization advice.

The subsystem that turns LEO's evidence channels (backward-slice blame,
``sync_resources``, ``issue_pressure``) into ranked, speedup-quantified
optimization advice — the paper's headline payoff (LEO-guided fixes:
1.73x-1.82x geomean), in three layers:

  * :mod:`repro_torch.advisor.whatif`  — declarative :class:`Mutation`s over the
    model stack, replayed deterministically by :class:`WhatIfEngine`;
  * :mod:`repro_torch.advisor.rules`   — evidence-pattern matchers with
    vendor-native phrasing (barriers vs waitcnt vs SBIDs);
  * :mod:`repro_torch.advisor.advisor` — ranks priced candidates into typed
    :class:`Advice`, landed in Diagnosis schema v4.

::

    from repro_torch.advisor import Advisor
    report = Advisor().report(module, backend)
    for a in report.advice:
        print(f"{a.modeled_speedup:5.2f}x  {a.rule}: {a.description}")
"""
from .advisor import Advice, Advisor, AdvisorReport, advice_section
from .rules import RULES, Evidence, Rule, match_rules, rule_by_name
from .whatif import (
    CoalesceSyncTags,
    Compose,
    Identity,
    Mutation,
    PipelineAsyncChain,
    RelaxSyncEdge,
    ResizePool,
    ScaleLatency,
    SetIssue,
    SetOccupancy,
    TreeReduceChain,
    WhatIfEngine,
    WhatIfResult,
    mutation_from_dict,
    profile_fingerprint,
    sync_resource_stall_cycles,
)

__all__ = [
    "Advice", "Advisor", "AdvisorReport", "advice_section",
    "RULES", "Evidence", "Rule", "match_rules", "rule_by_name",
    "Mutation", "Identity", "ResizePool", "SetIssue", "SetOccupancy",
    "ScaleLatency",
    "CoalesceSyncTags", "PipelineAsyncChain", "RelaxSyncEdge",
    "TreeReduceChain", "Compose",
    "WhatIfEngine", "WhatIfResult", "mutation_from_dict",
    "profile_fingerprint", "sync_resource_stall_cycles",
]
