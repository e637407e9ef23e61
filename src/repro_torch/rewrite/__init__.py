"""repro_torch.rewrite — advice-to-HLO rewrites closing the optimize loop.

Three layers (see docs/rewrite.md):

  * :mod:`repro_torch.rewrite.printer` — faithful HLO text emitter;
    ``parse_hlo(emit_hlo(m), hints) == m`` for any parser-produced ``m``;
  * :mod:`repro_torch.rewrite.rewriters` — per-mutation program rewriters with
    structural-equivalence certificates and typed refusals;
  * :mod:`repro_torch.rewrite.loop` — the :class:`RewriteLoop` that applies
    top-k advice (singly and stacked) and reports predicted-vs-realized
    speedup, surfaced as the Diagnosis v5 ``rewrites`` section.
"""
from .loop import RewriteLoop, RewriteOutcome, RewriteReport, \
    rewrites_section
from .printer import PrinterError, emit_hlo, emit_instruction, emit_shape
from .rewriters import (
    REWRITABLE_KINDS,
    EquivalenceCertificate,
    EquivalenceViolation,
    NotApplicable,
    RewriteError,
    RewriteResult,
    apply_rewrite,
    is_rewritable,
)

__all__ = [
    "emit_hlo", "emit_shape", "emit_instruction", "PrinterError",
    "RewriteError", "NotApplicable", "EquivalenceViolation",
    "EquivalenceCertificate", "RewriteResult", "REWRITABLE_KINDS",
    "apply_rewrite", "is_rewritable",
    "RewriteLoop", "RewriteOutcome", "RewriteReport", "rewrites_section",
]
