"""Per-mutation program rewriters: advice -> equivalence-checked HLO.

The advisor's program-side :class:`~repro_torch.advisor.whatif.Mutation`s edit
the in-memory :class:`~repro_torch.core.isa.Module`; this layer lowers each
edit to actual HLO *text* and proves the result equivalent:

  * ``CoalesceSyncTags``  — the remapped sync sets are expressed as
    ``frontend_attributes={sync_tag="<leader>"}`` on the non-leader
    starts (the parser derives waiters' tags transitively), so the
    rewritten text re-parses to exactly the mutated sync accounting;
  * ``PipelineAsyncChain`` — instruction reordering is directly
    representable: sunk starts simply move down the program text;
  * ``TreeReduceChain``   — operand rewiring is directly representable:
    the chain's own nodes re-pair level by level, names unchanged;
  * ``Identity``          — re-emits the module verbatim (the byte-
    identity anchor the golden lanes assert);
  * ``Compose``           — applies its program-rewritable parts in
    sequence, carrying one certificate per step.

Hardware-side mutations (``ResizePool``, ``SetIssue``, ``ScaleLatency``)
have no program text to rewrite — they model a *different part*, not a
different program — and refuse with a typed :class:`NotApplicable`
(``code="hardware_mutation"``), as does ``RelaxSyncEdge`` (dropping a
wait without dropping the data operand has no HLO form;
``code="unsupported"``) and any rewrite that would leave the text
unchanged (``code="noop"``).

Every successful rewrite returns a :class:`RewriteResult` whose
``module`` is the **re-parse of the emitted text** (what any downstream
consumer of the text would see) and whose
:class:`EquivalenceCertificate` proves structural equivalence: same
computations, same instruction names/opcodes/shapes, same roots, and
dataflow-isomorphic modulo the rewrite's declared change.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..advisor.whatif import (
    _ASSOCIATIVE_OPCODES,
    Compose,
    Identity,
    Mutation,
    mutation_from_dict,
)
from ..core.hlo_parser import _SYNC_TAG_RE, parse_hlo
from ..core.isa import Computation, Module, OpClass
from .printer import emit_hlo

__all__ = [
    "RewriteError",
    "NotApplicable",
    "EquivalenceViolation",
    "EquivalenceCertificate",
    "RewriteResult",
    "REWRITABLE_KINDS",
    "apply_rewrite",
    "is_rewritable",
]

#: Mutation kinds with a registered program rewriter.  Everything else is
#: hardware-side (or has no HLO text form) and refuses with NotApplicable.
REWRITABLE_KINDS = ("Identity", "CoalesceSyncTags", "PipelineAsyncChain",
                    "TreeReduceChain", "Compose")

_HARDWARE_KINDS = ("ResizePool", "SetIssue", "ScaleLatency")


class RewriteError(RuntimeError):
    """Base for everything the rewrite layer raises."""


class NotApplicable(RewriteError):
    """Typed refusal: this mutation cannot be lowered to an HLO rewrite
    of this program.  ``code`` is machine-readable:

      * ``hardware_mutation`` — the mutation edits the backend model,
        not the program; there is no text to rewrite;
      * ``noop``              — the rewriter ran but the program is
        already in the target shape (emitted text unchanged);
      * ``unsupported``       — no rewriter is registered for this kind.
    """

    def __init__(self, mutation_kind: str, code: str, reason: str):
        super().__init__(f"{mutation_kind}: {reason}")
        self.mutation_kind = mutation_kind
        self.code = code
        self.reason = reason

    def to_dict(self) -> Dict[str, Any]:
        return {"mutation_kind": self.mutation_kind, "code": self.code,
                "reason": self.reason}


class EquivalenceViolation(RewriteError):
    """A rewriter produced a structurally non-equivalent module — always
    a bug in the rewriter, never a caller error."""


@dataclass
class EquivalenceCertificate:
    """Structural-equivalence proof for one rewrite.

    ``declared`` names the one way the rewrite is allowed to differ from
    the original; every *other* structural property was checked equal:

      * ``identical``  — nothing may differ (Identity);
      * ``sync_retag`` — only sync-tag attributes differ; dataflow and
        program order are bit-equal;
      * ``reorder``    — program order is permuted (def-before-use
        verified); dataflow is bit-equal;
      * ``rebalance``  — associative chains are rewired; every boundary
        node (one an unchanged consumer observes) reduces the same leaf
        multiset;
      * ``stacked``    — a Compose; ``parts`` carries one certificate
        per applied step.
    """

    mutation_kind: str
    declared: str
    checks: List[str] = field(default_factory=list)
    reordered: Tuple[str, ...] = ()     # qualified names whose index moved
    rewired: Tuple[str, ...] = ()       # qualified names whose operands changed
    parts: List["EquivalenceCertificate"] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "mutation_kind": self.mutation_kind,
            "declared": self.declared,
            "checks": list(self.checks),
            "reordered": list(self.reordered),
            "rewired": list(self.rewired),
        }
        if self.parts:
            out["parts"] = [p.to_dict() for p in self.parts]
        return out


@dataclass
class RewriteResult:
    """One applied rewrite: the emitted text, its re-parse, and proof."""

    mutation: Dict[str, Any]            # Mutation.to_dict()
    hlo_text: str
    module: Module                      # parse_hlo(hlo_text, hints)
    certificate: EquivalenceCertificate
    changed: bool = True

    def to_dict(self) -> Dict[str, Any]:
        """JSON-light summary (the full text stays off the wire)."""
        import hashlib
        return {
            "mutation": dict(self.mutation),
            "certificate": self.certificate.to_dict(),
            "changed": self.changed,
            "hlo_sha256": hashlib.sha256(
                self.hlo_text.encode("utf-8")).hexdigest(),
            "hlo_bytes": len(self.hlo_text),
        }


# --------------------------------------------------------------------------
# Equivalence checking.
# --------------------------------------------------------------------------

def _strip_sync_tag(attrs: Dict[str, str]) -> Dict[str, str]:
    """Attributes with any sync_tag carrier removed (for sync_retag
    comparisons, where ONLY that attribute may differ)."""
    out = dict(attrs)
    fa = out.get("frontend_attributes")
    if fa is not None and _SYNC_TAG_RE.search(fa):
        inner = _SYNC_TAG_RE.sub("", fa.strip()[1:-1]).strip().strip(",")
        inner = inner.strip()
        if inner:
            out["frontend_attributes"] = "{" + inner + "}"
        else:
            out.pop("frontend_attributes")
    return out


def _check_skeleton(original: Module, rewritten: Module,
                    checks: List[str]) -> None:
    """Shared invariants: same computations, same instruction name sets,
    same opcode/shape per name, same root per computation."""
    if list(original.computations) != list(rewritten.computations):
        raise EquivalenceViolation(
            f"computation set changed: {list(original.computations)} -> "
            f"{list(rewritten.computations)}")
    if original.entry != rewritten.entry:
        raise EquivalenceViolation(
            f"entry changed: {original.entry!r} -> {rewritten.entry!r}")
    for cname, comp in original.computations.items():
        rcomp = rewritten.computations[cname]
        names = sorted(i.name for i in comp.instructions)
        rnames = sorted(i.name for i in rcomp.instructions)
        if names != rnames:
            raise EquivalenceViolation(
                f"{cname}: instruction set changed "
                f"(only {set(names) ^ set(rnames)} differ)")
        for instr in comp.instructions:
            other = rcomp.get(instr.name)
            if instr.opcode != other.opcode:
                raise EquivalenceViolation(
                    f"{cname}::{instr.name}: opcode {instr.opcode} -> "
                    f"{other.opcode}")
            if instr.shape != other.shape:
                raise EquivalenceViolation(
                    f"{cname}::{instr.name}: shape changed")
            if instr.is_root != other.is_root:
                raise EquivalenceViolation(
                    f"{cname}::{instr.name}: ROOT marker changed")
    checks.append("computations, instruction names, opcodes, shapes and "
                  "roots preserved")


def _changed_operands(comp: Computation,
                      rcomp: Computation) -> List[str]:
    return [i.name for i in comp.instructions
            if rcomp.get(i.name).operands != i.operands]


def _moved(comp: Computation, rcomp: Computation) -> List[str]:
    return [i.name for i in comp.instructions
            if rcomp.get(i.name).index != i.index]


def _check_def_before_use(comp: Computation) -> None:
    for instr in comp.instructions:
        for op in instr.operands:
            src = comp.get(op)
            if src is not None and src.index >= instr.index:
                raise EquivalenceViolation(
                    f"{comp.name}::{instr.name}: operand %{op} is defined "
                    f"at index {src.index} >= use at {instr.index}")


def _flatten_leaves(comp: Computation, name: str, changed: set,
                    opcode: str) -> Counter:
    """Multiset of leaf operand names reachable from ``name`` through
    changed same-opcode nodes — the value a rebalanced (sub)tree reduces."""
    out: Counter = Counter()
    stack = [name]
    while stack:
        cur = stack.pop()
        for op in comp.get(cur).operands:
            src = comp.get(op)
            if (op in changed and src is not None
                    and src.opcode == opcode):
                stack.append(op)
            else:
                out[op] += 1
    return out


def _check_rebalance(original: Module, rewritten: Module,
                     checks: List[str]) -> Tuple[str, ...]:
    """Every rewired node must be associative, and every *boundary* node
    (one consumed by unchanged code, or a root) must reduce the same
    leaf multiset as before."""
    rewired: List[str] = []
    for cname, comp in original.computations.items():
        rcomp = rewritten.computations[cname]
        if _moved(comp, rcomp):
            raise EquivalenceViolation(
                f"{cname}: rebalance must not reorder instructions")
        changed = set(_changed_operands(comp, rcomp))
        if not changed:
            continue
        for name in sorted(changed):
            if comp.get(name).opcode not in _ASSOCIATIVE_OPCODES:
                raise EquivalenceViolation(
                    f"{cname}::{name}: non-associative opcode "
                    f"{comp.get(name).opcode!r} was rewired")
        # boundary = a changed node some unchanged instruction consumes
        # (or a root): the points where the rest of the program observes
        # the reduction's value
        users: Dict[str, set] = {}
        for instr in comp.instructions:
            for op in set(instr.operands):
                users.setdefault(op, set()).add(instr.name)
        boundary = sorted(
            n for n in changed
            if comp.get(n).is_root
            or (users.get(n, set()) - changed)
            or not users.get(n))
        for n in boundary:
            opc = comp.get(n).opcode
            before = _flatten_leaves(comp, n, changed, opc)
            after = _flatten_leaves(rcomp, n, changed, opc)
            if before != after:
                raise EquivalenceViolation(
                    f"{cname}::{n}: rebalanced reduction changed its leaf "
                    f"multiset: {sorted(before.items())} -> "
                    f"{sorted(after.items())}")
        rewired.extend(f"{cname}::{n}" for n in sorted(changed))
        checks.append(
            f"{cname}: {len(boundary)} boundary node(s) reduce the same "
            f"leaf multiset over {len(changed)} rewired node(s)")
    return tuple(rewired)


def check_equivalence(original: Module, rewritten: Module, *,
                      mutation_kind: str,
                      declared: str) -> EquivalenceCertificate:
    """Verify ``rewritten`` against ``original`` modulo the ``declared``
    change; returns the certificate or raises
    :class:`EquivalenceViolation`."""
    checks: List[str] = []
    _check_skeleton(original, rewritten, checks)
    reordered: Tuple[str, ...] = ()
    rewired: Tuple[str, ...] = ()

    if declared in ("identical", "sync_retag"):
        for cname, comp in original.computations.items():
            rcomp = rewritten.computations[cname]
            bad = _changed_operands(comp, rcomp)
            if bad:
                raise EquivalenceViolation(
                    f"{cname}: operands changed on {bad[:3]} under a "
                    f"{declared} rewrite")
            if _moved(comp, rcomp):
                raise EquivalenceViolation(
                    f"{cname}: program order changed under a {declared} "
                    f"rewrite")
        checks.append("dataflow and program order bit-equal")
        if declared == "identical":
            for cname, comp in original.computations.items():
                rcomp = rewritten.computations[cname]
                for instr in comp.instructions:
                    if instr.attributes != rcomp.get(instr.name).attributes:
                        raise EquivalenceViolation(
                            f"{cname}::{instr.name}: attributes changed "
                            f"under an identity rewrite")
            checks.append("attributes bit-equal")
        else:
            retagged = []
            for cname, comp in original.computations.items():
                rcomp = rewritten.computations[cname]
                for instr in comp.instructions:
                    other = rcomp.get(instr.name)
                    if _strip_sync_tag(instr.attributes) != \
                            _strip_sync_tag(other.attributes):
                        raise EquivalenceViolation(
                            f"{cname}::{instr.name}: a non-sync_tag "
                            f"attribute changed under a sync_retag rewrite")
                    if instr.attributes != other.attributes:
                        retagged.append(f"{cname}::{instr.name}")
            checks.append(f"only sync_tag attributes differ "
                          f"({len(retagged)} op(s) retagged)")
            rewired = tuple(retagged)
    elif declared == "reorder":
        moved: List[str] = []
        for cname, comp in original.computations.items():
            rcomp = rewritten.computations[cname]
            bad = _changed_operands(comp, rcomp)
            if bad:
                raise EquivalenceViolation(
                    f"{cname}: operands changed on {bad[:3]} under a "
                    f"reorder rewrite")
            _check_def_before_use(rcomp)
            moved.extend(f"{cname}::{n}" for n in _moved(comp, rcomp))
        checks.append("dataflow bit-equal; new order is def-before-use "
                      f"valid ({len(moved)} op(s) moved)")
        reordered = tuple(moved)
    elif declared == "rebalance":
        rewired = _check_rebalance(original, rewritten, checks)
    else:
        raise ValueError(f"unknown declared change {declared!r}")

    return EquivalenceCertificate(mutation_kind=mutation_kind,
                                  declared=declared, checks=checks,
                                  reordered=reordered, rewired=rewired)


# --------------------------------------------------------------------------
# Rewriters.
# --------------------------------------------------------------------------

def _retag_sync_sets(module: Module) -> None:
    """Express each start op's (possibly remapped) sync set as a
    ``sync_tag`` frontend attribute, in place, so the emitted text
    re-parses to the same sync accounting.  Leaders (tag == own name)
    carry no attribute — the default — keeping the identity case
    byte-stable."""
    for comp in module.computations.values():
        for instr in comp.instructions:
            if instr.op_class is not OpClass.SYNC_SET or not instr.sync.sets:
                continue
            tag = instr.sync.sets[0]
            fa = instr.attributes.get("frontend_attributes", "")
            inner = _SYNC_TAG_RE.sub("", fa.strip()[1:-1]).strip().strip(",") \
                if fa else ""
            entries = [e for e in (inner.strip(),) if e]
            if tag != instr.name:
                entries.append(f'sync_tag="{tag}"')
            if entries:
                instr.attributes["frontend_attributes"] = \
                    "{" + ",".join(entries) + "}"
            else:
                instr.attributes.pop("frontend_attributes", None)


def _finish(original: Module, mutated: Module, mutation: Mutation,
            declared: str, hints: Optional[dict]) -> RewriteResult:
    """Emit, refuse no-ops, re-parse, certify."""
    text = emit_hlo(mutated)
    if text == emit_hlo(original) and not isinstance(mutation, Identity):
        raise NotApplicable(
            mutation.kind, "noop",
            f"the program is already in the target shape "
            f"({mutation.describe()} changes nothing)")
    module = parse_hlo(text, hints)
    cert = check_equivalence(original, module, mutation_kind=mutation.kind,
                             declared=declared)
    return RewriteResult(mutation=mutation.to_dict(), hlo_text=text,
                         module=module, certificate=cert,
                         changed=not isinstance(mutation, Identity))


def _rewrite_identity(module: Module, mutation: Mutation,
                      hints: Optional[dict]) -> RewriteResult:
    return _finish(module, module, mutation, "identical", hints)


def _rewrite_coalesce(module: Module, mutation: Mutation,
                      hints: Optional[dict]) -> RewriteResult:
    mutated = mutation.apply_module(module)
    if mutated is module:        # group == 1 returns the original
        raise NotApplicable(mutation.kind, "noop",
                            "group=1 coalescing is the identity")
    _retag_sync_sets(mutated)
    return _finish(module, mutated, mutation, "sync_retag", hints)


def _rewrite_pipeline(module: Module, mutation: Mutation,
                      hints: Optional[dict]) -> RewriteResult:
    return _finish(module, mutation.apply_module(module), mutation,
                   "reorder", hints)


def _rewrite_tree(module: Module, mutation: Mutation,
                  hints: Optional[dict]) -> RewriteResult:
    return _finish(module, mutation.apply_module(module), mutation,
                   "rebalance", hints)


def _rewrite_compose(module: Module, mutation: Compose,
                     hints: Optional[dict]) -> RewriteResult:
    if not mutation.parts:
        raise NotApplicable("Compose", "noop", "empty composition")
    for part in mutation.parts:
        if not is_rewritable(part):
            raise NotApplicable(
                "Compose", "hardware_mutation",
                f"part {part.kind} has no program rewrite; compose only "
                f"rewritable mutations for the stacked path")
    cur = module
    parts: List[EquivalenceCertificate] = []
    texts: List[str] = []
    any_change = False
    for part in mutation.parts:
        try:
            step = apply_rewrite(cur, part, hints=hints)
        except NotApplicable as e:
            if e.code == "noop":
                continue         # a stacked step may be subsumed by a prior one
            raise
        parts.append(step.certificate)
        texts.append(step.hlo_text)
        cur = step.module
        any_change = any_change or step.changed
    if not any_change or not texts:
        raise NotApplicable("Compose", "noop",
                            "no stacked step changed the program")
    cert = EquivalenceCertificate(
        mutation_kind="Compose", declared="stacked",
        checks=[f"{len(parts)} step(s) individually certified "
                f"(pairwise, in application order)"],
        parts=parts)
    return RewriteResult(mutation=mutation.to_dict(), hlo_text=texts[-1],
                         module=cur, certificate=cert, changed=True)


_REWRITERS: Dict[str, Callable[[Module, Any, Optional[dict]],
                               RewriteResult]] = {
    "Identity": _rewrite_identity,
    "CoalesceSyncTags": _rewrite_coalesce,
    "PipelineAsyncChain": _rewrite_pipeline,
    "TreeReduceChain": _rewrite_tree,
    "Compose": _rewrite_compose,
}


def is_rewritable(mutation: Mutation) -> bool:
    """Whether this mutation has a registered program rewriter (Compose
    counts only when every part does)."""
    if isinstance(mutation, Compose):
        return bool(mutation.parts) and all(is_rewritable(p)
                                            for p in mutation.parts)
    return mutation.kind in _REWRITERS


def apply_rewrite(module: Module, mutation: Any, *,
                  hints: Optional[dict] = None) -> RewriteResult:
    """Lower one mutation to an equivalence-checked HLO rewrite.

    ``mutation`` may be a :class:`Mutation` or its ``to_dict()`` form
    (the shape advice carries).  ``hints`` must match the hints the
    original module was parsed under, so the re-parse annotates costs
    identically.  Raises :class:`NotApplicable` (typed refusal) or
    :class:`EquivalenceViolation` (rewriter bug)."""
    if isinstance(mutation, dict):
        mutation = mutation_from_dict(mutation)
    kind = mutation.kind
    rewriter = _REWRITERS.get(kind)
    if rewriter is None:
        if kind in _HARDWARE_KINDS:
            raise NotApplicable(
                kind, "hardware_mutation",
                f"{mutation.describe()} edits the backend model, not the "
                f"program; there is no HLO rewrite to apply")
        raise NotApplicable(
            kind, "unsupported",
            f"no program rewriter is registered for {kind}")
    return rewriter(module, mutation, hints)
