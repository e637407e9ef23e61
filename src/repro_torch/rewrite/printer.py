"""Faithful HLO text emitter — the inverse of ``repro_torch.core.hlo_parser``.

The whole rewrite subsystem stands on one guarantee:

    parse_hlo(emit_hlo(m), hints) == m        for any parser-produced m

so a rewritten module can be lowered to text, shipped to the launch
layer, re-parsed, and re-analyzed with *zero* model drift.  The
guarantee holds because the parser recomputes every derived annotation
(costs, sync semantics, trip counts, fusion folding, virtual fusion)
deterministically from structure in ``HloParser._finalize`` — the
printer therefore only has to preserve structure:

  * computation order, instruction order, names, opcodes, ROOT/ENTRY;
  * shapes (dtype + dims; layouts are dropped by ``parse_shape``, so the
    canonical form here is already a fixed point);
  * operand references (emitted as bare ``%name``);
  * attributes **verbatim** in parse order, including ``metadata={...}``
    and the synthetic ``literal`` attribute the parser stores for
    constant/parameter operand text (printed back as the parenthesized
    operand);
  * ``frontend_attributes={sync_tag="..."}`` — the textual carrier for
    :class:`~repro_torch.advisor.whatif.CoalesceSyncTags` remaps (see
    ``HloParser._annotate_sync``).

Scope: modules produced by :func:`repro_torch.core.hlo_parser.parse_hlo` (and
mutations thereof).  Jaxpr-frontend modules carry annotations plain HLO
text cannot express (``predicate_operands``, ``source="jaxpr"``) and are
rejected rather than silently lossy.

Round-trip is property-tested in ``tests/test_rewrite.py`` over every
golden fixture HLO plus hypothesis-generated storm programs.
"""
from __future__ import annotations

from typing import List

from ..core.hlo_parser import _LITERAL_OPERAND_OPCODES
from ..core.isa import Computation, Instruction, Module, ShapeInfo

__all__ = ["emit_hlo", "emit_shape", "emit_instruction", "PrinterError"]


class PrinterError(ValueError):
    """The module carries state plain HLO text cannot represent."""


def emit_shape(shape: ShapeInfo) -> str:
    """Canonical shape text: ``dtype[d0,d1]`` / nested tuples.  Matches
    what ``parse_shape`` reconstructs (layouts are never re-emitted —
    the parser drops them, so they cannot round-trip anyway)."""
    if shape.is_tuple:
        return "(" + ", ".join(emit_shape(e) for e in shape.elements) + ")"
    return f"{shape.dtype}[{','.join(str(d) for d in shape.dims)}]"


def emit_instruction(instr: Instruction) -> str:
    """One instruction line, two-space indented, attributes verbatim."""
    if instr.opcode in _LITERAL_OPERAND_OPCODES:
        operand_txt = instr.attributes.get("literal", "")
    else:
        operand_txt = ", ".join(f"%{op}" for op in instr.operands)
    line = (f"  {'ROOT ' if instr.is_root else ''}%{instr.name} = "
            f"{emit_shape(instr.shape)} {instr.opcode}({operand_txt})")
    for key, value in instr.attributes.items():
        if key == "literal":
            continue
        line += f", {key}" if value == "" else f", {key}={value}"
    return line


def _emit_computation(comp: Computation, entry: bool) -> List[str]:
    params = ", ".join(f"{p.name}: {emit_shape(p.shape)}"
                       for p in comp.parameters)
    root = comp.root
    ret = emit_shape(root.shape) if root is not None else "()"
    lines = [f"{'ENTRY ' if entry else ''}%{comp.name} ({params}) "
             f"-> {ret} {{"]
    lines += [emit_instruction(i) for i in comp.instructions]
    lines.append("}")
    return lines


def emit_hlo(module: Module) -> str:
    """Module -> HLO text; ``parse_hlo(emit_hlo(m), hints) == m`` for any
    parser-produced ``m`` under the same hints."""
    if module.source != "hlo":
        raise PrinterError(
            f"cannot emit module {module.name!r} from source "
            f"{module.source!r}: only HLO-parsed modules round-trip "
            f"(jaxpr annotations have no HLO text form)")
    for instr in module.all_instructions():
        if instr.predicate_operands:
            raise PrinterError(
                f"instruction {instr.qualified_name!r} carries predicate "
                f"operands, which plain HLO text cannot express")
    blocks: List[str] = [f"HloModule {module.name}"]
    for name, comp in module.computations.items():
        blocks.append(
            "\n".join(_emit_computation(comp, entry=(name == module.entry))))
    return "\n\n".join(blocks) + "\n"
