"""Collective traffic of a `Module` (roofline + LEO shared).

The port's copy of the Module-level part of `repro.core.collectives`: the
port has no HLO text, so `collective_operand_bytes(text)` is not copied.

* `collective_summary(module)` — the trip-aware, per-chip *wire* bytes LEO's
  sampler uses (ring-algorithm effective bytes, scaled by loop trip counts),
  per opcode with op counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .isa import Module, OpClass

COLLECTIVE_OPCODES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)


@dataclass
class CollectiveStats:
    op_count: int = 0
    operand_bytes: float = 0.0   # raw operand sizes (prescription)
    wire_bytes: float = 0.0      # effective per-chip ICI bytes (trip-aware)


def collective_summary(module: Module,
                       trip_aware: bool = True) -> Dict[str, CollectiveStats]:
    return _operand_bytes_from_module(module, trip_aware=trip_aware)


def _operand_bytes_from_module(module: Module,
                               trip_aware: bool) -> Dict[str, CollectiveStats]:
    stats: Dict[str, CollectiveStats] = {}
    mults = _trip_multipliers(module) if trip_aware else {}
    for comp in module.computations.values():
        mult = mults.get(comp.name, 1.0) if trip_aware else 1.0
        for instr in comp.instructions:
            base = instr.opcode.replace("-start", "").replace("-done", "")
            if base not in COLLECTIVE_OPCODES:
                continue
            if instr.opcode.endswith("-done"):
                continue  # counted at the start op
            s = stats.setdefault(base, CollectiveStats())
            s.op_count += int(mult) if trip_aware else 1
            operand_bytes = sum(
                comp.get(o).shape.byte_size for o in instr.operands
                if comp.get(o) is not None)
            s.operand_bytes += mult * operand_bytes
            s.wire_bytes += mult * instr.comm_bytes
    return stats


def _trip_multipliers(module: Module) -> Dict[str, float]:
    """Execution multiplier per computation (product of enclosing trips)."""
    mults: Dict[str, float] = {}

    def visit(comp_name: str, mult: float, depth: int) -> None:
        if depth > 16 or comp_name not in module.computations:
            return
        mults[comp_name] = max(mults.get(comp_name, 0.0), mult)
        for instr in module.computations[comp_name].instructions:
            inner = mult * (instr.trip_count if instr.opcode == "while" else 1)
            for callee in instr.called_computations:
                visit(callee, inner, depth + 1)

    if module.entry:
        visit(module.entry, 1.0, 0)
    return mults


def total_collective_bytes(module: Module, trip_aware: bool = True) -> float:
    return sum(s.wire_bytes for s in
               collective_summary(module, trip_aware).values())
