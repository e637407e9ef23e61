"""Control-flow graph, reaching definitions, and path distances (§III-B/C).

The paper computes reaching definitions for machine-register writes with a
forward GEN/KILL fixed point over the CFG, unions at joins, then does a
per-use intra-block walk plus a backward-liveness cross-block filter.

In the XLA adaptation the instruction stream is SSA *within* a computation,
so the interesting multi-definition "registers" are **loop-state slots**: a
while-loop's tuple element `i` is written both by the init tuple (preheader)
and by the body root (back edge).  We keep the paper's formalism: blocks are
computations (preheader = calling computation, body, exit), GEN/KILL sets are
over `(while_op, slot)` registers, and the fixed point produces the union of
reaching definitions that `depgraph.py` turns into REG_RAW and LOOP_CARRIED
edges.  Conditionals contribute joins (union over branch roots).

This module also owns the **path-distance model** used by Stage-3 latency
pruning and the blame distance factor: for each (producer, consumer) edge we
enumerate the structural CFG paths (straight-line, cross-computation,
loop-carried) and accumulate both instruction counts and issue cycles along
them, via per-computation prefix sums.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .hwmodel import HardwareModel
from .isa import Computation, Instruction, Module, OpClass


# --------------------------------------------------------------------------
# Reaching definitions over loop-state slots (GEN/KILL fixed point).
# --------------------------------------------------------------------------

Register = Tuple[str, int]          # (while-op qualified name, tuple slot)
Definition = Tuple[str, Register]   # (defining instruction qualified name, reg)


@dataclass
class Block:
    """One CFG block: a computation playing a structural role."""

    name: str                      # computation name
    role: str                      # preheader | body | exit | plain
    gen: Set[Definition] = field(default_factory=set)
    kill: Set[Register] = field(default_factory=set)
    succs: List[str] = field(default_factory=list)
    preds: List[str] = field(default_factory=list)
    reach_in: Set[Definition] = field(default_factory=set)
    reach_out: Set[Definition] = field(default_factory=set)


class LoopSlotDataflow:
    """Forward reaching-definitions fixed point for while-loop state slots."""

    def __init__(self, module: Module):
        self.module = module
        self.blocks: Dict[str, Block] = {}
        self._build()
        self._fixed_point()

    def _build(self) -> None:
        mod = self.module
        for comp_name, comp in mod.computations.items():
            self.blocks[comp_name] = Block(name=comp_name, role=comp.kind)
        for comp_name, comp in mod.computations.items():
            for instr in comp.instructions:
                if instr.opcode != "while":
                    continue
                body = self._body_of(instr)
                if body is None:
                    continue
                reg_base = instr.qualified_name
                # Edges: caller -> body, body -> body (back edge), body -> caller.
                self._link(comp_name, body.name)
                self._link(body.name, body.name)
                self._link(body.name, comp_name)
                # GEN at preheader: init tuple elements.
                init = comp.get(instr.operands[0]) if instr.operands else None
                n_slots = self._slot_count(instr)
                for slot in range(n_slots):
                    reg: Register = (reg_base, slot)
                    src = self._tuple_element(comp, init, slot) if init else None
                    if src is not None:
                        self.blocks[comp_name].gen.add((src.qualified_name, reg))
                        self.blocks[comp_name].kill.add(reg)
                # GEN at body: root tuple elements (the back-edge definitions).
                root = body.root
                for slot in range(n_slots):
                    reg = (reg_base, slot)
                    src = self._tuple_element(body, root, slot)
                    if src is not None:
                        self.blocks[body.name].gen.add((src.qualified_name, reg))
                        self.blocks[body.name].kill.add(reg)

    def _link(self, a: str, b: str) -> None:
        if b not in self.blocks[a].succs:
            self.blocks[a].succs.append(b)
        if a not in self.blocks[b].preds:
            self.blocks[b].preds.append(a)

    def _body_of(self, while_instr: Instruction) -> Optional[Computation]:
        for cname in while_instr.called_computations:
            comp = self.module.computations.get(cname)
            if comp is not None and comp.kind == "loop_body":
                return comp
        return None

    def _slot_count(self, while_instr: Instruction) -> int:
        if while_instr.shape.is_tuple:
            return len(while_instr.shape.elements)
        return 1

    def _tuple_element(self, comp: Computation, instr: Optional[Instruction],
                       slot: int) -> Optional[Instruction]:
        if instr is None:
            return None
        if instr.opcode == "tuple" and slot < len(instr.operands):
            return comp.get(instr.operands[slot])
        return instr  # non-tuple root: slot 0 is the value itself

    def _fixed_point(self) -> None:
        changed = True
        while changed:
            changed = False
            for block in self.blocks.values():
                new_in: Set[Definition] = set()
                for p in block.preds:
                    new_in |= self.blocks[p].reach_out  # union at joins
                new_out = block.gen | {
                    d for d in new_in if d[1] not in block.kill}
                if new_in != block.reach_in or new_out != block.reach_out:
                    block.reach_in, block.reach_out = new_in, new_out
                    changed = True

    def reaching_defs(self, body_comp: str, while_qualified: str,
                      slot: int) -> List[Tuple[str, bool]]:
        """Definitions of loop slot reaching the body entry.

        Returns (defining instruction qualified name, is_loop_carried).
        """
        block = self.blocks.get(body_comp)
        if block is None:
            return []
        reg: Register = (while_qualified, slot)
        out: List[Tuple[str, bool]] = []
        for def_name, def_reg in block.reach_in:
            if def_reg == reg:
                carried = def_name.split("::")[0] == body_comp
                out.append((def_name, carried))
        return out

    def slot_live_in_body(self, body_comp: str, slot: int) -> bool:
        """Backward-liveness cross-block filter (§III-B): a loop-carried
        definition is only a candidate if the slot is actually read in the
        body (via get-tuple-element on the state parameter)."""
        comp = self.module.computations.get(body_comp)
        if comp is None:
            return False
        params = {p.name for p in comp.parameters}
        for instr in comp.instructions:
            if instr.opcode == "get-tuple-element" and instr.operands and \
                    instr.operands[0] in params:
                if int(instr.attributes.get("index", -1)) == slot:
                    return True
        # Non-tuple state: any direct use of the parameter.
        if slot == 0:
            for instr in comp.instructions:
                if any(op in params for op in instr.operands):
                    return True
        return False


# --------------------------------------------------------------------------
# Path distances (Stage-3 latency pruning + blame distance factor).
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PathInfo:
    """One structural CFG path from producer to consumer."""

    instr_count: float    # instructions issued strictly between the two
    issue_cycles: float   # accumulated issue cycles along the path
    kind: str             # straight | loop_carried | cross_comp


class DistanceModel:
    """Per-computation prefix sums of issue cycles for O(1) path segments."""

    def __init__(self, module: Module, hw: HardwareModel):
        self.module = module
        self.hw = hw
        self._prefix: Dict[str, List[float]] = {}
        for cname, comp in module.computations.items():
            acc = [0.0]
            for instr in comp.instructions:
                acc.append(acc[-1] + hw.issue_cycles(instr))
            self._prefix[cname] = acc

    def segment_cycles(self, comp: str, lo: int, hi: int) -> float:
        """Issue cycles of instructions with index in (lo, hi) exclusive."""
        if hi <= lo + 1:
            return 0.0
        pre = self._prefix[comp]
        return pre[hi] - pre[lo + 1]

    def body_cycles(self, comp: str) -> float:
        return self._prefix[comp][-1]

    def straight(self, producer: Instruction, consumer: Instruction) -> PathInfo:
        assert producer.computation == consumer.computation
        return PathInfo(
            instr_count=max(0, consumer.index - producer.index - 1),
            issue_cycles=self.segment_cycles(
                producer.computation, producer.index, consumer.index),
            kind="straight")

    def loop_carried(self, producer: Instruction,
                     consumer: Instruction) -> PathInfo:
        """producer (late in body, iter k) -> consumer (early in body, k+1)."""
        comp = producer.computation
        n = len(self.module.computations[comp].instructions)
        tail = self.segment_cycles(comp, producer.index, n)
        head = self.segment_cycles(comp, -1, consumer.index)
        count = (n - producer.index - 1) + consumer.index
        return PathInfo(instr_count=max(0, count),
                        issue_cycles=tail + head, kind="loop_carried")

    def cross_comp(self, producer: Instruction, call_site: Instruction,
                   consumer: Instruction) -> PathInfo:
        """producer in caller -> call-site -> consumer inside callee."""
        up = self.straight(producer, call_site)
        inner = self.segment_cycles(consumer.computation, -1, consumer.index)
        return PathInfo(
            instr_count=up.instr_count + consumer.index,
            issue_cycles=up.issue_cycles + inner, kind="cross_comp")
