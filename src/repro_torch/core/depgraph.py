"""CCT dependency-graph construction (§III-B).

Edges point *backward in execution*: from a stalled instruction (effect) to
the instruction(s) that may have produced its source operands (cause).  The
resolver below is the SSA/region equivalent of the paper's two-pass scheme
(block-level reaching definitions + per-use intra-block walk):

  * within a computation, SSA gives exact per-use reaching definitions;
  * tuple/get-tuple-element/bitcast glue is traversed transparently with
    element-index tracking, so blame lands on real producers;
  * at region boundaries it unions reaching definitions exactly as the paper
    unions at CFG joins: a use of loop state reaches both the init value
    (preheader path) and the body-root value of the previous iteration
    (back-edge path, `LOOP_CARRIED`); a use of a `conditional` result
    reaches every branch root;
  * uses inside fusion/call bodies resolve through the call site to caller
    operands (this is what makes chains cross framework layers — the CCT);
  * producers with no profile samples are retained as unsampled dependency
    sources (address-generation chains must be blameable).

Predicate guards (`select` / `conditional` predicates — the P0-P6 analogue)
get `PREDICATE` edges.  The backward-liveness filter from `cfg.py` removes
loop-carried candidates whose slot is never read in the body.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .cfg import DistanceModel, LoopSlotDataflow, PathInfo
from .hwmodel import HardwareModel
from .isa import (
    Computation,
    EdgeKind,
    Instruction,
    Module,
    OpClass,
)

# Glue opcodes traversed transparently during def resolution.
_TRANSPARENT = {"bitcast", "get-tuple-element", "tuple", "copy-done"}
# copy-done is transparent for *value* identity but its sync edge is added by
# sync_trace.py; seeing through it lets register chains continue.

_MAX_RESOLVE_DEPTH = 64


@dataclass
class Edge:
    producer: str                 # qualified name (cause)
    consumer: str                 # qualified name (effect; the stalled instr)
    kind: EdgeKind
    paths: List[PathInfo] = field(default_factory=list)
    pruned_by: Optional[str] = None   # pruning stage that removed it, if any
    # Concrete §III-E sync-resource instance this edge rode (e.g. "B3",
    # "vmcnt", "$5"); set by sync_trace when the backend carries a
    # SyncModel, None for register/predicate/loop edges.
    resource: Optional[str] = None

    @property
    def alive(self) -> bool:
        return self.pruned_by is None

    @property
    def min_cycles(self) -> float:
        return min((p.issue_cycles for p in self.paths), default=0.0)

    @property
    def avg_instr_distance(self) -> float:
        alive = [p for p in self.paths] or [PathInfo(1.0, 1.0, "straight")]
        return sum(p.instr_count for p in alive) / len(alive)


@dataclass
class DependencyGraph:
    module: Module
    edges: List[Edge] = field(default_factory=list)
    in_edges: Dict[str, List[Edge]] = field(default_factory=dict)   # by consumer
    out_edges: Dict[str, List[Edge]] = field(default_factory=dict)  # by producer

    def add(self, edge: Edge) -> None:
        self.edges.append(edge)
        self.in_edges.setdefault(edge.consumer, []).append(edge)
        self.out_edges.setdefault(edge.producer, []).append(edge)

    def deps_of(self, qualified: str, alive_only: bool = True) -> List[Edge]:
        edges = self.in_edges.get(qualified, [])
        return [e for e in edges if e.alive] if alive_only else list(edges)

    def instruction(self, qualified: str) -> Optional[Instruction]:
        return self.module.find(qualified)

    @property
    def alive_edges(self) -> List[Edge]:
        return [e for e in self.edges if e.alive]


@dataclass(frozen=True)
class _Resolved:
    instr: Instruction
    kind: EdgeKind
    path: PathInfo


class GraphBuilder:
    def __init__(self, module: Module, hw: HardwareModel):
        self.module = module
        self.hw = hw
        self.distance = DistanceModel(module, hw)
        self.loops = LoopSlotDataflow(module)
        # call-site lookup: computation name -> (caller Instruction)
        self.call_sites: Dict[str, Instruction] = {}
        for comp in module.computations.values():
            for instr in comp.instructions:
                for callee in instr.called_computations:
                    self.call_sites.setdefault(callee, instr)

    # -- public -------------------------------------------------------------

    def build(self) -> DependencyGraph:
        graph = DependencyGraph(module=self.module)
        seen: Set[Tuple[str, str, EdgeKind]] = set()
        for comp in self.module.computations.values():
            for instr in comp.instructions:
                if instr.op_class in (OpClass.PARAMETER, OpClass.CONSTANT):
                    continue
                pred_ops = set(self._predicate_positions(instr))
                for pos, operand in enumerate(instr.operands):
                    kind = EdgeKind.PREDICATE if pos in pred_ops \
                        else EdgeKind.REG_RAW
                    for res in self._resolve(comp, operand, None, instr, 0):
                        ekind = res.kind if res.kind is not EdgeKind.REG_RAW \
                            else kind
                        key = (res.instr.qualified_name,
                               instr.qualified_name, ekind)
                        # Self-edges are only meaningful as cross-iteration
                        # (loop-carried) dependencies — e.g. acc = f(acc).
                        if key in seen or (res.instr is instr and
                                           ekind is not EdgeKind.LOOP_CARRIED):
                            continue
                        seen.add(key)
                        graph.add(Edge(producer=res.instr.qualified_name,
                                       consumer=instr.qualified_name,
                                       kind=ekind, paths=[res.path]))
        return graph

    # -- predicate positions --------------------------------------------------

    def _predicate_positions(self, instr: Instruction) -> List[int]:
        if instr.opcode in ("select", "conditional", "select-and-scatter"):
            return [0]
        return []

    # -- definition resolution -------------------------------------------------

    def _resolve(self, comp: Computation, name: str,
                 elem_index: Optional[int], consumer: Instruction,
                 depth: int) -> List[_Resolved]:
        """All reaching definitions for `name` (element `elem_index` if the
        value is a tuple), as real producer instructions + path info."""
        if depth > _MAX_RESOLVE_DEPTH:
            return []
        instr = comp.get(name)
        if instr is None:
            return []

        if instr.opcode == "get-tuple-element":
            idx = int(instr.attributes.get("index", 0))
            return self._resolve(comp, instr.operands[0], idx, consumer,
                                 depth + 1)
        if instr.opcode == "tuple":
            if elem_index is not None and elem_index < len(instr.operands):
                return self._resolve(comp, instr.operands[elem_index], None,
                                     consumer, depth + 1)
            out: List[_Resolved] = []
            for op in instr.operands:
                out.extend(self._resolve(comp, op, None, consumer, depth + 1))
            return out
        if instr.opcode in ("bitcast", "copy-done") and instr.operands:
            inner = self._resolve(comp, instr.operands[0], elem_index,
                                  consumer, depth + 1)
            if inner:
                return inner
            return [self._make(instr, consumer, EdgeKind.REG_RAW)]

        if instr.op_class is OpClass.PARAMETER:
            return self._resolve_parameter(comp, instr, elem_index, consumer,
                                           depth)

        if instr.opcode == "while":
            return self._resolve_while_result(comp, instr, elem_index,
                                              consumer, depth)
        if instr.opcode == "conditional":
            return self._resolve_conditional(comp, instr, elem_index,
                                             consumer, depth)

        return [self._make(instr, consumer, EdgeKind.REG_RAW)]

    def _make(self, producer: Instruction, consumer: Instruction,
              kind: EdgeKind, path: Optional[PathInfo] = None) -> _Resolved:
        if path is None:
            if producer.computation == consumer.computation:
                if producer.index <= consumer.index:
                    path = self.distance.straight(producer, consumer)
                else:
                    path = self.distance.loop_carried(producer, consumer)
            else:
                call = self.call_sites.get(consumer.computation)
                if call is not None and \
                        call.computation == producer.computation and \
                        producer.index <= call.index:
                    path = self.distance.cross_comp(producer, call, consumer)
                else:
                    path = PathInfo(instr_count=1.0, issue_cycles=0.0,
                                    kind="cross_comp")
        return _Resolved(instr=producer, kind=kind, path=path)

    def _resolve_parameter(self, comp: Computation, param: Instruction,
                           elem_index: Optional[int], consumer: Instruction,
                           depth: int) -> List[_Resolved]:
        call = self.call_sites.get(comp.name)
        if call is None:
            # Entry parameter: terminal producer — a real HBM source.
            return [self._make(param, consumer, EdgeKind.REG_RAW)]
        caller_comp = self.module.computations[call.computation]
        pidx = int(param.attributes.get("literal", "0") or 0)

        if comp.kind in ("loop_body", "loop_cond"):
            return self._resolve_loop_param(caller_comp, call, comp,
                                            elem_index, consumer, depth)
        if comp.kind == "branch":
            # conditional(%pred, %arg0, %arg1, ...): branch k gets arg k+1.
            branches = call.called_computations
            try:
                k = branches.index(comp.name)
            except ValueError:
                k = 0
            arg_pos = k + 1
            if arg_pos < len(call.operands):
                return self._resolve(caller_comp, call.operands[arg_pos],
                                     elem_index, consumer, depth + 1)
            return []
        # fusion / call / reduce bodies: param i <- call-site operand i.
        if pidx < len(call.operands):
            return self._resolve(caller_comp, call.operands[pidx],
                                 elem_index, consumer, depth + 1)
        return []

    def _resolve_loop_param(self, caller_comp: Computation,
                            while_instr: Instruction, body: Computation,
                            elem_index: Optional[int], consumer: Instruction,
                            depth: int) -> List[_Resolved]:
        slot = elem_index if elem_index is not None else 0
        out: List[_Resolved] = []
        # Backward-liveness filter (paper §III-B): skip dead slots.
        body_name = body.name if body.kind == "loop_body" else None
        if body.kind == "loop_body" and \
                not self.loops.slot_live_in_body(body.name, slot):
            return out
        defs = self.loops.reaching_defs(
            body.name, while_instr.qualified_name, slot)
        if defs:
            for def_qualified, carried in defs:
                producer = self.module.find(def_qualified)
                if producer is None:
                    continue
                if carried:
                    path = self.distance.loop_carried(producer, consumer) \
                        if producer.computation == consumer.computation else \
                        PathInfo(1.0, 0.0, "loop_carried")
                    out.append(_Resolved(producer, EdgeKind.LOOP_CARRIED, path))
                else:
                    out.extend(self._resolve_through_init(
                        caller_comp, while_instr, slot, consumer, depth))
            return out
        return self._resolve_through_init(caller_comp, while_instr, slot,
                                          consumer, depth)

    def _resolve_through_init(self, caller_comp: Computation,
                              while_instr: Instruction, slot: int,
                              consumer: Instruction,
                              depth: int) -> List[_Resolved]:
        if not while_instr.operands:
            return []
        return self._resolve(caller_comp, while_instr.operands[0], slot,
                             consumer, depth + 1)

    def _resolve_while_result(self, comp: Computation, while_instr: Instruction,
                              elem_index: Optional[int], consumer: Instruction,
                              depth: int) -> List[_Resolved]:
        """Use of gte(while, i) after the loop: reaches the body root element
        (final iteration) and — paper-style union — the init value (zero-trip
        path)."""
        out: List[_Resolved] = []
        slot = elem_index if elem_index is not None else 0
        for cname in while_instr.called_computations:
            callee = self.module.computations.get(cname)
            if callee is None or callee.kind != "loop_body":
                continue
            root = callee.root
            if root is None:
                continue
            if root.opcode == "tuple" and slot < len(root.operands):
                for res in self._resolve(callee, root.operands[slot], None,
                                         consumer, depth + 1):
                    out.append(_Resolved(res.instr, res.kind,
                                         PathInfo(res.path.instr_count + 1,
                                                  res.path.issue_cycles,
                                                  "cross_comp")))
            else:
                out.append(self._make(root, consumer, EdgeKind.REG_RAW,
                                      PathInfo(1.0, 0.0, "cross_comp")))
        if not out:
            out.extend(self._resolve_through_init(
                comp, while_instr, slot, consumer, depth))
        return out

    def _resolve_conditional(self, comp: Computation, cond: Instruction,
                             elem_index: Optional[int], consumer: Instruction,
                             depth: int) -> List[_Resolved]:
        out: List[_Resolved] = []
        for cname in cond.called_computations:
            callee = self.module.computations.get(cname)
            if callee is None or callee.root is None:
                continue
            out.extend(self._resolve(callee, callee.root.name, elem_index,
                                     consumer, depth + 1))
        return out


def build_dependency_graph(module: Module, hw: HardwareModel) -> DependencyGraph:
    return GraphBuilder(module, hw).build()
