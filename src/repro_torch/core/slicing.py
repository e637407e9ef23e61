"""Backward slice / ranked dependency-chain extraction (§III, Fig. 7).

Starting from the top-stalled instructions, walk backward over surviving
edges following the highest-blame contributions, producing ranked chains of
the Fig.-7 form:

    DFMA        LTimes.cpp:62          96.7% stall cycles
    ^ LDG.E.64  LTimes.cpp:62          global load (stalled)
    ^ LEA.HI.X  TypedViewBase.hpp:216  array index
    ...

Each link carries the instruction, the edge kind that led to it, the blame
cycles flowing along that edge, and the op_name scope — which is what lets a
chain cross framework layers (model-library scopes play the role of RAJA
header files in the paper's Kripke case study).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .blame import BlameResult
from .depgraph import DependencyGraph
from .isa import EdgeKind, Instruction
from .sampler import StallProfile


@dataclass
class ChainLink:
    qualified: str
    opcode: str
    edge_kind: Optional[EdgeKind]   # edge that led here (None for the head)
    blame_cycles: float
    op_name: str = ""
    source: str = ""                # "file:line" when available

    def describe(self) -> str:
        arrow = "" if self.edge_kind is None else f"^ [{self.edge_kind.value}] "
        loc = self.source or self.op_name or "?"
        return f"{arrow}{self.opcode:<24s} {loc}  ({self.blame_cycles:,.0f} cyc)"


@dataclass
class StallChain:
    links: List[ChainLink] = field(default_factory=list)
    total_stall_cycles: float = 0.0   # stall at the head (symptom)

    @property
    def head(self) -> ChainLink:
        return self.links[0]

    @property
    def root(self) -> ChainLink:
        return self.links[-1]

    @property
    def score(self) -> float:
        return self.root.blame_cycles

    def describe(self) -> str:
        return "\n".join(("  " * i) + l.describe()
                         for i, l in enumerate(self.links))


def _source_of(instr: Optional[Instruction]) -> str:
    if instr is None:
        return ""
    if instr.source_file:
        return f"{instr.source_file}:{instr.source_line}"
    return ""


class Slicer:
    def __init__(self, graph: DependencyGraph, profile: StallProfile,
                 blame: BlameResult, max_depth: int = 8):
        self.graph = graph
        self.profile = profile
        self.blame = blame
        self.max_depth = max_depth
        # (producer, consumer) -> cycles for fast chain extension
        self._contrib: Dict[str, List] = {}
        for entry in blame.entries:
            self._contrib.setdefault(entry.consumer, []).append(entry)
        for v in self._contrib.values():
            v.sort(key=lambda e: -e.cycles)

    def top_chains(self, n_chains: int = 5,
                   branch_width: int = 2) -> List[StallChain]:
        chains: List[StallChain] = []
        for rec in self.profile.top_stalled(n_chains * 2):
            instr = self.graph.instruction(rec.qualified)
            head = ChainLink(
                qualified=rec.qualified,
                opcode=instr.opcode if instr else "?",
                edge_kind=None,
                blame_cycles=rec.latency_samples,
                op_name=instr.op_name if instr else "",
                source=_source_of(instr))
            for chain in self._extend(head, rec.latency_samples,
                                      {rec.qualified}, 0, branch_width):
                chain.total_stall_cycles = rec.latency_samples
                chains.append(chain)
        chains.sort(key=lambda c: -c.score)
        return chains[:n_chains]

    def _extend(self, link: ChainLink, flow: float, visited: Set[str],
                depth: int, branch_width: int) -> List[StallChain]:
        contribs = [e for e in self._contrib.get(link.qualified, [])
                    if e.producer not in visited]
        if depth >= self.max_depth or not contribs:
            return [StallChain(links=[link])]
        out: List[StallChain] = []
        for entry in contribs[:branch_width]:
            producer = self.graph.instruction(entry.producer)
            nxt = ChainLink(
                qualified=entry.producer,
                opcode=producer.opcode if producer else "?",
                edge_kind=entry.kind,
                blame_cycles=entry.cycles,
                op_name=producer.op_name if producer else "",
                source=_source_of(producer))
            for sub in self._extend(nxt, entry.cycles,
                                    visited | {entry.producer},
                                    depth + 1, 1):
                out.append(StallChain(links=[link] + sub.links))
        return out or [StallChain(links=[link])]


def top_chains(graph: DependencyGraph, profile: StallProfile,
               blame: BlameResult, n: int = 5) -> List[StallChain]:
    return Slicer(graph, profile, blame).top_chains(n)
