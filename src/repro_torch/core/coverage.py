"""Single-dependency coverage (§V-C, Fig. 5).

The fraction of dependency-graph nodes whose surviving incoming edges all
belong to one dependency class (memory vs execution vs synchronization), so
blame can be assigned without apportionment.  Reported before and after
LEO's workflow (synchronization tracing + four-stage pruning).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Set

from .depgraph import DependencyGraph
from .isa import EdgeKind, OpClass


def _edge_class(graph: DependencyGraph, edge) -> str:
    if edge.kind.is_sync:
        return "sync"
    producer = graph.instruction(edge.producer)
    if producer is None:
        return "execution"
    if producer.op_class in (OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE,
                             OpClass.DATA_MOVEMENT, OpClass.PARAMETER,
                             OpClass.CONSTANT):
        return "memory"
    if producer.op_class in (OpClass.COLLECTIVE, OpClass.SYNC_SET,
                             OpClass.SYNC_WAIT):
        return "sync"
    return "execution"


@dataclass
class CoverageReport:
    nodes_with_deps: int
    single_class_nodes: int

    @property
    def coverage(self) -> float:
        if self.nodes_with_deps == 0:
            return 1.0
        return self.single_class_nodes / self.nodes_with_deps


def single_dependency_coverage(graph: DependencyGraph,
                               alive_only: bool = True) -> CoverageReport:
    classes_by_node: Dict[str, Set[str]] = {}
    for edge in graph.edges:
        if alive_only and not edge.alive:
            continue
        classes_by_node.setdefault(edge.consumer, set()).add(
            _edge_class(graph, edge))
    nodes = len(classes_by_node)
    single = sum(1 for s in classes_by_node.values() if len(s) == 1)
    return CoverageReport(nodes_with_deps=nodes, single_class_nodes=single)
