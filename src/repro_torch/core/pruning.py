"""Four-stage pruning pipeline (§III-C).

The initial dependency graph is conservative; four sequential stages remove
false dependencies.  Synchronization-tracing edges (``mem_barrier`` /
``mem_waitcnt`` / ``mem_swsb``) are exempt from Stage 1 and Stage 3 — they
are compiler-verified dependencies (§III-E).

Stage 1  Opcode constraints: an edge is compatible only if the producer's
         opcode class can cause one of the stall classes actually observed
         at the consumer (e.g. consumer shows only memory stalls -> edges
         from compute producers are removed).
Stage 2  Barrier constraints: a producer that *sets* a barrier the consumer
         does not *wait* on cannot be the consumer's blocking dependency
         through that barrier (NVIDIA B1-B6 in the paper; async start/done
         pairs here).
Stage 3  Latency constraints: if enough issue cycles separate producer from
         consumer on *all* CFG paths, the producer's latency is pipeline-
         hidden and the edge is pruned.  Valid (non-hidden) paths are kept
         on the edge for blame's distance factor.
Stage 4  Execution constraints: edges from instructions with zero execution
         count are (optionally) pruned.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .cfg import PathInfo
from .depgraph import DependencyGraph, Edge
from .hwmodel import HardwareModel
from .isa import (
    Instruction,
    OpClass,
    StallClass,
    STALL_COMPATIBLE_PRODUCERS,
)
from .sampler import StallProfile

# Stall fraction below which an observed stall class is ignored for
# compatibility purposes (noise floor).
_STALL_NOISE_FLOOR = 0.02


@dataclass
class PruneStats:
    initial_edges: int = 0
    pruned_by_stage: Dict[str, int] = field(default_factory=dict)
    surviving_edges: int = 0

    def record(self, stage: str) -> None:
        self.pruned_by_stage[stage] = self.pruned_by_stage.get(stage, 0) + 1


class Pruner:
    def __init__(self, graph: DependencyGraph, profile: StallProfile,
                 hw: HardwareModel,
                 prune_unexecuted: bool = True):
        self.graph = graph
        self.profile = profile
        self.hw = hw
        self.prune_unexecuted = prune_unexecuted

    def run(self) -> PruneStats:
        stats = PruneStats(initial_edges=len(self.graph.edges))
        for edge in self.graph.edges:
            if not edge.alive:
                continue
            if self._stage1_opcode(edge):
                edge.pruned_by = "opcode"
                stats.record("opcode")
                continue
            if self._stage2_barrier(edge):
                edge.pruned_by = "barrier"
                stats.record("barrier")
                continue
            if self._stage3_latency(edge):
                edge.pruned_by = "latency"
                stats.record("latency")
                continue
            if self._stage4_execution(edge):
                edge.pruned_by = "execution"
                stats.record("execution")
                continue
        stats.surviving_edges = sum(1 for e in self.graph.edges if e.alive)
        return stats

    # -- stage 1 ----------------------------------------------------------------

    def _stage1_opcode(self, edge: Edge) -> bool:
        if edge.kind.is_sync:
            return False
        consumer = self.graph.instruction(edge.consumer)
        producer = self.graph.instruction(edge.producer)
        if consumer is None or producer is None:
            return False
        rec = self.profile.records.get(edge.consumer)
        if rec is None or rec.latency_samples <= 0:
            return False  # nothing observed: stay conservative
        observed = [cls for cls, cyc in rec.stall_breakdown.items()
                    if cyc / rec.latency_samples > _STALL_NOISE_FLOOR]
        if not observed:
            return False
        for cls in observed:
            compatible = STALL_COMPATIBLE_PRODUCERS.get(cls)
            if compatible is None or producer.op_class in compatible:
                return False  # at least one observed class is compatible
        return True

    # -- stage 2 ----------------------------------------------------------------

    def _stage2_barrier(self, edge: Edge) -> bool:
        if edge.kind.is_sync:
            return False
        producer = self.graph.instruction(edge.producer)
        consumer = self.graph.instruction(edge.consumer)
        if producer is None or consumer is None:
            return False
        sets = set(producer.sync.sets)
        if not sets or producer.op_class is not OpClass.SYNC_SET:
            return False
        # A register edge from an async start is only real if the consumer
        # waits on that barrier (otherwise the value is not yet legal).
        return not sets & set(consumer.sync.waits)

    # -- stage 3 ----------------------------------------------------------------

    def _stage3_latency(self, edge: Edge) -> bool:
        if edge.kind.is_sync:
            return False
        producer = self.graph.instruction(edge.producer)
        if producer is None or not edge.paths:
            return False
        latency = self.hw.latency_cycles(producer)
        valid = [p for p in edge.paths if p.issue_cycles < latency]
        if valid:
            edge.paths = valid  # keep non-hidden paths for distance factor
            return False
        return True

    # -- stage 4 ----------------------------------------------------------------

    def _stage4_execution(self, edge: Edge) -> bool:
        if not self.prune_unexecuted:
            return False
        rec = self.profile.records.get(edge.producer)
        return rec is not None and rec.exec_count == 0


def prune(graph: DependencyGraph, profile: StallProfile,
          hw: HardwareModel, prune_unexecuted: bool = True) -> PruneStats:
    return Pruner(graph, profile, hw, prune_unexecuted).run()
