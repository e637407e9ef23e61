"""Cross-vendor synchronization tracing (§III-E), TPU/XLA analogues.

Purely register-based tracing dead-ends at synchronization instructions,
which expose no data operands for the memory traffic they wait on.  The
paper adds vendor-specific edges; we implement all three mechanisms against
their exact XLA/Pallas counterparts:

* ``mem_barrier``  (NVIDIA B1-B6 analogue): HLO async pairs.  A ``*-start``
  op *sets* a barrier named by itself; the matching ``*-done`` op *waits* on
  it.  We link done -> start and, crucially, done -> the start's *data
  producers*, so a slice through ``all-gather-done`` reaches the tensor that
  was gathered.
* ``mem_waitcnt``  (AMD ``s_waitcnt`` analogue): Pallas DMA-semaphore
  counters in kernel jaxprs.  ``dma_wait(sem, allow_outstanding=N)`` drains
  the in-flight DMA count to N; we scan backward for the (M-N) *oldest*
  pending DMA starts on that semaphore, stopping at epoch boundaries where a
  prior wait already drained it — the paper's exact algorithm.
* ``mem_swsb``     (Intel SWSB analogue): XLA token threading.  Ops that
  consume a ``token[]`` value wait on the op that produced that token
  (``after-all`` merges are traversed to all their sources).

All three produce typed edges that are exempt from opcode and latency
pruning (they are compiler-verified dependencies).

When the backend carries a :class:`~repro.core.backends.SyncModel`, each
sync edge is additionally annotated with the *concrete resource instance*
it consumed ("B3", "vmcnt", "$5"): a logical scoreboard replay assigns
every set identifier to a physical instance the same way the sampler's
stateful scoreboard does, so edge annotations, SYNC_RESOURCE stall events
and the Diagnosis ``sync_resources`` section all name the same hardware.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .cfg import PathInfo
from .depgraph import DependencyGraph, Edge
from .isa import EdgeKind, Instruction, Module, OpClass, SyncKind

#: (kind, computation, tag) -> physical instance name, from the replay.
#: Tags are computation-scoped, mirroring the sampler's scoreboard keys.
ResourceAssignment = Dict[Tuple[SyncKind, str, str], str]

# Computation kinds the sampler never schedules as independent streams
# (mirrors sampler._SKIP_KINDS); the replay still visits them afterwards
# so their edges (e.g. Pallas DMA streams inside fusions) get annotated.
_SKIP_KINDS = ("fusion", "reduce", "loop_cond")


def assign_sync_resources(module: Module, sync,
                          queues: int = 1) -> ResourceAssignment:
    """Replay the module's sync ops against a logical scoreboard, mapping
    every set identifier to the physical resource instance it lands on.

    The replay follows the sampler's execution order — entry computation,
    recursing into called computations at their call sites — so instance
    assignments match the dynamic scoreboard's and the edge annotations
    name the same hardware as the SYNC_RESOURCE stall events.  ``queues``
    must match the backend's issue-queue count: the replay itself issues
    everything on queue 0 (it has no port-assignment model), but the
    scoreboard's queue-scoped pools then mint instance names in the same
    ``q<i>:...`` namespace the multi-queue pressure report uses, so even
    computations only the replay reaches (fusion bodies) get annotations
    that exist in the report.
    """
    if sync is None or not getattr(sync, "pools", ()):
        return {}
    board = sync.scoreboard(queues=queues)
    assign: ResourceAssignment = {}
    visited: Set[str] = set()

    def walk(comp_name: str, depth: int) -> None:
        if depth > 32 or comp_name in visited:
            return
        visited.add(comp_name)
        comp = module.computations.get(comp_name)
        if comp is None:
            return
        for instr in comp.instructions:
            si = instr.sync
            if si.kind is not None:
                for tag in si.waits:
                    board.retire(si.kind, f"{comp.name}::{tag}",
                                 drain_to=si.counter)
                for tag in si.sets:
                    acq = board.acquire(si.kind, f"{comp.name}::{tag}",
                                        consumer=instr.qualified_name)
                    if acq is not None:
                        assign[(si.kind, comp.name, tag)] = acq.instance
            for callee in instr.called_computations:
                c = module.computations.get(callee)
                if c is not None and c.kind not in _SKIP_KINDS:
                    walk(callee, depth + 1)

    if module.entry:
        walk(module.entry, 0)
    for comp in module.computations.values():   # unreached (fusion bodies…)
        walk(comp.name, 0)
    return assign


def add_sync_edges(graph: DependencyGraph, sync=None,
                   assignment: Optional[ResourceAssignment] = None,
                   queues: int = 1) -> int:
    """Extend `graph` with §III-E synchronization edges.  Returns # added.

    ``sync`` (a backend ``SyncModel``) enables per-edge resource-instance
    annotation via :func:`assign_sync_resources` (``queues`` = the
    backend's issue-queue count, so replay-minted names share the
    report's namespace).  ``assignment`` — the sampler's
    dynamically-recorded tag->instance map
    (``StallProfile.sync_assignment``) — overlays the static replay where
    present, so under a multi-queue issue model the edge annotations name
    the exact per-queue instance the dynamic scoreboard used; computations
    the sampler never schedules (fusion bodies) keep the replay's
    assignment.
    """
    assign = assign_sync_resources(graph.module, sync, queues=queues)
    if assignment:
        assign.update(assignment)
    n = 0
    n += _trace_barriers(graph, assign)
    n += _trace_waitcnt(graph, assign)
    n += _trace_tokens(graph, assign)
    return n


def _existing(graph: DependencyGraph) -> Set[Tuple[str, str, EdgeKind]]:
    return {(e.producer, e.consumer, e.kind) for e in graph.edges}


def _add(graph: DependencyGraph, seen: Set[Tuple[str, str, EdgeKind]],
         producer: Instruction, consumer: Instruction, kind: EdgeKind,
         path: Optional[PathInfo] = None,
         resource: Optional[str] = None) -> int:
    key = (producer.qualified_name, consumer.qualified_name, kind)
    if key in seen or producer is consumer:
        return 0
    seen.add(key)
    if path is None:
        dist = abs(consumer.index - producer.index) \
            if producer.computation == consumer.computation else 1.0
        path = PathInfo(instr_count=max(dist - 1, 0.0), issue_cycles=0.0,
                        kind="sync")
    graph.add(Edge(producer=producer.qualified_name,
                   consumer=consumer.qualified_name, kind=kind, paths=[path],
                   resource=resource))
    return 1


# -- NVIDIA-barrier analogue: HLO async pairs -------------------------------

def _trace_barriers(graph: DependencyGraph,
                    assign: ResourceAssignment) -> int:
    module = graph.module
    seen = _existing(graph)
    n = 0
    for comp in module.computations.values():
        starts: Dict[str, Instruction] = {
            i.name: i for i in comp.instructions
            if i.op_class is OpClass.SYNC_SET}
        for instr in comp.instructions:
            if instr.op_class is not OpClass.SYNC_WAIT:
                continue
            for waited in instr.sync.waits:
                start = starts.get(waited) or comp.get(waited)
                if start is None:
                    continue
                res = assign.get((SyncKind.BARRIER, comp.name, waited))
                n += _add(graph, seen, start, instr, EdgeKind.MEM_BARRIER,
                          resource=res)
                # Reach *through* the start to the memory/data producers the
                # transfer actually depends on (the paper's goal: identify
                # the memory accesses causing synchronization stalls).
                for op in start.operands:
                    producer = comp.get(op)
                    if producer is not None and producer.op_class not in (
                            OpClass.TUPLE, OpClass.CONSTANT):
                        n += _add(graph, seen, producer, instr,
                                  EdgeKind.MEM_BARRIER, resource=res)
    return n


# -- AMD s_waitcnt analogue: DMA semaphore counters --------------------------

def _trace_waitcnt(graph: DependencyGraph,
                   assign: ResourceAssignment) -> int:
    """Counted-semaphore tracing for Pallas-style DMA streams.

    Instructions carry SyncInfo(kind=WAITCNT): DMA starts *set* a counter id
    (semaphore name); waits carry ``counter=N`` = allowed outstanding count.
    For each wait we scan backward collecting pending starts on the same
    counter since the last epoch boundary (a prior wait that drained to <=
    our target), then blame the (M-N) oldest — exactly §III-E.
    """
    module = graph.module
    seen = _existing(graph)
    n = 0
    for comp in module.computations.values():
        for wi, instr in enumerate(comp.instructions):
            si = instr.sync
            if si.kind is not SyncKind.WAITCNT or not si.waits:
                continue
            allow = si.counter if si.counter is not None else 0
            for sem in si.waits:
                pending: List[Instruction] = []
                for prev in comp.instructions[:wi]:
                    psync = prev.sync
                    if psync.kind is not SyncKind.WAITCNT:
                        continue
                    if sem in psync.sets and not psync.waits:
                        pending.append(prev)
                    elif sem in psync.waits:
                        # epoch boundary: a prior wait drained the counter
                        drained_to = psync.counter or 0
                        pending = pending[len(pending) - drained_to:] \
                            if drained_to < len(pending) else pending
                        if drained_to == 0:
                            pending = []
                m = len(pending)
                res = assign.get((SyncKind.WAITCNT, comp.name, sem))
                blamed = pending[: max(0, m - allow)]  # the oldest (M-N)
                for start in blamed:
                    n += _add(graph, seen, start, instr, EdgeKind.MEM_WAITCNT,
                              resource=res)
                    for op in start.operands:
                        producer = comp.get(op)
                        if producer is not None and producer.op_class not in (
                                OpClass.TUPLE, OpClass.CONSTANT):
                            n += _add(graph, seen, producer, instr,
                                      EdgeKind.MEM_WAITCNT, resource=res)
    return n


# -- Intel SWSB analogue: token threading ------------------------------------

def _trace_tokens(graph: DependencyGraph,
                  assign: ResourceAssignment) -> int:
    module = graph.module
    seen = _existing(graph)
    n = 0
    for comp in module.computations.values():
        token_producers: Dict[str, Instruction] = {}
        for instr in comp.instructions:
            if instr.sync.kind is SyncKind.TOKEN and instr.sync.sets:
                for t in instr.sync.sets:
                    token_producers[t] = instr
        for instr in comp.instructions:
            waits: List[str] = []
            if instr.sync.kind is SyncKind.TOKEN:
                waits.extend(instr.sync.waits)
            # Any op consuming a token-typed value waits on its producer
            # (the SWSB-token analogue covers send/recv token threading).
            for op in instr.operands:
                producer = comp.get(op)
                if producer is not None and (
                        producer.shape.dtype == "token" or
                        producer.opcode == "after-all"):
                    waits.append(op)
            if not waits:
                continue
            frontier = list(waits)
            visited: Set[str] = set()
            while frontier:
                t = frontier.pop()
                if t in visited:
                    continue
                visited.add(t)
                producer = token_producers.get(t) or comp.get(t)
                if producer is None or producer is instr:
                    continue
                if producer.opcode == "after-all":
                    # merge node: traverse to all joined sources
                    frontier.extend(producer.operands)
                    continue
                n += _add(graph, seen, producer, instr, EdgeKind.MEM_SWSB,
                          resource=assign.get((SyncKind.TOKEN, comp.name,
                                               t)))
    return n
