"""Unified instruction model for LEO's cross-backend analysis.

LEO (the paper) parses three vendor ISAs (NVIDIA SASS, AMD GCN, Intel Xe) into
one instruction representation before slicing.  Our TPU/XLA adaptation keeps
the same shape: two front-ends — optimized HLO text (`hlo_parser.py`) and
jaxprs including Pallas kernel bodies (`jaxpr_frontend.py`) — lower into the
`Instruction`/`Computation`/`Module` model defined here.  Everything
downstream (CCT, dependency graph, pruning, blame) is front-end agnostic,
which is precisely the paper's "unified analysis layer" claim (§III).
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class OpClass(enum.Enum):
    """Coarse opcode classification (paper §III-C stage 1 operates on these)."""

    MATMUL = "matmul"              # MXU work: dot, convolution, grouped matmul
    COMPUTE = "compute"            # VPU elementwise / transcendental work
    MEMORY_LOAD = "memory_load"    # HBM reads: gather, dynamic-slice, parameter fetch
    MEMORY_STORE = "memory_store"  # HBM writes: scatter, dynamic-update-slice
    DATA_MOVEMENT = "data_movement"  # copy/transpose/reshape/bitcast/broadcast
    COLLECTIVE = "collective"      # synchronous collectives
    SYNC_SET = "sync_set"          # async *-start ops, dma_start (sets a "barrier")
    SYNC_WAIT = "sync_wait"        # async *-done ops, dma_wait (waits on a "barrier")
    CONTROL = "control"            # while / conditional / call
    FUSION = "fusion"              # XLA fusion node (costed by inner ops)
    PARAMETER = "parameter"
    CONSTANT = "constant"
    TUPLE = "tuple"                # tuple / get-tuple-element glue
    REDUCE = "reduce"              # reductions (VPU, often latency-critical)
    OTHER = "other"


class StallClass(enum.Enum):
    """Unified stall taxonomy (paper §II-D: vendor taxonomies map into this)."""

    NONE = "none"
    MEM_DEP = "mem_dep"                  # waiting on an HBM access
    EXEC_DEP = "exec_dep"                # waiting on a compute producer
    SYNC_WAIT = "sync_wait"              # waiting at an explicit sync (async-done)
    SYNC_RESOURCE = "sync_resource"      # finite sync resource exhausted
                                         # (barrier slot / waitcnt counter /
                                         # SWSB token oversubscription §III-E)
    COLLECTIVE_WAIT = "collective_wait"  # waiting on inter-chip communication
    FETCH = "fetch"                      # instruction fetch / program order
    PIPE_BUSY = "pipe_busy"              # execution resource busy (throughput bound)
    NOT_SELECTED = "not_selected"        # ready but scheduler picked other work
    OCCUPANCY_LIMITED = "occupancy_limited"  # latency only partially hidden:
                                         # too few co-resident waves to cover
                                         # the remainder (failed latency hiding)
    SELF = "self"                        # self-blame bucket (no surviving edge)


class SyncKind(enum.Enum):
    """Vendor-specific synchronization mechanisms (paper §III-E), TPU analogues.

    BARRIER  — HLO async start/done pairs      (NVIDIA B1-B6 analogue)
    WAITCNT  — Pallas DMA semaphore counters   (AMD s_waitcnt analogue)
    TOKEN    — XLA token-threaded dependencies (Intel SWSB analogue)
    """

    BARRIER = "barrier"
    WAITCNT = "waitcnt"
    TOKEN = "token"


# Dependency edge types.  The three `mem_*` types are sync-tracing edges that
# bypass opcode and latency pruning (paper §III-E "unified framework").
class EdgeKind(enum.Enum):
    REG_RAW = "reg_raw"            # SSA/register read-after-write
    PREDICATE = "predicate"        # guard predicate dependency
    LOOP_CARRIED = "loop_carried"  # while-loop back-edge (reaching def across iterations)
    MEM_BARRIER = "mem_barrier"    # via HLO async start/done pair
    MEM_WAITCNT = "mem_waitcnt"    # via Pallas DMA semaphore counter
    MEM_SWSB = "mem_swsb"          # via token threading

    @property
    def is_sync(self) -> bool:
        return self in (EdgeKind.MEM_BARRIER, EdgeKind.MEM_WAITCNT, EdgeKind.MEM_SWSB)


_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "s4": 1, "s8": 1, "u2": 1, "u4": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3fnuz": 1, "f8e5m2fnuz": 1,
    "f4e2m1fn": 1,
    "token": 0, "opaque": 0,
}


@dataclass(frozen=True)
class ShapeInfo:
    """Parsed HLO shape: scalar/array or tuple (then `elements` is set)."""

    dtype: str = "f32"
    dims: Tuple[int, ...] = ()
    elements: Optional[Tuple["ShapeInfo", ...]] = None  # tuple shapes

    @property
    def is_tuple(self) -> bool:
        return self.elements is not None

    @property
    def num_elements(self) -> int:
        if self.is_tuple:
            return sum(e.num_elements for e in self.elements)
        return int(math.prod(self.dims)) if self.dims else 1

    @property
    def byte_size(self) -> int:
        if self.is_tuple:
            return sum(e.byte_size for e in self.elements)
        return self.num_elements * _DTYPE_BYTES.get(self.dtype, 4)

    def __str__(self) -> str:  # pragma: no cover - debug aid
        if self.is_tuple:
            return "(" + ", ".join(str(e) for e in self.elements) + ")"
        return f"{self.dtype}[{','.join(map(str, self.dims))}]"


@dataclass
class SyncInfo:
    """Synchronization semantics attached to an instruction (§III-E).

    `sets` / `waits` hold abstract barrier/token/counter identifiers.  For
    HLO async pairs the identifier is the start op's name; for Pallas DMA
    semaphores it is the semaphore value name; for tokens the token value
    name.  `counter` carries the s_waitcnt-style outstanding-count semantics
    (wait until in-flight <= counter) when known.
    """

    kind: Optional[SyncKind] = None
    sets: Tuple[str, ...] = ()
    waits: Tuple[str, ...] = ()
    counter: Optional[int] = None


@dataclass
class Instruction:
    """One machine-level operation in the unified model."""

    name: str                       # SSA id ("%foo.1" -> "foo.1")
    opcode: str                     # raw opcode string
    op_class: OpClass
    shape: ShapeInfo
    operands: Tuple[str, ...]       # operand instruction names (same computation)
    computation: str                # owning computation name
    index: int                      # program order within computation
    attributes: Dict[str, str] = field(default_factory=dict)
    # Source attribution (paper: DWARF; here: HLO metadata / jaxpr source_info)
    op_name: str = ""               # scoped name, e.g. "jit(step)/transformer/layer/attn/dot"
    source_file: str = ""
    source_line: int = 0
    # Cost-model annotations (filled by the parser; consumed by the sampler)
    flops: float = 0.0
    bytes_read: float = 0.0
    bytes_written: float = 0.0
    raw_bytes_read: float = 0.0   # pre-zeroing cost (fusion-inner ops keep
                                  # their granule-penalized reads here)
    # Collective annotations
    comm_bytes: float = 0.0         # bytes moved over ICI (per participating chip)
    replica_groups: str = ""
    # Control-flow annotations
    called_computations: Tuple[str, ...] = ()
    trip_count: int = 1             # for while ops (estimated / hinted)
    # Predicate operands (subset of `operands` that act as guards)
    predicate_operands: Tuple[str, ...] = ()
    sync: SyncInfo = field(default_factory=SyncInfo)
    is_root: bool = False

    @property
    def qualified_name(self) -> str:
        return f"{self.computation}::{self.name}"

    @property
    def is_memory(self) -> bool:
        return self.op_class in (OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE)

    @property
    def is_communication(self) -> bool:
        return self.op_class in (OpClass.COLLECTIVE, OpClass.SYNC_SET, OpClass.SYNC_WAIT) \
            and self.comm_bytes > 0

    def scope_path(self) -> Tuple[str, ...]:
        """CCT path components from the scoped op_name metadata."""
        if not self.op_name:
            return ()
        return tuple(p for p in self.op_name.split("/") if p)


@dataclass
class Computation:
    """A computation (HLO computation / jaxpr): ordered instruction list."""

    name: str
    instructions: List[Instruction] = field(default_factory=list)
    kind: str = "plain"  # entry | fusion | loop_body | loop_cond | branch | reduce | plain
    parent_op: str = ""  # qualified name of the op that calls this computation

    _by_name: Dict[str, Instruction] = field(default_factory=dict, repr=False)

    def add(self, instr: Instruction) -> None:
        instr.index = len(self.instructions)
        self.instructions.append(instr)
        self._by_name[instr.name] = instr

    def get(self, name: str) -> Optional[Instruction]:
        return self._by_name.get(name)

    @property
    def root(self) -> Optional[Instruction]:
        for instr in reversed(self.instructions):
            if instr.is_root:
                return instr
        return self.instructions[-1] if self.instructions else None

    @property
    def parameters(self) -> List[Instruction]:
        return [i for i in self.instructions if i.op_class is OpClass.PARAMETER]


@dataclass
class Module:
    """A parsed module: the unit LEO analyzes (one compiled program)."""

    name: str
    computations: Dict[str, Computation] = field(default_factory=dict)
    entry: str = ""
    source: str = "hlo"  # hlo | jaxpr

    def add_computation(self, comp: Computation) -> None:
        self.computations[comp.name] = comp

    @property
    def entry_computation(self) -> Computation:
        return self.computations[self.entry]

    def all_instructions(self) -> Iterable[Instruction]:
        for comp in self.computations.values():
            yield from comp.instructions

    def find(self, qualified: str) -> Optional[Instruction]:
        comp_name, _, instr_name = qualified.partition("::")
        comp = self.computations.get(comp_name)
        return comp.get(instr_name) if comp else None

    def total_flops(self, trip_aware: bool = True) -> float:
        """Sum of per-op flops, expanding while-loop trip counts."""
        return self._comp_flops(self.entry, 1.0, trip_aware, set())

    def _comp_flops(self, comp_name: str, mult: float, trip_aware: bool,
                    stack: set) -> float:
        if comp_name in stack or comp_name not in self.computations:
            return 0.0
        stack = stack | {comp_name}
        total = 0.0
        for instr in self.computations[comp_name].instructions:
            total += mult * instr.flops
            inner_mult = mult * (instr.trip_count if trip_aware else 1)
            for callee in instr.called_computations:
                total += self._comp_flops(callee, inner_mult, trip_aware, stack)
        return total


# --- opcode classification tables -----------------------------------------

_COLLECTIVE_OPCODES = {
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
}
_ASYNC_START = {
    "all-reduce-start", "all-gather-start", "collective-permute-start",
    "copy-start", "send", "async-start", "reduce-scatter-start",
    "all-to-all-start",
}
_ASYNC_DONE = {
    "all-reduce-done", "all-gather-done", "collective-permute-done",
    "copy-done", "recv", "send-done", "recv-done", "async-done",
    "reduce-scatter-done", "all-to-all-done",
}
_MEMORY_LOAD_OPCODES = {"gather", "dynamic-slice", "slice", "iota"}
_MEMORY_STORE_OPCODES = {"scatter", "dynamic-update-slice"}
_DATA_MOVEMENT_OPCODES = {
    "copy", "transpose", "reshape", "bitcast", "bitcast-convert",
    "broadcast", "concatenate", "reverse", "pad", "convert",
}
_CONTROL_OPCODES = {"while", "conditional", "call", "custom-call"}
_TUPLE_OPCODES = {"tuple", "get-tuple-element", "optimization-barrier", "after-all"}
_REDUCE_OPCODES = {"reduce", "reduce-window", "sort", "select-and-scatter", "topk"}
_MATMUL_OPCODES = {"dot", "convolution", "ragged-dot"}


def classify_opcode(opcode: str) -> OpClass:
    if opcode in _MATMUL_OPCODES:
        return OpClass.MATMUL
    if opcode in _ASYNC_START:
        return OpClass.SYNC_SET
    if opcode in _ASYNC_DONE:
        return OpClass.SYNC_WAIT
    if opcode in _COLLECTIVE_OPCODES:
        return OpClass.COLLECTIVE
    if opcode in _MEMORY_LOAD_OPCODES:
        return OpClass.MEMORY_LOAD
    if opcode in _MEMORY_STORE_OPCODES:
        return OpClass.MEMORY_STORE
    if opcode in _DATA_MOVEMENT_OPCODES:
        return OpClass.DATA_MOVEMENT
    if opcode in _CONTROL_OPCODES:
        return OpClass.CONTROL
    if opcode in _TUPLE_OPCODES:
        return OpClass.TUPLE
    if opcode in _REDUCE_OPCODES:
        return OpClass.REDUCE
    if opcode == "fusion":
        return OpClass.FUSION
    if opcode == "parameter":
        return OpClass.PARAMETER
    if opcode == "constant":
        return OpClass.CONSTANT
    return OpClass.COMPUTE


# Stall-class compatibility used by Stage-1 opcode pruning (§III-C.1): which
# producer OpClasses can plausibly cause which observed stall class.
STALL_COMPATIBLE_PRODUCERS: Dict[StallClass, Tuple[OpClass, ...]] = {
    StallClass.MEM_DEP: (
        OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE, OpClass.DATA_MOVEMENT,
        OpClass.PARAMETER, OpClass.FUSION, OpClass.SYNC_SET, OpClass.SYNC_WAIT,
    ),
    StallClass.EXEC_DEP: (
        OpClass.MATMUL, OpClass.COMPUTE, OpClass.REDUCE, OpClass.FUSION,
        OpClass.CONTROL,
    ),
    StallClass.COLLECTIVE_WAIT: (
        OpClass.COLLECTIVE, OpClass.SYNC_SET, OpClass.SYNC_WAIT,
    ),
    StallClass.SYNC_WAIT: (
        OpClass.SYNC_SET, OpClass.SYNC_WAIT, OpClass.COLLECTIVE,
        OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE,
    ),
    StallClass.SYNC_RESOURCE: (
        OpClass.SYNC_SET, OpClass.SYNC_WAIT, OpClass.COLLECTIVE,
        OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE, OpClass.DATA_MOVEMENT,
    ),
    # Scheduler-contention classes are caused by the issue arbiter, not by
    # any data producer: no producer OpClass can explain them, so an edge
    # whose consumer shows ONLY these classes is Stage-1 prunable (the
    # stall self-blames into the scheduler-contention evidence channel).
    StallClass.NOT_SELECTED: (),
    StallClass.PIPE_BUSY: (),
    # Occupancy-limited stall is a property of the wave residency the
    # kernel achieved, not of any producer: the latency-hiding budget ran
    # out, so the exposed remainder self-blames into the occupancy
    # evidence channel.
    StallClass.OCCUPANCY_LIMITED: (),
}
