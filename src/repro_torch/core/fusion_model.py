"""Virtual fusion clustering: TPU-fusion-aware HBM byte accounting.

The dry-run HLO comes from the CPU backend, whose fusion is far less
aggressive than TPU's — naively counting every top-level operand as HBM
traffic overstates the memory roofline term ~20x.  This pass approximates
XLA-TPU behavior:

* producer-consumer clustering (union-find): elementwise/data-movement ops
  (and matmuls, as absorbing sinks) merge with a producer when they are its
  only consumer; HBM bytes are charged only when a read crosses a cluster
  boundary;
* tuple/get-tuple-element glue and loop-body parameters are *aliases*, not
  traffic: they cost nothing themselves, but a consumer crossing a boundary
  is charged the size of the value it actually consumes (the gte output,
  never the whole loop-state tuple);
* fusion nodes are inspected through their called computation: an operand
  whose callee parameter feeds only slice/dynamic-slice/gather ops is
  charged the slice sizes (XLA slice fusion reads only the slice); a root
  dynamic-update-slice writes only the update (in-place);
* while-loop *carried values* that a body iteration reads/writes in full DO
  count every iteration: XLA does not fuse across while iterations, so an
  online-softmax accumulator round-trips HBM per key block — which is
  exactly the traffic a hand-written Pallas flash-attention kernel
  eliminates (see EXPERIMENTS.md §Perf).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .isa import Computation, Instruction, Module, OpClass

_FUSABLE = {OpClass.COMPUTE, OpClass.DATA_MOVEMENT, OpClass.REDUCE,
            OpClass.FUSION, OpClass.MATMUL}
# Never fuse; keep parser-assigned costs.
_KEEP_COST = {OpClass.COLLECTIVE, OpClass.SYNC_SET, OpClass.SYNC_WAIT,
              OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE}
_SLICE_OPS = {"slice", "dynamic-slice", "gather"}


class _UF:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


FUSED_REGION_MARK = "pallas_fused_region"


def apply_virtual_fusion(module: Module) -> None:
    """Rewrite per-instruction bytes_read/bytes_written in place."""
    for comp in module.computations.values():
        if comp.kind in ("fusion", "reduce"):
            continue  # inner bodies already zeroed by the parser
        _cluster_computation(module, comp)
    _apply_fused_regions(module)


def _apply_fused_regions(module: Module) -> None:
    """Regions tagged with FUSED_REGION_MARK execute as one Pallas kernel:
    everything inside is VMEM-resident (no intra-region HBM traffic); the
    region's inputs/outputs are still charged at their producers/consumers
    outside the mark.  FLOPs are untouched — the MXU work is identical."""
    for comp in module.computations.values():
        for instr in comp.instructions:
            if FUSED_REGION_MARK in instr.op_name:
                instr.bytes_read = 0.0
                instr.bytes_written = 0.0
                instr.raw_bytes_read = 0.0


# The CPU backend legalizes bf16 compute through f32 convert chains that a
# TPU build never emits; inspection below is transparent to that glue.
_GLUE_OPS = {"convert", "bitcast", "copy", "reshape"}


def _real_consumers(callee: Computation, name: str,
                    depth: int = 0) -> List[Instruction]:
    """Consumers of `name`, traversing convert/bitcast/copy glue."""
    out: List[Instruction] = []
    if depth > 8:
        return out
    for instr in callee.instructions:
        if name not in instr.operands:
            continue
        if instr.opcode in _GLUE_OPS:
            out.extend(_real_consumers(callee, instr.name, depth + 1))
        else:
            out.append(instr)
    return out


def _through_glue(callee: Computation,
                  instr: Optional[Instruction]) -> Optional[Instruction]:
    seen = 0
    while instr is not None and instr.opcode in _GLUE_OPS and \
            instr.operands and seen < 8:
        instr = callee.get(instr.operands[0])
        seen += 1
    return instr


def _fusion_read_bytes(module: Module, fusion: Instruction,
                       operand_pos: int, default: float) -> float:
    """Charge slice sizes when the callee only slices this operand."""
    for cname in fusion.called_computations:
        callee = module.computations.get(cname)
        if callee is None:
            continue
        param = None
        for instr in callee.instructions:
            if instr.op_class is OpClass.PARAMETER and \
                    int(instr.attributes.get("literal", -1) or -1) == \
                    operand_pos:
                param = instr
                break
        if param is None:
            continue
        consumers = _real_consumers(callee, param.name)
        if not consumers:
            continue
        total = 0.0
        ok = True
        for c in consumers:
            if c.opcode in _SLICE_OPS:
                # keep the parser's granule-penalized cost when present
                total += max(c.raw_bytes_read, c.bytes_read,
                             float(c.shape.byte_size))
            elif c.opcode == "dynamic-update-slice" and c.operands and \
                    _through_glue(callee, callee.get(c.operands[0])) is param:
                total += 0.0  # in-place destination alias, not a read
            else:
                ok = False
                break
        if ok:
            return float(total)
    return default


def _fusion_write_bytes(module: Module, fusion: Instruction,
                        default: float) -> float:
    """Root dynamic-update-slice writes only the update (in-place)."""
    for cname in fusion.called_computations:
        callee = module.computations.get(cname)
        if callee is None or callee.root is None:
            continue
        root = _through_glue(callee, callee.root)
        if root is not None and root.opcode == "dynamic-update-slice" and \
                len(root.operands) > 1:
            upd = callee.get(root.operands[1])
            if upd is not None:
                return float(upd.shape.byte_size)
    return default


def _cluster_computation(module: Module, comp: Computation) -> None:
    instrs = comp.instructions
    index = {i.name: idx for idx, i in enumerate(instrs)}
    consumers: Dict[str, List[int]] = {}
    for idx, instr in enumerate(instrs):
        for op in instr.operands:
            consumers.setdefault(op, []).append(idx)

    uf = _UF(len(instrs))
    for idx, instr in enumerate(instrs):
        if instr.op_class not in _FUSABLE:
            continue
        for op in instr.operands:
            pidx = index.get(op)
            if pidx is None:
                continue
            producer = instrs[pidx]
            if producer.op_class not in _FUSABLE or \
                    producer.op_class is OpClass.MATMUL:
                continue  # matmuls absorb producers, not the other way
            if len(consumers.get(op, ())) == 1:
                uf.union(pidx, idx)

    # Sibling / multi-output fusion: XLA TPU fuses a cheap producer into all
    # of its consumers when they are themselves fusable elementwise work
    # (select feeding both max and subtract in an online softmax, say).
    for idx, instr in enumerate(instrs):
        if instr.op_class not in _FUSABLE or \
                instr.op_class is OpClass.MATMUL:
            continue
        cons = consumers.get(instr.name, [])
        if 1 < len(cons) <= 4 and all(
                instrs[c].op_class in _FUSABLE and
                instrs[c].op_class is not OpClass.MATMUL for c in cons):
            for c in cons:
                uf.union(idx, c)

    is_entry = comp.kind == "entry"
    for idx, instr in enumerate(instrs):
        cls = instr.op_class
        if cls in _KEEP_COST:
            continue
        if cls is OpClass.PARAMETER:
            # Parameters are buffer bindings, not traffic: each consuming
            # kernel pays for its own read (incl. gather amplification).
            instr.bytes_read = 0.0
            instr.bytes_written = 0.0
            continue
        if cls in (OpClass.TUPLE, OpClass.CONTROL, OpClass.CONSTANT):
            instr.bytes_read = 0.0
            instr.bytes_written = 0.0
            continue
        cid = uf.find(idx)
        reads = 0.0
        for pos, op in enumerate(instr.operands):
            pidx = index.get(op)
            if pidx is None:
                continue
            producer = instrs[pidx]
            crossing = uf.find(pidx) != cid or \
                producer.op_class not in _FUSABLE
            if not crossing:
                continue
            if producer.op_class in (OpClass.CONSTANT,):
                continue
            size = float(producer.shape.byte_size)
            if instr.opcode == "fusion":
                size = _fusion_read_bytes(module, instr, pos, size)
            reads += size
        cons = consumers.get(instr.name, [])
        outside = instr.is_root or not cons or any(
            uf.find(c) != cid for c in cons)
        writes = float(instr.shape.byte_size) if outside else 0.0
        if instr.opcode == "fusion" and writes > 0:
            writes = _fusion_write_bytes(module, instr, writes)
        instr.bytes_read = reads
        instr.bytes_written = writes
