"""HLO-text front-end: optimized HLO module text -> unified `Module`.

This is LEO's "disassembler" for the XLA backend (paper §III-A phase 1/2:
nvdisasm / llvm-objdump / GED).  It parses the post-optimization,
post-SPMD-partitioning HLO emitted by ``compiled.as_text()`` — shapes are
therefore *per-device* shards, which is exactly what per-chip roofline and
stall analysis need — and annotates every instruction with:

  * opcode class (for Stage-1 opcode pruning),
  * analytical FLOPs / HBM bytes / collective bytes (virtual PC sampling),
  * source attribution from ``metadata={op_name=... source_file=...}``
    (the DWARF analogue: this is what lets chains cross framework layers),
  * synchronization semantics for async start/done pairs (§III-E).

The parser is intentionally tolerant: unknown attributes are kept verbatim,
unknown opcodes classify as COMPUTE, so new XLA versions degrade gracefully
instead of failing (the paper's "ISA tables must evolve" limitation).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

from .isa import (
    Computation,
    Instruction,
    Module,
    OpClass,
    ShapeInfo,
    SyncInfo,
    SyncKind,
    classify_opcode,
)

# Opcodes whose "operand" text is a literal, not instruction references.
_LITERAL_OPERAND_OPCODES = {"constant", "parameter"}

_TRANSCENDENTAL = {
    "exponential", "exponential-minus-one", "log", "log-plus-one", "rsqrt",
    "sqrt", "power", "tanh", "sine", "cosine", "atan2", "erf", "logistic",
    "cbrt", "expm1",
}

_COMP_HEADER_RE = re.compile(
    r"^\s*(?P<entry>ENTRY\s+)?%?(?P<name>[^\s(]+)\s*\((?P<params>.*)\)\s*->")

# frontend_attributes={sync_tag="..."}: the sync identifier override the
# CoalesceSyncTags rewrite lowers to (see `_annotate_sync`).
_SYNC_TAG_RE = re.compile(r'sync_tag="([^"]*)"')
_INSTR_RE = re.compile(
    r"^\s*(?P<root>ROOT\s+)?%?(?P<name>[^\s=]+)\s*=\s*(?P<rest>.+)$")


def _split_top_level(s: str, sep: str = ",") -> List[str]:
    """Split on `sep` at nesting depth 0 (w.r.t. (), [], {}, and quotes)."""
    parts: List[str] = []
    depth = 0
    in_str = False
    cur: List[str] = []
    i = 0
    while i < len(s):
        c = s[i]
        if in_str:
            cur.append(c)
            if c == '"' and s[i - 1] != "\\":
                in_str = False
        elif c == '"':
            in_str = True
            cur.append(c)
        elif c in "([{":
            depth += 1
            cur.append(c)
        elif c in ")]}":
            depth -= 1
            cur.append(c)
        elif c == sep and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
        i += 1
    if cur:
        parts.append("".join(cur).strip())
    return [p for p in parts if p]


def parse_shape(text: str) -> ShapeInfo:
    """Parse an HLO shape string: 'bf16[4,128]{1,0:T(8,128)}' or tuples."""
    text = text.strip()
    if text.startswith("("):
        # Tuple shape.
        inner = text[1:text.rindex(")")]
        elems = tuple(parse_shape(p) for p in _split_top_level(inner))
        return ShapeInfo(dtype="tuple", dims=(), elements=elems)
    m = re.match(r"([a-z0-9]+)\[([0-9,\s]*)\]", text)
    if not m:
        # Scalar without brackets, e.g. 'token[]' handled above; bare types:
        m2 = re.match(r"([a-z0-9]+)", text)
        return ShapeInfo(dtype=m2.group(1) if m2 else "f32", dims=())
    dtype = m.group(1)
    dims_txt = m.group(2).strip()
    dims = tuple(int(d) for d in dims_txt.split(",") if d.strip()) if dims_txt else ()
    return ShapeInfo(dtype=dtype, dims=dims)


def _take_shape_prefix(rest: str) -> Tuple[str, str]:
    """Split '<shape> <opcode>(...)...' into (shape_text, remainder)."""
    rest = rest.strip()
    if rest.startswith("("):
        depth = 0
        for i, c in enumerate(rest):
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
                if depth == 0:
                    return rest[: i + 1], rest[i + 1:].strip()
        raise ValueError(f"unbalanced tuple shape in: {rest[:80]}")
    # array shape: dtype[dims]{layout}? then whitespace
    m = re.match(r"^([a-z0-9]+(?:\[[^\]]*\])?(?:\{[^}]*\})?)\s+(.*)$", rest)
    if not m:
        raise ValueError(f"cannot parse shape prefix from: {rest[:80]}")
    return m.group(1), m.group(2)


def _parse_operand_refs(operand_text: str) -> Tuple[str, ...]:
    refs: List[str] = []
    for part in _split_top_level(operand_text):
        # operand may be '%name' or 'f32[16]{0} %name'
        toks = part.split()
        name = None
        for tok in reversed(toks):
            if tok.startswith("%"):
                name = tok[1:]
                break
        if name is not None:
            refs.append(name)
    return tuple(refs)


_CALLED_COMP_KEYS = (
    "to_apply", "calls", "condition", "body", "true_computation",
    "false_computation", "branch_computations", "called_computations",
    "select", "scatter",
)


def _extract_comp_refs(value: str) -> List[str]:
    return [m.group(1) for m in re.finditer(r"%([\w.\-]+)", value)]


def _parse_metadata(value: str) -> Dict[str, str]:
    md: Dict[str, str] = {}
    for key in ("op_name", "source_file"):
        m = re.search(key + r'="((?:[^"\\]|\\.)*)"', value)
        if m:
            md[key] = m.group(1)
    m = re.search(r"source_line=(\d+)", value)
    if m:
        md["source_line"] = m.group(1)
    return md


def _replica_group_size(attr: str, total_devices: Optional[int]) -> int:
    """Parse replica_groups attr -> participants per group."""
    # Compact format: [num_groups,group_size]<=[...]
    m = re.match(r"\[(\d+),(\d+)\]<=", attr.strip())
    if m:
        return int(m.group(2))
    # Explicit format: {{0,1,2,3},{4,5,6,7}}
    m = re.match(r"\{\{([^}]*)\}", attr.strip())
    if m:
        return len([x for x in m.group(1).split(",") if x.strip() != ""])
    if total_devices:
        return total_devices
    return 1


class HloParser:
    """Parse optimized HLO module text into the unified instruction model."""

    def __init__(self, hints: Optional[dict] = None):
        self.hints = hints or {}

    # -- public API ---------------------------------------------------------

    def parse(self, text: str) -> Module:
        module = Module(name=self._module_name(text), source="hlo")
        cur: Optional[Computation] = None
        for raw_line in text.splitlines():
            line = raw_line.rstrip()
            stripped = line.strip()
            if not stripped or stripped.startswith("//"):
                continue
            if stripped.startswith("HloModule"):
                continue
            if stripped == "}" or stripped == "})":
                cur = None
                continue
            header = _COMP_HEADER_RE.match(line) if stripped.endswith("{") else None
            if header and "=" not in stripped.split("(")[0]:
                name = header.group("name")
                cur = Computation(name=name)
                if header.group("entry"):
                    module.entry = name
                    cur.kind = "entry"
                module.add_computation(cur)
                continue
            if cur is None:
                continue
            instr = self._parse_instruction(stripped, cur.name)
            if instr is not None:
                cur.add(instr)
        if not module.entry and module.computations:
            module.entry = next(reversed(module.computations))
        self._finalize(module)
        return module

    # -- line-level parsing ---------------------------------------------------

    def _module_name(self, text: str) -> str:
        m = re.search(r"HloModule\s+([\w.\-]+)", text)
        return m.group(1) if m else "module"

    def _parse_instruction(self, line: str, comp_name: str) -> Optional[Instruction]:
        m = _INSTR_RE.match(line)
        if not m:
            return None
        name = m.group("name")
        try:
            shape_txt, remainder = _take_shape_prefix(m.group("rest"))
        except ValueError:
            return None
        shape = parse_shape(shape_txt)
        # opcode(...)
        om = re.match(r"^([\w\-]+)\(", remainder)
        if not om:
            return None
        opcode = om.group(1)
        # find matching close paren for the operand list
        start = om.end() - 1
        depth = 0
        end = start
        in_str = False
        for i in range(start, len(remainder)):
            c = remainder[i]
            if in_str:
                if c == '"' and remainder[i - 1] != "\\":
                    in_str = False
                continue
            if c == '"':
                in_str = True
            elif c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        operand_text = remainder[start + 1:end]
        attr_text = remainder[end + 1:].lstrip(", ")

        attributes: Dict[str, str] = {}
        called: List[str] = []
        op_name = ""
        source_file = ""
        source_line = 0
        replica_groups = ""
        for part in _split_top_level(attr_text):
            if "=" not in part:
                attributes[part] = ""
                continue
            key, _, value = part.partition("=")
            key = key.strip()
            value = value.strip()
            attributes[key] = value
            if key in _CALLED_COMP_KEYS:
                called.extend(_extract_comp_refs(value))
            elif key == "metadata":
                md = _parse_metadata(value)
                op_name = md.get("op_name", "")
                source_file = md.get("source_file", "")
                source_line = int(md.get("source_line", 0))
            elif key == "replica_groups":
                replica_groups = value

        if opcode in _LITERAL_OPERAND_OPCODES:
            operands: Tuple[str, ...] = ()
            attributes["literal"] = operand_text
        else:
            operands = _parse_operand_refs(operand_text)

        op_class = classify_opcode(opcode)
        if opcode == "custom-call":
            target = attributes.get("custom_call_target", "")
            if any(k in target.lower() for k in ("dot", "gemm", "matmul", "conv")):
                op_class = OpClass.MATMUL

        instr = Instruction(
            name=name,
            opcode=opcode,
            op_class=op_class,
            shape=shape,
            operands=operands,
            computation=comp_name,
            index=0,
            attributes=attributes,
            op_name=op_name,
            source_file=source_file,
            source_line=source_line,
            replica_groups=replica_groups,
            called_computations=tuple(called),
            is_root=bool(m.group("root")),
        )
        return instr

    # -- module finalization --------------------------------------------------

    def _finalize(self, module: Module) -> None:
        self._mark_computation_kinds(module)
        self._annotate_costs(module)
        self._annotate_sync(module)
        self._annotate_trip_counts(module)
        self._fold_fusion_costs(module)
        self._zero_inner_bytes(module)
        if self.hints.get("virtual_fusion", True):
            from .fusion_model import apply_virtual_fusion
            apply_virtual_fusion(module)

    def _mark_computation_kinds(self, module: Module) -> None:
        for comp in module.computations.values():
            for instr in comp.instructions:
                for idx, callee in enumerate(instr.called_computations):
                    target = module.computations.get(callee)
                    if target is None:
                        continue
                    target.parent_op = instr.qualified_name
                    if instr.opcode == "fusion":
                        target.kind = "fusion"
                    elif instr.opcode == "while":
                        # condition first, body second by attribute order
                        cond = _extract_comp_refs(
                            instr.attributes.get("condition", ""))
                        target.kind = "loop_cond" if callee in cond else "loop_body"
                    elif instr.opcode == "conditional":
                        target.kind = "branch"
                    elif instr.opcode in ("reduce", "reduce-window", "sort",
                                          "scatter", "select-and-scatter",
                                          "all-reduce", "all-reduce-start",
                                          "reduce-scatter"):
                        target.kind = "reduce"
                    elif target.kind == "plain":
                        target.kind = "called"

    # cost annotation ---------------------------------------------------------

    def _annotate_costs(self, module: Module) -> None:
        total_devices = self.hints.get("total_devices")
        for comp in module.computations.values():
            for instr in comp.instructions:
                self._cost_one(module, comp, instr, total_devices)

    def _cost_one(self, module: Module, comp: Computation, instr: Instruction,
                  total_devices: Optional[int]) -> None:
        out_elems = instr.shape.num_elements
        opc = instr.opcode
        cls = instr.op_class

        if opc == "dot":
            lhs = comp.get(instr.operands[0]) if instr.operands else None
            k = 1
            if lhs is not None:
                cdims = re.findall(r"\d+", instr.attributes.get(
                    "lhs_contracting_dims", ""))
                for d in cdims:
                    di = int(d)
                    if di < len(lhs.shape.dims):
                        k *= lhs.shape.dims[di]
            instr.flops = 2.0 * out_elems * k
        elif opc == "convolution":
            # approximation: 2 * out_elems * kernel_elems
            rhs = comp.get(instr.operands[1]) if len(instr.operands) > 1 else None
            kern = rhs.shape.num_elements if rhs is not None else 1
            instr.flops = 2.0 * out_elems * kern
        elif cls is OpClass.REDUCE:
            in_elems = 0
            for op_name_ in instr.operands:
                src = comp.get(op_name_)
                if src is not None:
                    in_elems += src.shape.num_elements
            instr.flops = float(max(in_elems, out_elems))
        elif cls is OpClass.COMPUTE:
            per_elem = 8.0 if opc in _TRANSCENDENTAL else 1.0
            instr.flops = per_elem * out_elems

        # HBM bytes: operand reads + output write (per-device local shapes).
        bytes_read = 0.0
        for op_name_ in instr.operands:
            src = comp.get(op_name_)
            if src is not None:
                bytes_read += src.shape.byte_size
        instr.bytes_read = bytes_read
        instr.bytes_written = float(instr.shape.byte_size)
        if cls in (OpClass.PARAMETER, OpClass.CONSTANT):
            instr.bytes_read = float(instr.shape.byte_size)
            instr.bytes_written = 0.0
        if cls in (OpClass.TUPLE, OpClass.CONTROL):
            # Glue and region ops move no data themselves; their bodies (or
            # callee accounting) carry the traffic.
            instr.bytes_read = 0.0
            instr.bytes_written = 0.0
        # Sliced access touches only the slice, not the whole operand — a
        # one-token dynamic-update-slice into a 32k KV cache costs one
        # token's bytes (TPU updates in place), not the cache.
        if opc in ("slice", "dynamic-slice"):
            instr.bytes_read = float(instr.shape.byte_size)
        elif opc == "gather":
            idx_bytes = 0.0
            rows = 1
            if len(instr.operands) > 1:
                src = comp.get(instr.operands[1])
                if src is not None:
                    idx_bytes = float(src.shape.byte_size)
                    rows = max(1, src.shape.num_elements)
            useful = float(instr.shape.byte_size)
            # HBM moves >=256B granules: small gathered rows pay the full
            # granule (the uncoalesced-access analogue the paper's
            # efficiency factor penalizes).
            per_row = useful / rows
            if per_row < 256.0:
                # cap at 8x: real gathers coalesce partially
                useful = min(rows * 256.0, 8.0 * useful)
            instr.bytes_read = useful + idx_bytes
        elif opc in ("dynamic-update-slice", "scatter"):
            upd_bytes = 0.0
            for op_name_ in instr.operands[1:]:
                src = comp.get(op_name_)
                if src is not None:
                    upd_bytes += float(src.shape.byte_size)
            instr.bytes_read = upd_bytes
            instr.bytes_written = upd_bytes

        # Collective bytes over ICI, per participating chip.
        if cls in (OpClass.COLLECTIVE, OpClass.SYNC_SET) and \
                opc not in ("copy-start", "send", "async-start"):
            n = _replica_group_size(instr.replica_groups, total_devices)
            base = opc.replace("-start", "")
            in_bytes = bytes_read
            out_bytes = float(instr.shape.byte_size)
            if n <= 1:
                instr.comm_bytes = 0.0
            elif base == "all-reduce":
                instr.comm_bytes = 2.0 * in_bytes * (n - 1) / n
            elif base == "all-gather":
                instr.comm_bytes = out_bytes * (n - 1) / n
            elif base == "reduce-scatter":
                instr.comm_bytes = in_bytes * (n - 1) / n
            elif base == "all-to-all":
                instr.comm_bytes = in_bytes * (n - 1) / n
            elif base in ("collective-permute", "collective-broadcast"):
                instr.comm_bytes = in_bytes
            else:
                instr.comm_bytes = in_bytes
        if opc in ("send", "recv"):
            instr.comm_bytes = float(instr.shape.byte_size)

    def _annotate_sync(self, module: Module) -> None:
        """Attach §III-E synchronization semantics.

        HLO async pairs are the NVIDIA-barrier analogue: the ``*-start`` op
        "sets a barrier" named by itself; the matching ``*-done`` op "waits"
        on it.  Token-typed values (after-all / optimization-barrier and any
        op producing/consuming ``token[]``) are the Intel-SWSB analogue.

        ``frontend_attributes={sync_tag="..."}`` overrides the identifier a
        start op sets (and, transitively, what its waiters wait on): this is
        the textual carrier for the advisor's ``CoalesceSyncTags`` rewrite —
        several starts sharing one tag re-arm one physical sync instance
        instead of allocating one each.  Without the attribute the identifier
        is the op's own name, exactly as before.
        """
        for comp in module.computations.values():
            for instr in comp.instructions:
                if instr.op_class is OpClass.SYNC_SET:
                    instr.sync = SyncInfo(kind=SyncKind.BARRIER,
                                          sets=(self._sync_tag(instr),))
                elif instr.op_class is OpClass.SYNC_WAIT:
                    instr.sync = SyncInfo(
                        kind=SyncKind.BARRIER,
                        waits=tuple(self._effective_tag(comp, op)
                                    for op in instr.operands))
                elif instr.shape.dtype == "token" or instr.opcode == "after-all":
                    instr.sync = SyncInfo(
                        kind=SyncKind.TOKEN,
                        sets=(self._sync_tag(instr),),
                        waits=tuple(self._effective_tag(comp, op)
                                    for op in instr.operands))

    @staticmethod
    def _sync_tag(instr: Instruction) -> str:
        m = _SYNC_TAG_RE.search(instr.attributes.get("frontend_attributes",
                                                     ""))
        return m.group(1) if m else instr.name

    def _effective_tag(self, comp: Computation, operand: str) -> str:
        """The sync identifier an operand reference waits on: the operand
        op's sync_tag when declared, its name otherwise (unknown operands
        keep their name, matching the pre-sync_tag behavior)."""
        src = comp.get(operand)
        return operand if src is None else self._sync_tag(src)

    def _annotate_trip_counts(self, module: Module) -> None:
        hinted = dict(self.hints.get("while_trip_counts", {}))
        for comp in module.computations.values():
            for instr in comp.instructions:
                if instr.opcode != "while":
                    continue
                if instr.name in hinted:
                    instr.trip_count = int(hinted[instr.name])
                    continue
                cond_names = _extract_comp_refs(
                    instr.attributes.get("condition", ""))
                instr.trip_count = max(
                    1, self._trip_count_from_cond(module, cond_names))

    def _trip_count_from_cond(self, module: Module,
                              cond_names: List[str]) -> int:
        best = 1
        for cname in cond_names:
            comp = module.computations.get(cname)
            if comp is None:
                continue
            for instr in comp.instructions:
                if instr.opcode != "constant":
                    continue
                lit = instr.attributes.get("literal", "")
                m = re.search(r"-?\d+", lit)
                if m and instr.shape.dtype.startswith(("s", "u")):
                    best = max(best, int(m.group(0)))
        return best

    def _fold_fusion_costs(self, module: Module) -> None:
        """fusion-node flops = sum of inner flops (inner ops live in VMEM)."""
        memo: Dict[str, float] = {}

        def comp_flops(cname: str, stack: frozenset) -> float:
            if cname in memo:
                return memo[cname]
            if cname in stack or cname not in module.computations:
                return 0.0
            total = 0.0
            for instr in module.computations[cname].instructions:
                total += instr.flops
                for callee in instr.called_computations:
                    total += instr.trip_count * comp_flops(
                        callee, stack | {cname})
            memo[cname] = total
            return total

        for comp in module.computations.values():
            for instr in comp.instructions:
                if instr.opcode == "fusion" and instr.called_computations:
                    inner = sum(comp_flops(c, frozenset())
                                for c in instr.called_computations)
                    instr.flops += inner

    def _zero_inner_bytes(self, module: Module) -> None:
        """Instructions inside fusion/reduce bodies are VMEM-resident."""
        for comp in module.computations.values():
            if comp.kind in ("fusion", "reduce"):
                for instr in comp.instructions:
                    instr.raw_bytes_read = instr.bytes_read
                    instr.bytes_read = 0.0
                    instr.bytes_written = 0.0


def parse_hlo(text: str, hints: Optional[dict] = None) -> Module:
    return HloParser(hints=hints).parse(text)
