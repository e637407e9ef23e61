"""PTX front-end: one `.entry` of a CUDA kernel's PTX -> unified Module.

The counterpart of `repro.core.jaxpr_frontend` descending into a
`pallas_call` body, for the port's hand-written kernels: `kernels/_build.
ptx(source)` compiles a `csrc/*.cu` with `nvcc -ptx -lineinfo`, and
`from_ptx(text, entry)` turns one kernel of it into a `Module` with one
`Instruction` per PTX instruction, so the whole LEO pipeline (dependency
graph, section III-E waitcnt tracing, pruning, blame) runs on the card's
own code.

* Operands come from register def-use: an instruction reads the registers
  in its operands (addresses and predicate guards included) and defines its
  destination (the first operand, except for stores, copies, barriers and
  branches).
* `source_file`/`source_line` come from the innermost `.loc` before the
  instruction (an inlined helper's own line, not its call site), and
  `.file`.
* Classes: `ld.global` -> MEMORY_LOAD, `st.global` -> MEMORY_STORE; each
  `cp.async` copy -> MEMORY_LOAD; `ld.shared` -> MEMORY_LOAD and
  `st.shared` -> MEMORY_STORE, their bytes scaled by `SHARED_BYTE_SCALE`
  (on-chip traffic, priced as the jaxpr front-end prices a Pallas kernel's
  VMEM ref reads and writes); `cp.async.commit_group` -> SYNC_SET of
  kind WAITCNT on one counter per kernel, whose operands are the copies
  issued since the previous commit (the group it closes);
  `cp.async.wait_group N` -> SYNC_WAIT on that counter with `counter=N`;
  `bar.sync` -> SYNC_WAIT of kind BARRIER; the rest -> COMPUTE.  Bytes are
  the access width of one thread; FLOPs 1 per instruction, 8 for the
  special-function ones, as the jaxpr front-end's transcendental set.
* `wait_group N` waits until at most N groups are in flight: exactly the
  `s_waitcnt` rule `sync_trace._trace_waitcnt` implements (drain to N,
  link to the M - N oldest pending sets).  That rule reads one instruction
  sequence, so a loop whose body commits or waits is laid out twice, in
  program order: the second copy's wait then sees the first copy's commit
  still pending, and links to it -- the steady state of a ring, where each
  iteration's wait is for the group the previous iteration committed.  A
  loop with no commit or wait (an address loop, a reduction) is laid out
  once.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from .isa import (Computation, Instruction, Module, OpClass, ShapeInfo,
                  SyncInfo, SyncKind)

#: The counter every `cp.async` group of a kernel is counted on.
CP_ASYNC_COUNTER = "cp.async.groups"

#: Shared-memory bytes against device-memory bytes: on-chip traffic is
#: about 20x faster, so its bytes are scaled before the shared hardware
#: model prices them (a copy of `repro.core.jaxpr_frontend._VMEM_BYTE_SCALE`,
#: the scale of a Pallas kernel's VMEM ref traffic; a test holds the two
#: equal).
SHARED_BYTE_SCALE = 0.05

# Itanium-mangled template argument of each element type the kernels take.
DTYPE_MANGLING = {"float32": "f", "bfloat16": "13__nv_bfloat16"}

_SPECIAL = ("ex2", "lg2", "rsqrt", "sqrt", "rcp", "sin", "cos", "tanh")
_WIDTH = {"8": 1, "16": 2, "32": 4, "64": 8, "128": 16}

_ENTRY_RE = re.compile(r"^\s*(?:\.visible\s+|\.weak\s+)?\.entry\s+([\w$]+)\s*\(",
                       re.M)
_FILE_RE = re.compile(r'^\s*\.file\s+(\d+)\s+"([^"]+)"', re.M)
_LOC_RE = re.compile(r"^\.loc\s+(\d+)\s+(\d+)\s+\d+")
_REG_RE = re.compile(r"%[a-z]+\d+")
_LABEL_RE = re.compile(r"^([$\w]+):$")
_BRANCH_RE = re.compile(r"\bbra(?:\.uni)?\s+([$\w]+)")


def ptx_entries(text: str) -> List[str]:
    """The (mangled) names of the kernels in a PTX text."""
    return _ENTRY_RE.findall(text)


def find_entry(text: str, kernel: str, dtype: str,
               *fragments: str) -> str:
    """The one entry of template kernel `kernel` instantiated for `dtype`
    ("float32" / "bfloat16") whose mangled name also holds each of
    `fragments` (more template arguments, such as "Li32E" for an int 32)."""
    head = f"{len(kernel)}{kernel}I{DTYPE_MANGLING[dtype]}"
    found = [e for e in ptx_entries(text)
             if head in e and all(f in e for f in fragments)]
    if len(found) != 1:
        raise KeyError(f"{len(found)} PTX entries of {kernel} for {dtype} "
                       f"with {fragments}: {found}")
    return found[0]


def _body(text: str, entry: str) -> List[str]:
    """The lines of `entry`'s body, between its braces."""
    m = re.search(rf"\.entry\s+{re.escape(entry)}\s*\(", text)
    if m is None:
        raise KeyError(f"no PTX entry {entry}")
    start = text.index("{", text.index(")", m.end()))
    depth, lines, line = 0, [], []
    for i in range(start, len(text)):
        ch = text[i]
        if ch == "{":
            depth += 1
            if depth == 1:
                continue
        elif ch == "}":
            depth -= 1
            if depth == 0:
                lines.append("".join(line))
                return [ln.strip() for ln in lines]
        if ch == "\n":
            lines.append("".join(line))
            line = []
        else:
            line.append(ch)
    raise ValueError(f"PTX entry {entry}: unbalanced braces")


class _Item:
    """One parsed body line: a label or an instruction."""

    def __init__(self, label: str = "", opcode: str = "", args: str = "",
                 guard: str = "", loc: Tuple[int, int] = (0, 0)):
        self.label, self.opcode, self.args = label, opcode, args
        self.guard, self.loc = guard, loc


def _parse(lines: Sequence[str]) -> List[_Item]:
    items: List[_Item] = []
    loc = (0, 0)
    for raw in lines:
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        m = _LOC_RE.match(line)
        if m:
            if int(m.group(2)) > 0:  # line 0: no source line
                loc = (int(m.group(1)), int(m.group(2)))
            continue
        if line.startswith("."):
            continue  # .reg, .shared, .pragma ...
        m = _LABEL_RE.match(line)
        if m:
            items.append(_Item(label=m.group(1)))
            continue
        # inline asm comes wrapped in braces: `{ cvt.f32.bf16 %f1, %rs1;}`
        for stmt in line.strip("{} ").split(";"):
            stmt = stmt.strip().strip("{}").strip()
            if not stmt:
                continue
            guard = ""
            if stmt.startswith("@"):
                guard, stmt = stmt.split(None, 1)
            parts = stmt.split(None, 1)
            items.append(_Item(opcode=parts[0],
                               args=parts[1] if len(parts) > 1 else "",
                               guard=guard.lstrip("@!"), loc=loc))
    return items


def _has_sync(item: _Item) -> bool:
    return item.opcode.startswith(("cp.async.commit_group",
                                   "cp.async.wait_group",
                                   "cp.async.wait_all"))


def _layout(items: List[_Item]) -> List[Tuple[_Item, str]]:
    """Program order, with each outermost loop that commits or waits laid
    out twice; pairs (item, loop tag)."""
    labels = {it.label: i for i, it in enumerate(items) if it.label}
    loops = []  # (start, end) of loops by their back edges
    for i, it in enumerate(items):
        m = _BRANCH_RE.search(f"{it.opcode} {it.args}") if it.opcode else None
        if m and m.group(1) in labels and labels[m.group(1)] < i:
            loops.append((labels[m.group(1)], i))
    syncing = [(s, e) for s, e in loops
               if any(_has_sync(items[k]) for k in range(s, e + 1))]
    outer = [(s, e) for s, e in syncing
             if not any(s2 <= s and e <= e2 and (s2, e2) != (s, e)
                        for s2, e2 in syncing)]
    out: List[Tuple[_Item, str]] = []
    i = 0
    while i < len(items):
        loop = next(((s, e) for s, e in outer if s == i), None)
        if loop is None:
            out.append((items[i], ""))
            i += 1
            continue
        s, e = loop
        for copy in (1, 2):
            out.extend((items[k], f"{items[s].label}#{copy}")
                       for k in range(s, e + 1))
        i = e + 1
    return out


def _classify(opcode: str) -> OpClass:
    if opcode.startswith(("ld.global", "ld.shared")):
        return OpClass.MEMORY_LOAD
    if opcode.startswith(("st.global", "st.shared")):
        return OpClass.MEMORY_STORE
    if opcode.startswith("cp.async.commit_group"):
        return OpClass.SYNC_SET
    if opcode.startswith(("cp.async.wait_group", "cp.async.wait_all",
                          "bar.sync", "barrier.sync")):
        return OpClass.SYNC_WAIT
    if opcode.startswith("cp.async"):
        return OpClass.MEMORY_LOAD
    return OpClass.COMPUTE


def _defines(opcode: str) -> bool:
    """Whether the first operand is a destination register."""
    return not opcode.startswith(("st.", "cp.async", "bar", "barrier",
                                  "bra", "ret", "exit", "membar", "fence",
                                  "red.", "prefetch"))


def _access_bytes(opcode: str, args: str) -> float:
    if opcode.startswith("cp.async"):
        size = args.rsplit(",", 1)[-1].strip()
        return float(size) if size.isdigit() else 16.0
    parts = opcode.split(".")
    lanes = 1
    for p in parts:
        if p in ("v2", "v4", "v8"):
            lanes = int(p[1:])
    width = _WIDTH.get(re.sub(r"\D", "", parts[-1]), 4)
    return float(lanes * width)


def _split_operands(args: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in args:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def from_ptx(text: str, entry: str, name: Optional[str] = None) -> Module:
    """One `.entry` of a PTX text as a `Module` (one entry computation)."""
    files: Dict[int, str] = {int(k): v for k, v in _FILE_RE.findall(text)}
    name = name or entry
    module = Module(name=name, source="ptx")
    comp = Computation(name="c0_entry", kind="entry")
    module.add_computation(comp)
    module.entry = comp.name

    defs: Dict[str, str] = {}  # register -> defining instruction
    group: List[str] = []      # cp.async copies since the last commit
    last = None
    for n, (item, tag) in enumerate(_layout(_parse(_body(text, entry)))):
        if item.label:
            continue
        opcode, operands = item.opcode, _split_operands(item.args)
        dests: List[str] = []
        if _defines(opcode) and operands:
            dests = _REG_RE.findall(operands[0])
            operands = operands[1:]
        uses = [r for op in operands for r in _REG_RE.findall(op)]
        if item.guard:
            uses.append(item.guard)
        reads = tuple(dict.fromkeys(defs[r] for r in uses if r in defs))
        cls = _classify(opcode)
        instr = Instruction(
            name=f"i{n}", opcode=opcode, op_class=cls,
            shape=ShapeInfo(dtype="u8", dims=()), operands=reads,
            computation=comp.name, index=0,
            op_name=f"{name}/{tag}" if tag else name,
            source_file=files.get(item.loc[0], ""),
            source_line=item.loc[1],
            predicate_operands=(defs[item.guard],)
            if item.guard in defs else ())
        scale = SHARED_BYTE_SCALE if ".shared" in opcode and \
            not opcode.startswith("cp.async") else 1.0
        if cls is OpClass.MEMORY_LOAD:
            instr.bytes_read = scale * _access_bytes(opcode, item.args)
        elif cls is OpClass.MEMORY_STORE:
            instr.bytes_written = scale * _access_bytes(opcode, item.args)
        elif cls is OpClass.COMPUTE:
            special = any(f".{s}" in f".{opcode}" or opcode.startswith(s)
                          for s in _SPECIAL)
            instr.flops = 8.0 if special else 1.0
        if opcode.startswith("cp.async.commit_group"):
            instr.operands = tuple(group)
            instr.sync = SyncInfo(kind=SyncKind.WAITCNT,
                                  sets=(CP_ASYNC_COUNTER,))
            group = []
        elif opcode.startswith(("cp.async.wait_group", "cp.async.wait_all")):
            pending = int(operands[0]) if operands and \
                operands[0].isdigit() else 0
            instr.sync = SyncInfo(kind=SyncKind.WAITCNT,
                                  waits=(CP_ASYNC_COUNTER,), counter=pending)
        elif opcode.startswith(("bar.sync", "barrier.sync")):
            instr.sync = SyncInfo(kind=SyncKind.BARRIER)
        elif opcode.startswith("cp.async"):
            group.append(instr.name)
        comp.add(instr)
        for r in dests:
            defs[r] = instr.name
        last = instr
    if last is not None:
        last.is_root = True
    return module
