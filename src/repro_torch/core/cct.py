"""Calling-context tree (CCT) over scoped op_name metadata.

HPCToolkit organizes a kernel's instructions into a CCT spanning device
functions, inlined templates, loops and statements (paper §III-B).  The XLA
analogue: JAX embeds the full traced call path in each HLO instruction's
``metadata op_name`` (e.g. ``jit(train_step)/while/body/decoder/layer/attn/
qk_matmul``) — model-library scopes play the role of source files, which is
what makes Kripke-style "the root cause is three framework layers away"
diagnoses possible (§VI-E).

The CCT aggregates per-instruction samples/stall cycles bottom-up so reports
can show per-layer / per-module hot paths.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .isa import Instruction, Module
from .sampler import StallProfile


@dataclass
class CCTNode:
    name: str
    path: Tuple[str, ...]
    children: Dict[str, "CCTNode"] = field(default_factory=dict)
    instructions: List[str] = field(default_factory=list)  # qualified names
    stall_cycles: float = 0.0
    total_samples: float = 0.0

    def child(self, name: str) -> "CCTNode":
        if name not in self.children:
            self.children[name] = CCTNode(name=name, path=self.path + (name,))
        return self.children[name]

    def walk(self):
        yield self
        for c in self.children.values():
            yield from c.walk()

    def hot_path(self) -> List["CCTNode"]:
        """Descend along the highest-stall child at each level."""
        path = [self]
        node = self
        while node.children:
            node = max(node.children.values(), key=lambda c: c.stall_cycles)
            if node.stall_cycles <= 0:
                break
            path.append(node)
        return path


def build_cct(module: Module, profile: Optional[StallProfile] = None) -> CCTNode:
    root = CCTNode(name="<root>", path=())
    for instr in module.all_instructions():
        scope = instr.scope_path()
        node = root
        for part in scope:
            node = node.child(part)
        node.instructions.append(instr.qualified_name)
        if profile is not None:
            rec = profile.records.get(instr.qualified_name)
            if rec is not None:
                # accumulate up the path
                cur = root
                cur.stall_cycles += rec.latency_samples
                cur.total_samples += rec.total_samples
                for part in scope:
                    cur = cur.children[part]
                    cur.stall_cycles += rec.latency_samples
                    cur.total_samples += rec.total_samples
    return root


def format_hot_path(root: CCTNode, limit: int = 12) -> str:
    lines = []
    for i, node in enumerate(root.hot_path()[:limit]):
        pct = 100.0 * node.stall_cycles / max(root.stall_cycles, 1e-12)
        lines.append(f"{'  ' * i}{node.name or '<root>'}  "
                     f"[{node.stall_cycles:,.0f} stall cyc, {pct:.1f}%]")
    return "\n".join(lines)
