"""Three-term roofline analysis from compiled dry-run artifacts (§Roofline).

    compute term    = HLO_FLOPs       / (chips x peak FLOP/s)
    memory term     = HLO_bytes       / (chips x HBM bandwidth)
    collective term = collective bytes / (chips x ICI link bandwidth)

All quantities are *per-device* here: the parsed HLO is post-SPMD, so its
shapes are the local shards — dividing global totals by `chips` is the same
as using per-device numbers directly (we cross-check against XLA's
`cost_analysis()`, which reports per-device numbers too but counts while-loop
bodies exactly once; the parser's trip-aware totals correct that, which
matters enormously for scanned layer stacks).

`useful_ratio` = MODEL_FLOPS / HLO_FLOPs catches remat/redundancy waste.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Dict, Optional

from .collectives import collective_summary
from .hwmodel import HardwareModel, TPU_V5E
from .isa import Module, OpClass


@dataclass
class RooflineReport:
    label: str
    hw_name: str
    chips: int
    # Per-device quantities (trip-aware)
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    # Terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # Usefulness
    model_flops: float = 0.0            # 6*N*D (or 6*N_active*D), global
    model_flops_per_device: float = 0.0
    useful_ratio: float = 0.0
    # Cross-checks
    xla_flops_per_device: float = 0.0   # raw cost_analysis (loop bodies x1)
    xla_bytes_per_device: float = 0.0
    memory_stats: Dict[str, float] = field(default_factory=dict)
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    notes: str = ""

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step bound that is pure-compute: how close an
        ideal executor would be to the compute roofline."""
        if self.bound_s <= 0:
            return 0.0
        return self.compute_s / self.bound_s

    def to_dict(self) -> dict:
        d = asdict(self)
        d["bound_s"] = self.bound_s
        d["roofline_fraction"] = self.roofline_fraction
        return d

    def summary_row(self) -> str:
        return (f"{self.label:<40s} c={self.compute_s*1e3:9.3f}ms "
                f"m={self.memory_s*1e3:9.3f}ms x={self.collective_s*1e3:9.3f}ms "
                f"dom={self.dominant:<10s} useful={self.useful_ratio:5.2f} "
                f"frac={self.roofline_fraction:5.2f}")


def _trip_aware_bytes(module: Module) -> float:
    """Per-device HBM bytes, expanding loop trip counts."""
    total = 0.0

    def visit(comp_name: str, mult: float, depth: int, stack: frozenset) -> None:
        nonlocal total
        if depth > 16 or comp_name in stack or \
                comp_name not in module.computations:
            return
        comp = module.computations[comp_name]
        for instr in comp.instructions:
            total += mult * (instr.bytes_read + instr.bytes_written)
            inner = mult * (instr.trip_count if instr.opcode == "while" else 1)
            for callee in instr.called_computations:
                visit(callee, inner, depth + 1, stack | {comp_name})

    visit(module.entry, 1.0, 0, frozenset())
    return total


def compute_roofline(
    module: Module,
    hw: HardwareModel = TPU_V5E,
    chips: int = 1,
    label: str = "",
    model_flops: float = 0.0,
    cost_analysis: Optional[dict] = None,
    memory_analysis: Optional[object] = None,
    dtype_peak: str = "bf16",
) -> RooflineReport:
    flops = module.total_flops(trip_aware=True)
    hbm_bytes = _trip_aware_bytes(module)
    colls = collective_summary(module, trip_aware=True)
    coll_bytes = sum(s.wire_bytes for s in colls.values())

    peak = hw.peak_flops_bf16 if dtype_peak == "bf16" else hw.peak_flops_f32
    compute_s = flops / peak
    memory_s = hbm_bytes / hw.hbm_bw
    collective_s = coll_bytes / hw.ici_bw_per_link

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get) if any(terms.values()) else "compute"

    mfpd = model_flops / chips if chips else 0.0
    report = RooflineReport(
        label=label, hw_name=hw.name, chips=chips,
        hlo_flops=flops, hlo_bytes=hbm_bytes, collective_bytes=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops, model_flops_per_device=mfpd,
        useful_ratio=(mfpd / flops) if flops > 0 else 0.0,
        collective_breakdown={k: v.wire_bytes for k, v in colls.items()},
    )
    if cost_analysis:
        # jax >= 0.4.30 returns a one-element list of per-module dicts
        if isinstance(cost_analysis, (list, tuple)):
            cost_analysis = cost_analysis[0] if cost_analysis else {}
        report.xla_flops_per_device = float(cost_analysis.get("flops", 0.0))
        report.xla_bytes_per_device = float(
            cost_analysis.get("bytes accessed", 0.0))
    if memory_analysis is not None:
        for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                     "temp_size_in_bytes", "generated_code_size_in_bytes"):
            report.memory_stats[attr] = float(
                getattr(memory_analysis, attr, 0.0))
    return report


def save_report(report: RooflineReport, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report.to_dict(), f, indent=2)
