"""Analytical hardware models — the cross-"vendor" axis of the adaptation.

The paper analyzes the same kernel on NVIDIA GH200, AMD MI300A and Intel PVC
and shows the *same source* exhibits *different* bottlenecks per platform
(Observation 1).  Our backend axis is TPU generations with materially
different FLOP:HBM:ICI ratios — v5e (cost-optimized, narrow HBM), v5p
(training flagship, fat HBM + ICI) and v4 — so a kernel that is
collective-bound on v5e can be compute-bound on v5p, reproducing the paper's
cross-platform divergence with TPU-native semantics.

All roofline and stall-cycle arithmetic in `sampler.py` / `roofline.py` is
parameterized by one of these models; `TPU_V5E` carries the constants the
deliverable mandates (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from .isa import Instruction, OpClass

#: Scheduler policies an :class:`IssueModel` can declare.
ISSUE_POLICIES: Tuple[str, ...] = ("round_robin", "greedy_oldest")


@dataclass(frozen=True)
class IssueModel:
    """Per-vendor issue-stream model (the multi-stream sampler's contract).

    ``queues``  — concurrent issue queues (warp schedulers on NVIDIA-class
                  parts, SIMD units per CU on AMD-class parts, Xe vector
                  engines on Intel-class parts; 1 = the in-order VLIW
                  single stream of a TPU core).
    ``width``   — issue slots per queue (co-issue ports).
    ``policy``  — how ready instructions map onto queues:
                  ``round_robin``   static cyclic assignment (AMD's SIMD
                                    rotation; an instruction waits for
                                    *its* queue even if others are idle);
                  ``greedy_oldest`` work-conserving greedy-then-oldest
                                    arbitration (NVIDIA GTO): an
                                    instruction waits only when every
                                    queue is busy.

    With ``ports == 1`` the sampler degenerates *byte-identically* to the
    single-stream in-order model (the parity anchor for every pre-existing
    golden): a lone in-order stream has no arbitration, so no
    ``not_selected`` / ``pipe_busy`` samples are ever charged.
    """

    queues: int = 1
    width: int = 1
    policy: str = "round_robin"

    def __post_init__(self) -> None:
        if self.queues < 1:
            raise ValueError(f"queues must be >= 1, got {self.queues}")
        if self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")
        if self.policy not in ISSUE_POLICIES:
            raise ValueError(
                f"unknown issue policy {self.policy!r}; known: "
                f"{ISSUE_POLICIES}")

    @property
    def ports(self) -> int:
        """Total concurrent issue slots (queues x width)."""
        return self.queues * self.width

    @property
    def multi_stream(self) -> bool:
        return self.ports > 1


#: The degenerate single-stream model: one in-order queue, one slot.
SINGLE_ISSUE = IssueModel(queues=1, width=1, policy="round_robin")


#: Residency limiters an :class:`OccupancyModel` can declare — the
#: vendor-specific budget that bounds resident waves per issue queue.
OCCUPANCY_LIMITERS: Tuple[str, ...] = (
    "none",             # single resident wave (no hiding beyond async retire)
    "register_file",    # NVIDIA-style: register allocation caps warps/SM
    "wavefront_slots",  # AMD-style: wave slots per SIMD (VGPR/LDS budget)
    "thread_slots",     # Intel-style: hardware threads per Xe vector engine
)


@dataclass(frozen=True)
class OccupancyModel:
    """Per-vendor wave-residency model (failed-latency-hiding contract).

    ``waves``  — resident waves per issue queue (warps per scheduler on
                 NVIDIA-class parts, wavefront slots per SIMD on AMD-class
                 parts, hardware threads per Xe vector engine on
                 Intel-class parts; 1 = a TPU core's lone program).
    ``limiter`` — which vendor budget bounds ``waves`` (see
                 :data:`OCCUPANCY_LIMITERS`); advisory metadata that also
                 drives vendor-native advisor phrasing.
    ``window_cycles`` — per-wave cap on banked latency-hiding credit: a
                 co-resident wave can cover at most this many stall cycles
                 before it, too, runs out of independent work (the
                 ILP-per-wave horizon).  Per-vendor divergence knob.

    With ``waves == 1`` the sampler bypasses the occupancy machinery
    entirely and degenerates *byte-identically* to the single-wave model —
    the parity anchor for every pre-occupancy golden (same trick as
    ``IssueModel.ports == 1``).
    """

    waves: int = 1
    limiter: str = "none"
    window_cycles: float = 64.0

    def __post_init__(self) -> None:
        if self.waves < 1:
            raise ValueError(f"waves must be >= 1, got {self.waves}")
        if self.limiter not in OCCUPANCY_LIMITERS:
            raise ValueError(
                f"unknown occupancy limiter {self.limiter!r}; known: "
                f"{OCCUPANCY_LIMITERS}")
        if self.window_cycles <= 0:
            raise ValueError(
                f"window_cycles must be > 0, got {self.window_cycles}")

    @property
    def multi_wave(self) -> bool:
        return self.waves > 1


#: The degenerate residency model: one wave, no latency-hiding credit.
SINGLE_WAVE = OccupancyModel(waves=1, limiter="none")


@dataclass(frozen=True)
class HardwareModel:
    name: str
    # Peak compute, per chip.
    peak_flops_bf16: float          # FLOP/s
    peak_flops_f32: float           # FLOP/s (VPU-bound path)
    hbm_bw: float                   # bytes/s
    hbm_bytes: int                  # capacity per chip
    ici_bw_per_link: float          # bytes/s per link, per direction
    ici_links: int                  # usable links per chip (torus degree)
    vmem_bytes: int                 # on-chip vector memory
    clock_hz: float                 # core clock used to convert seconds->cycles
    issue_overhead_cycles: float    # per-instruction scheduler issue cost
    dma_setup_cycles: float         # HBM<->VMEM DMA setup latency
    collective_setup_cycles: float  # per-collective launch latency
    mxu_pipe_depth_cycles: float = 64.0   # systolic-array fill/drain latency
    vpu_pipe_depth_cycles: float = 16.0   # vector-unit pipeline latency
    # Cost to recycle an exhausted synchronization resource (§III-E): when a
    # kernel holds more async transfers in flight than the part has barrier
    # slots / waitcnt counters / SWSB tokens, the oversubscribing
    # instruction serializes against the oldest holder and pays this
    # additional drain/re-arm latency on top of the holder's remaining time.
    sync_realloc_cycles: float = 4.0
    # Concurrent issue-queue model driving the multi-stream sampler; the
    # default is the degenerate single in-order stream.
    issue: IssueModel = field(default=SINGLE_ISSUE)
    # Resident-wave model driving the latency-hiding sampler; the default
    # is the degenerate single wave (every registered backend keeps this —
    # native residency lives on `Backend.native_occupancy` and is engaged
    # via `Backend.with_occupancy()` so plain profiles stay byte-identical).
    occupancy: OccupancyModel = field(default=SINGLE_WAVE)

    @property
    def ici_bw_total(self) -> float:
        return self.ici_bw_per_link * self.ici_links

    # --- per-instruction latency model (virtual PC sampling input) ---------

    def compute_seconds(self, instr: Instruction) -> float:
        if instr.flops <= 0:
            return 0.0
        peak = self.peak_flops_bf16 if instr.op_class is OpClass.MATMUL \
            else self.peak_flops_f32
        # VPU elementwise work rarely reaches peak; keep a flat derate.
        derate = 1.0 if instr.op_class is OpClass.MATMUL else 0.5
        return instr.flops / (peak * derate)

    def memory_seconds(self, instr: Instruction) -> float:
        bytes_moved = instr.bytes_read + instr.bytes_written
        if bytes_moved <= 0:
            return 0.0
        return bytes_moved / self.hbm_bw

    def collective_seconds(self, instr: Instruction) -> float:
        if instr.comm_bytes <= 0:
            return 0.0
        return instr.comm_bytes / self.ici_bw_per_link \
            + self.collective_setup_cycles / self.clock_hz

    def latency_seconds(self, instr: Instruction) -> float:
        """Roofline latency of one instruction: max of its resource terms."""
        return max(self.compute_seconds(instr), self.memory_seconds(instr),
                   self.collective_seconds(instr))

    def latency_cycles(self, instr: Instruction) -> float:
        """Issue-to-result latency: when the value becomes consumable.

        Compute units have pipeline depth beyond their throughput occupancy
        (systolic fill/drain on the MXU, vector pipeline on the VPU), so a
        dependent consumer issued back-to-back stalls by that depth — the
        TPU analogue of the paper's DMUL->DMUL execution-dependency chains.
        """
        base = self.issue_overhead_cycles
        if instr.op_class in (OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE,
                              OpClass.DATA_MOVEMENT, OpClass.SYNC_SET):
            base += self.dma_setup_cycles
        elif instr.op_class is OpClass.MATMUL:
            base += self.mxu_pipe_depth_cycles
        elif instr.op_class in (OpClass.COMPUTE, OpClass.REDUCE,
                                OpClass.FUSION):
            base += self.vpu_pipe_depth_cycles
        elif instr.op_class is OpClass.COLLECTIVE:
            base += self.collective_setup_cycles
        return base + self.latency_seconds(instr) * self.clock_hz

    def issue_cycles(self, instr: Instruction) -> float:
        """Cycles the instruction occupies the issue slot (throughput cost).

        This plays the role of `control.stall` (NVIDIA) / instruction counts
        (AMD/Intel) in the paper's Stage-3 latency pruning: work issued
        between a producer and its consumer hides the producer's latency.

        Memory traffic, async copies and async collective *starts* retire
        from the issue slot after DMA setup and complete in the background
        (the TPU analogue of warp-level latency hiding): their latency is
        only *exposed* if a consumer catches up with them.  Compute ops
        occupy their pipeline for their full throughput cost.  Synchronous
        collectives block the stream.
        """
        if instr.op_class in (OpClass.MEMORY_LOAD, OpClass.MEMORY_STORE,
                              OpClass.DATA_MOVEMENT, OpClass.SYNC_SET):
            return self.issue_overhead_cycles + self.dma_setup_cycles
        if instr.op_class is OpClass.COLLECTIVE:
            # Collectives launch asynchronously onto the ICI DMA engines;
            # their transfer latency is exposed at the *consumer* (this is
            # what produces collective_wait stalls for LEO to trace).
            return self.issue_overhead_cycles + self.collective_setup_cycles
        if instr.op_class in (OpClass.SYNC_WAIT, OpClass.TUPLE,
                              OpClass.PARAMETER, OpClass.CONSTANT):
            return self.issue_overhead_cycles
        # COMPUTE / MATMUL / REDUCE / FUSION / CONTROL: the op occupies its
        # unit for its full roofline (throughput) time.
        return self.issue_overhead_cycles + self.latency_seconds(instr) * self.clock_hz


# TPU cores are in-order VLIW: the compiler schedules one bundle stream,
# so the issue model is the degenerate single queue (scheduler-contention
# stalls structurally cannot occur — the compiler already serialized).
TPU_ISSUE = SINGLE_ISSUE

TPU_V5E = HardwareModel(
    name="tpu_v5e",
    issue=TPU_ISSUE,
    peak_flops_bf16=197e12,
    peak_flops_f32=98.5e12,
    hbm_bw=819e9,
    hbm_bytes=16 * 2**30,
    ici_bw_per_link=50e9,
    ici_links=4,
    vmem_bytes=128 * 2**20,
    clock_hz=940e6,
    issue_overhead_cycles=1.0,
    dma_setup_cycles=8.0,
    collective_setup_cycles=2000.0,
)

TPU_V5P = HardwareModel(
    name="tpu_v5p",
    issue=TPU_ISSUE,
    peak_flops_bf16=459e12,
    peak_flops_f32=229.5e12,
    hbm_bw=2765e9,
    hbm_bytes=95 * 2**30,
    ici_bw_per_link=100e9,
    ici_links=6,
    vmem_bytes=128 * 2**20,
    clock_hz=1750e6,
    issue_overhead_cycles=1.0,
    dma_setup_cycles=8.0,
    collective_setup_cycles=2000.0,
)

TPU_V4 = HardwareModel(
    name="tpu_v4",
    issue=TPU_ISSUE,
    peak_flops_bf16=275e12,
    peak_flops_f32=137.5e12,
    hbm_bw=1228e9,
    hbm_bytes=32 * 2**30,
    ici_bw_per_link=50e9,
    ici_links=6,
    vmem_bytes=128 * 2**20,
    clock_hz=1050e6,
    issue_overhead_cycles=1.0,
    dma_setup_cycles=8.0,
    collective_setup_cycles=2000.0,
)

HARDWARE_MODELS: Dict[str, HardwareModel] = {
    m.name: m for m in (TPU_V5E, TPU_V5P, TPU_V4)
}


def get_hardware_model(name: str) -> HardwareModel:
    try:
        return HARDWARE_MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware model {name!r}; known: {sorted(HARDWARE_MODELS)}")
