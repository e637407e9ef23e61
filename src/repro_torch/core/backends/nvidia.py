"""NVIDIA-class backend descriptor (GH200/H100-class constants).

Numbers are public-spec class estimates, not measurements: dense bf16 tensor
FLOPs, HBM3 bandwidth, NVLink4 (18 links x 50 GB/s per direction).  The
taxonomy is CUPTI PC-sampling's stall-reason vocabulary (the paper's primary
platform), and the sync semantics are named barriers B1-B6 — the mechanism
LEO's barrier tracing models (§III-E).
"""
from __future__ import annotations

from ..hwmodel import HardwareModel, IssueModel, OccupancyModel
from ..isa import StallClass, SyncKind
from . import Backend, SyncModel, SyncResourcePool, register_backend

# Four warp schedulers per SM, greedy-then-oldest arbitration (GTO): a
# ready warp waits only when every scheduler is occupied, and that wait is
# what CUPTI reports as `not_selected`.
NVIDIA_ISSUE = IssueModel(queues=4, width=1, policy="greedy_oldest")

# High residency, register-limited: an SM hosts up to 64 warps (16 per
# scheduler) but register allocation caps a realistic kernel near 8 per
# scheduler — the `__launch_bounds__` / maxrregcount tradeoff.  Deep warp
# pools give each co-resident warp a long independent-issue horizon, so
# NVIDIA hides the most latency per stall of the three GPU-class parts.
NVIDIA_OCCUPANCY = OccupancyModel(waves=8, limiter="register_file",
                                  window_cycles=48.0)

NVIDIA_GH200 = HardwareModel(
    name="nvidia_gh200",
    issue=NVIDIA_ISSUE,
    peak_flops_bf16=989e12,          # dense tensor-core bf16
    peak_flops_f32=67e12,            # CUDA-core fp32 vector path
    hbm_bw=4000e9,                   # HBM3e, GH200-class
    hbm_bytes=96 * 2**30,
    ici_bw_per_link=50e9,            # NVLink4 per link per direction
    ici_links=18,
    vmem_bytes=50 * 2**20,           # L2-resident working set
    clock_hz=1830e6,
    issue_overhead_cycles=1.0,
    dma_setup_cycles=20.0,           # TMA/cp.async launch
    collective_setup_cycles=9000.0,  # NCCL kernel launch ~5us @ 1.8 GHz
    mxu_pipe_depth_cycles=32.0,      # tensor-core result latency
    vpu_pipe_depth_cycles=24.0,      # dependent-issue ALU latency
    sync_realloc_cycles=8.0,         # bar.sync drain before slot reuse
)

# CUPTI PC-sampling stall reasons (§II-D table).
CUPTI_TAXONOMY = {
    StallClass.NONE: "selected",
    StallClass.MEM_DEP: "long_scoreboard",
    StallClass.EXEC_DEP: "short_scoreboard",
    StallClass.SYNC_WAIT: "barrier",
    StallClass.SYNC_RESOURCE: "barrier_alloc",   # named-barrier slot reuse
    StallClass.COLLECTIVE_WAIT: "membar",
    StallClass.FETCH: "no_instruction",
    StallClass.PIPE_BUSY: "math_pipe_throttle",
    StallClass.NOT_SELECTED: "not_selected",
    StallClass.OCCUPANCY_LIMITED: "no_eligible_warp",
    StallClass.SELF: "misc",
}

# Every §III-E mechanism the unified IR records rides the B1-B6 named
# barriers on an NVIDIA-class part: 7+ async copies in flight oversubscribe
# and serialize (the paper's oldest-(M-N) rule).  The pool is CTA-scoped
# (`scope="device"`): all four warp schedulers allocate from the SAME six
# barriers, so multi-queue issue does not relieve barrier pressure.
NVIDIA_SYNC = SyncModel(
    pools=(SyncResourcePool.counted(
        "named_barrier", SyncKind.BARRIER, "named barriers B1-B6",
        "B", 6, start=1, scope="device"),),
    routing={SyncKind.BARRIER: "named_barrier",
             SyncKind.WAITCNT: "named_barrier",
             SyncKind.TOKEN: "named_barrier"},
    async_collectives=True,   # NCCL on copy engines / SM subsets
)

NVIDIA_GH200_BACKEND = register_backend(Backend(
    name="nvidia_gh200", vendor="nvidia", hw=NVIDIA_GH200,
    stall_taxonomy=CUPTI_TAXONOMY, sync=NVIDIA_SYNC,
    native_occupancy=NVIDIA_OCCUPANCY,
    description="GH200-class: dominant tensor FLOPs, mid-pack HBM ratio, "
                "fat NVLink — compute-rich, memory-ratio-poor."))

# The card the port runs on.  Every number below is a datasheet value for
# "NVIDIA H100 80GB HBM3, 700 W" (the SXM5 part; NVIDIA's H100 data sheet,
# dense rates without sparsity), not a measurement: the issue, occupancy and
# sync models are the GH200-class ones above (same Hopper SM).
NVIDIA_H100_SXM = HardwareModel(
    name="nvidia_h100_sxm",
    issue=NVIDIA_ISSUE,
    peak_flops_bf16=989e12,          # datasheet: dense tensor-core bf16
    peak_flops_f32=67e12,            # datasheet: fp32 outside tensor cores
    hbm_bw=3.35e12,                  # datasheet: HBM3, 3.35 TB/s
    hbm_bytes=80 * 10**9,            # datasheet: 80 GB
    ici_bw_per_link=25e9,            # datasheet: NVLink4, 18 links x 25 GB/s
    ici_links=18,                    #   each way (450 GB/s each way)
    vmem_bytes=50 * 2**20,           # datasheet: 50 MB L2
    clock_hz=1980e6,                 # datasheet: 1980 MHz boost clock
    issue_overhead_cycles=1.0,
    dma_setup_cycles=20.0,           # TMA/cp.async launch
    collective_setup_cycles=9000.0,  # NCCL kernel launch, as GH200 above
    mxu_pipe_depth_cycles=32.0,      # tensor-core result latency
    vpu_pipe_depth_cycles=24.0,      # dependent-issue ALU latency
    sync_realloc_cycles=8.0,         # bar.sync drain before slot reuse
)

NVIDIA_H100_SXM_BACKEND = register_backend(Backend(
    name="nvidia_h100_sxm", vendor="nvidia", hw=NVIDIA_H100_SXM,
    stall_taxonomy=CUPTI_TAXONOMY, sync=NVIDIA_SYNC,
    native_occupancy=NVIDIA_OCCUPANCY,
    description="H100 SXM5 80GB: the card the PyTorch/CUDA port runs on; "
                "GH200's SM models with HBM3 at 3.35 TB/s."))
