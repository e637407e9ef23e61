"""Intel-class backend descriptor (Ponte Vecchio / Max 1550-class constants).

Class estimates: XMX bf16 FLOPs, HBM2e bandwidth, Xe-Link fabric (many thin
links — the weakest per-link interconnect of the three vendors, which is
what makes collective-heavy programs diverge here, paper Observation 1).
Taxonomy follows Level Zero / GTPin vocabulary; synchronization is SWSB
software scoreboarding — the token-threading mechanism LEO traces (§III-E).
"""
from __future__ import annotations

from ..hwmodel import HardwareModel, IssueModel, OccupancyModel
from ..isa import StallClass, SyncKind
from . import Backend, SyncModel, SyncResourcePool, register_backend

# Eight Xe vector engines per Xe-core, each co-issuing to paired
# vector/matrix ports (width 2): the widest issue fabric of the three
# GPU-class parts — wide independent-op workloads that choke a 4-queue
# part sail through here (the PR-4 wide-ops divergence golden).
INTEL_ISSUE = IssueModel(queues=8, width=2, policy="round_robin")

# Low residency, thread-limited: a Xe vector engine hosts 8 hardware
# threads but large-GRF kernels (the XMX-heavy mode) halve that, and the
# wide issue fabric already spreads work across 8 engines — so per-queue
# residency is the shallowest of the three GPU-class parts.  Latency-bound
# kernels that NVIDIA hides behind warps stay exposed here.
INTEL_OCCUPANCY = OccupancyModel(waves=2, limiter="thread_slots",
                                 window_cycles=32.0)

INTEL_PVC = HardwareModel(
    name="intel_pvc",
    issue=INTEL_ISSUE,
    peak_flops_bf16=839e12,          # XMX bf16, Max 1550-class
    peak_flops_f32=52e12,            # vector fp32
    hbm_bw=3280e9,                   # HBM2e
    hbm_bytes=128 * 2**30,
    ici_bw_per_link=26.5e9,          # Xe-Link per link — thin
    ici_links=16,
    vmem_bytes=128 * 2**20,          # large Rambo/L2 cache
    clock_hz=1600e6,
    issue_overhead_cycles=1.0,
    dma_setup_cycles=24.0,
    collective_setup_cycles=16000.0,  # oneCCL launch @ 1.6 GHz
    mxu_pipe_depth_cycles=8.0,        # XMX systolic depth (8-deep)
    vpu_pipe_depth_cycles=10.0,
    sync_realloc_cycles=2.0,          # SBID release is a cheap sync.allrd
)

# Level Zero / GTPin stall vocabulary (SWSB scoreboard waits).
LEVELZERO_TAXONOMY = {
    StallClass.NONE: "active",
    StallClass.MEM_DEP: "sbid_wait_load",
    StallClass.EXEC_DEP: "swsb_dist_wait",
    StallClass.SYNC_WAIT: "sync_func_wait",
    StallClass.SYNC_RESOURCE: "sbid_alloc_wait",  # SBID reuse serialization
    StallClass.COLLECTIVE_WAIT: "xelink_wait",
    StallClass.FETCH: "instruction_fetch",
    StallClass.PIPE_BUSY: "pipe_stall",
    StallClass.NOT_SELECTED: "thread_not_selected",
    StallClass.OCCUPANCY_LIMITED: "no_ready_thread",
    StallClass.SELF: "other",
}

# Every in-flight async operation on a Xe-class part claims one of the 16
# SWSB scoreboard IDs; the compiler spills to serialization only past $15,
# so a copy storm that chokes NVIDIA's 6 named barriers sails through here
# (the cross-vendor divergence the §VI case study reports).  The 32
# per-subslice named barriers exist but carry execution barriers, not
# transfer tracking.
# SWSB scoreboard IDs are per-thread (`scope="queue"`): each hardware
# thread's compiler allocates its own $0-$15, so under multi-queue issue
# every queue owns a private token file; the subslice named barriers are
# shared (`scope="device"`).
INTEL_SYNC = SyncModel(
    pools=(SyncResourcePool.counted(
               "swsb_token", SyncKind.TOKEN, "SWSB scoreboard IDs $0-$15",
               "$", 16, scope="queue"),
           SyncResourcePool.counted(
               "named_barrier", SyncKind.BARRIER,
               "subslice named barriers", "nbar", 32, scope="device")),
    routing={SyncKind.BARRIER: "swsb_token",
             SyncKind.WAITCNT: "swsb_token",
             SyncKind.TOKEN: "swsb_token"},
    async_collectives=False,  # oneCCL collectives block the queue
)

INTEL_PVC_BACKEND = register_backend(Backend(
    name="intel_pvc", vendor="intel", hw=INTEL_PVC,
    stall_taxonomy=LEVELZERO_TAXONOMY, sync=INTEL_SYNC,
    native_occupancy=INTEL_OCCUPANCY,
    description="PVC-class: thin per-link Xe-Link fabric and slow "
                "collective launch — communication-heavy programs "
                "bottleneck here first."))
