"""AMD-class backend descriptor (MI300A-class constants).

Class estimates from public specs: CDNA3 bf16 matrix FLOPs, 5.3 TB/s HBM3,
Infinity Fabric links.  Taxonomy follows rocprofiler / GCN ISA vocabulary;
the signature sync mechanism is ``s_waitcnt`` counter draining, which LEO's
waitcnt tracing reproduces exactly (§III-E oldest-(M-N) rule).
"""
from __future__ import annotations

from ..hwmodel import HardwareModel, IssueModel, OccupancyModel
from ..isa import StallClass, SyncKind
from . import Backend, SyncModel, SyncResourcePool, register_backend

# Four SIMD units per CU; the CU front-end rotates across them round-robin
# (one SIMD considered per cycle), so a ready wave on a busy SIMD waits for
# its slot even when a sibling SIMD idles — rocprofiler's
# `arbiter_not_selected`.
AMD_ISSUE = IssueModel(queues=4, width=1, policy="round_robin")

# Mid residency, wavefront-slot-limited: each SIMD hosts up to 8-10 wave
# slots architecturally but VGPR/LDS budgets cap CDNA3 compute kernels
# near 4 per SIMD.  Fewer waves than NVIDIA, but the wide 64-lane waves
# carry more independent memory work each — a longer per-wave hiding
# window compensating the shallower pool.
AMD_OCCUPANCY = OccupancyModel(waves=4, limiter="wavefront_slots",
                               window_cycles=96.0)

AMD_MI300A = HardwareModel(
    name="amd_mi300a",
    issue=AMD_ISSUE,
    peak_flops_bf16=980e12,          # CDNA3 matrix-core bf16
    peak_flops_f32=122e12,           # vector fp32
    hbm_bw=5300e9,                   # HBM3, widest in class
    hbm_bytes=128 * 2**30,
    ici_bw_per_link=64e9,            # Infinity Fabric per link
    ici_links=8,
    vmem_bytes=64 * 2**20,           # LDS + L2-resident tiles
    clock_hz=2100e6,
    issue_overhead_cycles=1.0,
    dma_setup_cycles=16.0,
    collective_setup_cycles=12000.0,  # RCCL launch cost @ 2.1 GHz
    mxu_pipe_depth_cycles=16.0,       # MFMA result latency
    vpu_pipe_depth_cycles=8.0,        # VALU forwarding latency
    sync_realloc_cycles=6.0,          # s_waitcnt 0 full-drain before reuse
)

# rocprofiler / GCN wait vocabulary.
ROCM_TAXONOMY = {
    StallClass.NONE: "issued",
    StallClass.MEM_DEP: "s_waitcnt_vmcnt",
    StallClass.EXEC_DEP: "s_waitcnt_lgkmcnt",
    StallClass.SYNC_WAIT: "s_barrier",
    StallClass.SYNC_RESOURCE: "s_waitcnt_alias",  # streams sharing a counter
    StallClass.COLLECTIVE_WAIT: "xgmi_wait",
    StallClass.FETCH: "instruction_fetch",
    StallClass.PIPE_BUSY: "mfma_pipe_busy",
    StallClass.NOT_SELECTED: "arbiter_not_selected",
    StallClass.OCCUPANCY_LIMITED: "no_ready_wave",
    StallClass.SELF: "other",
}

# Async copies on a GCN-class part are tracked by the two memory waitcnt
# counters (vmcnt for HBM, lgkmcnt for LDS/scalar; expcnt tracks exports
# and cannot carry copies), so barrier-style async pairs AND token chains
# all route onto those two counters — independent streams beyond two alias
# a counter, and a drain on the shared counter serializes both (§III-E).
# The single workgroup s_barrier is an execution barrier, not a transfer-
# tracking resource; it is declared but nothing routes to it.  The waitcnt
# counters are per-wave (`scope="queue"`): every SIMD's wave slot tracks
# its own vmcnt/lgkmcnt, so pressure is per issue queue, while the
# workgroup s_barrier stays device-global.
AMD_SYNC = SyncModel(
    pools=(SyncResourcePool(
               name="waitcnt_counter", kind=SyncKind.WAITCNT,
               label="s_waitcnt memory counters",
               instances=("vmcnt", "lgkmcnt"), scope="queue"),
           SyncResourcePool(
               name="s_barrier", kind=SyncKind.BARRIER,
               label="workgroup s_barrier", instances=("s_barrier",),
               scope="device")),
    routing={SyncKind.BARRIER: "waitcnt_counter",
             SyncKind.WAITCNT: "waitcnt_counter",
             SyncKind.TOKEN: "waitcnt_counter"},
    async_collectives=True,
)

AMD_MI300A_BACKEND = register_backend(Backend(
    name="amd_mi300a", vendor="amd", hw=AMD_MI300A,
    stall_taxonomy=ROCM_TAXONOMY, sync=AMD_SYNC,
    native_occupancy=AMD_OCCUPANCY,
    description="MI300A-class: widest HBM (5.3 TB/s) per FLOP — memory-"
                "bound kernels flip compute-bound here first."))
