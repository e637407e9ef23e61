"""TPU backend descriptors (the seed's three hardware models).

The TPU stall taxonomy speaks xplane/trace-viewer vocabulary: stalls show up
as wait-time buckets on the TensorCore timeline rather than warp-scheduler
counters.
"""
from __future__ import annotations

from ..hwmodel import TPU_V4, TPU_V5E, TPU_V5P
from ..isa import StallClass, SyncKind
from . import Backend, SyncModel, SyncResourcePool, register_backend

TPU_TAXONOMY = {
    StallClass.NONE: "idle",
    StallClass.MEM_DEP: "hbm_wait",
    StallClass.EXEC_DEP: "scalar_pipeline_wait",
    StallClass.SYNC_WAIT: "dma_semaphore_wait",
    StallClass.SYNC_RESOURCE: "dma_slot_wait",   # async context exhausted
    StallClass.COLLECTIVE_WAIT: "ici_wait",
    StallClass.FETCH: "program_fetch",
    StallClass.PIPE_BUSY: "mxu_occupied",
    # TPU cores run one compiler-scheduled VLIW program — there is no wave
    # residency to raise, so these buckets are structurally empty (the
    # native_occupancy default SINGLE_WAVE).
    StallClass.NOT_SELECTED: "not_selected",
    StallClass.OCCUPANCY_LIMITED: "occupancy_limited",
    StallClass.SELF: "self",
}

# TPUs expose all three §III-E mechanisms through XLA/Pallas, each backed
# by its own finite pool: async start/done pairs ride per-core async copy
# contexts, Pallas DMA streams ride hardware semaphores, and token threads
# ride in-flight token registers.  Routing is the identity — TPU is the
# only backend where no mechanism is emulated on another's resource.  All
# three pools are per-core device resources behind the single VLIW issue
# stream (`scope="device"`; the issue model is `queues=1`, so scoping is
# moot today but documented for when Megacore-style dual streams land).
TPU_SYNC = SyncModel(
    pools=(SyncResourcePool.counted(
               "async_context", SyncKind.BARRIER, "async copy contexts",
               "ctx", 32, scope="device"),
           SyncResourcePool.counted(
               "dma_semaphore", SyncKind.WAITCNT, "Pallas DMA semaphores",
               "sem", 16, scope="device"),
           SyncResourcePool.counted(
               "token_slot", SyncKind.TOKEN, "XLA token slots", "tok", 8,
               scope="device")),
    routing={SyncKind.BARRIER: "async_context",
             SyncKind.WAITCNT: "dma_semaphore",
             SyncKind.TOKEN: "token_slot"},
    async_collectives=True,
)

TPU_V5E_BACKEND = register_backend(Backend(
    name="tpu_v5e", vendor="google", hw=TPU_V5E,
    stall_taxonomy=TPU_TAXONOMY, sync=TPU_SYNC,
    description="TPU v5e: cost-optimized, narrow HBM (819 GB/s), 4 ICI "
                "links — collective- and memory-sensitive."))

TPU_V5P_BACKEND = register_backend(Backend(
    name="tpu_v5p", vendor="google", hw=TPU_V5P,
    stall_taxonomy=TPU_TAXONOMY, sync=TPU_SYNC,
    description="TPU v5p: training flagship, fat HBM (2.8 TB/s) + 6 ICI "
                "links — the same kernel often flips compute-bound here."))

TPU_V4_BACKEND = register_backend(Backend(
    name="tpu_v4", vendor="google", hw=TPU_V4,
    stall_taxonomy=TPU_TAXONOMY, sync=TPU_SYNC,
    description="TPU v4: balanced mid-generation part."))
