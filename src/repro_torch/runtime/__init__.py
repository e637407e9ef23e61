"""Step builders of the port (train, serve and prefill), and the fault
handling of the training control plane (a copy of `repro.runtime.fault`)."""
from .fault import (
    ElasticController,
    FaultTolerantLoop,
    HeartbeatMonitor,
    MeshPlan,
    StragglerPolicy,
)
from .steps import (
    TrainOptions,
    default_microbatch,
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = ["ElasticController", "FaultTolerantLoop", "HeartbeatMonitor",
           "MeshPlan", "StragglerPolicy", "TrainOptions",
           "default_microbatch", "init_train_state", "make_prefill_step",
           "make_serve_step", "make_train_step"]
