"""Step builders of the port: train, serve and prefill."""
from .steps import (
    TrainOptions,
    default_microbatch,
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = ["TrainOptions", "default_microbatch", "init_train_state",
           "make_prefill_step", "make_serve_step", "make_train_step"]
