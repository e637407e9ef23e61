"""PyTorch model zoo of the port: dense GQA and hybrid attention + SSM
transformers, full or sliding-window attention."""
from .convert import decode_state_from_numpy, params_from_numpy
from .transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
    layer_descriptors,
    layer_groups,
    loss_fn,
)

__all__ = [
    "decode_state_from_numpy", "decode_step", "forward",
    "init_decode_state", "init_params", "layer_descriptors", "layer_groups",
    "loss_fn", "params_from_numpy",
]
