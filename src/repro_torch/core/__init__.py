"""LEO's analyzer tiers for the PyTorch/CUDA port.

Copies of `repro.core`'s Module-level tiers (the port imports nothing of
`repro`; `tests/test_torch_core.py` holds each copy's results equal to the
original's on the same `Module`), plus the port's own front-ends and its
H100 backend:

  * `torch_frontend.capture` — a PyTorch program (the port's `loss_fn`,
    with each hand kernel as one fused on-chip region) -> `Module`;
  * `ptx_frontend.from_ptx` — one `.entry` of a CUDA kernel's PTX (its
    `cp.async` groups as counted-wait sets and waits) -> `Module`;
  * `backends.nvidia` registers `nvidia_h100_sxm` beside the six
    backends of the reference.

    from repro_torch.core import analyze_module, capture
    module = capture(fn, *example_args, device="cuda")
    an = analyze_module(module, "nvidia_h100_sxm")
"""
from .analyzer import LeoAnalysis, analyze_module, cross_backend_analyze
from .backends import (
    Backend,
    REGISTRY,
    get_backend,
    list_backends,
    register_backend,
    resolve_backend,
)
from .fusion_model import FUSED_REGION_MARK
from .hwmodel import HARDWARE_MODELS, TPU_V4, TPU_V5E, TPU_V5P, HardwareModel
from .isa import (
    Computation,
    EdgeKind,
    Instruction,
    Module,
    OpClass,
    ShapeInfo,
    StallClass,
    SyncInfo,
    SyncKind,
)
from .ptx_frontend import from_ptx, ptx_entries
from .report import diagnostic_context, recommendations
from .roofline import RooflineReport, compute_roofline
from .torch_frontend import capture

__all__ = [
    "Backend", "Computation", "EdgeKind", "FUSED_REGION_MARK",
    "HARDWARE_MODELS", "HardwareModel", "Instruction", "LeoAnalysis",
    "Module", "OpClass", "REGISTRY", "RooflineReport", "ShapeInfo",
    "StallClass", "SyncInfo", "SyncKind", "TPU_V4", "TPU_V5E", "TPU_V5P",
    "analyze_module", "capture", "compute_roofline", "cross_backend_analyze",
    "diagnostic_context", "from_ptx", "get_backend", "list_backends",
    "ptx_entries", "recommendations", "register_backend", "resolve_backend",
]
