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

The session and service tiers (`session.py`, `service.py`, `caching.py`,
and `hlo_parser.py`, which the session parses text with) are verbatim
copies of the reference's; `LeoSession.analyze` takes a captured `Module`
as it takes HLO text.  `LeoService`'s `advise=True` and `rewrite=True`
run the port's copies of the advisor (`repro_torch.advisor`) and the
rewrite loop (`repro_torch.rewrite`); `repro_torch.serve` and
`launch/analysis_server.py` serve diagnoses over HTTP.

    from repro_torch.core import LeoSession, capture
    module = capture(fn, *example_args, device="cuda")
    an = LeoSession().analyze(module, backend="nvidia_h100_sxm")
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
from .caching import DiskCache, LRUCache
from .fusion_model import FUSED_REGION_MARK
from .hlo_parser import HloParser, parse_hlo
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
from .report import Diagnosis, diagnostic_context, recommendations
from .roofline import RooflineReport, compute_roofline
from .service import AnalyzeRequest, DiagnoseOptions, LeoService
from .session import LeoSession, SessionStats
from .torch_frontend import capture

__all__ = [
    "AnalyzeRequest", "Backend", "Computation", "DiagnoseOptions",
    "Diagnosis", "DiskCache", "EdgeKind", "FUSED_REGION_MARK",
    "HARDWARE_MODELS", "HardwareModel", "HloParser", "Instruction",
    "LRUCache", "LeoAnalysis", "LeoService", "LeoSession", "Module",
    "OpClass", "REGISTRY", "RooflineReport", "SessionStats", "ShapeInfo",
    "StallClass", "SyncInfo", "SyncKind", "TPU_V4", "TPU_V5E", "TPU_V5P",
    "analyze_module", "capture", "compute_roofline", "cross_backend_analyze",
    "diagnostic_context", "from_ptx", "get_backend", "list_backends",
    "parse_hlo", "ptx_entries", "recommendations", "register_backend",
    "resolve_backend",
]
