"""Legacy entry points — thin shims over the composable pass pipeline.

The port's copy of `repro.core.analyzer`, over `Module`s only: the port
has no XLA, so there is no `analyze_hlo`; its programs reach the `Module`
IR through `torch_frontend.capture` (PyTorch programs) and
`ptx_frontend.from_ptx` (the CUDA kernels' PTX).

    analyze_module(module, hw=...)      == DEFAULT_PIPELINE.analyze(module, ...)
    cross_backend_analyze(module)       == one analysis per registered backend
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from .backends import BackendLike, list_backends, resolve_backend
from .hwmodel import TPU_V5E
from .isa import Module
from .passes import DEFAULT_PIPELINE, LeoAnalysis
from .sampler import StallProfile

__all__ = ["LeoAnalysis", "analyze_module", "cross_backend_analyze"]


def analyze_module(module: Module, hw: BackendLike = TPU_V5E,
                   profile: Optional[StallProfile] = None,
                   n_chains: int = 5,
                   prune_unexecuted: bool = True) -> LeoAnalysis:
    """Single-module analysis on one backend (hw may be a HardwareModel,
    a registered backend name, or a Backend descriptor)."""
    return DEFAULT_PIPELINE.analyze(module, resolve_backend(hw),
                                    profile=profile, n_chains=n_chains,
                                    prune_unexecuted=prune_unexecuted)


def cross_backend_analyze(module: Module,
                          hw_models: Optional[Sequence[BackendLike]] = None
                          ) -> Dict[str, LeoAnalysis]:
    """Observation 1: the same program on every backend model.

    Defaults to every *registered* backend (3 TPU generations plus the
    NVIDIA/AMD/Intel-class descriptors and the H100 SXM), so the divergence
    the paper reports across genuinely different vendors shows up out of
    the box."""
    backends = [resolve_backend(hw) for hw in hw_models] \
        if hw_models is not None else list_backends()
    return {b.name: analyze_module(module, b) for b in backends}
