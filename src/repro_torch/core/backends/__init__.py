"""Pluggable cross-vendor backend registry (paper §II / Observation 1).

A :class:`Backend` bundles everything LEO needs to analyze a program *as if*
it ran on one vendor's part:

  * an analytical :class:`~repro.core.hwmodel.HardwareModel` (roofline and
    latency constants — the per-vendor FLOP:HBM:interconnect ratios that make
    the same kernel bottleneck differently per platform);
  * a *stall-class taxonomy*: the mapping from LEO's unified
    :class:`~repro.core.isa.StallClass` buckets back to the vendor-native
    profiler counter names (CUPTI / rocprofiler / Level Zero / TPU xplane),
    so reports can speak each vendor's language;
  * a :class:`SyncModel` describing the §III-E synchronization resources
    the vendor's ISA exposes (named barriers, waitcnt counters, SWSB-style
    tokens) as *finite, named pools* with a stateful scoreboard, plus how
    collectives launch.  The deprecated :class:`SyncSemantics` knob bag is
    accepted and converted transparently.

Backends register into a process-global :class:`BackendRegistry`; third
parties add vendors with :func:`register_backend` without touching core
files.  Six descriptors ship by default — three TPU generations (the seed's
models) plus NVIDIA-, AMD- and Intel-class parts — so
``LeoSession.compare_backends`` exercises genuinely divergent vendors.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, Iterator, List, Mapping, Optional, Tuple, Union

from ..hwmodel import (SINGLE_ISSUE, SINGLE_WAVE, HardwareModel, IssueModel,
                       OccupancyModel)
from ..isa import StallClass, SyncKind
from .syncmodel import (
    DEFAULT_SYNC_MODEL,
    SyncAcquire,
    SyncLike,
    SyncModel,
    SyncPressureReport,
    SyncResourcePool,
    SyncScoreboard,
    SyncSemantics,
    resolve_sync_model,
)


@dataclass(frozen=True)
class Backend:
    """One vendor/part descriptor: hardware model + taxonomy + sync model."""

    name: str
    vendor: str                               # "google" | "nvidia" | ...
    hw: HardwareModel
    stall_taxonomy: Mapping[StallClass, str]  # unified -> native counter name
    sync: SyncModel = DEFAULT_SYNC_MODEL
    description: str = ""
    # The part's NATIVE wave residency (a capability, not an engagement):
    # `hw.occupancy` stays SINGLE_WAVE on every registered backend so plain
    # profiles are byte-identical to the pre-occupancy sampler; analysis
    # under native residency goes through `with_occupancy()`.
    native_occupancy: OccupancyModel = SINGLE_WAVE

    def __post_init__(self) -> None:
        # Legacy callers hand us the deprecated SyncSemantics knob bag;
        # convert so everything downstream sees one behavioral type.
        if not isinstance(self.sync, SyncModel):
            object.__setattr__(self, "sync", resolve_sync_model(self.sync))

    def native_stall_name(self, cls: StallClass) -> str:
        """Vendor-native profiler name for a unified stall class."""
        return self.stall_taxonomy.get(cls, cls.value)

    def taxonomy_table(self) -> Dict[str, str]:
        return {cls.value: name for cls, name in self.stall_taxonomy.items()}

    @property
    def issue(self) -> IssueModel:
        """The hardware model's issue-stream descriptor."""
        return getattr(self.hw, "issue", SINGLE_ISSUE) or SINGLE_ISSUE

    def with_issue(self, issue: IssueModel,
                   name: Optional[str] = None) -> "Backend":
        """Derive a backend with a different issue model (e.g. the K=1
        single-stream variant anchoring the pre-multi-stream goldens).
        The derived descriptor gets a distinct name — covering every
        IssueModel field, policy included — so session/service caches
        (keyed on backend name) cannot alias two variants."""
        derived = name or (f"{self.name}@q{issue.queues}x{issue.width}-"
                           f"{issue.policy}")
        return _dc_replace(self, name=derived,
                           hw=_dc_replace(self.hw, issue=issue))

    @property
    def occupancy(self) -> OccupancyModel:
        """The hardware model's ACTIVE wave-residency descriptor."""
        return getattr(self.hw, "occupancy", SINGLE_WAVE) or SINGLE_WAVE

    def with_occupancy(self, occ: Optional[OccupancyModel] = None,
                       name: Optional[str] = None) -> "Backend":
        """Derive a backend whose sampler runs under wave residency ``occ``
        (default: this part's native residency).  As with ``with_issue``,
        the derived descriptor gets a distinct name covering every
        OccupancyModel field so session/service caches (keyed on backend
        name) can never alias the W=1 and native-W variants."""
        occ = occ if occ is not None else self.native_occupancy
        derived = name or (f"{self.name}@w{occ.waves}-{occ.limiter}-"
                           f"h{occ.window_cycles:g}")
        return _dc_replace(self, name=derived,
                           hw=_dc_replace(self.hw, occupancy=occ))


class UnknownBackendError(KeyError):
    """Raised for lookups of unregistered backend names."""

    def __init__(self, name: str, known: List[str]):
        super().__init__(
            f"unknown backend {name!r}; registered: {sorted(known)}")
        self.name = name
        self.known = sorted(known)

    def __str__(self) -> str:  # KeyError quotes its arg; keep it readable
        return self.args[0]


class BackendRegistry:
    """Name -> :class:`Backend` mapping with third-party registration."""

    def __init__(self) -> None:
        self._backends: Dict[str, Backend] = {}

    def register(self, backend: Backend, *, overwrite: bool = False) -> Backend:
        if not overwrite and backend.name in self._backends:
            raise ValueError(
                f"backend {backend.name!r} already registered; pass "
                f"overwrite=True to replace it")
        self._backends[backend.name] = backend
        return backend

    def unregister(self, name: str) -> None:
        self._backends.pop(name, None)

    def get(self, name: str) -> Backend:
        try:
            return self._backends[name]
        except KeyError:
            raise UnknownBackendError(name, list(self._backends)) from None

    def names(self) -> List[str]:
        return list(self._backends)

    def by_vendor(self, vendor: str) -> List[Backend]:
        return [b for b in self._backends.values() if b.vendor == vendor]

    def __contains__(self, name: str) -> bool:
        return name in self._backends

    def __iter__(self) -> Iterator[Backend]:
        return iter(self._backends.values())

    def __len__(self) -> int:
        return len(self._backends)


#: Process-global default registry; `register_backend` and `LeoSession`
#: operate on this unless handed an explicit registry.
REGISTRY = BackendRegistry()


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    return REGISTRY.register(backend, overwrite=overwrite)


def get_backend(name: str) -> Backend:
    return REGISTRY.get(name)


def list_backends() -> List[Backend]:
    return list(REGISTRY)


BackendLike = Union[Backend, HardwareModel, str]


def resolve_backend(spec: BackendLike) -> Backend:
    """Coerce a backend name / Backend / bare HardwareModel to a Backend.

    Bare hardware models (the legacy ``hw=TPU_V5E`` calling convention)
    resolve to their registered backend when one carries the same model,
    otherwise wrap into an anonymous descriptor with the generic taxonomy —
    legacy callers keep working without registering anything.
    """
    if isinstance(spec, Backend):
        return spec
    if isinstance(spec, str):
        return get_backend(spec)
    if isinstance(spec, HardwareModel):
        for backend in REGISTRY:
            if backend.hw is spec or backend.hw == spec:
                return backend
        return Backend(name=spec.name, vendor="custom", hw=spec,
                       stall_taxonomy=GENERIC_TAXONOMY,
                       description="ad-hoc backend wrapping a bare "
                                   "HardwareModel")
    raise TypeError(f"cannot resolve backend from {type(spec).__name__}")


#: Fallback taxonomy: unified names map to themselves.
GENERIC_TAXONOMY: Mapping[StallClass, str] = {
    cls: cls.value for cls in StallClass
}


# -- default registrations ---------------------------------------------------
# Imported last: the vendor modules call register_backend() at import time.
from . import amd, intel, nvidia, tpu  # noqa: E402,F401  (registration side effect)

__all__ = [
    "Backend", "BackendRegistry", "BackendLike", "IssueModel",
    "OccupancyModel", "SINGLE_ISSUE", "SINGLE_WAVE",
    "DEFAULT_SYNC_MODEL", "SyncAcquire", "SyncLike", "SyncModel",
    "SyncPressureReport", "SyncResourcePool", "SyncScoreboard",
    "SyncSemantics", "resolve_sync_model",
    "UnknownBackendError", "REGISTRY", "GENERIC_TAXONOMY",
    "register_backend", "get_backend", "list_backends", "resolve_backend",
]
