"""`LeoSession`: the cached facade over the pass pipeline.

A session owns three content-addressed caches so production callers (the
benchmark harness, a profiling service fanning one trace out to N vendor
models) never re-do work:

  * **parse cache** — HLO text (sha256 + hints) -> parsed ``Module``;
  * **graph cache** — (module, backend) -> pristine dependency graph;
    pipeline passes mutate graphs (sync edges, prune marks), so the cache
    stores an untouched copy and hands out cheap structural clones that
    share ``Instruction``/``PathInfo`` objects but own their ``Edge``s;
  * **analysis cache** — (module, backend, options) -> ``LeoAnalysis``.

All three tiers are bounded LRU maps (``*_cache_size=None`` keeps the
legacy unbounded behavior) and the whole session is **thread-safe**: every
cache fill is single-flighted, so N threads racing on the same HLO text
produce exactly one parse / one graph build / one pipeline run while the
others wait for the winner's result.  ``compare_backends`` fanned out over
a thread pool (see ``LeoService``) therefore keeps the parse-once
invariant — asserted against ``session.stats`` in the tier-1 tests.

When a :class:`~repro.core.caching.DiskCache` is attached, parse misses
consult the content-addressed on-disk tier before parsing, so a *second
process* pointed at a warm cache directory performs zero HLO parses.
"""
from __future__ import annotations

import hashlib
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .backends import Backend, BackendLike, list_backends, resolve_backend
from .caching import DiskCache, LRUCache
from .depgraph import DependencyGraph, Edge, build_dependency_graph
from .hlo_parser import parse_hlo
from .isa import Module
from .passes import DEFAULT_PIPELINE, LeoAnalysis, Pipeline
from .sampler import StallProfile


@dataclass
class SessionStats:
    parse_calls: int = 0
    parse_misses: int = 0
    parse_disk_hits: int = 0
    graph_requests: int = 0
    graph_builds: int = 0
    analyze_calls: int = 0
    analyze_misses: int = 0

    @property
    def parse_hits(self) -> int:
        return self.parse_calls - self.parse_misses - self.parse_disk_hits

    @property
    def graph_hits(self) -> int:
        return self.graph_requests - self.graph_builds

    @property
    def analyze_hits(self) -> int:
        return self.analyze_calls - self.analyze_misses

    def as_dict(self) -> Dict[str, int]:
        return {
            "parse_calls": self.parse_calls, "parse_hits": self.parse_hits,
            "parse_disk_hits": self.parse_disk_hits,
            "graph_requests": self.graph_requests,
            "graph_hits": self.graph_hits,
            "analyze_calls": self.analyze_calls,
            "analyze_hits": self.analyze_hits,
        }


def _clone_graph(graph: DependencyGraph) -> DependencyGraph:
    """Structural clone: shares the Module and per-edge PathInfo objects
    (immutable), owns the Edge records and index lists (mutated by the
    sync/prune passes)."""
    clone = DependencyGraph(module=graph.module)
    for e in graph.edges:
        clone.add(Edge(producer=e.producer, consumer=e.consumer, kind=e.kind,
                       paths=list(e.paths), pruned_by=e.pruned_by,
                       resource=e.resource))
    return clone


class _SingleFlight:
    """Per-key in-flight dedup: the first caller computes, the rest wait.

    ``begin`` returns (future, owner).  The owner runs the work and must
    call ``finish``/``fail``; non-owners block on ``future.result()``.
    """

    def __init__(self, lock: threading.Lock):
        self._lock = lock            # shared with the owning cache/session
        self._inflight: Dict[Any, Future] = {}

    def begin(self, key: Any) -> Tuple[Future, bool]:
        # caller holds self._lock
        fut = self._inflight.get(key)
        if fut is not None:
            return fut, False
        fut = Future()
        self._inflight[key] = fut
        return fut, True

    def finish(self, key: Any, fut: Future, value: Any) -> None:
        with self._lock:
            self._inflight.pop(key, None)
        fut.set_result(value)

    def fail(self, key: Any, fut: Future, exc: BaseException) -> None:
        with self._lock:
            self._inflight.pop(key, None)
        fut.set_exception(exc)


class _SessionCache:
    """The duck-typed ``ctx.cache`` object pipeline passes consult."""

    def __init__(self, stats: SessionStats,
                 capacity: Optional[int] = None):
        self.stats = stats
        self._lock = threading.Lock()
        self._graphs: LRUCache = LRUCache(capacity)
        self._flight = _SingleFlight(self._lock)

    @property
    def evictions(self) -> int:
        return self._graphs.evictions

    def graph_for(self, module_key: str, module: Module,
                  backend: Backend) -> DependencyGraph:
        key = (module_key, backend.hw.name)
        with self._lock:
            self.stats.graph_requests += 1
            cached = self._graphs.get(key)
            if cached is None:
                fut, owner = self._flight.begin(key)
        if cached is not None:
            # clone OUTSIDE the lock: the pristine copy is never mutated,
            # and cloning a large graph under the lock would serialize
            # every concurrent hit
            return _clone_graph(cached)
        if not owner:
            return _clone_graph(fut.result())
        try:
            with self._lock:
                self.stats.graph_builds += 1
            built = build_dependency_graph(module, backend.hw)
            pristine = _clone_graph(built)   # keep an untouched copy
            with self._lock:
                self._graphs[key] = pristine
        except BaseException as exc:
            self._flight.fail(key, fut, exc)
            raise
        self._flight.finish(key, fut, pristine)
        return built

    def clear(self) -> None:
        with self._lock:
            self._graphs.clear()


ModuleLike = Union[str, Module]


class LeoSession:
    """Cached, thread-safe, multi-backend entry point to LEO's pipeline.

    ::

        session = LeoSession()
        an = session.analyze(hlo_text, backend="tpu_v5e")
        per_vendor = session.compare_backends(hlo_text)   # parses ONCE

    ``parse_cache_size`` / ``graph_cache_size`` / ``analysis_cache_size``
    bound the in-memory tiers (LRU; ``None`` = unbounded, the legacy
    default).  ``disk_cache`` attaches a cross-process on-disk tier for
    parsed modules; :class:`~repro.core.service.LeoService` wires all of
    these with serving-grade defaults.
    """

    def __init__(self, pipeline: Optional[Pipeline] = None,
                 backends: Optional[Sequence[BackendLike]] = None,
                 hints: Optional[dict] = None,
                 default_backend: BackendLike = "tpu_v5e",
                 parse_cache_size: Optional[int] = None,
                 graph_cache_size: Optional[int] = None,
                 analysis_cache_size: Optional[int] = None,
                 disk_cache: Optional[DiskCache] = None):
        self.pipeline = pipeline or DEFAULT_PIPELINE
        # None = live view of the registry (backends registered after the
        # session is constructed still show up in compare_backends).
        self._backends: Optional[List[Backend]] = \
            [resolve_backend(b) for b in backends] \
            if backends is not None else None
        self.hints = hints
        self.default_backend = resolve_backend(default_backend)
        self.stats = SessionStats()
        self.disk_cache = disk_cache
        self._lock = threading.Lock()
        self._modules: LRUCache = LRUCache(
            parse_cache_size, on_evict=self._on_module_evict)
        self._module_keys: Dict[int, str] = {}   # id(Module) -> key
        self._id_seq = 0   # monotonic suffix for identity keys (never reused)
        self._analyses: LRUCache = LRUCache(analysis_cache_size)
        self._cache = _SessionCache(self.stats, graph_cache_size)
        self._parse_flight = _SingleFlight(self._lock)
        self._analyze_flight = _SingleFlight(self._lock)

    def _on_module_evict(self, key: str, module: Module) -> None:
        # drop the id() reverse index so a recycled id cannot alias
        if self._module_keys.get(id(module)) == key:
            del self._module_keys[id(module)]

    @property
    def backends(self) -> List[Backend]:
        return list(self._backends) if self._backends is not None \
            else list_backends()

    @property
    def cache_evictions(self) -> Dict[str, int]:
        return {"parse": self._modules.evictions,
                "graph": self._cache.evictions,
                "analysis": self._analyses.evictions}

    # -- parsing --------------------------------------------------------------

    def module_key(self, hlo_text: str, hints: Optional[dict] = None) -> str:
        h = hashlib.sha256(hlo_text.encode())
        merged = {**(self.hints or {}), **(hints or {})}
        h.update(repr(sorted(merged.items())).encode())
        return h.hexdigest()

    def parse(self, hlo_text: str, hints: Optional[dict] = None) -> Module:
        """Content-hash cached `parse_hlo` (memory -> disk -> parse)."""
        key = self.module_key(hlo_text, hints)
        with self._lock:
            self.stats.parse_calls += 1
            module = self._modules.get(key)
            if module is not None:
                return module
            fut, owner = self._parse_flight.begin(key)
        if not owner:
            return fut.result()
        try:
            module = self.disk_cache.load_module(key) \
                if self.disk_cache is not None else None
            from_disk = module is not None
            if module is None:
                merged = {**(self.hints or {}), **(hints or {})}
                module = parse_hlo(hlo_text, hints=merged or None)
            with self._lock:
                if from_disk:
                    self.stats.parse_disk_hits += 1
                else:
                    self.stats.parse_misses += 1
                self._modules[key] = module
                self._module_keys[id(module)] = key
            if not from_disk and self.disk_cache is not None:
                self.disk_cache.store_module(key, module)
        except BaseException as exc:
            self._parse_flight.fail(key, fut, exc)
            raise
        self._parse_flight.finish(key, fut, module)
        return module

    def _resolve_module(self, program: ModuleLike,
                        hints: Optional[dict]) -> Tuple[Module, str]:
        if isinstance(program, Module):
            # Directly-supplied modules are identity-keyed: the session did
            # not build them and cannot content-hash them cheaply.  The
            # module is retained in the cache so its id() cannot be recycled
            # onto a different Module while the key mapping is live, and the
            # monotonic sequence suffix guarantees a Module whose id IS
            # recycled after LRU eviction still gets a fresh key (its stale
            # analyses can never be hit again).
            with self._lock:
                key = self._module_keys.get(id(program))
                if key is None or self._modules.get(key) is not program:
                    self._id_seq += 1
                    key = f"module-id-{id(program)}-{self._id_seq}"
                    self._module_keys[id(program)] = key
                    self._modules[key] = program
            return program, key
        return self.parse(program, hints), self.module_key(program, hints)

    # -- analysis -------------------------------------------------------------

    def analyze(self, program: ModuleLike, *,
                backend: Optional[BackendLike] = None,
                profile: Optional[StallProfile] = None,
                hints: Optional[dict] = None,
                n_chains: int = 5,
                prune_unexecuted: bool = True) -> LeoAnalysis:
        """Analyze one program (HLO text or pre-parsed Module) on one backend."""
        b = resolve_backend(backend) if backend is not None \
            else self.default_backend
        module, mkey = self._resolve_module(program, hints)
        akey = (mkey, b.name, n_chains, prune_unexecuted)
        with self._lock:
            self.stats.analyze_calls += 1
            if profile is None:
                cached = self._analyses.get(akey)
                if cached is not None:
                    return cached
                fut, owner = self._analyze_flight.begin(akey)
            else:
                fut, owner = None, True   # measured profiles are never cached
        if not owner:
            return fut.result()
        try:
            with self._lock:
                self.stats.analyze_misses += 1
            analysis = self._run_pipeline(module, b, mkey, profile=profile,
                                          n_chains=n_chains,
                                          prune_unexecuted=prune_unexecuted)
            if profile is None:
                with self._lock:
                    self._analyses[akey] = analysis
        except BaseException as exc:
            if fut is not None:
                self._analyze_flight.fail(akey, fut, exc)
            raise
        if fut is not None:
            self._analyze_flight.finish(akey, fut, analysis)
        return analysis

    def _run_pipeline(self, module: Module, backend: Backend, mkey: str,
                      profile: Optional[StallProfile],
                      **options: Any) -> LeoAnalysis:
        import time as _time
        t0 = _time.perf_counter()
        ctx = self.pipeline.run(module, backend, profile=profile,
                                cache=self._cache, module_key=mkey,
                                **options)
        return ctx.to_analysis(analysis_seconds=_time.perf_counter() - t0)

    def analyze_batch(self, programs: Iterable[ModuleLike], *,
                      backend: Optional[BackendLike] = None,
                      **kwargs: Any) -> List[LeoAnalysis]:
        """Fan a set of programs through the cache (e.g. one per pipeline
        stage of a multi-kernel workload).  Serial here; ``LeoService``
        overlays a thread pool."""
        return [self.analyze(p, backend=backend, **kwargs) for p in programs]

    def compare_backends(self, program: ModuleLike, *,
                         backends: Optional[Sequence[BackendLike]] = None,
                         hints: Optional[dict] = None,
                         **kwargs: Any) -> Dict[str, LeoAnalysis]:
        """Observation-1 driver: same program, every backend, parsed once."""
        targets = [resolve_backend(b) for b in backends] \
            if backends is not None else self.backends
        return {b.name: self.analyze(program, backend=b, hints=hints,
                                     **kwargs)
                for b in targets}

    # -- maintenance ----------------------------------------------------------

    def clear_cache(self) -> None:
        with self._lock:
            self._modules.clear()
            self._module_keys.clear()
            self._analyses.clear()
        self._cache.clear()

    def __repr__(self) -> str:
        s = self.stats
        return (f"LeoSession(backends={[b.name for b in self.backends]}, "
                f"modules={len(self._modules)}, analyses={len(self._analyses)}, "
                f"parse {s.parse_hits}/{s.parse_calls} hit)")
