"""`LeoService`: the serving-grade analysis API.

Where :class:`~repro.core.session.LeoSession` is an in-process cache,
``LeoService`` is the production surface a profiler-adjacent analyzer
needs to serve heavy traffic:

  * **typed requests** — :class:`AnalyzeRequest` is a versioned,
    JSON-round-trippable request schema (what a queue or RPC layer
    carries), and every answer is a serializable
    :class:`~repro.core.report.Diagnosis`;
  * **bounded caches** — the session tiers run with LRU capacities by
    default, plus a diagnosis LRU in front of the pipeline;
  * **on-disk persistence** — pass ``cache_dir=`` and parsed modules +
    diagnoses are content-addressed onto disk (sha256 -> gzip), so a
    second process re-running the same trace performs zero HLO parses;
  * **concurrent fan-out** — ``analyze_batch`` / ``compare_backends`` /
    ``diagnose_batch`` run over a shared thread pool; the session's
    single-flight caches keep the parse-once invariant under concurrency
    (stats-asserted in ``tests/test_service.py``).

::

    svc = LeoService(cache_dir="experiments/.leo_cache")
    diag = svc.diagnose(hlo_text, backend="tpu_v5e")     # Diagnosis
    per_vendor = svc.compare_backends(hlo_text)          # concurrent
    svc.submit(AnalyzeRequest(hlo_text=hlo, backend="amd_mi300a"))
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from .backends import BackendLike, resolve_backend
from .caching import DiskCache, LRUCache
from .isa import Module
from .passes import LeoAnalysis, Pipeline
from .report import SCHEMA_VERSION, Diagnosis
from .session import LeoSession, ModuleLike, SessionStats

#: Bump when analysis *semantics* change without a schema change (pass
#: internals, blame weighting, recommendation rules): part of the disk
#: diagnosis key, so old cache_dir artifacts read as misses, never as
#: stale answers.  Backend constant changes are fingerprinted
#: automatically (see `LeoService._diagnosis_key`).
#: v2: the sampler now drives a SyncModel scoreboard (finite §III-E sync
#: resources serialize), changing stall profiles for oversubscribed
#: programs.
#: v3: multi-stream issue model — the sampler interleaves instructions
#: across the backend's issue queues (per-queue sync scoreboards,
#: NOT_SELECTED/PIPE_BUSY contention), changing stall profiles and
#: makespans for every multi-queue backend.
#: v4: the optional advisor (what-if replay) rides the diagnosis; the
#: `advise` knob joins the key list so advice-carrying artifacts never
#: answer advice-free requests (or vice versa).
#: v5: the optional rewrite loop (equivalence-checked HLO rewrites with
#: realized speedups) rides the diagnosis; the `rewrite` knob joins the
#: key list under the same never-alias rule as `advise`.  The `occupancy`
#: knob (schema v6) deliberately did NOT bump this: it appends to the key
#: only when engaged (see `DiagnoseOptions.key_suffix`), so every
#: pre-existing knob combination keeps its byte-identical key and a warm
#: cache_dir survives the upgrade.
DIAGNOSIS_KEY_VERSION = 5


#: (caller, kwarg-names) pairs already warned about — legacy boolean
#: kwargs warn once per call site shape, not once per request.
_LEGACY_KWARG_WARNED: set = set()


def _warn_legacy_kwargs(caller: str, given: Dict[str, Any]) -> None:
    key = (caller, tuple(sorted(given)))
    if key in _LEGACY_KWARG_WARNED:
        return
    _LEGACY_KWARG_WARNED.add(key)
    args = ", ".join(f"{k}={v!r}" for k, v in sorted(given.items()))
    warnings.warn(
        f"{caller}: keyword(s) {', '.join(sorted(given))} are deprecated; "
        f"pass options=DiagnoseOptions({args}) instead "
        f"(the keywords are removed two minor releases after v6)",
        DeprecationWarning, stacklevel=4)


@dataclass(frozen=True)
class DiagnoseOptions:
    """The typed request surface: every analysis knob in one frozen,
    hashable value — the single source of truth for both the diagnosis
    cache key (:meth:`key_fields` / :meth:`key_suffix`) and the wire
    fields (:meth:`wire_fields`), so the service, the HTTP client, and
    the queue protocol can never drift apart one boolean at a time.

    ``occupancy=True`` engages the backend's native wave-residency model
    (:meth:`Backend.with_occupancy`): stalls that co-resident waves
    would cover are hidden, the remainder reclassifies as
    ``OCCUPANCY_LIMITED``, and the Diagnosis gains its schema-v6
    ``occupancy`` section.  Single-wave parts (TPUs) analyze
    identically with the knob on — there is no residency to raise."""

    n_chains: int = 5
    prune_unexecuted: bool = True
    advise: bool = False
    rewrite: bool = False
    occupancy: bool = False

    def validate(self) -> None:
        if self.n_chains < 1:
            raise ValueError("n_chains must be >= 1")

    def key_fields(self) -> List[Any]:
        """The cache-key components every generation has carried, in
        their historical order — byte-identity with pre-v6 keys."""
        return [self.n_chains, self.prune_unexecuted, self.advise,
                self.rewrite]

    def key_suffix(self) -> List[Any]:
        """Appended after the version/pipeline tail, and ONLY when
        non-default: a default-occupancy request hashes exactly like a
        pre-v6 one, so warm disk caches keep answering."""
        return ["occupancy"] if self.occupancy else []

    def wire_fields(self) -> Dict[str, Any]:
        """The flat request-dict fields (an ``occupancy``-unaware peer's
        ``from_dict`` ignores the new key)."""
        return {
            "n_chains": self.n_chains,
            "prune_unexecuted": self.prune_unexecuted,
            "advise": self.advise,
            "rewrite": self.rewrite,
            "occupancy": self.occupancy,
        }

    @classmethod
    def from_wire(cls, data: Dict[str, Any]) -> "DiagnoseOptions":
        return cls(
            n_chains=data.get("n_chains", 5),
            prune_unexecuted=data.get("prune_unexecuted", True),
            advise=data.get("advise", False),
            rewrite=data.get("rewrite", False),
            occupancy=data.get("occupancy", False),
        )

    @classmethod
    def coalesce(cls, options: Optional["DiagnoseOptions"], caller: str,
                 **legacy: Any) -> "DiagnoseOptions":
        """Resolve an ``options=`` argument against the deprecated
        boolean kwargs: explicit options win (mixing raises), legacy
        kwargs warn once per call-site shape and build an equivalent
        options value, neither yields the defaults."""
        given = {k: v for k, v in legacy.items() if v is not None}
        if options is not None:
            if given:
                raise TypeError(
                    f"{caller}: pass options=DiagnoseOptions(...) or the "
                    f"deprecated keyword(s) {sorted(given)}, not both")
            return options
        if not given:
            return cls()
        _warn_legacy_kwargs(caller, given)
        return cls(**given)


@dataclass(init=False)
class AnalyzeRequest:
    """One unit of service work: a program plus analysis knobs.

    ``backend=None`` targets the service default; set ``backends`` to fan
    the same program across several vendor models in one request (the
    Observation-1 shape).  The analysis knobs live in one typed
    :class:`DiagnoseOptions` value (``options=``); the old flat boolean
    kwargs still construct (warn-once shims) and the wire layout keeps
    the flat fields, so queued requests and older peers interoperate.
    The schema is versioned and JSON-round-trips, so requests can ride a
    queue between processes.
    """

    hlo_text: str = ""
    backend: Optional[str] = None
    backends: Optional[List[str]] = None
    hints: Optional[Dict[str, Any]] = None
    options: DiagnoseOptions = field(default_factory=DiagnoseOptions)
    request_id: Optional[str] = None
    schema_version: int = SCHEMA_VERSION

    def __init__(self, hlo_text: str = "",
                 backend: Optional[str] = None,
                 backends: Optional[List[str]] = None,
                 hints: Optional[Dict[str, Any]] = None,
                 options: Optional[DiagnoseOptions] = None,
                 request_id: Optional[str] = None,
                 schema_version: int = SCHEMA_VERSION, *,
                 n_chains: Optional[int] = None,
                 prune_unexecuted: Optional[bool] = None,
                 advise: Optional[bool] = None,
                 rewrite: Optional[bool] = None,
                 occupancy: Optional[bool] = None):
        self.hlo_text = hlo_text
        self.backend = backend
        self.backends = backends
        self.hints = hints
        self.options = DiagnoseOptions.coalesce(
            options, "AnalyzeRequest", n_chains=n_chains,
            prune_unexecuted=prune_unexecuted, advise=advise,
            rewrite=rewrite, occupancy=occupancy)
        self.request_id = request_id
        self.schema_version = schema_version

    # legacy read accessors: the knobs' single home is .options
    @property
    def n_chains(self) -> int:
        return self.options.n_chains

    @property
    def prune_unexecuted(self) -> bool:
        return self.options.prune_unexecuted

    @property
    def advise(self) -> bool:
        return self.options.advise

    @property
    def rewrite(self) -> bool:
        return self.options.rewrite

    @property
    def occupancy(self) -> bool:
        return self.options.occupancy

    def validate(self) -> None:
        if not self.hlo_text:
            raise ValueError("AnalyzeRequest.hlo_text must be non-empty")
        if self.backend is not None and self.backends is not None:
            raise ValueError(
                "set AnalyzeRequest.backend or .backends, not both")
        if self.schema_version != SCHEMA_VERSION:
            raise ValueError(
                f"AnalyzeRequest schema_version {self.schema_version} != "
                f"{SCHEMA_VERSION}")
        self.options.validate()

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "schema_version": self.schema_version,
            "hlo_text": self.hlo_text,
            "backend": self.backend,
            "backends": self.backends,
            "hints": self.hints,
        }
        out.update(self.options.wire_fields())
        out["request_id"] = self.request_id
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "AnalyzeRequest":
        return cls(
            hlo_text=data.get("hlo_text", ""),
            backend=data.get("backend"),
            backends=data.get("backends"),
            hints=data.get("hints"),
            options=DiagnoseOptions.from_wire(data),
            request_id=data.get("request_id"),
            schema_version=data.get("schema_version", 0),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=False)

    @classmethod
    def from_json(cls, payload: str) -> "AnalyzeRequest":
        return cls.from_dict(json.loads(payload))


class LeoService:
    """Bounded-cache, disk-persistent, concurrent analysis service.

    The service owns a :class:`LeoSession` (exposed as ``.session`` for
    callers that need raw ``LeoAnalysis`` artifacts) and adds the typed
    request/diagnosis surface on top.  Default cache capacities are
    serving-grade bounds rather than the session's legacy ``None``
    (unbounded).
    """

    def __init__(self, pipeline: Optional[Pipeline] = None,
                 backends: Optional[Sequence[BackendLike]] = None,
                 hints: Optional[dict] = None,
                 default_backend: BackendLike = "tpu_v5e",
                 parse_cache_size: Optional[int] = 64,
                 graph_cache_size: Optional[int] = 256,
                 analysis_cache_size: Optional[int] = 512,
                 diagnosis_cache_size: Optional[int] = 512,
                 cache_dir: Optional[str] = None,
                 disk_cache_max_bytes: Optional[int] = None,
                 disk_cache_ttl_seconds: Optional[float] = None,
                 max_workers: int = 8,
                 metrics: Optional[Any] = None):
        # disk_cache_max_bytes / _ttl_seconds bound the on-disk tier (size
        # cap enforced oldest-accessed-first, idle TTL); None keeps the
        # legacy unbounded behavior.
        self.disk_cache = DiskCache(
            cache_dir, max_bytes=disk_cache_max_bytes,
            ttl_seconds=disk_cache_ttl_seconds) if cache_dir else None
        self.session = LeoSession(
            pipeline=pipeline, backends=backends, hints=hints,
            default_backend=default_backend,
            parse_cache_size=parse_cache_size,
            graph_cache_size=graph_cache_size,
            analysis_cache_size=analysis_cache_size,
            disk_cache=self.disk_cache)
        self.max_workers = max_workers
        self._diagnoses: LRUCache = LRUCache(diagnosis_cache_size)
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self.diagnosis_hits = 0
        self.diagnosis_misses = 0
        # optional repro.serve.metrics.MetricsRegistry (typed Any: the
        # core layer must not import the serving layer).  None keeps the
        # hot path allocation- and branch-cheap.
        self.metrics = metrics
        self._m_diagnoses = self._m_cache = None
        self._m_parse = self._m_pipeline = self._m_advisor = None
        self._m_rewrite = None
        if metrics is not None:
            self._m_diagnoses = metrics.counter(
                "leo_diagnoses_total",
                "Diagnoses served (cache hits included), per backend.",
                labelnames=("backend",))
            self._m_cache = metrics.counter(
                "leo_cache_requests_total",
                "Diagnosis cache lookups per tier and outcome.",
                labelnames=("tier", "result"))
            self._m_parse = metrics.histogram(
                "leo_parse_seconds",
                "HLO parse latency (session cache hits land sub-ms).")
            self._m_pipeline = metrics.histogram(
                "leo_pipeline_seconds",
                "Full analysis pipeline latency on diagnosis misses.")
            self._m_advisor = metrics.histogram(
                "leo_advisor_seconds",
                "What-if advisor latency on advise=True diagnosis misses.")
            self._m_rewrite = metrics.histogram(
                "leo_rewrite_seconds",
                "Rewrite-loop latency on rewrite=True diagnosis misses.")
            g = metrics.gauge(
                "leo_session_cache_hits",
                "Session single-flight cache hit counters, per op.",
                labelnames=("op",))
            g.set_function(lambda: float(self.session.stats.parse_hits),
                           op="parse")
            g.set_function(lambda: float(self.session.stats.analyze_hits),
                           op="analyze")
            if self.disk_cache is not None:
                db = metrics.gauge(
                    "leo_disk_cache_bytes",
                    "Bytes currently held by the on-disk cache tier.")
                db.set_function(
                    lambda: float(self.disk_cache.total_bytes()))

    # -- plumbing --------------------------------------------------------------

    @property
    def stats(self) -> SessionStats:
        return self.session.stats

    def stats_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.session.stats.as_dict())
        out["pid"] = os.getpid()    # which pool worker answered /stats
        out["cache_evictions"] = self.session.cache_evictions
        out["diagnosis_hits"] = self.diagnosis_hits
        out["diagnosis_misses"] = self.diagnosis_misses
        if self.disk_cache is not None:
            out["disk"] = self.disk_cache.stats.as_dict()
        return out

    def _executor(self) -> Optional[ThreadPoolExecutor]:
        """The shared pool — or None when already on a pool worker (a
        nested fan-out must run inline, otherwise bounded workers waiting
        on tasks that cannot be scheduled deadlock the pool)."""
        if threading.current_thread().name.startswith("leo-service"):
            return None
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.max_workers,
                    thread_name_prefix="leo-service")
            return self._pool

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def flush(self) -> Dict[str, int]:
        """Flush the on-disk tier (final blocking sweep) — called by the
        serving front-end on graceful drain.  No-op without a
        ``cache_dir``."""
        if self.disk_cache is not None:
            return self.disk_cache.flush()
        return {"evicted": 0, "bytes_freed": 0}

    def __enter__(self) -> "LeoService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _fan_out(self, call, items: Sequence[Any]) -> List[Any]:
        """Run ``call(item)`` per item — on the pool when one is available
        (never nested inside a pool worker), serially otherwise.  Results
        come back in item order; the first failure propagates."""
        items = list(items)
        pool = self._executor() if len(items) > 1 else None
        if pool is None:
            return [call(it) for it in items]
        futs = [pool.submit(call, it) for it in items]
        return [f.result() for f in futs]

    # -- raw-analysis surface (LeoAnalysis out) --------------------------------

    def parse(self, hlo_text: str, hints: Optional[dict] = None) -> Module:
        if self._m_parse is None:
            return self.session.parse(hlo_text, hints=hints)
        t0 = time.monotonic()
        module = self.session.parse(hlo_text, hints=hints)
        self._m_parse.observe(time.monotonic() - t0)
        return module

    def analyze(self, program: ModuleLike, **kwargs: Any) -> LeoAnalysis:
        return self.session.analyze(program, **kwargs)

    def analyze_batch(self, programs: Iterable[ModuleLike], *,
                      backend: Optional[BackendLike] = None,
                      **kwargs: Any) -> List[LeoAnalysis]:
        """Concurrent fan-out: each program analyzed on the thread pool.

        The session's single-flight caches make duplicate programs in the
        batch collapse to one parse / one pipeline run."""
        return self._fan_out(
            lambda p: self.session.analyze(p, backend=backend, **kwargs),
            programs)

    def compare_backends(self, program: ModuleLike, *,
                         backends: Optional[Sequence[BackendLike]] = None,
                         hints: Optional[dict] = None,
                         **kwargs: Any) -> Dict[str, LeoAnalysis]:
        """Observation-1 fan-out, concurrently: same program, every
        backend, one parse (single-flighted under the pool)."""
        targets = [resolve_backend(b) for b in backends] \
            if backends is not None else self.session.backends
        results = self._fan_out(
            lambda b: self.session.analyze(program, backend=b, hints=hints,
                                           **kwargs), targets)
        return {b.name: r for b, r in zip(targets, results)}

    # -- diagnosis surface (serializable Diagnosis out) ------------------------

    def _diagnosis_key(self, program: ModuleLike, backend: Any,
                       hints: Optional[dict],
                       options: DiagnoseOptions) -> Optional[str]:
        """Content key for a diagnosis; None for identity-keyed Modules
        (not content-hashable, so never disk-cached).

        The key fingerprints the *backend descriptor contents* (hardware
        constants, taxonomy, sync knobs) rather than just its name, so
        recalibrating e.g. ``nvidia_gh200``'s HBM bandwidth invalidates
        every diagnosis cached under the old constants instead of
        silently serving stale estimates from a warm ``cache_dir``.
        ``DIAGNOSIS_KEY_VERSION`` covers analysis-code changes that keys
        cannot see (pass internals, recommendation rules): bump it when
        their semantics change.  The Diagnosis SCHEMA_VERSION is
        deliberately NOT part of the key: schema-only bumps keep hitting
        the old artifacts, which ``Diagnosis.from_dict`` migrates forward
        (a warm cache survives a schema bump).  ``options`` supplies its
        own components (:meth:`DiagnoseOptions.key_fields` in the
        historical positions, :meth:`~DiagnoseOptions.key_suffix` only
        when non-default), so every pre-v6 knob combination hashes
        byte-identically to what it always did."""
        if isinstance(program, Module):
            return None
        mkey = self.session.module_key(program, hints)
        backend_fp = repr((backend.name, backend.vendor, backend.hw,
                           sorted((k.value, v) for k, v
                                  in backend.stall_taxonomy.items()),
                           backend.sync))
        h = hashlib.sha256()
        h.update(json.dumps([
            mkey, backend_fp, *options.key_fields(),
            DIAGNOSIS_KEY_VERSION,
            self.session.pipeline.names,
            *options.key_suffix(),
        ]).encode())
        return h.hexdigest()

    def diagnose(self, program: ModuleLike, *,
                 backend: Optional[BackendLike] = None,
                 hints: Optional[dict] = None,
                 options: Optional[DiagnoseOptions] = None,
                 n_chains: Optional[int] = None,
                 prune_unexecuted: Optional[bool] = None,
                 advise: Optional[bool] = None,
                 rewrite: Optional[bool] = None,
                 occupancy: Optional[bool] = None) -> Diagnosis:
        """Analyze and return the serializable :class:`Diagnosis`,
        consulting the memory and disk diagnosis tiers first — a warm
        disk tier answers without parsing or running the pipeline.
        Analysis knobs ride one typed ``options=DiagnoseOptions(...)``
        value; the flat keyword forms still work as warn-once
        deprecation shims.

        ``options.advise`` additionally runs the what-if advisor
        (:mod:`repro.advisor`) on cache misses and lands ranked,
        speedup-priced advice in the Diagnosis ``advice`` section
        (schema v4); advice-carrying artifacts are cached under their
        own key, so toggling the knob never serves a stale shape.

        ``options.rewrite`` closes the loop (:mod:`repro.rewrite`): the
        top advice is lowered to equivalence-checked HLO rewrites, each
        rewritten text is re-analyzed through this same session, and the
        ``rewrites`` section (schema v5) lands predicted-vs-realized
        speedups.  The advisor runs internally either way, but the
        ``advice`` section is only recorded when ``advise`` is set — the
        two knobs key the caches independently.

        ``options.occupancy`` engages the backend's native wave-residency
        model (``backend.with_occupancy()``) before analysis: the
        Diagnosis gains the schema-v6 ``occupancy`` section, and the
        derived ``@wN-...`` backend name keys the session caches so an
        occupancy analysis can never alias a plain one.  Single-wave
        parts analyze unchanged (they have no residency to raise)."""
        opts = DiagnoseOptions.coalesce(
            options, "LeoService.diagnose", n_chains=n_chains,
            prune_unexecuted=prune_unexecuted, advise=advise,
            rewrite=rewrite, occupancy=occupancy)
        opts.validate()
        b = resolve_backend(backend) if backend is not None \
            else self.session.default_backend
        if opts.occupancy and b.native_occupancy.multi_wave \
                and not b.occupancy.multi_wave:
            b = b.with_occupancy()
        dkey = self._diagnosis_key(program, b, hints, opts)
        # cached entries are returned as copies: a caller mutating its
        # Diagnosis (e.g. inserting a pipeline-level recommendation, as
        # benchmarks/harness.py does) must not poison the shared cache
        if dkey is not None:
            with self._lock:
                cached = self._diagnoses.get(dkey)
                if cached is not None:
                    self.diagnosis_hits += 1
            if self._m_cache is not None:
                self._m_cache.inc(tier="diagnosis_memory",
                                  result="hit" if cached is not None
                                  else "miss")
            if cached is not None:
                if self._m_diagnoses is not None:
                    self._m_diagnoses.inc(backend=b.name)
                return cached.copy()
            if self.disk_cache is not None:
                diag = self.disk_cache.load_diagnosis(dkey)
                if self._m_cache is not None:
                    self._m_cache.inc(tier="diagnosis_disk",
                                      result="hit" if diag is not None
                                      else "miss")
                if diag is not None:
                    with self._lock:
                        self.diagnosis_hits += 1
                        self._diagnoses[dkey] = diag
                    if self._m_diagnoses is not None:
                        self._m_diagnoses.inc(backend=b.name)
                    return diag.copy()
        with self._lock:
            self.diagnosis_misses += 1
        if self._m_parse is not None and isinstance(program, str):
            # warm the session parse tier through the timed parse() so
            # the parse histogram sees serving-path data; analyze() below
            # still keys its caches by content, not Module identity
            self.parse(program, hints=hints)
        t0 = time.monotonic()
        analysis = self.session.analyze(
            program, backend=b, hints=hints, n_chains=opts.n_chains,
            prune_unexecuted=opts.prune_unexecuted)
        if self._m_pipeline is not None:
            self._m_pipeline.observe(time.monotonic() - t0)
        diag = Diagnosis.from_analysis(analysis, max_chains=opts.n_chains)
        rep = None
        if opts.advise or opts.rewrite:
            # lazy: repro.advisor imports core, so core must not import
            # it at module scope (and advice-free serving never pays it)
            from ..advisor import Advisor, advice_section
            t1 = time.monotonic()
            rep = Advisor().report(
                analysis.module, b,
                profile=analysis.profile, blame=analysis.blame)
            if self._m_advisor is not None:
                self._m_advisor.observe(time.monotonic() - t1)
            if opts.advise:
                diag.advice = advice_section(rep.advice, rep)
        if opts.rewrite:
            # same lazy-import rule as the advisor; verification samples
            # the module re-parsed from each rewritten text directly
            # (identical makespan to a full session.analyze by the
            # round-trip guarantee, without paying a cold pipeline per
            # rewrite — the bench rewrite-overhead gate holds it < 4x)
            from ..rewrite import RewriteLoop, rewrites_section
            t2 = time.monotonic()
            rw = RewriteLoop().run(
                analysis.module, b, hints=hints,
                profile=analysis.profile, blame=analysis.blame,
                advisor_report=rep)
            if self._m_rewrite is not None:
                self._m_rewrite.observe(time.monotonic() - t2)
            diag.rewrites = rewrites_section(rw)
        if dkey is not None:
            with self._lock:
                self._diagnoses[dkey] = diag.copy()
            if self.disk_cache is not None:
                self.disk_cache.store_diagnosis(dkey, diag)
        if self._m_diagnoses is not None:
            self._m_diagnoses.inc(backend=b.name)
        return diag

    def submit(self, request: AnalyzeRequest
               ) -> Union[Diagnosis, Dict[str, Diagnosis]]:
        """Serve one typed request.  Returns a single ``Diagnosis``, or a
        ``{backend: Diagnosis}`` map when the request names ``backends``."""
        request.validate()
        if request.backends is not None:
            return self.diagnose_fanout(
                request.hlo_text, backends=request.backends,
                hints=request.hints, options=request.options)
        return self.diagnose(
            request.hlo_text, backend=request.backend, hints=request.hints,
            options=request.options)

    def submit_async(self, request: AnalyzeRequest) -> Future:
        """`submit` as a Future — the non-blocking shape a queue-driven
        front-end (e.g. ``repro.launch.analysis_server``) consumes.  Runs
        on the shared pool; degrades to an already-resolved Future when
        called from a pool worker (same no-nesting rule as `_fan_out`)."""
        request.validate()
        pool = self._executor()
        if pool is not None:
            return pool.submit(self.submit, request)
        fut: Future = Future()
        try:
            fut.set_result(self.submit(request))
        except Exception as e:  # noqa: BLE001 - future carries the failure
            fut.set_exception(e)
        return fut

    def diagnose_batch(self, requests: Sequence[AnalyzeRequest]
                       ) -> List[Union[Diagnosis, Dict[str, Diagnosis]]]:
        """Concurrent typed-request batch (order-preserving)."""
        requests = list(requests)
        for r in requests:
            r.validate()
        return self._fan_out(self.submit, requests)

    def diagnose_fanout(self, program: ModuleLike, *,
                        backends: Optional[Sequence[BackendLike]] = None,
                        hints: Optional[dict] = None,
                        options: Optional[DiagnoseOptions] = None,
                        n_chains: Optional[int] = None,
                        prune_unexecuted: Optional[bool] = None,
                        advise: Optional[bool] = None,
                        rewrite: Optional[bool] = None,
                        occupancy: Optional[bool] = None
                        ) -> Dict[str, Diagnosis]:
        """``compare_backends`` with serializable results."""
        opts = DiagnoseOptions.coalesce(
            options, "LeoService.diagnose_fanout", n_chains=n_chains,
            prune_unexecuted=prune_unexecuted, advise=advise,
            rewrite=rewrite, occupancy=occupancy)
        targets = [resolve_backend(b) for b in backends] \
            if backends is not None else self.session.backends
        results = self._fan_out(
            lambda b: self.diagnose(program, backend=b, hints=hints,
                                    options=opts), targets)
        return {b.name: r for b, r in zip(targets, results)}

    def __repr__(self) -> str:
        disk = self.disk_cache.root if self.disk_cache is not None else None
        return (f"LeoService(session={self.session!r}, disk={disk!r}, "
                f"workers={self.max_workers})")
