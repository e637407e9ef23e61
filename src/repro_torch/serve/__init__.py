"""repro_torch.serve — networked diagnosis serving.

The stdlib-only network layer over the analysis stack:

  * :mod:`repro_torch.serve.protocol` — versioned JSON wire format with
    Diagnosis schema negotiation (v1–v3 migration across the wire);
  * :mod:`repro_torch.serve.httpd` — backpressure-aware HTTP front-end
    (bounded admission, 429 + Retry-After shedding, per-request
    deadlines, graceful SIGTERM drain);
  * :mod:`repro_torch.serve.client` — retrying ``LeoClient`` with capped
    jittered backoff, a pipelined ``diagnose_batch``, and client-side
    load balancing across replicas (``endpoints=[...]``:
    power-of-two-choices over an EWMA of observed queue wait, ejection
    with half-open probing);
  * :mod:`repro_torch.serve.metrics` — counter/gauge/histogram registry with
    a Prometheus-text ``/metrics`` renderer and cross-worker
    aggregation (:func:`~repro_torch.serve.metrics.aggregate_dumps`);
  * :mod:`repro_torch.serve.pool` — pre-forked multi-process serving
    (``LeoWorkerPool``: bind once, fork N workers, supervise/respawn,
    rolling SIGTERM drain, aggregated control endpoints).

``repro_torch.serve`` imports torch through ``repro_torch.core`` but runs
on the host and never initialises CUDA (the slot engine under
``repro_torch.launch`` is imported lazily by the front-end at construction
time).
"""
from .client import LeoClient, LeoClientError, RetriesExceeded
from .httpd import LeoHttpd, serve_forever
from .metrics import (
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    aggregate_dumps,
)
from .pool import LeoWorkerPool, serve_pool_forever
from .protocol import (
    ERROR_CODES,
    MIN_PROTOCOL_VERSION,
    PROTOCOL_VERSION,
    ProtocolError,
    WireRequest,
    WireResponse,
    decode_request,
    decode_response,
    downgrade_diagnosis_dict,
    encode_error,
    encode_request,
    encode_result,
    negotiate_schema,
)

__all__ = [
    "LeoClient",
    "LeoClientError",
    "RetriesExceeded",
    "LeoHttpd",
    "serve_forever",
    "LeoWorkerPool",
    "serve_pool_forever",
    "LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "aggregate_dumps",
    "ERROR_CODES",
    "MIN_PROTOCOL_VERSION",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "WireRequest",
    "WireResponse",
    "decode_request",
    "decode_response",
    "downgrade_diagnosis_dict",
    "encode_error",
    "encode_request",
    "encode_result",
    "negotiate_schema",
]
