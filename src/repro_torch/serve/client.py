"""`LeoClient`: the retrying, pipelining HTTP client for `repro_torch.serve`.

The consumer half of the wire protocol: typed
:class:`~repro_torch.core.service.AnalyzeRequest` in, migrated
:class:`~repro_torch.core.report.Diagnosis` out, with the transport behavior a
production caller needs and the core schema deliberately does not carry:

  * **timeouts** — one socket timeout for connect/read; per-request
    ``deadline_seconds`` rides the wire envelope so the *server* also
    stops working on an abandoned request;
  * **retries** — capped exponential backoff with equal jitter on 429 /
    503 / 5xx / connection errors, honoring the server's ``Retry-After``
    hint when it is larger than the computed backoff.  4xx protocol and
    validation errors never retry (they will not get better);
  * **pipelining** — ``diagnose_batch`` fans a request list over a small
    pool of persistent keep-alive connections (order-preserving);
  * **load balancing** — ``endpoints=["host:port", ...]`` spreads
    requests across replicas: each attempt picks by power-of-two-choices
    over an EWMA of the ``queue_seconds`` each endpoint reported in its
    wire ``timing``, a connection failure ejects the endpoint for a
    (doubling) cool-off, and an expired ejection admits exactly one
    half-open probe before the endpoint rejoins the rotation.  Retries
    re-pick, so a dead replica's traffic flows to the survivors;
  * **schema negotiation** — the client advertises ``accept_schema``
    (its own generation by default); older-generation responses are
    migrated forward by ``Diagnosis.from_dict`` exactly like a warm
    disk cache surviving a schema bump.

::

    with LeoClient(port=8321) as client:
        diag = client.diagnose(hlo_text, backend="tpu_v5e")
        per_vendor = client.diagnose(hlo_text, backends=["tpu_v5e",
                                                         "amd_mi300a"])
        diags = client.diagnose_batch(requests)     # pipelined

    with LeoClient(endpoints=["10.0.0.1:8321", "10.0.0.2:8321"]) as c:
        diags = c.diagnose_batch(requests)  # balanced across replicas
"""
from __future__ import annotations

import http.client
import random
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..core.report import SCHEMA_VERSION, Diagnosis
from ..core.service import AnalyzeRequest, DiagnoseOptions
from .protocol import (
    ProtocolError,
    WireResponse,
    decode_response,
    encode_request,
)

#: HTTP statuses worth retrying: shed (429), draining (503), transient
#: server trouble (other 5xx).
RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})

#: Exception classes that mean "this connection (or endpoint) is bad".
_CONN_ERRORS = (ConnectionError, socket.timeout, socket.gaierror,
                http.client.HTTPException, OSError)


class LeoClientError(Exception):
    """Terminal client-side failure (non-retryable status, or retry
    budget exhausted).  ``status``/``code`` carry the last server
    answer when there was one."""

    def __init__(self, message: str, status: Optional[int] = None,
                 code: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.code = code


class RetriesExceeded(LeoClientError):
    """Every attempt failed retryably; ``attempts`` made, ``last`` holds
    the final error."""

    def __init__(self, attempts: int, last: Exception):
        status = getattr(last, "status", None)
        code = getattr(last, "code", None)
        super().__init__(
            f"request failed after {attempts} attempt(s); last error: "
            f"{type(last).__name__}: {last}", status=status, code=code)
        self.attempts = attempts
        self.last = last


class _Endpoint:
    """Per-replica balancer state.  ``ewma_queue_seconds`` tracks the
    server-reported queue wait (None until first observation — an
    untried endpoint looks maximally attractive); ``ejected_until`` > now
    takes it out of rotation; an expired ejection admits one half-open
    probe (``probing``) before full reinstatement."""

    __slots__ = ("host", "port", "ewma_queue_seconds", "failures",
                 "ejected_until", "probing")

    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port
        self.ewma_queue_seconds: Optional[float] = None
        self.failures = 0
        self.ejected_until = 0.0
        self.probing = False

    def __repr__(self) -> str:
        return (f"_Endpoint({self.host}:{self.port}, "
                f"ewma={self.ewma_queue_seconds}, "
                f"failures={self.failures})")


def _parse_endpoint(spec: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    if isinstance(spec, str):
        host, _, port = spec.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"endpoint {spec!r} is not 'host:port'")
        return host, int(port)
    host, port = spec
    return str(host), int(port)


class LeoClient:
    """HTTP client for one ``repro_torch.serve`` front-end or a replica fleet.

    ``max_retries`` counts *re*-tries (0 = single attempt).  Backoff for
    attempt ``k`` is equal-jittered ``min(cap, base * 2**k)`` — half
    deterministic, half uniform-random — then raised to the server's
    ``Retry-After`` hint if that is larger.  Pass ``rng`` (any
    ``random.Random``) to make backoff and endpoint sampling
    deterministic in tests.

    ``endpoints`` (list of ``"host:port"`` strings or ``(host, port)``
    pairs) enables client-side load balancing; ``host``/``port`` remain
    the single-endpoint shorthand.  ``ewma_alpha`` weights the newest
    ``queue_seconds`` observation; ``eject_seconds`` is the base
    ejection cool-off after a connection failure (doubles per
    consecutive failure, capped at 8x).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8321, *,
                 endpoints: Optional[Sequence[Union[str, Tuple[str, int]]]]
                 = None,
                 timeout: float = 60.0,
                 max_retries: int = 5,
                 backoff_base_seconds: float = 0.05,
                 backoff_cap_seconds: float = 2.0,
                 accept_schema: int = SCHEMA_VERSION,
                 rng: Optional[random.Random] = None,
                 ewma_alpha: float = 0.3,
                 eject_seconds: float = 0.5):
        if endpoints:
            pairs = [_parse_endpoint(e) for e in endpoints]
        else:
            pairs = [(host, port)]
        self.endpoints: List[_Endpoint] = [_Endpoint(h, p)
                                           for h, p in pairs]
        self.host, self.port = pairs[0]     # primary, for repr/back-compat
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_base_seconds = backoff_base_seconds
        self.backoff_cap_seconds = backoff_cap_seconds
        self.accept_schema = accept_schema
        self.ewma_alpha = ewma_alpha
        self.eject_seconds = eject_seconds
        self._rng = rng or random.Random()
        self._rng_lock = threading.Lock()
        self._lb_lock = threading.Lock()
        self._local = threading.local()     # per-thread per-endpoint conns
        # Registry of every live connection, keyed by id(conn): close()
        # must reach conns owned by *other* (possibly dead) threads —
        # thread-local storage alone cannot enumerate them.
        self._conns: Dict[int, Tuple[threading.Thread,
                                     http.client.HTTPConnection]] = {}
        self._conns_lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "attempts": 0, "retries": 0, "sheds_seen": 0,
            "errors_5xx": 0, "connect_errors": 0, "deadline_hits": 0,
        }
        self._stats_lock = threading.Lock()

    # -- connection plumbing ---------------------------------------------------

    def _conn(self, idx: int) -> http.client.HTTPConnection:
        conns: Optional[Dict[int, http.client.HTTPConnection]] = \
            getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        conn = conns.get(idx)
        if conn is None:
            ep = self.endpoints[idx]
            conn = http.client.HTTPConnection(ep.host, ep.port,
                                              timeout=self.timeout)
            conns[idx] = conn
        with self._conns_lock:
            # (re-)register: a close() may have emptied the registry while
            # this thread's cached conn lives on and reconnects
            self._conns.setdefault(id(conn),
                                   (threading.current_thread(), conn))
        return conn

    def _reset_conn(self, idx: int) -> None:
        conns = getattr(self._local, "conns", None)
        if not conns:
            return
        conn = conns.pop(idx, None)
        if conn is not None:
            conn.close()
            with self._conns_lock:
                self._conns.pop(id(conn), None)

    def _prune_dead(self) -> None:
        """Close and drop connections owned by threads that have exited
        (e.g. a finished ``diagnose_batch`` pool) — keep-alive sockets
        must not outlive their worker threads."""
        with self._conns_lock:
            dead = [key for key, (thread, _) in self._conns.items()
                    if not thread.is_alive()]
            closing = [self._conns.pop(key)[1] for key in dead]
        for conn in closing:
            conn.close()

    def open_connection_count(self) -> int:
        """Registered connections with a live socket (diagnostic; the
        socket-leak regression test pins this at 0 after a batch)."""
        self._prune_dead()
        with self._conns_lock:
            return sum(1 for _, conn in self._conns.values()
                       if conn.sock is not None)

    def close(self) -> None:
        """Close every registered connection — including those created
        by other (possibly already-dead) worker threads."""
        with self._conns_lock:
            conns = [conn for _, conn in self._conns.values()]
            self._conns.clear()
        for conn in conns:
            conn.close()
        local_conns = getattr(self._local, "conns", None)
        if local_conns:
            local_conns.clear()

    def __enter__(self) -> "LeoClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _bump(self, field: str, by: int = 1) -> None:
        with self._stats_lock:
            self.stats[field] += by

    # -- endpoint selection ----------------------------------------------------

    def _pick_endpoint(self, now: Optional[float] = None) -> int:
        """Power-of-two-choices over the EWMA of observed queue wait.

        Ejected endpoints are out of rotation until their cool-off
        expires; an expired ejection admits exactly one in-flight
        half-open probe.  With every endpoint dead, the least-recently
        ejected one is tried anyway (better a likely-failing attempt
        that updates state than certain failure)."""
        now = time.monotonic() if now is None else now
        with self._lb_lock:
            healthy: List[int] = []
            half_open: List[int] = []
            for i, ep in enumerate(self.endpoints):
                if ep.ejected_until <= 0.0:
                    healthy.append(i)
                elif ep.ejected_until <= now and not ep.probing:
                    half_open.append(i)
            if half_open:
                # probe first: a recovered replica should rejoin the
                # rotation as soon as its cool-off expires
                idx = half_open[0]
                self.endpoints[idx].probing = True
                return idx
            if not healthy:
                return min(range(len(self.endpoints)),
                           key=lambda i: self.endpoints[i].ejected_until)
            if len(healthy) == 1:
                return healthy[0]
            with self._rng_lock:
                a, b = self._rng.sample(healthy, 2)

            def load(i: int) -> float:
                ewma = self.endpoints[i].ewma_queue_seconds
                return ewma if ewma is not None else -1.0
            return a if load(a) <= load(b) else b

    def _observe_queue(self, idx: int, queue_seconds: float) -> None:
        with self._lb_lock:
            ep = self.endpoints[idx]
            if ep.ewma_queue_seconds is None:
                ep.ewma_queue_seconds = queue_seconds
            else:
                ep.ewma_queue_seconds = (
                    self.ewma_alpha * queue_seconds
                    + (1.0 - self.ewma_alpha) * ep.ewma_queue_seconds)

    def _note_success(self, idx: int) -> None:
        with self._lb_lock:
            ep = self.endpoints[idx]
            ep.failures = 0
            ep.ejected_until = 0.0
            ep.probing = False

    def _note_conn_failure(self, idx: int,
                           now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lb_lock:
            ep = self.endpoints[idx]
            ep.failures += 1
            ep.probing = False
            cooloff = self.eject_seconds * min(2 ** (ep.failures - 1), 8)
            ep.ejected_until = now + cooloff

    def lb_snapshot(self) -> List[Dict[str, Any]]:
        """Balancer state per endpoint (tests and debugging)."""
        now = time.monotonic()
        with self._lb_lock:
            return [{"host": ep.host, "port": ep.port,
                     "ewma_queue_seconds": ep.ewma_queue_seconds,
                     "failures": ep.failures,
                     "ejected": ep.ejected_until > now,
                     "ejected_for_seconds":
                         max(0.0, ep.ejected_until - now),
                     "probing": ep.probing}
                    for ep in self.endpoints]

    # -- raw HTTP with retry ---------------------------------------------------

    def _backoff(self, attempt: int,
                 retry_after: Optional[float]) -> float:
        ceiling = min(self.backoff_cap_seconds,
                      self.backoff_base_seconds * (2 ** attempt))
        with self._rng_lock:
            jittered = ceiling / 2 + self._rng.uniform(0, ceiling / 2)
        if retry_after is not None:
            jittered = max(jittered, retry_after)
        return jittered

    def _once(self, method: str, path: str,
              body: Optional[bytes] = None,
              idx: int = 0) -> "tuple[int, dict, bytes]":
        conn = self._conn(idx)
        headers = {"Content-Type": "application/json"} if body else {}
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()       # drain: keep-alive stays usable
            return resp.status, dict(resp.headers.items()), payload
        except _CONN_ERRORS:
            # a broken keep-alive conn poisons every later request on
            # this thread — drop it before the retry layer reconnects
            self._reset_conn(idx)
            raise

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None
                 ) -> "tuple[int, dict, bytes, int]":
        """One logical request: up to ``1 + max_retries`` attempts with
        backoff on retryable failures.  Each attempt re-picks the
        endpoint, so retries route around ejected replicas.  Returns
        ``(status, headers, payload, endpoint_index)``."""
        last_error: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if attempt > 0:
                retry_after = None
                if isinstance(last_error, LeoClientError) and \
                        getattr(last_error, "retry_after", None) is not None:
                    retry_after = last_error.retry_after
                time.sleep(self._backoff(attempt - 1, retry_after))
                self._bump("retries")
            self._bump("attempts")
            idx = self._pick_endpoint()
            try:
                status, headers, payload = self._once(method, path, body,
                                                      idx)
            except _CONN_ERRORS as e:
                self._bump("connect_errors")
                self._note_conn_failure(idx)
                last_error = e
                continue
            if status in RETRYABLE_STATUSES:
                if status == 429:
                    self._bump("sheds_seen")
                elif status >= 500:
                    self._bump("errors_5xx")
                if status == 504:
                    self._bump("deadline_hits")
                err = LeoClientError(
                    f"{method} {path} -> {status}", status=status)
                retry_after = headers.get("Retry-After")
                err.retry_after = float(retry_after) \
                    if retry_after is not None else None   # type: ignore
                # the endpoint answered (it is alive — no ejection), but
                # a shed means its queue is deep: fold the Retry-After
                # hint into the EWMA so the balancer steers elsewhere
                if status == 429:
                    self._observe_queue(
                        idx, err.retry_after                # type: ignore
                        if err.retry_after is not None      # type: ignore
                        else self.retry_penalty_seconds)
                self._note_success(idx)     # connectivity-wise healthy
                last_error = err
                continue
            if status >= 400:
                # non-retryable (4xx): surface the typed error envelope
                # when the server sent one — the caller gets the machine
                # code, not a stringly wrapper
                self._note_success(idx)
                try:
                    decode_response(payload).result()
                except ProtocolError:
                    raise
                except Exception:   # noqa: BLE001 - not an envelope
                    pass
                raise LeoClientError(
                    f"{method} {path} -> {status}: "
                    f"{payload[:200].decode('utf-8', 'replace')}",
                    status=status)
            self._note_success(idx)
            return status, headers, payload, idx
        raise RetriesExceeded(self.max_retries + 1, last_error)

    #: EWMA penalty charged for a 429 without a Retry-After hint.
    retry_penalty_seconds = 0.25

    # -- typed surface ---------------------------------------------------------

    def submit(self, request: AnalyzeRequest, *,
               deadline_seconds: Optional[float] = None
               ) -> Union[Diagnosis, Dict[str, Diagnosis]]:
        """Serve one typed request over the wire: a ``Diagnosis``, or a
        ``{backend: Diagnosis}`` map for fan-out requests — the same
        contract as ``LeoService.submit`` in-process."""
        resp = self.submit_wire(request, deadline_seconds=deadline_seconds)
        return resp.result()

    def submit_wire(self, request: AnalyzeRequest, *,
                    deadline_seconds: Optional[float] = None
                    ) -> WireResponse:
        """Like :meth:`submit` but returns the decoded envelope — for
        callers that want the negotiated ``schema_version`` and server
        ``timing`` alongside the payload."""
        body = encode_request(request, accept_schema=self.accept_schema,
                              deadline_seconds=deadline_seconds)
        _, _, payload, idx = self._request("POST", "/v1/analyze", body)
        resp = decode_response(payload)
        timing = getattr(resp, "timing", None) or {}
        queue_seconds = timing.get("queue_seconds")
        if isinstance(queue_seconds, (int, float)):
            self._observe_queue(idx, float(queue_seconds))
        return resp

    def diagnose(self, hlo_text: str, *,
                 backend: Optional[str] = None,
                 backends: Optional[Sequence[str]] = None,
                 hints: Optional[Dict[str, Any]] = None,
                 options: Optional[DiagnoseOptions] = None,
                 n_chains: Optional[int] = None,
                 prune_unexecuted: Optional[bool] = None,
                 advise: Optional[bool] = None,
                 rewrite: Optional[bool] = None,
                 occupancy: Optional[bool] = None,
                 deadline_seconds: Optional[float] = None
                 ) -> Union[Diagnosis, Dict[str, Diagnosis]]:
        """One-call diagnosis over the wire.  Analysis knobs ride a typed
        ``options=DiagnoseOptions(...)`` (the flat keywords remain as
        warn-once deprecation shims), mirroring ``LeoService.diagnose``."""
        opts = DiagnoseOptions.coalesce(
            options, "LeoClient.diagnose", n_chains=n_chains,
            prune_unexecuted=prune_unexecuted, advise=advise,
            rewrite=rewrite, occupancy=occupancy)
        return self.submit(AnalyzeRequest(
            hlo_text=hlo_text, backend=backend,
            backends=list(backends) if backends is not None else None,
            hints=hints, options=opts),
            deadline_seconds=deadline_seconds)

    def diagnose_batch(self, requests: Sequence[AnalyzeRequest], *,
                       max_connections: int = 4,
                       deadline_seconds: Optional[float] = None
                       ) -> List[Union[Diagnosis, Dict[str, Diagnosis]]]:
        """Pipeline a batch over up to ``max_connections`` persistent
        connections (one per worker thread), balanced across endpoints;
        order-preserving — ``results[i]`` answers ``requests[i]`` no
        matter which replica served it.  The first terminal failure
        propagates after the batch settles.  The pool threads' keep-alive
        connections are closed when the batch finishes (no socket
        leaks)."""
        requests = list(requests)
        if len(requests) <= 1:
            return [self.submit(r, deadline_seconds=deadline_seconds)
                    for r in requests]
        try:
            with ThreadPoolExecutor(
                    max_workers=min(max_connections, len(requests)),
                    thread_name_prefix="leo-client") as pool:
                futs = [pool.submit(self.submit, r,
                                    deadline_seconds=deadline_seconds)
                        for r in requests]
                return [f.result() for f in futs]
        finally:
            self._prune_dead()

    # -- health / telemetry ----------------------------------------------------

    def healthz(self) -> bool:
        status, _, _, _ = self._request("GET", "/healthz")
        return status == 200

    def readyz(self) -> bool:
        """True when at least one endpoint is admitting.  Unlike other
        calls, a 503 here is an *answer*, not a failure — no retries
        burned, no ejection bookkeeping."""
        for idx in range(len(self.endpoints)):
            try:
                status, _, _ = self._once("GET", "/readyz", idx=idx)
            except _CONN_ERRORS:
                continue
            if status == 200:
                return True
        return False

    def metrics_text(self) -> str:
        _, _, payload, _ = self._request("GET", "/metrics")
        return payload.decode("utf-8")

    def server_stats(self) -> Dict[str, Any]:
        import json
        _, _, payload, _ = self._request("GET", "/stats")
        return json.loads(payload)

    def wait_ready(self, timeout: float = 10.0,
                   poll_seconds: float = 0.05) -> bool:
        """Poll ``/readyz`` until the server admits (fresh processes
        take a moment to bind + warm); True when it did."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.readyz():
                return True
            time.sleep(poll_seconds)
        return False

    def __repr__(self) -> str:
        targets = ",".join(f"{ep.host}:{ep.port}" for ep in self.endpoints)
        return (f"LeoClient(http://{targets}, "
                f"retries={self.max_retries}, stats={self.stats})")
