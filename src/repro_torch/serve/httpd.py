"""Backpressure-aware HTTP front-end over the slot-based analysis engine.

A stdlib :class:`~http.server.ThreadingHTTPServer` wrapping
:class:`~repro_torch.launch.analysis_server.AnalysisServer`: handler threads
admit requests into the engine's **bounded queue** and block in
``engine.wait`` while a background ticker drives the slots.  The serving
semantics a front-end owes its callers:

  * **load shedding** — a full admission queue answers 429 with a
    ``Retry-After`` hint instead of buffering unboundedly; a draining
    server answers 503.  Both carry the machine-readable error envelope
    from :mod:`repro_torch.serve.protocol`.
  * **deadlines** — a request's ``deadline_seconds`` (or the server
    default) bounds its total time in the system.  Overdue-in-queue
    requests are cancelled without ever occupying a slot; overdue
    in-flight requests are *abandoned* (504 to the caller; the analysis
    finishes into the warm cache, so the retry is cheap).
  * **health** — ``GET /healthz`` (process liveness, always 200) vs
    ``GET /readyz`` (admission readiness: 503 while draining).
  * **telemetry** — ``GET /metrics`` renders the shared
    :class:`~repro_torch.serve.metrics.MetricsRegistry` in Prometheus text
    format; ``GET /stats`` dumps the service cache counters as JSON.
  * **graceful drain** — SIGTERM (via :func:`serve_forever`) or
    :meth:`LeoHttpd.drain`: stop admitting, finish in-flight analyses,
    flush the disk cache, then stop listening.

Endpoints: ``POST /v1/analyze`` (single or fan-out, per the request),
``GET /healthz`` | ``/readyz`` | ``/metrics`` | ``/stats``.

::

    app = LeoHttpd(service=LeoService(cache_dir=".leo_cache"), port=0)
    app.start()                      # app.port is the bound port
    ...
    app.drain()                      # or serve_forever(app) + SIGTERM
"""
from __future__ import annotations

import json
import signal
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..core.service import LeoService
from .metrics import MetricsRegistry
from .protocol import (
    ProtocolError,
    decode_request,
    encode_error,
    encode_result,
)


class _Httpd(ThreadingHTTPServer):
    """ThreadingHTTPServer that can adopt an already-listening socket.

    The pre-fork pool (:mod:`repro_torch.serve.pool`) binds the listener once
    in the parent and hands the inherited socket to each forked worker;
    ``listen_socket`` skips bind/listen and serves on the given socket
    instead.  Without it the behavior is byte-identical to PR 6.
    """

    daemon_threads = True
    app: "LeoHttpd"                     # set by LeoHttpd.__init__

    def __init__(self, server_address: Any, handler_class: Any,
                 listen_socket: Optional[socket.socket] = None):
        if listen_socket is None:
            super().__init__(server_address, handler_class)
            return
        super().__init__(server_address, handler_class,
                         bind_and_activate=False)
        self.socket.close()             # drop the unused placeholder
        self.socket = listen_socket
        # N workers share one listener, so a select() wakeup is only a
        # hint: a sibling may win the accept() race, and a blocking
        # accept would then wedge serve_forever past shutdown().  Non-
        # blocking turns the lost race into a BlockingIOError, which
        # _handle_request_noblock() already treats as "nothing to do".
        listen_socket.setblocking(False)
        # What server_bind()/server_activate() would have set, minus the
        # reverse-DNS lookup (socket.getfqdn) — a forked worker must not
        # stall on a resolver during spawn.
        self.server_address = listen_socket.getsockname()
        host, port = self.server_address[:2]
        self.server_name = host
        self.server_port = port


class LeoHttpd:
    """The networked diagnosis server: HTTP admission over engine slots.

    ``slots`` bounds concurrent analyses, ``max_queue`` bounds waiting
    admissions — together the whole memory footprint of pending work.
    ``metrics`` (shared with the :class:`LeoService` for the cache/
    latency instruments) feeds ``/metrics``.
    """

    def __init__(self, service: Optional[LeoService] = None,
                 engine: Optional[Any] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 slots: int = 4, max_queue: int = 16,
                 retry_after_seconds: float = 0.25,
                 default_deadline_seconds: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 drain_timeout_seconds: Optional[float] = 30.0,
                 listen_socket: Optional[Any] = None):
        # imported here, not at module top: the slot engine under
        # repro_torch.launch loads only once a server is actually
        # constructed
        from ..launch.analysis_server import AnalysisServer
        self.metrics = metrics or MetricsRegistry()
        if service is None:
            service = LeoService(max_workers=max(slots, 2),
                                 metrics=self.metrics)
        self.service = service
        self.engine = engine or AnalysisServer(service, slots=slots,
                                               max_queue=max_queue)
        self.retry_after_seconds = retry_after_seconds
        self.default_deadline_seconds = default_deadline_seconds
        self.drain_timeout_seconds = drain_timeout_seconds
        self._drained = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None

        m = self.metrics
        self.m_requests = m.counter(
            "leo_requests_total", "HTTP requests served, by endpoint and "
            "status code", labelnames=("endpoint", "code"))
        self.m_admissions = m.counter(
            "leo_admissions_total", "Requests admitted into the engine "
            "queue")
        self.m_sheds = m.counter(
            "leo_sheds_total", "Requests shed with 429 (admission queue "
            "full)")
        self.m_deadline = m.counter(
            "leo_deadline_exceeded_total", "Requests that missed their "
            "deadline (cancelled in queue or abandoned in flight)")
        self.m_queue_seconds = m.histogram(
            "leo_queue_seconds", "Queue wait per served request "
            "(submit to slot admission)")
        self.m_service_seconds = m.histogram(
            "leo_service_seconds", "Service time per served request "
            "(slot admission to completion)")
        m.gauge("leo_queue_depth", "Requests waiting for a slot right "
                "now").set_function(lambda: self.engine.queue_depth)
        m.gauge("leo_inflight_requests", "Requests occupying a slot "
                "right now").set_function(lambda: self.engine.in_flight)
        m.gauge("leo_slots", "Configured engine slots").set_function(
            lambda: len(self.engine.slots))
        m.gauge("leo_ready", "1 while admitting, 0 while draining"
                ).set_function(lambda: 0.0 if self.draining else 1.0)

        self.httpd = _Httpd((host, port), _Handler,
                            listen_socket=listen_socket)
        self.httpd.app = self
        self.host = self.httpd.server_address[0]
        self.port = self.httpd.server_address[1]

    # -- lifecycle -------------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self.engine._draining

    def start(self) -> "LeoHttpd":
        """Start the engine ticker and the HTTP accept loop (both on
        daemon threads); returns self so ``LeoHttpd(...).start()`` reads
        naturally."""
        self.engine.start_ticker()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="leo-httpd")
        self._serve_thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (new POSTs get 503, readyz
        flips), let queued + in-flight analyses finish, flush the disk
        cache, then close the listener.  True when everything finished
        inside the timeout."""
        timeout = timeout if timeout is not None \
            else self.drain_timeout_seconds
        drained = self.engine.drain(timeout=timeout)
        self.engine.stop_ticker()
        self.service.flush()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
            self._serve_thread = None
        self._drained.set()
        return drained

    def __enter__(self) -> "LeoHttpd":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        if not self._drained.is_set():
            self.drain()

    def __repr__(self) -> str:
        return (f"LeoHttpd(http://{self.host}:{self.port}, "
                f"slots={len(self.engine.slots)}, "
                f"max_queue={self.engine.max_queue})")


class _Handler(BaseHTTPRequestHandler):
    server_version = "leo-serve/1"
    protocol_version = "HTTP/1.1"       # keep-alive: clients pipeline

    # quiet by default: the access log is what /metrics is for
    def log_message(self, format: str, *args: Any) -> None:
        pass

    @property
    def app(self) -> LeoHttpd:
        return self.server.app          # type: ignore[attr-defined]

    def _send(self, status: int, body: bytes, content_type: str,
              extra_headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_envelope(self, endpoint: str, code: str, message: str,
                             retry_after: Optional[float] = None,
                             request_id: Optional[str] = None) -> None:
        body, status = encode_error(code, message, retry_after=retry_after,
                                    request_id=request_id)
        headers = {}
        if retry_after is not None:
            # ceil-ish text form; proxies expect integral seconds but
            # fractional is widely accepted — keep the precise hint
            headers["Retry-After"] = f"{retry_after:g}"
        self.app.m_requests.inc(endpoint=endpoint, code=str(status))
        self._send(status, body, "application/json", headers)

    # -- GET: health / telemetry ----------------------------------------------

    def do_GET(self) -> None:
        app = self.app
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self.app.m_requests.inc(endpoint="healthz", code="200")
            self._send(200, b"ok\n", "text/plain; charset=utf-8")
        elif path == "/readyz":
            if app.draining:
                app.m_requests.inc(endpoint="readyz", code="503")
                self._send(503, b"draining\n",
                           "text/plain; charset=utf-8",
                           {"Retry-After": f"{app.retry_after_seconds:g}"})
            else:
                app.m_requests.inc(endpoint="readyz", code="200")
                body = (f"ready queue={app.engine.queue_depth}/"
                        f"{app.engine.max_queue} "
                        f"inflight={app.engine.in_flight}/"
                        f"{len(app.engine.slots)}\n").encode()
                self._send(200, body, "text/plain; charset=utf-8")
        elif path == "/metrics":
            body = app.metrics.render().encode("utf-8")
            app.m_requests.inc(endpoint="metrics", code="200")
            self._send(200, body,
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/stats":
            body = json.dumps(app.service.stats_dict(),
                              sort_keys=True).encode("utf-8")
            app.m_requests.inc(endpoint="stats", code="200")
            self._send(200, body, "application/json")
        else:
            self._send_error_envelope("unknown", "not_found",
                                      f"no such endpoint {path!r}")

    # -- POST: the analysis endpoint ------------------------------------------

    def do_POST(self) -> None:
        app = self.app
        path = self.path.split("?", 1)[0]
        if path != "/v1/analyze":
            self._send_error_envelope("unknown", "not_found",
                                      f"no such endpoint {path!r}")
            return
        from ..launch.analysis_server import QueueFull, ServerDraining
        try:
            length = int(self.headers.get("Content-Length", 0))
            wire = decode_request(self.rfile.read(length))
        except ProtocolError as e:
            self._send_error_envelope("analyze", e.code, e.message)
            return

        deadline = wire.deadline_seconds \
            if wire.deadline_seconds is not None \
            else app.default_deadline_seconds
        try:
            rid = app.engine.submit(wire.request,
                                    deadline_seconds=deadline)
        except QueueFull as e:
            app.m_sheds.inc()
            self._send_error_envelope(
                "analyze", "overloaded", str(e),
                retry_after=app.retry_after_seconds)
            return
        except ServerDraining as e:
            self._send_error_envelope(
                "analyze", "draining", str(e),
                retry_after=app.retry_after_seconds)
            return
        except ValueError as e:
            self._send_error_envelope("analyze", "invalid_request", str(e))
            return
        app.m_admissions.inc()

        # small grace past the deadline: the engine's own expiry (queue
        # cancellation) is the authoritative result and races the
        # handler's timeout by up to one tick; the handler timeout is
        # the backstop for overdue *in-flight* work
        res = app.engine.wait(
            rid, timeout=deadline + 0.05 if deadline is not None else None)
        if res is None:
            # overdue in flight: abandon (the slot finishes into the
            # warm cache; this caller stops waiting)
            res = app.engine.abandon(rid)
            if res is None:
                app.m_deadline.inc()
                self._send_error_envelope(
                    "analyze", "deadline_exceeded",
                    f"request {rid} exceeded its {deadline:g}s deadline "
                    f"in flight; abandoned",
                    retry_after=app.retry_after_seconds, request_id=rid)
                return
        app.m_queue_seconds.observe(res.queue_seconds)
        if res.error is not None:
            if res.error.startswith("deadline_exceeded"):
                app.m_deadline.inc()
                self._send_error_envelope(
                    "analyze", "deadline_exceeded", res.error,
                    retry_after=app.retry_after_seconds, request_id=rid)
            else:
                self._send_error_envelope("analyze", "internal", res.error,
                                          request_id=rid)
            return
        app.m_service_seconds.observe(res.service_seconds)
        body = encode_result(
            res.fanout if res.fanout is not None else res.diagnosis,
            schema_version=wire.negotiated_schema, request_id=rid,
            timing={"queue_seconds": res.queue_seconds,
                    "service_seconds": res.service_seconds,
                    "seconds": res.seconds})
        app.m_requests.inc(endpoint="analyze", code="200")
        self._send(200, body, "application/json")


def serve_forever(app: LeoHttpd, *,
                  install_signal_handlers: bool = True) -> None:
    """Run until SIGTERM/SIGINT, then drain gracefully: stop admitting,
    finish in-flight analyses, flush the disk cache, close the listener.
    The entry point behind ``analysis_server --serve PORT``."""
    stop = threading.Event()
    if install_signal_handlers and \
            threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
    app.start()
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        app.drain()
