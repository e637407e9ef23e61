"""Pre-forked multi-process serving: N workers behind one listener.

``repro_torch.serve`` (PR 6) funnels every parse and ``VirtualSampler`` replay
through one CPython process, so the GIL — not the hardware — bounds
diagnosis throughput.  :class:`LeoWorkerPool` removes that ceiling with
the classic pre-fork shape every production inference front-end uses:

  * **bind once, fork N** — the parent binds the listening socket, then
    forks N workers that each run the existing :class:`LeoHttpd` engine
    over the *inherited* socket; the kernel load-balances ``accept()``
    across them.  Where inheriting is unsuitable, ``mode="reuseport"``
    gives every worker its own ``SO_REUSEPORT`` socket on the same port
    (the parent keeps a bound-but-not-listening anchor so ``port=0``
    resolves once and the port stays claimed across respawns).
  * **supervision** — each worker heartbeats over a control socketpair
    (a JSON line carrying readiness, queue depth, its metrics-registry
    dump, and its service cache stats).  The parent reaps crashed
    workers and SIGKILLs hung ones (stale heartbeat), then respawns
    with a restart-storm backoff so a crash-looping worker cannot spin
    the host.
  * **rolling drain** — SIGTERM drains workers one at a time: each gets
    SIGTERM, runs the PR 6 ``begin_drain``/``drain`` machinery (in-flight
    diagnoses finish into the shared disk cache), and exits 0 before the
    next worker is told to stop — capacity falls gradually, never to
    zero until the last worker.
  * **aggregated observability** — the parent's control endpoints
    (``/metrics``, ``/stats``, ``/healthz``, ``/readyz`` on a separate
    control port) merge the per-worker registry dumps:
    counters/histograms summed, gauges labeled ``worker="k"`` (see
    :func:`repro_torch.serve.metrics.aggregate_dumps`).

The shared ``cache_dir`` is the cross-process warm tier: a trace parsed
by worker 3 is a disk hit for workers 1..N (atomic publish + sweep
lockfile live in :mod:`repro_torch.core.caching`).

POSIX-only (needs ``os.fork``); ``--workers 1`` never constructs a pool,
so single-worker serving stays byte-identical to PR 6.
"""
from __future__ import annotations

import json
import os
import select
import signal
import socket
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import aggregate_dumps

#: Seconds between worker heartbeats on the control socket.
HEARTBEAT_INTERVAL = 0.25
#: A worker silent this long is presumed hung and is SIGKILLed.
DEFAULT_HANG_TIMEOUT = 15.0


def respawn_delay(history: Sequence[float], now: float, *,
                  base: float = 0.5, cap: float = 5.0,
                  window: float = 30.0, free_restarts: int = 3) -> float:
    """Restart-storm backoff: the first ``free_restarts`` respawns inside
    ``window`` seconds are immediate, then the delay doubles per extra
    respawn up to ``cap``.  Pure function (unit-tested directly)."""
    recent = [t for t in history if now - t <= window]
    if len(recent) < free_restarts:
        return 0.0
    return min(cap, base * (2 ** (len(recent) - free_restarts)))


class _Worker:
    """Parent-side record of one forked worker."""

    __slots__ = ("idx", "pid", "ctrl", "buf", "last_seen", "snapshot",
                 "exit_code", "spawned_at")

    def __init__(self, idx: int, pid: int, ctrl: socket.socket,
                 now: float) -> None:
        self.idx = idx
        self.pid = pid
        self.ctrl = ctrl
        self.buf = b""
        self.last_seen = now
        self.snapshot: Optional[Dict[str, Any]] = None
        self.exit_code: Optional[int] = None
        self.spawned_at = now

    @property
    def alive(self) -> bool:
        return self.exit_code is None


class LeoWorkerPool:
    """Bind once, pre-fork N :class:`LeoHttpd` workers, supervise them.

    ``mode`` selects how workers share the port: ``"inherit"`` (default
    via ``"auto"``) forks over one parent-bound listener;
    ``"reuseport"`` gives each worker its own ``SO_REUSEPORT`` socket.
    ``control_port`` (0 = ephemeral, ``None`` = disabled) serves the
    aggregated ``/metrics`` / ``/stats`` / ``/healthz`` / ``/readyz``.
    """

    def __init__(self, workers: int = 2, host: str = "127.0.0.1",
                 port: int = 0, *, slots: int = 2, max_queue: int = 16,
                 retry_after_seconds: float = 0.25,
                 default_deadline_seconds: Optional[float] = None,
                 cache_dir: Optional[str] = None,
                 mode: str = "auto",
                 control_port: Optional[int] = 0,
                 heartbeat_interval: float = HEARTBEAT_INTERVAL,
                 hang_timeout: float = DEFAULT_HANG_TIMEOUT,
                 drain_timeout_seconds: float = 30.0,
                 respawn_backoff_base: float = 0.5,
                 respawn_backoff_cap: float = 5.0,
                 respawn_storm_window: float = 30.0,
                 respawn_free_restarts: int = 3):
        if workers < 1:
            raise ValueError(f"need >= 1 worker, got {workers}")
        if mode not in ("auto", "inherit", "reuseport"):
            raise ValueError(f"unknown pool mode {mode!r}")
        if mode == "reuseport" and not hasattr(socket, "SO_REUSEPORT"):
            raise ValueError("SO_REUSEPORT unsupported on this platform")
        if not hasattr(os, "fork"):
            raise RuntimeError("LeoWorkerPool needs os.fork (POSIX)")
        self.workers = workers
        self.host = host
        self.port = port
        self.slots = slots
        self.max_queue = max_queue
        self.retry_after_seconds = retry_after_seconds
        self.default_deadline_seconds = default_deadline_seconds
        self.cache_dir = cache_dir
        self.mode = "inherit" if mode == "auto" else mode
        self.control_port_request = control_port
        self.control_port: Optional[int] = None
        self.heartbeat_interval = heartbeat_interval
        self.hang_timeout = hang_timeout
        self.drain_timeout_seconds = drain_timeout_seconds
        self._backoff = dict(base=respawn_backoff_base,
                             cap=respawn_backoff_cap,
                             window=respawn_storm_window,
                             free_restarts=respawn_free_restarts)

        self.respawns_total = 0
        self.drain_events: List[Tuple[str, int, float]] = []
        self._respawn_times: List[float] = []
        self._pending_respawn: Dict[int, float] = {}
        self._records: Dict[int, _Worker] = {}
        self._lock = threading.Lock()
        self._draining = False
        self._stop = threading.Event()
        self._listen_sock: Optional[socket.socket] = None
        self._anchor_sock: Optional[socket.socket] = None
        self._supervisor: Optional[threading.Thread] = None
        self._control_httpd: Optional[ThreadingHTTPServer] = None
        self._control_thread: Optional[threading.Thread] = None
        self._started = False
        self._drained = False

    # -- socket setup ----------------------------------------------------------

    def _bind(self) -> None:
        if self.mode == "inherit":
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.host, self.port))
            sock.listen(128)
            self._listen_sock = sock
            self.port = sock.getsockname()[1]
        else:
            # Anchor: bound but NOT listening, so it claims the port
            # (and resolves port=0) without stealing connections from
            # the workers' listening SO_REUSEPORT sockets.
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            sock.bind((self.host, self.port))
            self._anchor_sock = sock
            self.port = sock.getsockname()[1]

    def _worker_listener(self) -> socket.socket:
        """The socket a worker serves on (called in the child)."""
        if self.mode == "inherit":
            assert self._listen_sock is not None
            return self._listen_sock
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((self.host, self.port))
        sock.listen(128)
        return sock

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "LeoWorkerPool":
        if self._started:
            raise RuntimeError("pool already started")
        self._started = True
        # Import the whole worker stack BEFORE the first fork: the heavy
        # modules (repro_torch.core pulls torch in) load once in the parent and
        # are shared copy-on-write by every worker, making respawns cheap.
        from . import httpd as _httpd                      # noqa: F401
        from ..core import service as _service             # noqa: F401
        from ..launch import analysis_server as _engine    # noqa: F401
        self._bind()
        now = time.monotonic()
        for idx in range(self.workers):
            self._spawn(idx, now)
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True, name="leo-pool-supervisor")
        self._supervisor.start()
        if self.control_port_request is not None:
            self._start_control_httpd()
        return self

    def _spawn(self, idx: int, now: float) -> None:
        parent_sock, child_sock = socket.socketpair()
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:
            # ---- child ----
            try:
                parent_sock.close()
                # Drop inherited fds that belong to the parent or to
                # sibling workers: their control sockets (else a dead
                # sibling never EOFs for the parent) and the parent's
                # control HTTP listener.
                for rec in list(self._records.values()):
                    try:
                        rec.ctrl.close()
                    except OSError:
                        pass
                if self._control_httpd is not None:
                    try:
                        self._control_httpd.socket.close()
                    except OSError:
                        pass
                if self._anchor_sock is not None:
                    try:
                        self._anchor_sock.close()
                    except OSError:
                        pass
                self._worker_main(idx, child_sock)
            except BaseException:       # noqa: BLE001 - last-resort report
                traceback.print_exc()
                sys.stderr.flush()
            finally:
                os._exit(2)             # only reached on crash
        # ---- parent ----
        child_sock.close()
        with self._lock:
            self._records[idx] = _Worker(idx, pid, parent_sock, now)

    # -- the worker process ----------------------------------------------------

    def _worker_main(self, idx: int, ctrl: socket.socket) -> None:
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        # Parent coordinates the rolling drain; a tty Ctrl-C (SIGINT to
        # the whole foreground group) must not make every worker drain
        # at once.
        signal.signal(signal.SIGINT, signal.SIG_IGN)

        from ..core.service import LeoService
        from .httpd import LeoHttpd
        from .metrics import MetricsRegistry

        metrics = MetricsRegistry()
        service = LeoService(cache_dir=self.cache_dir,
                             max_workers=max(self.slots, 2),
                             metrics=metrics)
        app = LeoHttpd(service=service, host=self.host, port=self.port,
                       slots=self.slots, max_queue=self.max_queue,
                       retry_after_seconds=self.retry_after_seconds,
                       default_deadline_seconds=self.default_deadline_seconds,
                       metrics=metrics,
                       listen_socket=self._worker_listener())
        app.start()

        def snapshot(**extra: Any) -> Dict[str, Any]:
            snap: Dict[str, Any] = {
                "worker": idx, "pid": os.getpid(),
                "ready": not app.draining,
                "queue_depth": app.engine.queue_depth,
                "in_flight": app.engine.in_flight,
                "metrics": metrics.dump(),
                "stats": service.stats_dict(),
            }
            snap.update(extra)
            return snap

        ctrl.settimeout(self.heartbeat_interval)
        orphaned = False
        while not stop.is_set():
            try:
                ctrl.sendall(json.dumps(snapshot()).encode() + b"\n")
            except OSError:
                orphaned = True         # parent is gone: drain and exit
                break
            try:
                data = ctrl.recv(4096)
                if not data:            # parent closed its end
                    orphaned = True
                    break
                # any inbound bytes are a "snapshot now" nudge; the next
                # loop iteration sends one regardless
            except socket.timeout:
                continue
            except OSError:
                orphaned = True
                break

        ok = app.drain(timeout=self.drain_timeout_seconds)
        if not ok:
            print(f"leo-pool: worker {idx} (pid {os.getpid()}) drain "
                  f"timed out with queue_depth={app.engine.queue_depth} "
                  f"in_flight={app.engine.in_flight}",
                  file=sys.stderr, flush=True)
        try:
            ctrl.sendall(json.dumps(
                snapshot(draining=True, drained=ok)).encode() + b"\n")
            ctrl.close()
        except OSError:
            pass
        os._exit(0 if (ok or orphaned) else 3)

    # -- parent-side supervision ----------------------------------------------

    def _supervise(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                live = [r for r in self._records.values()
                        if r.alive and r.ctrl is not None]
            try:
                readable, _, _ = select.select(
                    [r.ctrl for r in live], [], [], 0.1)
            except (OSError, ValueError):
                readable = []
            now = time.monotonic()
            for rec in live:
                if rec.ctrl in readable:
                    self._read_heartbeats(rec, now)
            self._reap(now)
            if not self._draining:
                self._kill_hung(now)
                self._do_pending_respawns(now)

    def _read_heartbeats(self, rec: _Worker, now: float) -> None:
        try:
            data = rec.ctrl.recv(1 << 20)
        except OSError:
            return
        if not data:
            return                      # EOF: the reaper handles exit
        rec.buf += data
        *lines, rec.buf = rec.buf.split(b"\n")
        for line in lines:
            if not line.strip():
                continue
            try:
                rec.snapshot = json.loads(line)
            except ValueError:
                continue
            rec.last_seen = now

    def _reap(self, now: float) -> None:
        with self._lock:
            records = list(self._records.values())
        for rec in records:
            if not rec.alive:
                continue
            try:
                pid, status = os.waitpid(rec.pid, os.WNOHANG)
            except ChildProcessError:
                pid, status = rec.pid, 0
            if pid == 0:
                continue
            rec.exit_code = os.waitstatus_to_exitcode(status)
            try:
                rec.ctrl.close()
            except OSError:
                pass
            self.drain_events.append(("exit", rec.idx, now))
            if not self._draining:
                print(f"leo-pool: worker {rec.idx} (pid {rec.pid}) exited "
                      f"with {rec.exit_code}; respawning",
                      file=sys.stderr, flush=True)
                delay = respawn_delay(self._respawn_times, now,
                                      **self._backoff)
                self._pending_respawn[rec.idx] = now + delay

    def _kill_hung(self, now: float) -> None:
        with self._lock:
            records = list(self._records.values())
        for rec in records:
            if not rec.alive or rec.idx in self._pending_respawn:
                continue
            if now - rec.last_seen > self.hang_timeout:
                print(f"leo-pool: worker {rec.idx} (pid {rec.pid}) silent "
                      f"for {now - rec.last_seen:.1f}s; killing",
                      file=sys.stderr, flush=True)
                try:
                    os.kill(rec.pid, signal.SIGKILL)
                except OSError:
                    pass
                # the reaper notices the exit and schedules the respawn

    def _do_pending_respawns(self, now: float) -> None:
        due = [idx for idx, t in self._pending_respawn.items() if now >= t]
        for idx in due:
            del self._pending_respawn[idx]
            self._respawn_times.append(now)
            self.respawns_total += 1
            self._spawn(idx, now)

    # -- drain -----------------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Rolling graceful shutdown: workers are drained one at a time
        (SIGTERM -> worker ``begin_drain``/``drain`` -> exit 0) so serving
        capacity steps down instead of vanishing.  True when every worker
        exited 0 inside the timeout."""
        if self._drained:
            return True
        self._drained = True
        self._draining = True
        timeout = timeout if timeout is not None \
            else self.drain_timeout_seconds
        deadline = time.monotonic() + timeout
        clean = True
        with self._lock:
            records = [self._records[i] for i in sorted(self._records)]
        for rec in records:
            if not rec.alive:
                clean = clean and rec.exit_code == 0
                continue
            self.drain_events.append(("sigterm", rec.idx, time.monotonic()))
            try:
                os.kill(rec.pid, signal.SIGTERM)
            except OSError:
                pass
            while rec.alive and time.monotonic() < deadline:
                time.sleep(0.02)
            if rec.alive:               # over deadline: stop waiting nicely
                clean = False
                print(f"leo-pool: worker {rec.idx} (pid {rec.pid}) missed "
                      f"the drain deadline; killing", file=sys.stderr,
                      flush=True)
                try:
                    os.kill(rec.pid, signal.SIGKILL)
                except OSError:
                    pass
                t0 = time.monotonic()
                while rec.alive and time.monotonic() - t0 < 5.0:
                    time.sleep(0.02)
            else:
                if rec.exit_code != 0:
                    print(f"leo-pool: worker {rec.idx} exited "
                          f"{rec.exit_code} during drain (3 = worker-side "
                          f"drain timeout)", file=sys.stderr, flush=True)
                clean = clean and rec.exit_code == 0
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5.0)
            self._supervisor = None
        if self._control_httpd is not None:
            self._control_httpd.shutdown()
            self._control_httpd.server_close()
            if self._control_thread is not None:
                self._control_thread.join(timeout=5.0)
        for sock in (self._listen_sock, self._anchor_sock):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        with self._lock:
            for rec in self._records.values():
                try:
                    rec.ctrl.close()
                except OSError:
                    pass
        return clean

    def __enter__(self) -> "LeoWorkerPool":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.drain()

    # -- introspection (and the control endpoints' data) -----------------------

    @property
    def worker_pids(self) -> Dict[int, int]:
        with self._lock:
            return {idx: rec.pid for idx, rec in self._records.items()
                    if rec.alive}

    @property
    def healthy(self) -> bool:
        with self._lock:
            return any(rec.alive for rec in self._records.values())

    @property
    def ready(self) -> bool:
        if self._draining:
            return False
        with self._lock:
            return any(rec.alive and rec.snapshot is not None
                       and rec.snapshot.get("ready")
                       for rec in self._records.values())

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """True once every worker slot is live and has reported ready."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                recs = list(self._records.values())
            if len(recs) == self.workers and all(
                    r.alive and r.snapshot is not None
                    and r.snapshot.get("ready") for r in recs):
                return True
            time.sleep(0.02)
        return False

    def worker_snapshots(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {idx: dict(rec.snapshot) for idx, rec in
                    self._records.items() if rec.snapshot is not None}

    def aggregate_metrics_text(self) -> str:
        """The fleet-wide ``/metrics`` page: per-worker registry dumps
        merged (counters/histograms summed, gauges ``worker="k"``), plus
        the pool's own supervision gauges."""
        snaps = self.worker_snapshots()
        text = aggregate_dumps({str(idx): snap["metrics"]
                                for idx, snap in snaps.items()
                                if "metrics" in snap})
        pool_lines = [
            "# HELP leo_pool_workers Configured worker count",
            "# TYPE leo_pool_workers gauge",
            f"leo_pool_workers {self.workers}",
            "# HELP leo_pool_alive_workers Live worker processes",
            "# TYPE leo_pool_alive_workers gauge",
            f"leo_pool_alive_workers {len(self.worker_pids)}",
            "# HELP leo_pool_respawns_total Workers respawned after a "
            "crash or hang",
            "# TYPE leo_pool_respawns_total counter",
            f"leo_pool_respawns_total {self.respawns_total}",
            "# HELP leo_pool_ready 1 while admitting, 0 while draining",
            "# TYPE leo_pool_ready gauge",
            f"leo_pool_ready {0 if self._draining else 1}",
        ]
        return text + "\n".join(pool_lines) + "\n"

    def stats_snapshot(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            workers = {
                str(idx): {
                    "pid": rec.pid,
                    "alive": rec.alive,
                    "exit_code": rec.exit_code,
                    "heartbeat_age_seconds": round(now - rec.last_seen, 3),
                    "ready": bool(rec.snapshot and rec.snapshot.get("ready")),
                    "stats": (rec.snapshot or {}).get("stats"),
                }
                for idx, rec in self._records.items()
            }
        return {"workers": workers, "respawns_total": self.respawns_total,
                "draining": self._draining, "mode": self.mode,
                "port": self.port}

    # -- the parent's control HTTP endpoints -----------------------------------

    def _start_control_httpd(self) -> None:
        pool = self

        class _ControlHandler(BaseHTTPRequestHandler):
            server_version = "leo-pool/1"
            protocol_version = "HTTP/1.1"

            def log_message(self, format: str, *args: Any) -> None:
                pass

            def _send(self, status: int, body: bytes,
                      content_type: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200,
                               pool.aggregate_metrics_text().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/stats":
                    self._send(200,
                               json.dumps(pool.stats_snapshot(),
                                          sort_keys=True).encode(),
                               "application/json")
                elif path == "/healthz":
                    if pool.healthy:
                        self._send(200, b"ok\n",
                                   "text/plain; charset=utf-8")
                    else:
                        self._send(503, b"no live workers\n",
                                   "text/plain; charset=utf-8")
                elif path == "/readyz":
                    if pool.ready:
                        self._send(200, b"ready\n",
                                   "text/plain; charset=utf-8")
                    else:
                        self._send(503, b"not ready\n",
                                   "text/plain; charset=utf-8")
                else:
                    self._send(404, b"not found\n",
                               "text/plain; charset=utf-8")

        class _ControlHttpd(ThreadingHTTPServer):
            daemon_threads = True

        self._control_httpd = _ControlHttpd(
            (self.host, self.control_port_request), _ControlHandler)
        self.control_port = self._control_httpd.server_address[1]
        self._control_thread = threading.Thread(
            target=self._control_httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True, name="leo-pool-control")
        self._control_thread.start()

    def __repr__(self) -> str:
        return (f"LeoWorkerPool(http://{self.host}:{self.port}, "
                f"workers={self.workers}, mode={self.mode!r}, "
                f"alive={sorted(self.worker_pids)})")


def serve_pool_forever(pool: LeoWorkerPool, *,
                       install_signal_handlers: bool = True) -> bool:
    """Run until SIGTERM/SIGINT, then perform the rolling drain.  The
    entry point behind ``analysis_server --serve PORT --workers N``."""
    stop = threading.Event()
    if install_signal_handlers and \
            threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
    if not pool._started:       # callers may pre-start to learn the port
        pool.start()
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        return pool.drain()
