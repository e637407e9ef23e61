"""Queue-driven analysis server: "analysis as a service" as an entry point.

The LEO analogue of `launch/serve.py`'s token-serving engine, mirroring its
slot pattern: :class:`AnalyzeRequest`s (HLO traces plus analysis knobs)
queue into a fixed pool of worker slots; each engine tick admits queued
requests to free slots (dispatching them onto the shared
:class:`~repro_torch.core.service.LeoService` thread pool) and harvests finished
:class:`~repro_torch.core.report.Diagnosis` results.  The service's single-flight
caches mean N queued requests for the same trace cost one parse and one
pipeline run, and a warm ``--cache-dir`` serves repeat traffic from disk
without parsing at all.

The engine is thread-safe and is the execution half of the networked
front-end in :mod:`repro_torch.serve`: ``--serve PORT`` wraps it in the HTTP
server (bounded admission with 429 shed, per-request deadlines,
``/metrics``, graceful SIGTERM drain — see ``docs/serving.md``).
``max_queue`` bounds admission (:class:`QueueFull` when exceeded), each
queued request may carry an absolute deadline (overdue entries are
cancelled in the queue or abandoned in flight), and every result records
``queue_seconds`` (submit→admit) and ``service_seconds`` (admit→done)
separately.

Usage (smoke: built-in demo traces, 3 slots):

  PYTHONPATH=src python -m repro_torch.launch.analysis_server --smoke

  PYTHONPATH=src python -m repro_torch.launch.analysis_server \\
      --hlo experiments/dryrun/qwen2__train_4k__single.hlo.gz \\
      --backends tpu_v5e,nvidia_gh200,amd_mi300a --cache-dir .leo_cache

  PYTHONPATH=src python -m repro_torch.launch.analysis_server \\
      --serve 8321 --slots 4 --max-queue 16 --cache-dir .leo_cache
"""
from __future__ import annotations

import argparse
import gzip
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core import AnalyzeRequest, Diagnosis, LeoService


class QueueFull(RuntimeError):
    """Admission rejected: the bounded queue is at capacity.  The HTTP
    front-end maps this to 429 + ``Retry-After``."""

    def __init__(self, depth: int, limit: int):
        super().__init__(f"admission queue full ({depth}/{limit})")
        self.depth = depth
        self.limit = limit


class ServerDraining(RuntimeError):
    """Admission rejected: the server is draining (SIGTERM received);
    in-flight work finishes, new work goes elsewhere (HTTP 503)."""


@dataclass
class _Pending:
    """A queued request plus its transport envelope: when it arrived and
    when (monotonic clock) it stops being worth serving."""
    request: AnalyzeRequest
    submitted_at: float = 0.0
    deadline: Optional[float] = None       # absolute time.monotonic()


@dataclass
class _Slot:
    pending: Optional[_Pending] = None
    future: Optional[Future] = None
    admitted_at: float = 0.0


@dataclass
class ServerResult:
    request_id: str
    diagnosis: Optional[Diagnosis] = None      # single-backend requests
    fanout: Optional[Dict[str, Diagnosis]] = None  # multi-backend requests
    error: Optional[str] = None
    #: total submit→done wall time (= queue_seconds + service_seconds);
    #: kept for callers of the pre-split field
    seconds: float = 0.0
    queue_seconds: float = 0.0             # submit → admit (queue wait)
    service_seconds: float = 0.0           # admit → done (actual service)


class AnalysisServer:
    """Slot-based continuous batching over `LeoService.submit`.

    Deliberately the same shape as ``ServeEngine``: ``submit`` enqueues,
    ``tick`` fills free slots and harvests completions, ``run`` loops
    until drained.  Slots bound the number of in-flight analyses
    independently of queue depth — the admission-control half of a
    serving deployment, with the service pool as the execution half.

    Thread-safe: the HTTP front-end submits from N handler threads and
    waits per-request on :meth:`wait` while a background ticker (see
    :meth:`start_ticker`) drives admissions/harvests; the single-threaded
    ``submit``/``run`` smoke path is unchanged.
    """

    def __init__(self, service: Optional[LeoService] = None,
                 slots: int = 4, max_queue: Optional[int] = None):
        self.service = service or LeoService(max_workers=max(slots, 2))
        self.slots = [_Slot() for _ in range(slots)]
        self.max_queue = max_queue
        self.queue: List[_Pending] = []
        self.results: Dict[str, ServerResult] = {}
        self._auto_rid = 0
        self._lock = threading.RLock()
        self._done = threading.Condition(self._lock)
        self._draining = False
        self._abandoned: set = set()
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()

    def submit(self, request: AnalyzeRequest,
               deadline_seconds: Optional[float] = None) -> str:
        """Enqueue one request.  Raises :class:`QueueFull` when the
        bounded queue is at capacity and :class:`ServerDraining` after
        :meth:`begin_drain` — admission control, not silent buffering."""
        request.validate()
        now = time.monotonic()
        with self._lock:
            if self._draining:
                raise ServerDraining("server is draining; not admitting")
            if self.max_queue is not None and \
                    len(self.queue) >= self.max_queue:
                raise QueueFull(len(self.queue), self.max_queue)
            if request.request_id is None:
                request.request_id = f"req-{self._auto_rid}"
                self._auto_rid += 1
            self.queue.append(_Pending(
                request=request, submitted_at=now,
                deadline=now + deadline_seconds
                if deadline_seconds is not None else None))
            return request.request_id

    @property
    def active(self) -> bool:
        with self._lock:
            return bool(self.queue) or any(s.pending for s in self.slots)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self.queue)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return sum(1 for s in self.slots if s.pending is not None)

    def _finish(self, rid: str, res: ServerResult) -> None:
        # caller holds the lock; abandoned requests' results are dropped
        # (their waiter already gave up — retaining them would leak)
        if rid in self._abandoned:
            self._abandoned.discard(rid)
            return
        self.results[rid] = res

    def _expire_queued(self, now: float) -> int:
        """Cancel queued requests whose deadline passed before a slot
        freed up: they complete as ``deadline_exceeded`` errors without
        ever occupying a slot."""
        expired = 0
        keep: List[_Pending] = []
        for pending in self.queue:
            if pending.deadline is not None and now > pending.deadline:
                waited = now - pending.submitted_at
                self._finish(pending.request.request_id, ServerResult(
                    request_id=pending.request.request_id,
                    error=f"deadline_exceeded: cancelled after "
                          f"{waited:.3f}s in queue, never admitted",
                    seconds=waited, queue_seconds=waited))
                expired += 1
            else:
                keep.append(pending)
        if expired:
            self.queue[:] = keep
        return expired

    def _fill_slots(self, now: float) -> None:
        for slot in self.slots:
            if slot.pending is None and self.queue:
                pending = self.queue.pop(0)
                slot.pending = pending
                slot.admitted_at = now
                slot.future = self.service.submit_async(pending.request)

    def _harvest(self, now: float) -> int:
        done = 0
        for slot in self.slots:
            if slot.pending is None or not slot.future.done():
                continue
            pending = slot.pending
            rid = pending.request.request_id
            res = ServerResult(
                request_id=rid,
                queue_seconds=slot.admitted_at - pending.submitted_at,
                service_seconds=now - slot.admitted_at,
                seconds=now - pending.submitted_at)
            try:
                out = slot.future.result()
                if isinstance(out, dict):
                    res.fanout = out
                else:
                    res.diagnosis = out
            except Exception as e:  # noqa: BLE001 - report failures as results
                res.error = f"{type(e).__name__}: {e}"
            self._finish(rid, res)
            slot.pending = None
            slot.future = None
            done += 1
        return done

    def tick(self) -> int:
        """One engine step: expire overdue queued requests, admit to free
        slots, harvest completions.  Returns requests finished this tick
        (deadline cancellations included)."""
        with self._lock:
            now = time.monotonic()
            expired = self._expire_queued(now)
            self._fill_slots(now)
            done = expired + self._harvest(now)
            if done:
                self._done.notify_all()
            return done

    def run(self, poll_seconds: float = 0.005) -> Dict[str, ServerResult]:
        while self.active:
            if self.tick() == 0:
                time.sleep(poll_seconds)
        return self.results

    # -- front-end surface (the networked half consumes these) ----------------

    def wait(self, request_id: str,
             timeout: Optional[float] = None) -> Optional[ServerResult]:
        """Block until ``request_id`` finishes and pop its result; None on
        timeout (the caller decides whether to :meth:`abandon`)."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        with self._done:
            while request_id not in self.results:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._done.wait(remaining)
            return self.results.pop(request_id)

    def abandon(self, request_id: str) -> Optional[ServerResult]:
        """Give up on a request: drop it from the queue if still waiting,
        or mark it so its eventual result is discarded (the analysis
        itself is not interrupted — the service pool finishes and the
        warm cache keeps the work).  Returns the result if it raced in
        just before abandonment."""
        with self._lock:
            raced = self.results.pop(request_id, None)
            if raced is not None:
                return raced
            before = len(self.queue)
            self.queue[:] = [p for p in self.queue
                             if p.request.request_id != request_id]
            if len(self.queue) == before:        # queued nowhere: in flight
                self._abandoned.add(request_id)
            return None

    def begin_drain(self) -> None:
        """Stop admitting (``submit`` raises :class:`ServerDraining`);
        queued + in-flight work keeps going."""
        with self._lock:
            self._draining = True

    def drain(self, timeout: Optional[float] = None,
              poll_seconds: float = 0.01) -> bool:
        """`begin_drain` then wait until queued + in-flight work is
        finished.  True when fully drained; False on timeout.  Needs a
        running ticker (or an external ``tick()`` driver)."""
        self.begin_drain()
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        while self.active:
            if deadline is not None and time.monotonic() > deadline:
                return False
            if self._ticker is None:
                self.tick()
            time.sleep(poll_seconds)
        return True

    def start_ticker(self, poll_seconds: float = 0.002) -> None:
        """Run ``tick()`` on a daemon thread — the drive loop the HTTP
        front-end relies on while its handler threads block in
        :meth:`wait`."""
        if self._ticker is not None:
            return
        self._ticker_stop.clear()

        def loop() -> None:
            while not self._ticker_stop.is_set():
                if self.tick() == 0:
                    self._ticker_stop.wait(poll_seconds)

        self._ticker = threading.Thread(target=loop, daemon=True,
                                        name="leo-analysis-ticker")
        self._ticker.start()

    def stop_ticker(self) -> None:
        if self._ticker is None:
            return
        self._ticker_stop.set()
        self._ticker.join(timeout=5.0)
        self._ticker = None


# --------------------------------------------------------------------------
# Entry point.
# --------------------------------------------------------------------------

#: Format-valid demo trace (async collective + gather + while loop): the
#: features the stall taxonomy diverges on across vendors.
_DEMO_HLO = """\
HloModule demo_trace_{seed}

%body.1 (p.1: (s32[], f32[{n},{n}])) -> (s32[], f32[{n},{n}]) {{
  %p.1 = (s32[], f32[{n},{n}]) parameter(0)
  %iv = s32[] get-tuple-element(%p.1), index=0
  %one = s32[] constant(1)
  %iv2 = s32[] add(%iv, %one)
  %acc = f32[{n},{n}] get-tuple-element(%p.1), index=1
  %gain = f32[{n},{n}] multiply(%acc, %acc)
  ROOT %out = (s32[], f32[{n},{n}]) tuple(%iv2, %gain)
}}

%cond.1 (p.2: (s32[], f32[{n},{n}])) -> pred[] {{
  %p.2 = (s32[], f32[{n},{n}]) parameter(0)
  %iv3 = s32[] get-tuple-element(%p.2), index=0
  %lim = s32[] constant({trips})
  ROOT %lt = pred[] compare(%iv3, %lim), direction=LT
}}

ENTRY %main.1 (arg0: f32[{n},{n}], arg1: f32[{n},{n}]) -> f32[{n},{n}] {{
  %arg0 = f32[{n},{n}] parameter(0)
  %arg1 = f32[{n},{n}] parameter(1)
  %gather.1 = f32[{n},{n}] gather(%arg0, %arg1), metadata={{op_name="jit(step)/model/embed/gather"}}
  %ag-start = f32[{n},{n}] all-gather-start(%gather.1), channel_id=1, replica_groups=[2,4]<=[8], dimensions={{0}}, metadata={{op_name="jit(step)/model/layer/allgather"}}
  %indep = f32[{n},{n}] multiply(%arg1, %arg1)
  %ag-done = f32[{n},{n}] all-gather-done(%ag-start), metadata={{op_name="jit(step)/model/layer/allgather"}}
  %dot.1 = f32[{n},{n}] dot(%ag-done, %indep), lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}, metadata={{op_name="jit(step)/model/layer/mlp/dot_general"}}
  %zero = s32[] constant(0)
  %init = (s32[], f32[{n},{n}]) tuple(%zero, %dot.1)
  %loop = (s32[], f32[{n},{n}]) while(%init), condition=%cond.1, body=%body.1
  %result = f32[{n},{n}] get-tuple-element(%loop), index=1
  ROOT %final = f32[{n},{n}] add(%result, %indep)
}}
"""


def demo_hlo(seed: int = 0, n: int = 128, trips: int = 5) -> str:
    return _DEMO_HLO.format(seed=seed, n=n, trips=trips)


def copy_storm_hlo(n_copies: int = 8, dim: int = 512) -> str:
    """Oversubscription demo trace (§III-E): `n_copies` async copies all
    in flight before any done — a double-buffered pipeline prologue
    cranked past some vendors' finite sync resources.  8 copies exceed
    NVIDIA-class named barriers (6) and AMD-class waitcnt counters (2)
    but fit Intel-class SWSB tokens (16) and TPU async contexts (32), so
    the same program serializes on some backends and not others.  Shared
    by `examples/crossvendor_divergence.py` and the divergence goldens
    (`tests/test_backend_divergence.py` pins snapshots of this exact
    trace — keep them in sync when changing it)."""
    lines = [f"  %arg{i} = f32[{dim},{dim}] parameter({i})"
             for i in range(n_copies)]
    for i in range(n_copies):
        lines.append(
            f"  %cp{i}-start = (f32[{dim},{dim}], f32[{dim},{dim}], u32[]) "
            f"copy-start(%arg{i}), "
            f'metadata={{op_name="jit(step)/model/io/copy{i}"}}')
    for i in range(n_copies):
        lines.append(
            f"  %cp{i}-done = f32[{dim},{dim}] copy-done(%cp{i}-start), "
            f'metadata={{op_name="jit(step)/model/io/copy{i}"}}')
    acc = "cp0-done"
    for i in range(1, n_copies):
        lines.append(f"  %s{i} = f32[{dim},{dim}] add(%{acc}, %cp{i}-done)")
        acc = f"s{i}"
    lines.append(f"  ROOT %out = f32[{dim},{dim}] negate(%{acc})")
    params = ", ".join(f"arg{i}: f32[{dim},{dim}]" for i in range(n_copies))
    return (f"HloModule fixture_copystorm\n\nENTRY %main.1 ({params}) -> "
            f"f32[{dim},{dim}] {{\n" + "\n".join(lines) + "\n}\n")


def wide_ops_hlo(n_streams: int = 12, depth: int = 3, dim: int = 256) -> str:
    """Wide independent-ops demo trace (the multi-stream issue fixture):
    `n_streams` dependency-free chains of `depth` elementwise/matmul ops,
    emitted round-robin so adjacent instructions belong to different
    chains.  Every chain is ready at t=0, so the program's ILP is bounded
    only by the backend's issue fabric: a narrow-issue part (4 queues)
    charges heavy `not_selected`/`pipe_busy` scheduler-contention cycles,
    a wide one (16 ports) issues the whole front cleanly, and a
    single-stream in-order part (TPU VLIW) structurally cannot emit those
    classes at all — the cross-vendor divergence the single-stream sampler
    could never show.  Chains alternate VPU (multiply) and MXU (dot) work
    so the contention splits between `not_selected` (arbitration loss to
    a different pipe) and `pipe_busy` (same pipe saturated).  Shared by
    the divergence goldens and the bench-smoke lane — keep them in sync
    when changing it."""
    lines = ["  %arg0 = f32[{d},{d}] parameter(0)".format(d=dim)]
    chains = []
    for i in range(n_streams):
        mxu = i % 2 == 1    # odd chains run on the matmul pipe
        ops = []
        prev = "arg0"
        for j in range(depth):
            name = f"c{i}_{j}"
            op = (f"  %{name} = f32[{dim},{dim}] "
                  + (f"dot(%{prev}, %{prev}), lhs_contracting_dims={{1}}, "
                     f"rhs_contracting_dims={{0}}"
                     if mxu else f"multiply(%{prev}, %{prev})")
                  + f', metadata={{op_name="jit(step)/wide/chain{i}/op{j}"}}')
            ops.append(op)
            prev = name
        chains.append(ops)
    # round-robin interleave: instruction k of every chain before k+1
    for j in range(max(len(c) for c in chains)):
        for c in chains:
            if j < len(c):
                lines.append(c[j])
    # reduction-tree tail joining the chains into one root
    acc = "c0_%d" % (depth - 1)
    for i in range(1, n_streams):
        lines.append(f"  %j{i} = f32[{dim},{dim}] "
                     f"add(%{acc}, %c{i}_{depth - 1})")
        acc = f"j{i}"
    lines.append(f"  ROOT %out = f32[{dim},{dim}] negate(%{acc})")
    return (f"HloModule fixture_wideops\n\nENTRY %main.1 "
            f"(arg0: f32[{dim},{dim}]) -> f32[{dim},{dim}] {{\n"
            + "\n".join(lines) + "\n}\n")


def _load_hlo(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def main(argv=None) -> Dict[str, ServerResult]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hlo", action="append", default=[],
                    help="HLO text file (.hlo or .hlo.gz); repeatable")
    ap.add_argument("--smoke", action="store_true",
                    help="use built-in demo traces (duplicates included, "
                         "to exercise single-flight dedup)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--backends", default="",
                    help="comma list; empty = service default backend, "
                         "'all' = fan out across every registered backend")
    ap.add_argument("--cache-dir", default=None,
                    help="content-addressed disk cache shared across runs")
    ap.add_argument("--hints-devices", type=int, default=8)
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve over HTTP on PORT (0 = ephemeral) instead "
                         "of running a one-shot batch; SIGTERM drains "
                         "gracefully (see docs/serving.md)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --serve")
    ap.add_argument("--max-queue", type=int, default=16,
                    help="bounded admission queue for --serve; full = "
                         "429 + Retry-After")
    ap.add_argument("--retry-after", type=float, default=0.25,
                    help="Retry-After seconds hinted on 429/503 sheds")
    ap.add_argument("--default-deadline", type=float, default=None,
                    help="deadline applied to --serve requests that do "
                         "not carry their own")
    ap.add_argument("--port-file", default=None,
                    help="write the bound --serve port to this file once "
                         "listening (how scripts find an ephemeral port)")
    ap.add_argument("--workers", type=int, default=1,
                    help="pre-forked worker processes for --serve; 1 "
                         "(default) serves in-process exactly as before, "
                         "N>1 binds once and forks N LeoHttpd workers "
                         "behind the listener (POSIX only)")
    ap.add_argument("--control-port", type=int, default=0,
                    help="with --workers N>1: port for the pool's "
                         "aggregated /metrics /stats /healthz /readyz "
                         "(0 = ephemeral)")
    ap.add_argument("--control-port-file", default=None,
                    help="write the bound control port to this file")
    args = ap.parse_args(argv)

    if args.serve is not None and args.workers > 1:
        # pre-forked multi-process serving: bind once, fork N workers,
        # rolling drain on SIGTERM (see repro_torch.serve.pool)
        from ..serve.pool import LeoWorkerPool, serve_pool_forever
        pool = LeoWorkerPool(
            workers=args.workers, host=args.host, port=args.serve,
            slots=args.slots, max_queue=args.max_queue,
            retry_after_seconds=args.retry_after,
            default_deadline_seconds=args.default_deadline,
            cache_dir=args.cache_dir, control_port=args.control_port)
        pool.start()
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(pool.port))
        if args.control_port_file and pool.control_port is not None:
            with open(args.control_port_file, "w") as f:
                f.write(str(pool.control_port))
        print(f"leo-serve pool listening on http://{args.host}:{pool.port} "
              f"({args.workers} workers x {args.slots} slots, "
              f"queue {args.max_queue}, control port {pool.control_port}); "
              f"SIGTERM drains rolling", flush=True)
        clean = serve_pool_forever(pool, install_signal_handlers=True)
        if not clean:
            print("leo-serve pool drain incomplete", flush=True)
            raise SystemExit(1)
        print("leo-serve drained cleanly", flush=True)
        return {}

    if args.serve is not None:
        # the networked front-end: stdlib HTTP around this engine's slots
        from ..serve.httpd import LeoHttpd, serve_forever
        from ..serve.metrics import MetricsRegistry
        metrics = MetricsRegistry()
        service = LeoService(cache_dir=args.cache_dir,
                             max_workers=max(args.slots, 2),
                             metrics=metrics)
        app = LeoHttpd(service=service, host=args.host, port=args.serve,
                       slots=args.slots, max_queue=args.max_queue,
                       retry_after_seconds=args.retry_after,
                       default_deadline_seconds=args.default_deadline,
                       metrics=metrics)
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(app.port))
        print(f"leo-serve listening on http://{args.host}:{app.port} "
              f"({args.slots} slots, queue {args.max_queue}); "
              f"SIGTERM drains", flush=True)
        serve_forever(app)
        print("leo-serve drained cleanly", flush=True)
        return {}

    if not args.hlo and not args.smoke:
        ap.error("give --hlo file(s) or --smoke")

    texts = [_load_hlo(p) for p in args.hlo]
    if args.smoke:
        # fewer distinct traces than requests: repeats collapse in-cache
        texts += [demo_hlo(seed=i, n=128 + 32 * (i % 3))
                  for i in range(max(2, args.requests // 2))]

    backends = None
    fanout = False
    if args.backends == "all":
        fanout = True
    elif args.backends:
        names = args.backends.split(",")
        backends, fanout = (names, True) if len(names) > 1 else (None, False)

    service = LeoService(cache_dir=args.cache_dir,
                         max_workers=max(args.slots, 2))
    server = AnalysisServer(service, slots=args.slots)
    hints = {"total_devices": args.hints_devices}
    for i in range(args.requests):
        req = AnalyzeRequest(hlo_text=texts[i % len(texts)], hints=hints)
        if fanout:
            req.backends = backends if backends is not None else \
                [b.name for b in service.session.backends]
        elif args.backends:
            req.backend = args.backends
        server.submit(req)

    t0 = time.perf_counter()
    results = server.run()
    wall = time.perf_counter() - t0

    errors = 0
    for rid in sorted(results, key=lambda r: int(r.split("-")[-1])):
        res = results[rid]
        if res.error is not None:
            errors += 1
            print(f"{rid}: ERROR {res.error}")
            continue
        diags = res.fanout if res.fanout is not None \
            else {"": res.diagnosis}
        for d in diags.values():
            top = d.root_causes[0]["instruction"] if d.root_causes else "-"
            print(f"{rid} [{d.backend}]: "
                  f"est {d.estimated_step_seconds*1e6:9.1f} us, "
                  f"queued {res.queue_seconds*1e3:6.1f} ms + "
                  f"service {res.service_seconds*1e3:7.1f} ms, "
                  f"top root cause: {top}")
    stats = service.stats_dict()
    ok = [r for r in results.values() if r.error is None]
    if ok:
        mean_q = sum(r.queue_seconds for r in ok) / len(ok)
        mean_s = sum(r.service_seconds for r in ok) / len(ok)
        print(f"\nmean queue wait {mean_q*1e3:.1f} ms, "
              f"mean service {mean_s*1e3:.1f} ms over {len(ok)} ok")
    print(f"{len(results)} requests via {len(server.slots)} slots in "
          f"{wall:.2f}s; parses: {stats['parse_calls']} calls -> "
          f"{service.stats.parse_misses} actual "
          f"(+{stats['parse_disk_hits']} from disk), "
          f"analyses: {stats['analyze_calls']} calls -> "
          f"{stats['analyze_calls'] - stats['analyze_hits']} runs")
    if errors:
        raise SystemExit(f"{errors} request(s) failed")
    service.close()
    return results


if __name__ == "__main__":
    main()
