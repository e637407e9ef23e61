"""Prometheus-style metrics registry (stdlib-only) for the serving layer.

Three instrument kinds, the minimum a scrape-based operator needs:

  * :class:`Counter` — monotonically increasing totals (requests,
    admissions, sheds, cache hits/misses, per-backend diagnoses);
  * :class:`Gauge` — point-in-time values, either set explicitly or
    backed by a callback sampled at scrape time (queue depth, in-flight
    requests, session cache hit counters);
  * :class:`Histogram` — cumulative-bucket latency distributions
    (parse / pipeline / queue-wait / service time), rendered with the
    standard ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet.

All instruments support fixed label names; a
:class:`MetricsRegistry` is the factory and renderer — creation is
get-or-create, so any layer (``LeoService``, the HTTP front-end, the
slot engine) can ask for the same metric and share it.
:meth:`MetricsRegistry.render` emits the Prometheus text exposition
format (version 0.0.4), which is what the ``/metrics`` endpoint serves.

Everything is thread-safe: one lock per registry guards creation, one
lock per metric guards its label children.  See ``docs/serving.md`` for
the full metric catalog the serving stack emits.

For multi-process serving every instrument also supports a structured
:meth:`~_Metric.dump` (JSON-serializable snapshot), and
:func:`aggregate_dumps` merges the per-worker registry dumps into one
Prometheus page: counters and histogram buckets/sums/counts are SUMMED
across workers, gauges keep one sample per worker labeled
``worker="k"`` (summing a queue depth across workers is meaningful, but
summing e.g. ``leo_ready`` flags is not — the operator gets both views:
the per-worker gauge samples and the summed counters).
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: Default latency buckets (seconds): sub-millisecond cache hits through
#: multi-second cold compiles/analyses.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_LabelKey = Tuple[str, ...]


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value)


def _labels_suffix(labelnames: Sequence[str], labelvalues: _LabelKey,
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(labelnames, labelvalues)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    body = ",".join(f'{n}="{_escape_label_value(str(v))}"'
                    for n, v in pairs)
    return "{" + body + "}"


class _Metric:
    """Shared label-children plumbing for all three instrument kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> _LabelKey:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def header(self) -> List[str]:
        return [f"# HELP {self.name} {_escape_help(self.help)}",
                f"# TYPE {self.name} {self.kind}"]

    def render(self) -> List[str]:  # pragma: no cover - overridden
        raise NotImplementedError

    def dump(self) -> Dict[str, Any]:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic total.  ``inc()`` on the bare metric (no labels) or with
    every declared label: ``c.inc(backend="tpu_v5e")``."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]     # label-less counters render at 0
        for key, value in items:
            out.append(f"{self.name}"
                       f"{_labels_suffix(self.labelnames, key)} "
                       f"{_format_value(value)}")
        return out

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            values = [[list(k), v] for k, v in sorted(self._values.items())]
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames), "values": values}


class Gauge(_Metric):
    """Point-in-time value.  ``set``/``inc``/``dec`` for explicit values,
    or ``set_function`` to sample a callback at scrape time (queue depth,
    cache-stat snapshots — values owned by another object)."""

    kind = "gauge"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[_LabelKey, float] = {}
        self._functions: Dict[_LabelKey, Callable[[], float]] = {}

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn: Callable[[], float], **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._functions[key] = fn

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            fn = self._functions.get(key)
            if fn is None:
                return self._values.get(key, 0.0)
        return float(fn())

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            values = dict(self._values)
            functions = dict(self._functions)
        for key, fn in functions.items():
            try:
                values[key] = float(fn())
            except Exception:   # noqa: BLE001 - a dead callback must not
                pass            # take the whole scrape down
        if not values and not self.labelnames:
            values = {(): 0.0}
        for key, value in sorted(values.items()):
            out.append(f"{self.name}"
                       f"{_labels_suffix(self.labelnames, key)} "
                       f"{_format_value(value)}")
        return out

    def dump(self) -> Dict[str, Any]:
        """Snapshot with callback gauges sampled at dump time — the
        control-pipe heartbeat ships live queue depths, not stale sets."""
        with self._lock:
            values = dict(self._values)
            functions = dict(self._functions)
        for key, fn in functions.items():
            try:
                values[key] = float(fn())
            except Exception:   # noqa: BLE001 - mirror render()
                pass
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames),
                "values": [[list(k), v] for k, v in sorted(values.items())]}


class Histogram(_Metric):
    """Cumulative-bucket distribution (Prometheus semantics: each
    ``le`` bucket counts observations <= its bound, ``+Inf`` counts
    all)."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = tuple(bounds)
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}
        self._totals: Dict[_LabelKey, int] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.bounds)
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, **labels: str) -> int:
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def sum(self, **labels: str) -> float:
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            keys = sorted(self._counts)
            counts = {k: list(v) for k, v in self._counts.items()}
            sums = dict(self._sums)
            totals = dict(self._totals)
        if not keys and not self.labelnames:
            keys = [()]
            counts[()] = [0] * len(self.bounds)
            sums[()] = 0.0
            totals[()] = 0
        for key in keys:
            for bound, cum in zip(self.bounds, counts[key]):
                out.append(
                    f"{self.name}_bucket"
                    f"{_labels_suffix(self.labelnames, key, ('le', _format_value(bound)))}"
                    f" {cum}")
            out.append(
                f"{self.name}_bucket"
                f"{_labels_suffix(self.labelnames, key, ('le', '+Inf'))}"
                f" {totals[key]}")
            out.append(f"{self.name}_sum"
                       f"{_labels_suffix(self.labelnames, key)} "
                       f"{_format_value(sums[key])}")
            out.append(f"{self.name}_count"
                       f"{_labels_suffix(self.labelnames, key)} "
                       f"{totals[key]}")
        return out

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            rows = [[list(k), list(self._counts[k]), self._sums[k],
                     self._totals[k]] for k in sorted(self._counts)]
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames),
                "bounds": list(self.bounds), "rows": rows}


class MetricsRegistry:
    """Get-or-create factory plus the ``/metrics`` renderer.

    Re-requesting a metric by name returns the existing instrument (so
    independent layers share totals); re-requesting with a *different*
    kind or label set is a programming error and raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: "Dict[str, _Metric]" = {}

    def _get_or_create(self, cls: type, name: str, help: str,
                       labelnames: Sequence[str], **kwargs: Any) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or \
                        existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels "
                        f"{existing.labelnames}")
                return existing
            metric = cls(name, help, labelnames=labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition format, metrics in name order."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for metric in metrics:
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"

    def dump(self) -> Dict[str, Dict[str, Any]]:
        """JSON-serializable snapshot of every registered metric — the
        unit a pool worker ships over its control pipe each heartbeat."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        return {m.name: m.dump() for m in metrics}

    def __repr__(self) -> str:
        with self._lock:
            return f"MetricsRegistry({sorted(self._metrics)})"


def _merge_counter(name: str, dumps: List[Dict[str, Any]]) -> List[str]:
    first = dumps[0]
    labelnames = tuple(first["labelnames"])
    merged: Dict[_LabelKey, float] = {}
    for d in dumps:
        for key, value in d["values"]:
            k = tuple(key)
            merged[k] = merged.get(k, 0.0) + float(value)
    out = [f"# HELP {name} {_escape_help(first['help'])}",
           f"# TYPE {name} counter"]
    items = sorted(merged.items()) or ([((), 0.0)] if not labelnames else [])
    for key, value in items:
        out.append(f"{name}{_labels_suffix(labelnames, key)} "
                   f"{_format_value(value)}")
    return out


def _merge_gauge(name: str, worker_dumps: List[Tuple[str, Dict[str, Any]]]
                 ) -> List[str]:
    first = worker_dumps[0][1]
    labelnames = tuple(first["labelnames"])
    out = [f"# HELP {name} {_escape_help(first['help'])}",
           f"# TYPE {name} gauge"]
    for worker, d in worker_dumps:
        for key, value in d["values"]:
            out.append(
                f"{name}"
                f"{_labels_suffix(labelnames, tuple(key), ('worker', worker))}"
                f" {_format_value(float(value))}")
    return out


def _merge_histogram(name: str, dumps: List[Dict[str, Any]]) -> List[str]:
    first = dumps[0]
    labelnames = tuple(first["labelnames"])
    bounds = tuple(float(b) for b in first["bounds"])
    counts: Dict[_LabelKey, List[int]] = {}
    sums: Dict[_LabelKey, float] = {}
    totals: Dict[_LabelKey, int] = {}
    for d in dumps:
        if tuple(float(b) for b in d["bounds"]) != bounds:
            continue    # mismatched buckets (mid-upgrade worker): skip
        for key, row_counts, row_sum, row_total in d["rows"]:
            k = tuple(key)
            if k not in counts:
                counts[k] = [0] * len(bounds)
            for i, c in enumerate(row_counts):
                counts[k][i] += int(c)
            sums[k] = sums.get(k, 0.0) + float(row_sum)
            totals[k] = totals.get(k, 0) + int(row_total)
    out = [f"# HELP {name} {_escape_help(first['help'])}",
           f"# TYPE {name} histogram"]
    for key in sorted(counts):
        for bound, cum in zip(bounds, counts[key]):
            out.append(
                f"{name}_bucket"
                f"{_labels_suffix(labelnames, key, ('le', _format_value(bound)))}"
                f" {cum}")
        out.append(f"{name}_bucket"
                   f"{_labels_suffix(labelnames, key, ('le', '+Inf'))}"
                   f" {totals[key]}")
        out.append(f"{name}_sum{_labels_suffix(labelnames, key)} "
                   f"{_format_value(sums[key])}")
        out.append(f"{name}_count{_labels_suffix(labelnames, key)} "
                   f"{totals[key]}")
    return out


def aggregate_dumps(dumps: Dict[str, Dict[str, Dict[str, Any]]]) -> str:
    """Merge per-worker :meth:`MetricsRegistry.dump` snapshots into one
    Prometheus text page.

    ``dumps`` maps a worker id (e.g. ``"0"``, ``"1"``) to that worker's
    registry dump.  Counters and histograms are summed across workers —
    the fleet-wide ``leo_requests_total`` equals the sum of per-worker
    totals by construction.  Gauges are NOT summed: each worker's sample
    is kept and tagged with an extra ``worker="k"`` label, because most
    gauges (readiness flags, slot counts) are meaningless as sums.
    Workers missing a metric simply contribute nothing to it.
    """
    names: Dict[str, str] = {}
    for d in dumps.values():
        for name, md in d.items():
            names.setdefault(name, md["kind"])
    lines: List[str] = []
    for name in sorted(names):
        kind = names[name]
        present = [(w, dumps[w][name]) for w in sorted(dumps)
                   if name in dumps[w] and dumps[w][name]["kind"] == kind]
        if not present:
            continue
        if kind == "counter":
            lines.extend(_merge_counter(name, [d for _, d in present]))
        elif kind == "gauge":
            lines.extend(_merge_gauge(name, present))
        elif kind == "histogram":
            lines.extend(_merge_histogram(name, [d for _, d in present]))
    return "\n".join(lines) + "\n"
