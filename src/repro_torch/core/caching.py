"""Cache tiers backing `LeoSession` / `LeoService` (serving-scale storage).

Two building blocks:

  * :class:`LRUCache` — a bounded mapping with least-recently-used
    eviction.  The session's parse/graph/analysis caches were unbounded
    dicts before; at serving scale ("millions of users") an analyzer that
    never forgets a trace is a memory leak.  ``capacity=None`` keeps the
    legacy unbounded behavior.
  * :class:`DiskCache` — a content-addressed on-disk tier (sha256 key ->
    gzipped artifact) shared across processes.  Parsed ``Module``s are
    stored as gzipped pickles, :class:`~repro.core.report.Diagnosis`
    results as gzipped JSON, so a warm cache directory lets a *second
    process* re-run an analysis with zero HLO parses (asserted in
    ``tests/test_service.py``).

The disk tier supports bounded growth: ``max_bytes`` caps the total
artifact size (oldest-accessed evicted first; hits refresh mtime so the
policy is LRU-ish across processes) and ``ttl_seconds`` expires idle
artifacts.  A sweep runs opportunistically every ``sweep_interval``
writes — ``<outdir>/.leo_cache`` no longer grows without bound.

Writes are atomic (tmp file + ``os.replace``), so concurrent writers on
the same key are safe: last writer wins with an intact artifact either
way.

Multi-process serving (``repro.serve.pool``) shares one cache root
across N forked workers, which adds two cross-process obligations:

  * sweeps coordinate through an advisory ``flock`` on
    ``<root>/.sweep.lock`` so only one *process* compacts at a time —
    an opportunistic sweep that finds the file lock held skips, exactly
    like the in-process non-blocking path;
  * the mtime scan and the tmp-file publish tolerate a concurrently
    exiting/clearing process: paths that vanish between listing and
    ``stat`` are skipped, and a ``mkstemp`` whose parent directory was
    just removed recreates it and retries once.
"""
from __future__ import annotations

import gzip
import json
import os
import pickle
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, List, MutableMapping, \
    Optional, Tuple

try:                # POSIX only; on other platforms sweeps fall back to
    import fcntl    # in-process coordination (the threading lock).
except ImportError:             # pragma: no cover - non-POSIX
    fcntl = None  # type: ignore[assignment]

#: Bump when the pickled Module layout changes incompatibly; stale
#: artifacts are treated as misses, never as errors.
MODULE_ARTIFACT_FORMAT = 1


class LRUCache(MutableMapping):
    """Bounded mapping with LRU eviction and an eviction counter.

    ``capacity=None`` disables eviction (legacy unbounded behavior);
    ``on_evict(key, value)`` lets the owner drop secondary indexes that
    reference the evicted entry.
    """

    def __init__(self, capacity: Optional[int] = None,
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"LRU capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.evictions = 0
        self._on_evict = on_evict
        self._data: "OrderedDict[Any, Any]" = OrderedDict()

    def __getitem__(self, key: Any) -> Any:
        value = self._data[key]          # KeyError propagates
        self._data.move_to_end(key)
        return value

    def __setitem__(self, key: Any, value: Any) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while self.capacity is not None and len(self._data) > self.capacity:
            old_key, old_value = self._data.popitem(last=False)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(old_key, old_value)

    def __delitem__(self, key: Any) -> None:
        del self._data[key]

    def __iter__(self) -> Iterator[Any]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Any) -> bool:
        return key in self._data

    def __repr__(self) -> str:
        cap = "inf" if self.capacity is None else self.capacity
        return (f"LRUCache({len(self._data)}/{cap}, "
                f"evictions={self.evictions})")


class DiskCacheStats:
    """Hit/miss/write counters for the on-disk tier (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.module_hits = 0
        self.module_misses = 0
        self.diagnosis_hits = 0
        self.diagnosis_misses = 0
        self.writes = 0
        self.sweeps = 0
        self.evictions = 0          # artifacts removed by cap or TTL
        self.bytes_evicted = 0

    def bump(self, field: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def as_dict(self) -> Dict[str, int]:
        return {
            "module_hits": self.module_hits,
            "module_misses": self.module_misses,
            "diagnosis_hits": self.diagnosis_hits,
            "diagnosis_misses": self.diagnosis_misses,
            "writes": self.writes,
            "sweeps": self.sweeps,
            "evictions": self.evictions,
            "bytes_evicted": self.bytes_evicted,
        }


class DiskCache:
    """Content-addressed artifact store: ``<root>/<kind>/<k[:2]>/<k>.gz``.

    Keys are sha256 hex digests computed by the caller (the session's
    ``module_key`` / the service's diagnosis key), so identical content
    always lands on the same path regardless of which process wrote it.
    Corrupt or format-incompatible artifacts read as misses.

    ``max_bytes`` / ``ttl_seconds`` bound the tier: a sweep (every
    ``sweep_interval`` writes, or on explicit :meth:`sweep`) first drops
    artifacts idle longer than the TTL, then removes oldest-accessed
    artifacts until the total size fits the cap.  Hits refresh the
    artifact mtime (best-effort), so eviction order approximates LRU even
    across processes.
    """

    def __init__(self, root: str, max_bytes: Optional[int] = None,
                 ttl_seconds: Optional[float] = None,
                 sweep_interval: int = 64):
        self.root = os.path.abspath(root)
        self.max_bytes = max_bytes
        self.ttl_seconds = ttl_seconds
        self.sweep_interval = max(1, sweep_interval)
        self.stats = DiskCacheStats()
        # _counter_lock guards only the cheap write counter; _sweep_lock
        # serializes sweeps.  Writers never block behind a running sweep —
        # they bump the counter and move on (a due sweep that finds the
        # lock taken is simply skipped; the next due write retries).
        self._counter_lock = threading.Lock()
        self._sweep_lock = threading.Lock()
        self._writes_since_sweep = 0
        # Cross-process sweep coordination: advisory flock on a lockfile
        # at the cache root (see module docstring).
        self._sweep_lock_path = os.path.join(self.root, ".sweep.lock")

    def _path(self, kind: str, key: str, ext: str) -> str:
        return os.path.join(self.root, kind, key[:2], f"{key}{ext}")

    @staticmethod
    def _touch(path: str) -> None:
        try:
            os.utime(path, None)
        except OSError:
            pass

    def _sweep_file_lock(self, blocking: bool) -> Optional[int]:
        """Acquire the cross-process sweep lock.  Returns an fd to pass
        to :meth:`_sweep_file_unlock`, ``-1`` when flock is unavailable
        (non-POSIX: proceed, in-process lock already held), or ``None``
        when non-blocking and another process holds it."""
        if fcntl is None:               # pragma: no cover - non-POSIX
            return -1
        try:
            os.makedirs(self.root, exist_ok=True)
            fd = os.open(self._sweep_lock_path,
                         os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            return -1   # can't create the lockfile: sweep uncoordinated
        flags = fcntl.LOCK_EX if blocking else fcntl.LOCK_EX | fcntl.LOCK_NB
        try:
            fcntl.flock(fd, flags)
        except OSError:
            os.close(fd)
            return None
        return fd

    @staticmethod
    def _sweep_file_unlock(fd: Optional[int]) -> None:
        if fd is None or fd < 0:
            return
        try:
            os.close(fd)    # closing the fd releases the flock
        except OSError:     # pragma: no cover - close on valid fd
            pass

    def _write_atomic(self, path: str, payload: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       suffix=".tmp")
        except FileNotFoundError:
            # A concurrent clear()/eviction removed the freshly created
            # directory; recreate and retry once.
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.stats.bump("writes")
        if self.max_bytes is None and self.ttl_seconds is None:
            return
        with self._counter_lock:
            self._writes_since_sweep += 1
            due = self._writes_since_sweep >= self.sweep_interval
            if due:
                self._writes_since_sweep = 0
        if due:
            self.sweep(blocking=False)

    # -- parsed modules (gzipped pickle) ---------------------------------------

    def load_module(self, key: str):
        path = self._path("modules", key, ".pkl.gz")
        try:
            with gzip.open(path, "rb") as f:
                payload = pickle.load(f)
            if payload.get("format") != MODULE_ARTIFACT_FORMAT:
                raise ValueError("stale module artifact format")
            module = payload["module"]
        except (OSError, ValueError, KeyError, EOFError,
                pickle.UnpicklingError, AttributeError):
            self.stats.bump("module_misses")
            return None
        self.stats.bump("module_hits")
        self._touch(path)   # refresh LRU position for the sweeper
        return module

    def store_module(self, key: str, module: Any) -> None:
        payload = pickle.dumps(
            {"format": MODULE_ARTIFACT_FORMAT, "module": module},
            protocol=pickle.HIGHEST_PROTOCOL)
        self._write_atomic(self._path("modules", key, ".pkl.gz"),
                           gzip.compress(payload))

    # -- diagnoses (gzipped JSON) ----------------------------------------------

    def load_diagnosis(self, key: str):
        from .report import Diagnosis
        path = self._path("diagnoses", key, ".json.gz")
        try:
            with gzip.open(path, "rt", encoding="utf-8") as f:
                data = json.load(f)
            # from_dict migrates any supported older schema generation
            # forward (e.g. v1 payloads gain an explicit "not recorded"
            # sync_resources default) and rejects unknown generations.
            diag = Diagnosis.from_dict(data)
        except (OSError, ValueError, KeyError, TypeError):
            self.stats.bump("diagnosis_misses")
            return None
        self.stats.bump("diagnosis_hits")
        self._touch(path)
        return diag

    def store_diagnosis(self, key: str, diagnosis: Any) -> None:
        self._write_atomic(
            self._path("diagnoses", key, ".json.gz"),
            gzip.compress(diagnosis.to_json().encode("utf-8")))

    # -- maintenance -----------------------------------------------------------

    def _artifacts(self) -> List[Tuple[float, int, str]]:
        """(mtime, size, path) for every stored artifact."""
        out: List[Tuple[float, int, str]] = []
        for kind in ("modules", "diagnoses"):
            base = os.path.join(self.root, kind)
            for dirpath, _, files in os.walk(base):
                for name in files:
                    if not name.endswith(".gz"):
                        continue
                    path = os.path.join(dirpath, name)
                    try:
                        st = os.stat(path)
                    except FileNotFoundError:
                        # A concurrently-exiting process (its final
                        # flush-sweep, or a clear()) unlinked the path
                        # between listing and stat: skip and continue.
                        continue
                    except OSError:
                        continue
                    out.append((st.st_mtime, st.st_size, path))
        return out

    def _evict(self, path: str, size: int) -> bool:
        try:
            os.unlink(path)
        except OSError:
            return False
        self.stats.bump("evictions")
        self.stats.bump("bytes_evicted", size)
        return True

    def total_bytes(self) -> int:
        return sum(size for _, size, _ in self._artifacts())

    def sweep(self, now: Optional[float] = None,
              blocking: bool = True) -> Dict[str, int]:
        """TTL-expire idle artifacts, then enforce the size cap
        oldest-accessed first.  Safe to call concurrently / cross-process:
        a racing unlink simply counts as someone else's eviction.  With
        ``blocking=False`` (the opportunistic write-path mode), a sweep
        already in progress — in this process (threading lock) or in any
        other process sharing the root (``.sweep.lock`` flock) — is
        skipped instead of waited on, so only one worker compacts."""
        if self.max_bytes is None and self.ttl_seconds is None:
            return {"evicted": 0, "bytes_freed": 0}
        if not self._sweep_lock.acquire(blocking=blocking):
            return {"evicted": 0, "bytes_freed": 0, "skipped": 1}
        lock_fd = self._sweep_file_lock(blocking)
        if lock_fd is None:
            self._sweep_lock.release()
            return {"evicted": 0, "bytes_freed": 0, "skipped": 1}
        now = time.time() if now is None else now
        evicted = freed = 0
        try:
            self.stats.bump("sweeps")
            artifacts = sorted(self._artifacts())   # oldest mtime first
            if self.ttl_seconds is not None:
                cutoff = now - self.ttl_seconds
                keep: List[Tuple[float, int, str]] = []
                for mtime, size, path in artifacts:
                    if mtime < cutoff and self._evict(path, size):
                        evicted += 1
                        freed += size
                    else:
                        keep.append((mtime, size, path))
                artifacts = keep
            if self.max_bytes is not None:
                total = sum(size for _, size, _ in artifacts)
                for mtime, size, path in artifacts:
                    if total <= self.max_bytes:
                        break
                    if self._evict(path, size):
                        evicted += 1
                        freed += size
                        total -= size
        finally:
            self._sweep_file_unlock(lock_fd)
            self._sweep_lock.release()
        return {"evicted": evicted, "bytes_freed": freed}

    def flush(self) -> Dict[str, int]:
        """Final blocking sweep — the graceful-drain hook.  Waits for any
        in-progress opportunistic sweep, then enforces TTL + size bounds
        so a terminating server leaves the on-disk tier within budget."""
        return self.sweep(blocking=True)

    def clear(self) -> None:
        import shutil
        for kind in ("modules", "diagnoses"):
            shutil.rmtree(os.path.join(self.root, kind), ignore_errors=True)

    def __repr__(self) -> str:
        return f"DiskCache({self.root!r}, {self.stats.as_dict()})"
