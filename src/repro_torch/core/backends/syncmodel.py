"""First-class vendor synchronization resources (paper §III-E).

The paper's central observation is that stall root causes hinge on
*vendor-specific* synchronization mechanisms backed by **finite hardware
resources**: NVIDIA exposes six named barriers B1-B6, AMD drains
``s_waitcnt`` memory counters (vmcnt/lgkmcnt), Intel allocates SWSB
scoreboard IDs $0..$15.  A kernel that keeps more transfers in flight than
the part has resources *serializes* — the hardware reuses the oldest
in-flight resource, and the reusing instruction inherits its latency (the
oldest-(M-N) rule §III-E).

This module makes those resources behavioral:

* :class:`SyncResourcePool` — one finite, *named* set of physical resource
  instances (``B1..B6``, ``vmcnt``/``lgkmcnt``, ``$0..$15``);
* :class:`SyncModel` — a backend's immutable descriptor: its pools plus a
  routing table mapping each abstract :class:`~repro.core.isa.SyncKind`
  (what the unified IR records) onto the pool that physically implements
  it on this vendor.  Async-copy barriers ride named barriers on
  NVIDIA-class parts, waitcnt counters on AMD-class parts, and SBID
  tokens on Intel-class parts — which is exactly why the same kernel
  blames differently per vendor;
* :class:`SyncScoreboard` — the *stateful* allocator the virtual sampler
  drives: ``acquire`` claims an instance (serializing against the oldest
  holder when the pool is exhausted), ``complete`` records when the
  underlying transfer lands, ``retire`` returns the instance.  It never
  exceeds capacity and a full allocate→retire round-trip drains to empty
  (property-tested in ``tests/test_syncmodel.py``);
* :class:`SyncPressureReport` — the JSON-pure per-pool pressure summary
  that flows into ``LeoAnalysis.sync_pressure`` and the ``Diagnosis``
  ``sync_resources`` section ("barrier slots 6/6 in flight at peak").

:class:`SyncSemantics` — the pre-SyncModel knob bag whose counts nothing
read — survives as a parity-tested deprecation shim: constructing one
warns and any :class:`~repro.core.backends.Backend` built with it is
converted via :meth:`SyncSemantics.to_model`.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ..isa import SyncKind

#: Contention events retained per pool (bounds report size on pathological
#: programs; the counters keep aggregating past the cap).
_MAX_EVENTS_PER_POOL = 64


# --------------------------------------------------------------------------
# Descriptors (immutable).
# --------------------------------------------------------------------------

#: Valid sync-resource pool scopes (see :class:`SyncResourcePool.scope`).
POOL_SCOPES: Tuple[str, ...] = ("device", "queue")


@dataclass(frozen=True)
class SyncResourcePool:
    """A finite, named set of physical sync-resource instances.

    ``scope`` says how the pool replicates under a multi-queue issue model
    (:class:`~repro.core.hwmodel.IssueModel`):

    * ``"device"`` — one physical pool shared by every issue queue.  This
      is NVIDIA's named barriers (CTA-scoped: all four warp schedulers of
      an SM allocate from the same B1-B6) and the TPU pools (per-core
      resources behind a single VLIW stream).
    * ``"queue"``  — each issue queue owns a private copy of the pool.
      This is AMD's ``s_waitcnt`` counters (architecturally per-wave:
      every wave slot tracks its own vmcnt/lgkmcnt) and Intel's SWSB
      scoreboard IDs (per-thread).

    With a single issue queue the distinction vanishes — both scopes
    behave as one pool, which is what keeps K=1 profiles byte-identical
    to the pre-multi-stream sampler.
    """

    name: str                   # registry key, e.g. "named_barrier"
    kind: SyncKind              # native mechanism this pool implements
    label: str                  # human label, e.g. "named barriers B1-B6"
    instances: Tuple[str, ...]  # concrete instance names; len == capacity
    scope: str = "device"       # "device" (shared) | "queue" (per-queue)

    def __post_init__(self) -> None:
        if not self.instances:
            raise ValueError(f"pool {self.name!r} needs >= 1 instance")
        if len(set(self.instances)) != len(self.instances):
            raise ValueError(f"pool {self.name!r} has duplicate instances")
        if self.scope not in POOL_SCOPES:
            raise ValueError(f"pool {self.name!r} scope {self.scope!r} not "
                             f"in {POOL_SCOPES}")

    @property
    def capacity(self) -> int:
        return len(self.instances)

    @classmethod
    def counted(cls, name: str, kind: SyncKind, label: str, prefix: str,
                capacity: int, start: int = 0,
                scope: str = "device") -> "SyncResourcePool":
        return cls(name=name, kind=kind, label=label,
                   instances=tuple(f"{prefix}{i}"
                                   for i in range(start, start + capacity)),
                   scope=scope)


@dataclass(frozen=True)
class SyncModel:
    """A backend's synchronization-resource descriptor.

    ``routing`` maps each abstract mechanism the unified IR can record
    (async-pair BARRIER, DMA-counter WAITCNT, token-threading TOKEN) onto
    the pool that physically backs it on this vendor.  Kinds left out of
    the routing fall back to the first declared pool (emulation).
    ``scoreboard()`` mints a fresh stateful allocator.
    """

    pools: Tuple[SyncResourcePool, ...] = ()
    routing: Tuple[Tuple[SyncKind, str], ...] = ()
    async_collectives: bool = True

    def __post_init__(self) -> None:
        # accept a Mapping for ergonomic construction; store a sorted
        # tuple so repr/fingerprints are deterministic
        routing = self.routing
        if isinstance(routing, Mapping):
            routing = tuple(sorted(routing.items(), key=lambda kv: kv[0].value))
        object.__setattr__(self, "routing", tuple(routing))
        names = [p.name for p in self.pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names: {names}")
        for _, pname in self.routing:
            if pname not in names:
                raise ValueError(
                    f"routing targets unknown pool {pname!r}; have {names}")

    # -- lookups ---------------------------------------------------------------

    def pool(self, name: str) -> SyncResourcePool:
        for p in self.pools:
            if p.name == name:
                return p
        raise KeyError(f"no pool named {name!r}")

    def pool_for(self, kind: SyncKind) -> Optional[SyncResourcePool]:
        """The pool physically backing `kind` (first pool when unrouted)."""
        for k, pname in self.routing:
            if k is kind:
                return self.pool(pname)
        return self.pools[0] if self.pools else None

    def serves(self, pool_name: str) -> Tuple[SyncKind, ...]:
        """Which abstract kinds route onto `pool_name`."""
        return tuple(k for k, p in self.routing if p == pool_name)

    # -- legacy knob views (SyncSemantics compatibility) -----------------------

    def _capacity_of_kind(self, kind: SyncKind) -> int:
        return sum(p.capacity for p in self.pools if p.kind is kind)

    @property
    def barrier_slots(self) -> int:
        return self._capacity_of_kind(SyncKind.BARRIER)

    @property
    def waitcnt_counters(self) -> int:
        return self._capacity_of_kind(SyncKind.WAITCNT)

    @property
    def swsb_tokens(self) -> int:
        return self._capacity_of_kind(SyncKind.TOKEN)

    @property
    def mechanisms(self) -> Tuple[SyncKind, ...]:
        seen: List[SyncKind] = []
        for p in self.pools:
            if p.kind not in seen:
                seen.append(p.kind)
        return tuple(seen)

    # -- factories -------------------------------------------------------------

    def scoreboard(self, realloc_cycles: float = 0.0,
                   queues: int = 1, waves: int = 1) -> "SyncScoreboard":
        """Mint a stateful allocator; ``queues`` > 1 replicates every
        ``scope="queue"`` pool per issue queue (ROADMAP's "one scoreboard
        per simulated core/queue") while ``scope="device"`` pools stay
        shared.  ``waves`` > 1 gives the simulated wave its fair share of
        every ``scope="device"`` pool (W symmetric co-resident waves
        contend for the same physical instances), while ``scope="queue"``
        pools stay per-wave private — the per-wave scoreboard view."""
        return SyncScoreboard(self, realloc_cycles=realloc_cycles,
                              queues=queues, waves=waves)

    @classmethod
    def from_semantics(cls, sem: "SyncSemantics") -> "SyncModel":
        return _model_from_knobs(sem.mechanisms, sem.barrier_slots,
                                 sem.waitcnt_counters, sem.swsb_tokens,
                                 sem.async_collectives)


#: AMD-style counter names used when synthesizing waitcnt pools from knobs.
_WAITCNT_NAMES = ("vmcnt", "lgkmcnt", "expcnt")


def _model_from_knobs(mechanisms: Sequence[SyncKind], barrier_slots: int,
                      waitcnt_counters: int, swsb_tokens: int,
                      async_collectives: bool) -> SyncModel:
    """Build a SyncModel from legacy SyncSemantics knob values."""
    pools: List[SyncResourcePool] = []
    if barrier_slots > 0:
        pools.append(SyncResourcePool.counted(
            "named_barrier", SyncKind.BARRIER,
            f"named barriers B1-B{barrier_slots}", "B", barrier_slots,
            start=1))
    if waitcnt_counters > 0:
        names = (_WAITCNT_NAMES[:waitcnt_counters]
                 + tuple(f"cnt{i}" for i in range(len(_WAITCNT_NAMES),
                                                  waitcnt_counters)))
        pools.append(SyncResourcePool(
            name="waitcnt_counter", kind=SyncKind.WAITCNT,
            label="s_waitcnt-style outstanding-op counters",
            instances=tuple(names)))
    if swsb_tokens > 0:
        pools.append(SyncResourcePool.counted(
            "swsb_token", SyncKind.TOKEN,
            f"SWSB scoreboard IDs $0-${swsb_tokens - 1}", "$", swsb_tokens))
    by_kind = {p.kind: p.name for p in pools}
    primary: Optional[str] = None
    for m in mechanisms:
        if m in by_kind:
            primary = by_kind[m]
            break
    if primary is None and pools:
        primary = pools[0].name
    routing: Dict[SyncKind, str] = {}
    for kind in (SyncKind.BARRIER, SyncKind.WAITCNT, SyncKind.TOKEN):
        target = by_kind.get(kind) if kind in mechanisms else None
        target = target or primary
        if target is not None:
            routing[kind] = target
    return SyncModel(pools=tuple(pools), routing=routing,
                     async_collectives=async_collectives)


# --------------------------------------------------------------------------
# Deprecated knob bag (parity-tested shim).
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SyncSemantics:
    """Deprecated: inert sync knobs.  Use :class:`SyncModel` instead.

    Kept as a parity-tested shim (like ``analyze_module`` and
    ``structured_report`` before it): constructing one warns, and a
    :class:`~repro.core.backends.Backend` handed a ``SyncSemantics``
    transparently converts it via :meth:`to_model` — the resulting
    scoreboard behaves identically to the equivalent hand-built model
    (``tests/test_syncmodel.py::TestSyncSemanticsShim``).
    """

    mechanisms: Tuple[SyncKind, ...] = (SyncKind.BARRIER, SyncKind.WAITCNT,
                                        SyncKind.TOKEN)
    barrier_slots: int = 6        # named-barrier resources (NVIDIA: B1..B6)
    waitcnt_counters: int = 2     # outstanding-op counters (AMD: vmcnt/lgkmcnt)
    swsb_tokens: int = 16         # scoreboard token IDs (Intel SWSB: $0..$15)
    async_collectives: bool = True

    def __post_init__(self) -> None:
        warnings.warn(
            "SyncSemantics is deprecated; build a SyncModel (finite, "
            "behavioral sync resources) instead — see docs/sync_resources.md "
            "(shim slated for removal two releases after the SyncModel API "
            "landed)", DeprecationWarning, stacklevel=3)

    def to_model(self) -> SyncModel:
        return SyncModel.from_semantics(self)


SyncLike = Union[SyncModel, SyncSemantics]


def resolve_sync_model(sync: Optional[SyncLike]) -> SyncModel:
    """Coerce a SyncModel / legacy SyncSemantics / None to a SyncModel."""
    if sync is None:
        return DEFAULT_SYNC_MODEL
    if isinstance(sync, SyncModel):
        return sync
    if isinstance(sync, SyncSemantics):
        return sync.to_model()
    raise TypeError(f"cannot resolve a SyncModel from {type(sync).__name__}")


#: Default model for backends that do not declare one: all three mechanisms
#: natively, with the legacy default capacities.
DEFAULT_SYNC_MODEL = _model_from_knobs(
    (SyncKind.BARRIER, SyncKind.WAITCNT, SyncKind.TOKEN),
    barrier_slots=6, waitcnt_counters=2, swsb_tokens=16,
    async_collectives=True)


# --------------------------------------------------------------------------
# Stateful scoreboard.
# --------------------------------------------------------------------------

@dataclass
class SyncAcquire:
    """Result of one scoreboard acquisition."""

    pool: str
    kind: SyncKind
    tag: str
    instance: str
    available_at: float = 0.0        # when the instance can actually be used
    stall_cycles: float = 0.0        # serialization charged to the acquirer
    evicted_tag: Optional[str] = None
    evicted_holder: Optional[str] = None   # qualified instr that held it


@dataclass
class _Alloc:
    tag: str
    instance: str
    holder: str          # qualified name of the acquiring instruction
    busy_until: float    # completion time of the underlying transfer
    count: int = 1       # outstanding ops sharing this instance (counters)


class _PoolBoard:
    """Allocator state for one pool: never exceeds capacity; exhaustion
    serializes against the oldest in-flight allocation (§III-E)."""

    def __init__(self, spec: SyncResourcePool, realloc_cycles: float = 0.0,
                 queue: Optional[int] = None):
        self.spec = spec
        self.realloc_cycles = realloc_cycles
        self.queue = queue     # replica index when the pool is queue-scoped
        self._free: List[str] = list(spec.instances)
        self._live: "OrderedDict[str, _Alloc]" = OrderedDict()
        self.acquisitions = 0
        self.evictions = 0
        self.peak_in_flight = 0
        self.contention_cycles = 0.0
        self.events: List[Dict[str, Any]] = []

    @property
    def in_flight(self) -> int:
        return len(self._live)

    def acquire(self, kind: SyncKind, tag: str, consumer: str, now: float,
                weight: float) -> SyncAcquire:
        self.acquisitions += 1
        live = self._live.get(tag)
        if live is not None:
            # same identifier re-armed while in flight: a counter-style
            # increment on the same physical instance (free)
            live.count += 1
            return SyncAcquire(pool=self.spec.name, kind=kind, tag=tag,
                               instance=live.instance, available_at=now)
        if self._free:
            instance = self._free.pop(0)
            self._live[tag] = _Alloc(tag=tag, instance=instance,
                                     holder=consumer, busy_until=now)
            self.peak_in_flight = max(self.peak_in_flight, len(self._live))
            return SyncAcquire(pool=self.spec.name, kind=kind, tag=tag,
                               instance=instance, available_at=now)
        # Exhausted: reuse the OLDEST in-flight instance; the acquirer
        # inherits its remaining latency, plus the hardware recycle cost
        # (drain/re-arm) that every reuse pays even when the holder's
        # transfer already landed.
        old_tag, old = self._live.popitem(last=False)
        stall = max(0.0, old.busy_until - now) + self.realloc_cycles
        self.evictions += 1
        if stall > 0:
            self.contention_cycles += stall * weight
            if len(self.events) < _MAX_EVENTS_PER_POOL:
                ev = {
                    "consumer": consumer, "instance": old.instance,
                    "holder": old.holder, "evicted_tag": old_tag,
                    "stall_cycles": stall, "at": now, "weight": weight,
                }
                if self.queue is not None:
                    ev["queue"] = self.queue
                self.events.append(ev)
        self._live[tag] = _Alloc(tag=tag, instance=old.instance,
                                 holder=consumer, busy_until=now + stall)
        self.peak_in_flight = max(self.peak_in_flight, len(self._live))
        return SyncAcquire(pool=self.spec.name, kind=kind, tag=tag,
                           instance=old.instance, available_at=now + stall,
                           stall_cycles=stall, evicted_tag=old_tag,
                           evicted_holder=old.holder)

    def complete(self, tag: str, t: float) -> None:
        live = self._live.get(tag)
        if live is not None:
            live.busy_until = max(live.busy_until, t)

    def retire(self, tag: str, drain_to: Optional[int] = None) -> bool:
        live = self._live.get(tag)
        if live is None:
            return False
        if drain_to is None:
            live.count -= 1
        else:
            live.count = min(live.count, max(0, drain_to))
        if live.count <= 0:
            del self._live[tag]
            self._free.append(live.instance)
        return True

    def fork(self) -> "_PoolBoard":
        """Copy the mutable allocator state; the spec is shared."""
        clone = _PoolBoard(self.spec, self.realloc_cycles, queue=self.queue)
        clone._free = list(self._free)
        clone._live = OrderedDict(
            (tag, _Alloc(tag=a.tag, instance=a.instance, holder=a.holder,
                         busy_until=a.busy_until, count=a.count))
            for tag, a in self._live.items())
        clone.acquisitions = self.acquisitions
        clone.evictions = self.evictions
        clone.peak_in_flight = self.peak_in_flight
        clone.contention_cycles = self.contention_cycles
        clone.events = [dict(e) for e in self.events]
        return clone

    def snapshot(self, serves: Tuple[SyncKind, ...]) -> Dict[str, Any]:
        return {
            "pool": self.spec.name,
            "kind": self.spec.kind.value,
            "label": self.spec.label,
            "capacity": self.spec.capacity,
            "instances": list(self.spec.instances),
            "serves": [k.value for k in serves],
            "acquisitions": self.acquisitions,
            "peak_in_flight": self.peak_in_flight,
            "in_flight_at_end": self.in_flight,
            "evictions": self.evictions,
            "contention_cycles": self.contention_cycles,
            "events": list(self.events),
        }


class SyncScoreboard:
    """Stateful allocator over every pool of one :class:`SyncModel`.

    One scoreboard per simulated device; with ``queues > 1`` every
    ``scope="queue"`` pool is replicated per issue queue (ROADMAP's "one
    scoreboard per simulated core/queue") — its instances are exposed as
    ``q<i>:<name>`` — while ``scope="device"`` pools keep a single board
    every queue allocates from.  All methods take the *abstract* kind
    recorded in the IR; routing picks the physical pool, and ``queue``
    picks the replica (ignored for device-scoped pools).  Tags are
    namespaced by kind so barrier and token identifiers sharing a pool
    cannot collide; a live tag is always found on whichever replica holds
    it, so counter-style re-arms land on their original board regardless
    of the issuing queue.
    """

    def __init__(self, model: SyncModel, realloc_cycles: float = 0.0,
                 queues: int = 1, waves: int = 1):
        if queues < 1:
            raise ValueError(f"queues must be >= 1, got {queues}")
        if waves < 1:
            raise ValueError(f"waves must be >= 1, got {waves}")
        self.model = model
        self.realloc_cycles = realloc_cycles
        self.queues = queues
        self.waves = waves
        self._boards: Dict[str, List[_PoolBoard]] = {}
        for p in model.pools:
            if p.scope == "device" and waves > 1:
                # W symmetric co-resident waves share a device-scoped pool;
                # the simulated wave sees its fair share of the instances
                # (floored at one) — raising occupancy RAISES barrier-style
                # pressure, the cross-vendor tradeoff §III-E predicts.
                share = max(1, p.capacity // waves)
                p = _dc_replace(p, instances=p.instances[:share])
            if p.scope == "queue" and queues > 1:
                self._boards[p.name] = [
                    _PoolBoard(_dc_replace(p, instances=tuple(
                        f"q{i}:{inst}" for inst in p.instances)),
                        realloc_cycles, queue=i)
                    for i in range(queues)]
            else:
                self._boards[p.name] = [_PoolBoard(p, realloc_cycles)]

    def _pool_boards(self, kind: SyncKind) -> Optional[List[_PoolBoard]]:
        pool = self.model.pool_for(kind)
        return self._boards[pool.name] if pool is not None else None

    @staticmethod
    def _key(kind: SyncKind, tag: str) -> str:
        return f"{kind.value}:{tag}"

    @staticmethod
    def _holding(boards: List[_PoolBoard], key: str) -> Optional[_PoolBoard]:
        for b in boards:
            if key in b._live:
                return b
        return None

    # -- allocation lifecycle --------------------------------------------------

    def acquire(self, kind: SyncKind, tag: str, consumer: str = "",
                now: float = 0.0, weight: float = 1.0,
                queue: int = 0) -> Optional[SyncAcquire]:
        boards = self._pool_boards(kind)
        if boards is None:
            return None
        key = self._key(kind, tag)
        # a live tag re-armed from another queue is a counter increment on
        # the replica that holds it, not a fresh allocation elsewhere
        board = self._holding(boards, key) or boards[queue % len(boards)]
        return board.acquire(kind, key, consumer, now, weight)

    def complete(self, kind: SyncKind, tag: str, t: float) -> None:
        boards = self._pool_boards(kind)
        if boards is None:
            return
        board = self._holding(boards, self._key(kind, tag))
        if board is not None:
            board.complete(self._key(kind, tag), t)

    def retire(self, kind: SyncKind, tag: str,
               drain_to: Optional[int] = None) -> bool:
        boards = self._pool_boards(kind)
        if boards is None:
            return False
        board = self._holding(boards, self._key(kind, tag))
        if board is None:
            return False
        return board.retire(self._key(kind, tag), drain_to=drain_to)

    # -- introspection ---------------------------------------------------------

    def in_flight(self, kind: SyncKind, queue: Optional[int] = None) -> int:
        boards = self._pool_boards(kind)
        if boards is None:
            return 0
        if queue is not None and len(boards) > 1:
            return boards[queue % len(boards)].in_flight
        return sum(b.in_flight for b in boards)

    def peak(self, kind: SyncKind) -> int:
        boards = self._pool_boards(kind)
        return max((b.peak_in_flight for b in boards), default=0) \
            if boards is not None else 0

    @property
    def total_in_flight(self) -> int:
        return sum(b.in_flight for boards in self._boards.values()
                   for b in boards)

    def fork(self) -> "SyncScoreboard":
        """Independent copy of the mutable allocator state, sharing the
        immutable model (the sampler's while-loop warm-up pass must not
        pollute steady-state pressure stats)."""
        clone = SyncScoreboard.__new__(SyncScoreboard)
        clone.model = self.model
        clone.realloc_cycles = self.realloc_cycles
        clone.queues = self.queues
        clone.waves = self.waves
        clone._boards = {name: [b.fork() for b in boards]
                         for name, boards in self._boards.items()}
        return clone

    def report(self) -> "SyncPressureReport":
        return SyncPressureReport(pools=[
            self._pool_snapshot(p) for p in self.model.pools])

    def _pool_snapshot(self, pool: SyncResourcePool) -> Dict[str, Any]:
        boards = self._boards[pool.name]
        serves = self.model.serves(pool.name)
        if len(boards) == 1:
            snap = boards[0].snapshot(serves)
            snap["scope"] = pool.scope
            snap["queues"] = 1
            return snap
        # merge per-queue replicas: capacity stays the per-queue capacity
        # (the §III-E oversubscription threshold a single stream sees),
        # instances carry the q<i>: prefix, counters aggregate, and the
        # per_queue breakdown preserves each replica's pressure.
        snaps = [b.snapshot(serves) for b in boards]
        # Every per-board field must be merged explicitly below (sum, max,
        # or concat is a semantic choice a generic fold cannot make);
        # fail loudly if _PoolBoard.snapshot grows a field this merge
        # doesn't know, instead of silently dropping it from multi-queue
        # reports only.
        unmerged = set(snaps[0]) - {
            "pool", "kind", "label", "capacity", "instances", "serves",
            "acquisitions", "peak_in_flight", "in_flight_at_end",
            "evictions", "contention_cycles", "events"}
        if unmerged:
            raise AssertionError(
                f"_PoolBoard.snapshot grew fields {sorted(unmerged)} that "
                f"the multi-queue merge does not aggregate; extend "
                f"SyncScoreboard._pool_snapshot")
        merged: Dict[str, Any] = {
            "pool": pool.name,
            "kind": pool.kind.value,
            "label": pool.label,
            "capacity": pool.capacity,
            "instances": [i for s in snaps for i in s["instances"]],
            "serves": [k.value for k in serves],
            "acquisitions": sum(s["acquisitions"] for s in snaps),
            "peak_in_flight": max(s["peak_in_flight"] for s in snaps),
            "in_flight_at_end": sum(s["in_flight_at_end"] for s in snaps),
            "evictions": sum(s["evictions"] for s in snaps),
            "contention_cycles": sum(s["contention_cycles"] for s in snaps),
            "events": [e for s in snaps for e in s["events"]],
            "scope": pool.scope,
            "queues": len(boards),
            "per_queue": [{
                "queue": i,
                "acquisitions": s["acquisitions"],
                "peak_in_flight": s["peak_in_flight"],
                "evictions": s["evictions"],
                "contention_cycles": s["contention_cycles"],
            } for i, s in enumerate(snaps)],
        }
        merged["events"].sort(key=lambda e: (e.get("at", 0.0),
                                             e.get("consumer", "")))
        return merged


# --------------------------------------------------------------------------
# Pressure report (JSON-pure).
# --------------------------------------------------------------------------

@dataclass
class SyncPressureReport:
    """Per-pool pressure stats; every value is a plain JSON type so the
    report embeds directly into the ``Diagnosis`` schema."""

    pools: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def contended(self) -> bool:
        return any(p.get("contention_cycles", 0.0) > 0 for p in self.pools)

    @property
    def total_contention_cycles(self) -> float:
        return sum(p.get("contention_cycles", 0.0) for p in self.pools)

    def pool(self, name: str) -> Optional[Dict[str, Any]]:
        for p in self.pools:
            if p.get("pool") == name:
                return p
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {"contended": self.contended,
                "contention_cycles": self.total_contention_cycles,
                "pools": self.pools}


__all__ = [
    "DEFAULT_SYNC_MODEL", "SyncAcquire", "SyncModel", "SyncPressureReport",
    "SyncResourcePool", "SyncScoreboard", "SyncSemantics", "SyncLike",
    "resolve_sync_model",
]
