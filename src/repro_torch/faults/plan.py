"""Deterministic, seeded fault injection for the PMV pipeline (this package's
own copy of the JAX package's ``repro.faults.plan``: the same names, events
and semantics, so one plan and seed inject the same faults in both).

A :class:`FaultPlan` is a *schedule* of fault events -- shard corruption on
a fetch, a transient ``IOError``, a slow (straggler) fetch, a broken
prefetch thread, a process kill at an iteration boundary -- built either
explicitly or pseudo-randomly from a seed (:meth:`FaultPlan.random`).  The
plan is immutable; running it takes a :class:`FaultInjector`
(``plan.build(obs)``), which tracks which events have fired.  Every event is
one-shot: once consumed it never fires again, which is what makes a plan
*recoverable* -- a corrupted fetch fails checksum verification, the
executor re-fetches, and the second read is clean.

The contract: a run under a recoverable plan gives results bitwise equal to
the fault-free run, every injected fault shows in the obs metrics
(``fault.injected`` / ``fault.injected.<kind>``), and retries stay within
the :class:`repro_torch.faults.RetryPolicy` budget.

Injection sites:

- ``DiskBlockStore.fetch`` calls :meth:`FaultInjector.on_fetch` (may raise
  :class:`InjectedIOError` or sleep) and, on the host arrays the slice was
  read into, :meth:`FaultInjector.corrupt_slice` (may flip one byte, before
  checksum verification).
- ``PrefetchPipeline`` consumes a :class:`BreakPrefetch` when it is built
  and then fetches synchronously for its lifetime.
- ``PMVEngine.run`` calls :meth:`FaultInjector.on_iteration` at the top of
  every iteration (may raise :class:`InjectedKill`, a crash after the last
  completed checkpoint).

The injector is shared engine-wide and server-wide: a kill consumed by the
first ``run()`` stays consumed when the caller resumes, so the resumed solve
finishes clean.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "CorruptFetch",
    "TransientIO",
    "SlowFetch",
    "BreakPrefetch",
    "KillAtIteration",
    "FaultPlan",
    "FaultInjector",
    "InjectedIOError",
    "InjectedKill",
    "as_injector",
]

FAULT_KINDS = ("corrupt_fetch", "transient_io", "slow_fetch", "break_prefetch", "kill")


class InjectedIOError(IOError):
    """A scheduled transient I/O failure (an ``OSError``: the retry policy
    retries it)."""


class InjectedKill(RuntimeError):
    """A scheduled mid-run crash, raised at an iteration boundary BEFORE the
    iteration runs: what a SIGKILL between checkpoints looks like.  Not an
    ``OSError``, so no fetch retry loop swallows it."""


# ---------------------------------------------------------------------------
# Events: frozen dataclasses, so a plan is hashable and replays exactly.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CorruptFetch:
    """Flip one byte of ``array`` in the slice fetched for ``block``, the
    ``occurrence``-th time that block is fetched (1-based).  The flip comes
    before checksum verification, so a checksummed store detects it and the
    re-fetch (the event consumed) reads clean data.  ``worker=None`` hits
    whichever store fetches first; an int targets the store whose
    ``fault_scope`` is that worker (fetch counts are kept per (scope,
    block))."""

    block: int
    array: str = "seg"           # 'seg' | 'gat' | 'cnt'
    occurrence: int = 1
    worker: int | None = None
    kind: str = dataclasses.field(default="corrupt_fetch", init=False)


@dataclasses.dataclass(frozen=True)
class TransientIO:
    """Raise :class:`InjectedIOError` for the next ``times`` fetch attempts
    of ``block`` (each raise consumes one).  ``worker`` scopes the fault to
    one store (None: any store)."""

    block: int
    times: int = 1
    worker: int | None = None
    kind: str = dataclasses.field(default="transient_io", init=False)


@dataclasses.dataclass(frozen=True)
class SlowFetch:
    """Sleep ``delay_s`` inside the ``occurrence``-th fetch of ``block``: a
    straggler read.  ``worker`` scopes the fault to one store (None: any
    store)."""

    block: int
    delay_s: float = 0.05
    occurrence: int = 1
    worker: int | None = None
    kind: str = dataclasses.field(default="slow_fetch", init=False)


@dataclasses.dataclass(frozen=True)
class BreakPrefetch:
    """Break the prefetch THREAD of the next pipeline to start (``worker``:
    only a store of that scope): the pipeline degrades to synchronous
    fetches for its lifetime -- ``store.prefetch_degraded`` counts it -- and
    the solve must still finish bitwise.  A deterministic stand-in for a
    pool that dies mid-run."""

    worker: int | None = None
    kind: str = dataclasses.field(default="break_prefetch", init=False)


@dataclasses.dataclass(frozen=True)
class KillAtIteration:
    """Raise :class:`InjectedKill` when iteration ``iteration`` (0-based) is
    about to start, i.e. after ``iteration`` completed iterations."""

    iteration: int
    kind: str = dataclasses.field(default="kill", init=False)


_EVENT_TYPES = (CorruptFetch, TransientIO, SlowFetch, BreakPrefetch, KillAtIteration)


def _scope_matches(event, scope) -> bool:
    """A worker-scoped event fires only on its worker's store; an unscoped
    event fires on any store (single-host stores pass scope=None)."""
    target = getattr(event, "worker", None)
    return target is None or target == scope


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of fault events plus the seed that derives every
    random choice inside injection (the corrupted byte offsets), so a plan
    replays bit for bit."""

    events: tuple = ()
    seed: int = 0

    def __post_init__(self):
        for e in self.events:
            if not isinstance(e, _EVENT_TYPES):
                raise TypeError(f"not a fault event: {e!r}")
        object.__setattr__(self, "events", tuple(self.events))

    @classmethod
    def random(cls, seed: int, *, blocks, n_corrupt: int = 1, n_transient: int = 2,
               n_slow: int = 0, kill_at: int | None = None,
               slow_delay_s: float = 0.01) -> "FaultPlan":
        """A seeded recoverable plan over the given fetchable ``blocks``
        (it draws only blocks that will be fetched, so every event fires)."""
        blocks = list(blocks)
        if not blocks:
            raise ValueError("FaultPlan.random needs at least one fetchable block")
        rng = np.random.default_rng(seed)
        events: list = []
        for _ in range(n_corrupt):
            events.append(CorruptFetch(block=int(rng.choice(blocks)),
                                       array=str(rng.choice(["seg", "gat"]))))
        for _ in range(n_transient):
            events.append(TransientIO(block=int(rng.choice(blocks))))
        for _ in range(n_slow):
            events.append(SlowFetch(block=int(rng.choice(blocks)), delay_s=slow_delay_s))
        if kill_at is not None:
            events.append(KillAtIteration(iteration=int(kill_at)))
        return cls(events=tuple(events), seed=seed)

    def build(self, obs=None) -> "FaultInjector":
        return FaultInjector(self, obs=obs)

    def counts(self) -> dict:
        """Shots scheduled per kind (a TransientIO counts its ``times``)."""
        out = {k: 0 for k in FAULT_KINDS}
        for e in self.events:
            out[e.kind] += int(getattr(e, "times", 1))
        return out


# ---------------------------------------------------------------------------
# The injector (runtime state).
# ---------------------------------------------------------------------------

class FaultInjector:
    """Mutable consumption state of one FaultPlan.  Thread-safe: a prefetch
    thread calls ``on_fetch`` / ``corrupt_slice`` while the engine thread
    calls ``on_iteration``."""

    def __init__(self, plan: FaultPlan, obs=None):
        from repro_torch.obs.recorder import as_recorder

        self.plan = plan
        self.obs = as_recorder(obs)
        self._lock = threading.Lock()
        # shots left per event (a TransientIO carries `times`)
        self._remaining = [int(getattr(e, "times", 1)) for e in plan.events]
        # fetch-attempt counts per (scope, block), for occurrence matching
        self._fetch_counts: dict[tuple, int] = {}
        self._rng = np.random.default_rng(plan.seed)
        self.injected: dict[str, int] = {k: 0 for k in FAULT_KINDS}

    @property
    def remaining(self) -> int:
        """Unfired shots left in the plan (0: every fault was injected)."""
        with self._lock:
            return sum(self._remaining)

    def _fire(self, i: int) -> None:
        e = self.plan.events[i]
        self._remaining[i] -= 1
        self.injected[e.kind] += 1
        self.obs.counter("fault.injected").add(1)
        self.obs.counter(f"fault.injected.{e.kind}").add(1)

    def on_fetch(self, block: int, scope: int | None = None) -> None:
        """Called at the top of every fetch ATTEMPT of ``block``.  May raise
        InjectedIOError (transient_io) or sleep (slow_fetch).  ``scope`` is
        the calling store's ``fault_scope`` (None for a single store)."""
        delay = None
        with self._lock:
            count = self._fetch_counts.get((scope, block), 0) + 1
            self._fetch_counts[(scope, block)] = count
            for i, e in enumerate(self.plan.events):
                if (self._remaining[i] <= 0 or getattr(e, "block", None) != block
                        or not _scope_matches(e, scope)):
                    continue
                if e.kind == "transient_io":
                    self._fire(i)
                    raise InjectedIOError(
                        f"injected transient I/O error fetching block {block} "
                        f"(attempt {count})")
                if e.kind == "slow_fetch" and e.occurrence == count:
                    self._fire(i)
                    delay = e.delay_s
        if delay:
            with self.obs.span("fault.slow_fetch", {"block": block}):
                time.sleep(delay)

    def corrupt_slice(self, block: int, arrays: dict, scope: int | None = None) -> None:
        """Called with the freshly read, writable host arrays of ``block``'s
        slice (``seg`` / ``gat`` [b_w, e_cap] int32); flips one seeded byte
        of the scheduled array.  Runs before checksum verification, so the
        corruption is detectable."""
        with self._lock:
            count = self._fetch_counts.get((scope, block), 1)
            for i, e in enumerate(self.plan.events):
                if (self._remaining[i] <= 0 or e.kind != "corrupt_fetch"
                        or e.block != block or e.occurrence != count
                        or not _scope_matches(e, scope)):
                    continue
                arr = arrays.get(e.array)
                if arr is None:
                    continue
                flat = np.asarray(arr).view(np.uint8).reshape(-1)
                off = int(self._rng.integers(flat.size))
                flat[off] ^= 0xFF          # always changes the byte
                self._fire(i)
                self.obs.counter("fault.corrupt_bytes").add(1)

    def break_prefetch(self, scope: int | None = None) -> bool:
        """Consume a scheduled ``BreakPrefetch`` matching ``scope``.  True
        exactly once per scheduled event: the pipeline that sees it degrades
        to synchronous fetches for its lifetime."""
        with self._lock:
            for i, e in enumerate(self.plan.events):
                if (self._remaining[i] > 0 and e.kind == "break_prefetch"
                        and _scope_matches(e, scope)):
                    self._fire(i)
                    return True
        return False

    def drop_unscoped(self) -> None:
        """Drop every fetch event that names no worker (``worker=None``) from
        this injector's schedule, unfired: what each SPMD rank but the one at
        worker index 0 does with its own injector, so that such an event
        fires once across the fleet (``repro_torch.store.spmd``).  Kills and
        the events that name a worker stay."""
        with self._lock:
            for i, e in enumerate(self.plan.events):
                if hasattr(e, "worker") and e.worker is None:
                    self._remaining[i] = 0

    def on_iteration(self, iteration: int) -> None:
        """Called at the top of every engine iteration; raises InjectedKill
        where a kill is scheduled."""
        with self._lock:
            for i, e in enumerate(self.plan.events):
                if (self._remaining[i] > 0 and e.kind == "kill"
                        and e.iteration == iteration):
                    self._fire(i)
                    raise InjectedKill(
                        f"injected kill at iteration {iteration} -- resume from the "
                        "last checkpoint (run(..., resume=True))")


def as_injector(faults, obs=None) -> FaultInjector | None:
    """Normalize the ``faults=`` knob: None passes through (no injection), a
    FaultPlan is built once, an injector is shared as it is (so an engine,
    a server and their stores consume one schedule together)."""
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return faults.build(obs)
    raise TypeError(
        f"faults must be a FaultPlan, FaultInjector, or None; got {type(faults)!r}")
