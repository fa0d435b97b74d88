"""Span tracing + metrics recorder for the PMV pipeline (this package's
copy of the JAX package's ``repro.obs.recorder``).

A :class:`Recorder` collects

- **spans**: wall-clock intervals with a name and optional attributes,
  entered via ``with rec.span("pmv.iteration"):``.  CUDA work is
  asynchronous, so span bodies that end at a step boundary call
  :meth:`Recorder.fence` (``torch.cuda.synchronize`` on every CUDA device
  the value lives on) to attribute the device time to the enclosing span
  instead of whichever span happens to synchronize later.
- **metrics**: named counters / gauges / histograms / per-iteration series
  in a :class:`MetricsRegistry` (``rec.counter("store.bytes_read").add(...)``).

Exporters live in :mod:`repro_torch.obs.trace` (Chrome trace-event JSON,
loadable in Perfetto / ``chrome://tracing``) and
:mod:`repro_torch.obs.report` (predicted-vs-measured cost calibration).

Disabled observability must cost nothing and change nothing: the
:data:`NULL_RECORDER` singleton answers the whole API with shared no-op
objects -- ``span()`` returns one module-level null span (no allocation per
call: the signature takes a pre-built ``attrs`` dict or None, never
``**kwargs``), ``fence`` returns its argument WITHOUT synchronizing, and the
null metric instruments drop writes.  The traced path is therefore bitwise
identical with the recorder on or off (fences only reorder host timing), and
the disabled path allocates no per-iteration Python objects.
"""
from __future__ import annotations

import json
import random
import threading
import time

import torch

__all__ = [
    "Recorder",
    "NullRecorder",
    "NULL_RECORDER",
    "as_recorder",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "Series",
]

HISTOGRAM_RESERVOIR = 4096  # values kept per histogram for percentiles


# ---------------------------------------------------------------------------
# Metric instruments.
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic sum (e.g. total exchange bytes).  Adds are locked: the
    disk store's prefetch threads (two on the hybrid) and the compute loop
    add to the same counters."""

    __slots__ = ("name", "value", "events", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.events = 0
        self._lock = threading.Lock()

    def add(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.value += v
            self.events += 1

    def to_dict(self) -> dict:
        return {"kind": "counter", "name": self.name,
                "value": self.value, "events": self.events}


class Gauge:
    """Last-write-wins scalar (e.g. batch occupancy)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> dict:
        return {"kind": "gauge", "name": self.name, "value": self.value}


class Histogram:
    """Streaming distribution with a bounded value reservoir.

    Keeps exact count/sum/min/max plus an Algorithm R reservoir of
    ``HISTOGRAM_RESERVOIR`` observations: every observation — not just the
    first R — has an R/count chance of being represented, so a long-running
    server's p50/p99 track the live distribution instead of freezing on
    warmup latencies.  The replacement draws come from a per-instrument PRNG
    seeded on the metric name, so a fixed input stream reproduces the exact
    same reservoir run-to-run."""

    __slots__ = ("name", "count", "sum", "min", "max", "values", "_rng")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.values: list[float] = []
        # str seeds take random.Random's deterministic (hash-free) path
        self._rng = random.Random(name)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self.values) < HISTOGRAM_RESERVOIR:
            self.values.append(v)
        else:
            # Algorithm R: observation i (1-based) replaces a reservoir slot
            # with probability R/i, keeping the sample uniform over the stream
            j = self._rng.randrange(self.count)
            if j < HISTOGRAM_RESERVOIR:
                self.values[j] = v

    def percentile(self, q: float) -> float | None:
        if not self.values:
            return None
        xs = sorted(self.values)
        k = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[k]

    def to_dict(self) -> dict:
        return {
            "kind": "histogram", "name": self.name, "count": self.count,
            "sum": self.sum, "min": self.min, "max": self.max,
            "mean": (self.sum / self.count) if self.count else None,
            "p50": self.percentile(50), "p99": self.percentile(99),
        }


class Series:
    """Ordered per-iteration samples (e.g. the convergence-delta trajectory)."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: list[float] = []

    def append(self, v: float) -> None:
        self.values.append(float(v))

    def to_dict(self) -> dict:
        return {"kind": "series", "name": self.name, "n": len(self.values),
                "values": self.values}


class MetricsRegistry:
    """Name -> instrument table; one per Recorder."""

    _KINDS = {"counter": Counter, "gauge": Gauge,
              "histogram": Histogram, "series": Series}

    def __init__(self):
        self._table: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str):
        inst = self._table.get(name)
        if inst is None:
            with self._lock:
                inst = self._table.get(name)
                if inst is None:
                    inst = self._KINDS[kind](name)
                    self._table[name] = inst
        cls = self._KINDS[kind]
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name)

    def histogram(self, name: str) -> Histogram:
        return self._get("histogram", name)

    def series(self, name: str) -> Series:
        return self._get("series", name)

    def __len__(self) -> int:
        return len(self._table)

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def get(self, name: str):
        return self._table.get(name)

    def to_dicts(self) -> list[dict]:
        return [inst.to_dict() for _, inst in sorted(self._table.items())]

    def write_jsonl(self, path: str) -> None:
        """One JSON object per metric (the JSONL metrics dump)."""
        with open(path, "w") as f:
            for d in self.to_dicts():
                f.write(json.dumps(d) + "\n")


# ---------------------------------------------------------------------------
# Spans.
# ---------------------------------------------------------------------------

class _Span:
    """One live span; records itself into the recorder at exit."""

    __slots__ = ("_rec", "name", "attrs", "t0")

    def __init__(self, rec: "Recorder", name: str, attrs: dict | None):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.t0 = None

    def set(self, key: str, value) -> None:
        """Attach one attribute (lazily creates the attr dict)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self) -> "_Span":
        self.t0 = self._rec._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rec._finish(self)
        return False


class _NullSpan:
    """Shared no-op span: the disabled path's context manager.  A module
    singleton, so ``NULL_RECORDER.span(...)`` performs zero allocations."""

    __slots__ = ()

    def set(self, key, value):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _NullInstrument:
    """Shared no-op metric instrument (counter/gauge/histogram/series)."""

    __slots__ = ()

    def add(self, v):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def append(self, v):
        pass


_NULL_INSTRUMENT = _NullInstrument()


# ---------------------------------------------------------------------------
# Recorders.
# ---------------------------------------------------------------------------

class Recorder:
    """Collects spans + metrics for one pipeline run (thread-safe: the disk
    prefetch worker records fetch spans under its own trace thread id).

    A recorder can hand out named **child shards** (:meth:`child`): each
    SPMD worker (and through it its prefetch thread) records spans into its
    own shard while all shards share the parent's clock *and epoch* — one
    monotonic anchor, so a trace merger can lay the shards out as aligned
    per-worker process lanes of one Chrome trace.  Metrics
    stay fleet-wide: children share the parent's :class:`MetricsRegistry`
    (counters like ``store.prefetch_degraded`` count across the fleet)."""

    enabled = True

    def __init__(self, *, clock=time.perf_counter, label: str | None = None,
                 _epoch: float | None = None,
                 _metrics: MetricsRegistry | None = None):
        self._clock = clock
        self.epoch = clock() if _epoch is None else _epoch
        self.label = label
        self.events: list[dict] = []          # finished spans, completion order
        self.metrics = MetricsRegistry() if _metrics is None else _metrics
        self._lock = threading.Lock()
        self._tids: dict[int, int] = {}       # thread ident -> dense trace tid
        self.children: dict[str, "Recorder"] = {}

    # -- child shards ---------------------------------------------------
    def child(self, label: str) -> "Recorder":
        """The child shard named ``label`` (created on first request).
        Shares this recorder's clock, epoch, and metrics registry; keeps its
        own span list and thread-id table (one trace lane per shard)."""
        with self._lock:
            ch = self.children.get(label)
            if ch is None:
                ch = Recorder(clock=self._clock, label=label,
                              _epoch=self.epoch, _metrics=self.metrics)
                self.children[label] = ch
        return ch

    def shards(self) -> list["Recorder"]:
        """This recorder followed by its child shards, depth-first in label
        order (one trace lane each)."""
        out = [self]
        for _label, ch in sorted(self.children.items()):
            out.extend(ch.shards())
        return out

    # -- spans ----------------------------------------------------------
    def span(self, name: str, attrs: dict | None = None) -> _Span:
        """Open a span; use as a context manager.  ``attrs`` is stored by
        reference — pass a fresh or immutable dict."""
        return _Span(self, name, attrs)

    def _trace_tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _finish(self, span: _Span) -> None:
        t1 = self._clock()
        ev = {
            "name": span.name,
            "ts": span.t0 - self.epoch,       # seconds since recorder epoch
            "dur": max(t1 - span.t0, 0.0),
            "tid": self._trace_tid(),
        }
        if span.attrs is not None:
            ev["attrs"] = span.attrs
        with self._lock:
            self.events.append(ev)

    def fence(self, x):
        """Wait for the device work behind ``x`` so the enclosing span's
        duration includes it (CUDA launches are asynchronous).  ``x`` may be
        a tensor or a tuple / list / dict of them (None and other leaves are
        skipped); every CUDA device found is synchronized once.  CPU tensors
        need no wait.  Returns ``x`` unchanged."""
        devices: set = set()
        _cuda_devices(x, devices)
        for dev in devices:
            torch.cuda.synchronize(dev)
        return x

    # -- metric shorthands ---------------------------------------------
    def counter(self, name: str) -> Counter:
        return self.metrics.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.metrics.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.metrics.histogram(name)

    def series(self, name: str) -> Series:
        return self.metrics.series(name)

    # -- queries / exporters -------------------------------------------
    def spans(self, prefix: str = "") -> list[dict]:
        """Finished spans whose name starts with ``prefix``."""
        return [e for e in self.events if e["name"].startswith(prefix)]

    def total(self, prefix: str) -> float:
        """Summed duration (s) of all spans matching ``prefix``."""
        return sum(e["dur"] for e in self.spans(prefix))

    def to_chrome_trace(self) -> dict:
        from repro_torch.obs.trace import to_chrome_trace

        return to_chrome_trace(self)

    def write_chrome_trace(self, path: str) -> None:
        from repro_torch.obs.trace import write_chrome_trace

        write_chrome_trace(self, path)

    def write_metrics_jsonl(self, path: str) -> None:
        self.metrics.write_jsonl(path)


def _cuda_devices(x, out: set) -> None:
    """Collect the CUDA devices of the tensors in ``x`` (a tensor, or
    tuples / lists / dicts of them) into ``out``."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _cuda_devices(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _cuda_devices(y, out)


class NullRecorder:
    """Disabled recorder: every method is a shared no-op.  ``fence`` does
    NOT synchronize — the untraced schedule is exactly the pre-obs one."""

    enabled = False
    events: list = []          # immutable-by-convention shared empty list
    children: dict = {}        # immutable-by-convention shared empty dict
    label = None

    def __init__(self):
        self.metrics = MetricsRegistry()   # stays empty: instruments are null

    def child(self, label: str) -> "NullRecorder":
        return self

    def shards(self) -> list:
        return [self]

    def span(self, name: str, attrs: dict | None = None) -> _NullSpan:
        return _NULL_SPAN

    @staticmethod
    def fence(x):
        return x

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def series(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def spans(self, prefix: str = "") -> list:
        return []

    def total(self, prefix: str) -> float:
        return 0.0


NULL_RECORDER = NullRecorder()


def as_recorder(obs) -> Recorder | NullRecorder:
    """Normalize the engine/server ``obs=`` knob: None/False -> the null
    singleton, True -> a fresh enabled Recorder, a Recorder passes through
    (shared across engine + server + store so one trace covers the run)."""
    if obs is None or obs is False:
        return NULL_RECORDER
    if obs is True:
        return Recorder()
    if isinstance(obs, (Recorder, NullRecorder)):
        return obs
    raise TypeError(f"obs must be a Recorder, bool, or None; got {type(obs)!r}")
