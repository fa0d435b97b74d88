"""Live serving telemetry: rolling windows, SLO burn rates, OpenMetrics
(this package's copy of the JAX package's ``repro.obs.live``).

The server's retirement ledger records *what happened* (completed /
deadline_exceeded / shed / failed per query); this module watches it *as it
happens*, the way a production operator would:

- :class:`WindowedHistogram` / :class:`WindowedRate` -- rolling-window
  percentile and rate instruments layered over the cumulative registry (the
  registry's ``Histogram`` answers "p99 since start"; these answer "p99 over
  the last 60 s").
- :class:`SloTracker` -- target-p99-latency and deadline-hit-rate objectives
  over the retirement stream, with multi-window error-budget **burn rates**
  (window error rate / allowed error rate: 1.0 = exactly consuming budget,
  >1 = on track to blow the SLO; the standard multi-window alert signal).
- :func:`openmetrics_text` -- Prometheus/OpenMetrics text exposition of the
  live view plus the cumulative registry; :class:`LiveTelemetry` bundles the
  instruments and serves ``/metrics`` (text) + ``/metrics.json`` (snapshot)
  from a stdlib ``http.server`` daemon thread behind the
  ``PMVServer(telemetry=)`` knob.

Everything here is host-side bookkeeping on the retirement path -- no
fences, no device work -- so telemetry on/off cannot change a served result.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import re
import threading
import time

__all__ = [
    "WindowedHistogram",
    "WindowedRate",
    "SloTracker",
    "TelemetryConfig",
    "LiveTelemetry",
    "as_telemetry",
    "openmetrics_text",
    "format_top",
]

DEFAULT_WINDOW_S = 60.0
DEFAULT_BURN_WINDOWS = (60.0, 300.0)
_QUANTILES = (0.5, 0.9, 0.99)


# ---------------------------------------------------------------------------
# Rolling-window instruments.
# ---------------------------------------------------------------------------

class WindowedHistogram:
    """Percentiles over the observations of the trailing ``window_s``."""

    def __init__(self, name: str, window_s: float = DEFAULT_WINDOW_S,
                 clock=time.monotonic):
        self.name = name
        self.window_s = float(window_s)
        self._clock = clock
        self._samples: collections.deque = collections.deque()  # (t, v)
        self._lock = threading.Lock()
        self.count = 0          # cumulative, like the registry Histogram
        self.sum = 0.0

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def observe(self, v: float, now: float | None = None) -> None:
        v = float(v)
        now = self._clock() if now is None else now
        with self._lock:
            self.count += 1
            self.sum += v
            self._samples.append((now, v))
            self._prune(now)

    def snapshot(self, now: float | None = None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            self._prune(now)
            xs = sorted(v for _t, v in self._samples)
        out = {"name": self.name, "window_s": self.window_s,
               "count": len(xs), "total_count": self.count,
               "rate_per_s": len(xs) / self.window_s if xs else 0.0}
        if xs:
            out["sum"] = float(sum(xs))
            out["mean"] = out["sum"] / len(xs)
            out["min"], out["max"] = xs[0], xs[-1]
            for q in _QUANTILES:
                k = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
                out[f"p{int(q * 100)}"] = xs[k]
        else:
            out.update(sum=0.0, mean=None, min=None, max=None,
                       **{f"p{int(q * 100)}": None for q in _QUANTILES})
        return out


class WindowedRate:
    """Events (and value throughput) per second over the trailing window."""

    def __init__(self, name: str, window_s: float = DEFAULT_WINDOW_S,
                 clock=time.monotonic):
        self.name = name
        self.window_s = float(window_s)
        self._clock = clock
        self._samples: collections.deque = collections.deque()  # (t, v)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0

    def add(self, v: float = 1.0, now: float | None = None) -> None:
        v = float(v)
        now = self._clock() if now is None else now
        with self._lock:
            self.count += 1
            self.sum += v
            cutoff = now - self.window_s
            self._samples.append((now, v))
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()

    def snapshot(self, now: float | None = None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            cutoff = now - self.window_s
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            n = len(self._samples)
            s = float(sum(v for _t, v in self._samples))
        return {"name": self.name, "window_s": self.window_s,
                "count": n, "sum": s, "total_count": self.count,
                "rate_per_s": n / self.window_s,
                "value_per_s": s / self.window_s}


# ---------------------------------------------------------------------------
# SLO tracking.
# ---------------------------------------------------------------------------

class SloTracker:
    """Error-budget accounting over the retirement stream.

    Two objectives, both fractions of *good* retirements:

    - ``latency``: good = completed within ``latency_target_s`` (when a
      target is set; otherwise any completion).  Shed / failed /
      deadline-expired retirements are bad.
    - ``deadline``: over retirements of queries that *carried a deadline* —
      good = completed (the deadline-hit rate of the retirement ledger).

    Each objective reports, overall and per burn window, the error rate and
    the **burn rate** = error rate / (1 - objective): how many times faster
    than allowed the error budget is being consumed."""

    def __init__(self, *, latency_target_s: float | None = None,
                 latency_objective: float = 0.99,
                 deadline_objective: float = 0.99,
                 windows: tuple[float, ...] = DEFAULT_BURN_WINDOWS,
                 clock=time.monotonic):
        self.latency_target_s = latency_target_s
        self.objectives = {"latency": float(latency_objective),
                           "deadline": float(deadline_objective)}
        self.windows = tuple(float(w) for w in windows)
        self._clock = clock
        self._lock = threading.Lock()
        # (t, latency_bad, deadline_applicable, deadline_bad)
        self._events: collections.deque = collections.deque()
        self._totals = {"events": 0, "latency_bad": 0,
                        "deadline_events": 0, "deadline_bad": 0}

    def record(self, reason: str, latency_s: float | None = None, *,
               had_deadline: bool = False, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        lat_bad = reason != "completed" or (
            self.latency_target_s is not None
            and latency_s is not None and latency_s > self.latency_target_s)
        dl_bad = had_deadline and reason != "completed"
        with self._lock:
            self._events.append((now, lat_bad, had_deadline, dl_bad))
            self._totals["events"] += 1
            self._totals["latency_bad"] += int(lat_bad)
            self._totals["deadline_events"] += int(had_deadline)
            self._totals["deadline_bad"] += int(dl_bad)
            cutoff = now - max(self.windows, default=0.0)
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    @staticmethod
    def _rates(objective: float, events: int, bad: int) -> dict:
        err = bad / events if events else 0.0
        budget = 1.0 - objective
        return {"events": events, "bad": bad, "error_rate": err,
                "good_rate": 1.0 - err,
                "burn_rate": (err / budget) if budget > 0 else None}

    def snapshot(self, now: float | None = None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            events = list(self._events)
            totals = dict(self._totals)
        out = {}
        for name in ("latency", "deadline"):
            obj = self.objectives[name]
            if name == "latency":
                total = self._rates(obj, totals["events"],
                                    totals["latency_bad"])
            else:
                total = self._rates(obj, totals["deadline_events"],
                                    totals["deadline_bad"])
            wins = {}
            for w in self.windows:
                cutoff = now - w
                if name == "latency":
                    sel = [(1, b) for t, b, _a, _d in events if t >= cutoff]
                else:
                    sel = [(1, d) for t, _b, a, d in events
                           if t >= cutoff and a]
                wins[f"{w:g}s"] = self._rates(
                    obj, len(sel), sum(b for _one, b in sel))
            out[name] = {"objective": obj, "total": total, "windows": wins}
            if name == "latency":
                out[name]["target_s"] = self.latency_target_s
        return out


# ---------------------------------------------------------------------------
# The telemetry bundle + HTTP exporter.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """The ``PMVServer(telemetry=)`` knob's shape.

    ``port=0`` binds an ephemeral port (read it back from
    ``server.telemetry.url``); ``serve=False`` keeps the instruments +
    SLO tracker without the HTTP thread."""

    window_s: float = DEFAULT_WINDOW_S
    latency_target_s: float | None = None
    latency_objective: float = 0.99
    deadline_objective: float = 0.99
    burn_windows: tuple[float, ...] = DEFAULT_BURN_WINDOWS
    serve: bool = True
    host: str = "127.0.0.1"
    port: int = 0


class LiveTelemetry:
    """Rolling-window serving instruments + SLO tracker + exporter."""

    def __init__(self, config: TelemetryConfig | None = None, *,
                 registry=None, clock=time.monotonic):
        cfg = config if config is not None else TelemetryConfig()
        self.config = cfg
        self.registry = registry        # the recorder's MetricsRegistry (or None)
        w = cfg.window_s
        self.latency = WindowedHistogram("serve.query_latency_s", w, clock)
        self.queue_wait = WindowedHistogram("serve.queue_wait_s", w, clock)
        self.iter_wall = WindowedHistogram("serve.iteration_wall_s", w, clock)
        self.retired = WindowedRate("serve.retired", w, clock)
        self.queue_depth = 0.0
        self.active_columns = 0.0
        self.slo = SloTracker(
            latency_target_s=cfg.latency_target_s,
            latency_objective=cfg.latency_objective,
            deadline_objective=cfg.deadline_objective,
            windows=cfg.burn_windows, clock=clock)
        self._httpd = None
        self._thread = None

    # -- feed points (called from the serving hot path; host-side only) --
    def record_retirement(self, reason: str, latency_s: float, *,
                          queue_wait_s: float | None = None,
                          had_deadline: bool = False) -> None:
        self.retired.add(1.0)
        self.latency.observe(latency_s)
        if queue_wait_s is not None:
            self.queue_wait.observe(queue_wait_s)
        self.slo.record(reason, latency_s, had_deadline=had_deadline)

    def record_iteration(self, wall_s: float,
                         active: float | None = None) -> None:
        self.iter_wall.observe(wall_s)
        if active is not None:
            self.active_columns = float(active)

    def record_queue_depth(self, depth: float) -> None:
        self.queue_depth = float(depth)

    # -- views -----------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``/metrics.json`` payload."""
        return {
            "window_s": self.config.window_s,
            "queue_depth": self.queue_depth,
            "active_columns": self.active_columns,
            "retired": self.retired.snapshot(),
            "latency": self.latency.snapshot(),
            "queue_wait": self.queue_wait.snapshot(),
            "iteration_wall": self.iter_wall.snapshot(),
            "slo": self.slo.snapshot(),
        }

    def openmetrics(self) -> str:
        return openmetrics_text(live=self, registry=self.registry)

    # -- the stdlib http.server exporter ---------------------------------
    @property
    def url(self) -> str | None:
        if self._httpd is None:
            return None
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start_server(self) -> str:
        """Serve ``/metrics`` + ``/metrics.json`` from a daemon thread;
        returns the base URL (idempotent)."""
        if self._httpd is not None:
            return self.url
        import http.server

        telemetry = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                path = self.path.split("?", 1)[0]
                if path in ("/metrics.json", "/snapshot"):
                    self._reply(json.dumps(telemetry.snapshot()).encode(),
                                "application/json")
                elif path == "/metrics":
                    self._reply(telemetry.openmetrics().encode(),
                                "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    self._reply(b"ok\n", "text/plain")
                else:
                    self.send_error(404)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self.config.host, self.config.port), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pmv-telemetry",
            daemon=True)
        self._thread.start()
        return self.url

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None


def as_telemetry(telemetry, *, registry=None) -> LiveTelemetry | None:
    """Normalize the ``telemetry=`` knob: None/False -> off, True -> default
    config, a TelemetryConfig is instantiated, a LiveTelemetry passes
    through (shared across servers)."""
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True:
        return LiveTelemetry(TelemetryConfig(), registry=registry)
    if isinstance(telemetry, TelemetryConfig):
        return LiveTelemetry(telemetry, registry=registry)
    if isinstance(telemetry, LiveTelemetry):
        if telemetry.registry is None:
            telemetry.registry = registry
        return telemetry
    raise TypeError("telemetry must be a LiveTelemetry, TelemetryConfig, "
                    f"bool, or None; got {type(telemetry)!r}")


# ---------------------------------------------------------------------------
# OpenMetrics text exposition.
# ---------------------------------------------------------------------------

def _metric_name(name: str, prefix: str = "pmv") -> str:
    return f"{prefix}_{re.sub(r'[^a-zA-Z0-9_:]', '_', name)}"


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def openmetrics_text(*, live: LiveTelemetry | None = None, registry=None,
                     prefix: str = "pmv") -> str:
    """Prometheus/OpenMetrics text format over the live view and/or a
    cumulative :class:`repro_torch.obs.MetricsRegistry`."""
    lines: list[str] = []

    def emit(name: str, mtype: str, samples: list[tuple[str, object]]):
        lines.append(f"# TYPE {name} {mtype}")
        for labels, v in samples:
            lines.append(f"{name}{labels} {_fmt(v)}")

    if live is not None:
        w = f'window="{live.config.window_s:g}s"'
        emit(f"{prefix}_serve_queue_depth", "gauge",
             [("", live.queue_depth)])
        emit(f"{prefix}_serve_active_columns", "gauge",
             [("", live.active_columns)])
        r = live.retired.snapshot()
        emit(f"{prefix}_serve_retired_total", "counter",
             [("", r["total_count"])])
        emit(f"{prefix}_serve_retired_rate", "gauge",
             [(f"{{{w}}}", r["rate_per_s"])])
        for label, hist in (("query_latency_seconds", live.latency),
                            ("queue_wait_seconds", live.queue_wait),
                            ("iteration_wall_seconds", live.iter_wall)):
            s = hist.snapshot()
            name = f"{prefix}_serve_{label}"
            samples = [(f'{{{w},quantile="{q:g}"}}', s[f"p{int(q * 100)}"])
                       for q in _QUANTILES]
            emit(name, "summary", samples
                 + [("_count", s["count"]), ("_sum", s["sum"])])
        slo = live.slo.snapshot()
        for obj_name, obj in slo.items():
            labels = f'objective="{obj_name}"'
            emit(f"{prefix}_slo_objective", "gauge",
                 [(f"{{{labels}}}", obj["objective"])])
            err = [(f'{{{labels},window="total"}}',
                    obj["total"]["error_rate"])]
            burn = [(f'{{{labels},window="total"}}',
                     obj["total"]["burn_rate"])]
            for win, rates in obj["windows"].items():
                err.append((f'{{{labels},window="{win}"}}',
                            rates["error_rate"]))
                burn.append((f'{{{labels},window="{win}"}}',
                             rates["burn_rate"]))
            emit(f"{prefix}_slo_error_rate", "gauge", err)
            emit(f"{prefix}_slo_burn_rate", "gauge", burn)

    if registry is not None:
        for d in registry.to_dicts():
            name = _metric_name(d["name"], prefix)
            if d["kind"] == "counter":
                emit(f"{name}_total", "counter", [("", d["value"])])
            elif d["kind"] == "gauge":
                emit(name, "gauge", [("", d["value"])])
            elif d["kind"] == "histogram":
                emit(name, "summary",
                     [('{quantile="0.5"}', d["p50"]),
                      ('{quantile="0.99"}', d["p99"]),
                      ("_count", d["count"]), ("_sum", d["sum"])])
            # series are unbounded per-iteration trajectories: not exposed

    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The `python -m repro_torch obs top` text dashboard.
# ---------------------------------------------------------------------------

def _ms(v) -> str:
    return "-" if v is None else f"{v * 1e3:.1f}ms"


def format_top(snapshot: dict) -> str:
    """One ``top``-style frame from a ``/metrics.json`` snapshot."""
    lat, ret, slo = (snapshot.get("latency", {}), snapshot.get("retired", {}),
                     snapshot.get("slo", {}))
    it = snapshot.get("iteration_wall", {})
    lines = [
        f"pmv serve — window {snapshot.get('window_s', 0):g}s",
        (f"  throughput {ret.get('rate_per_s', 0.0):8.2f} q/s"
         f"   retired {ret.get('total_count', 0):6d}"
         f"   queue {snapshot.get('queue_depth', 0):.0f}"
         f"   active {snapshot.get('active_columns', 0):.0f}"),
        (f"  latency    p50 {_ms(lat.get('p50'))}"
         f"   p90 {_ms(lat.get('p90'))}"
         f"   p99 {_ms(lat.get('p99'))}"
         f"   ({lat.get('count', 0)} in window)"),
        (f"  iteration  p50 {_ms(it.get('p50'))}"
         f"   p99 {_ms(it.get('p99'))}"),
    ]
    for name, obj in slo.items():
        tot = obj.get("total", {})
        wins = "  ".join(
            f"{w}={r['burn_rate']:.2f}" if r.get("burn_rate") is not None
            else f"{w}=-"
            for w, r in obj.get("windows", {}).items())
        target = (f" target {obj['target_s'] * 1e3:g}ms"
                  if obj.get("target_s") is not None else "")
        lines.append(
            f"  slo {name:<9} obj {obj.get('objective', 0):.3f}{target}"
            f"   good {tot.get('good_rate', 1.0):.4f}"
            f"   burn {wins}")
    return "\n".join(lines)
