"""Chrome trace-event JSON export + schema/nesting validation (this
package's copy of the JAX package's ``repro.obs.trace``).

The exported document follows the Trace Event Format's "JSON Object Format":
``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}`` with
one complete event (``ph: "X"``) per finished span — microsecond ``ts``/
``dur`` relative to the recorder epoch, ``pid`` 0 (one process), and the
recorder's dense thread ids (the disk prefetch worker shows up as its own
track).  Load the file in Perfetto (ui.perfetto.dev) or chrome://tracing.

``validate_chrome_trace`` is the schema gate (``chip_smoke.py`` runs it on
a trace written to a file and read back); ``check_span_nesting`` asserts
the span-stack invariant (per thread, spans nest — no partial overlap),
which holds by construction for context-manager spans and catches clock or
threading bugs.
"""
from __future__ import annotations

import json

__all__ = [
    "to_chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "check_span_nesting",
    "TraceSchemaError",
]

_US = 1e6


class TraceSchemaError(ValueError):
    """The document does not satisfy the Chrome trace-event schema subset."""


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if hasattr(v, "item"):          # numpy scalar, 0-d torch.Tensor
            v = v.item()
        elif not isinstance(v, (str, int, float, bool, type(None))):
            v = str(v)
        out[str(k)] = v
    return out


def to_chrome_trace(recorder, *, pid: int = 0) -> dict:
    """Recorder -> Chrome trace-event JSON object (complete 'X' events)."""
    events = []
    for ev in recorder.events:
        rec = {
            "name": ev["name"],
            "ph": "X",
            "ts": ev["ts"] * _US,
            "dur": ev["dur"] * _US,
            "pid": pid,
            "tid": ev["tid"],
        }
        attrs = ev.get("attrs")
        if attrs:
            rec["args"] = _jsonable_attrs(attrs)
        events.append(rec)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs", "spans": len(events)},
    }


def write_chrome_trace(recorder, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(recorder), f)


_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(doc: dict) -> int:
    """Validate the schema subset this exporter emits; returns the event
    count.  Raises :class:`TraceSchemaError` on the first violation."""
    if not isinstance(doc, dict):
        raise TraceSchemaError(f"trace document must be an object, got {type(doc)}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise TraceSchemaError("traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise TraceSchemaError(f"event {i}: not an object")
        for key in _REQUIRED:
            if key not in ev:
                raise TraceSchemaError(f"event {i}: missing required key {key!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise TraceSchemaError(f"event {i}: name must be a non-empty string")
        if ev["ph"] not in ("X", "B", "E", "i", "C", "M"):
            raise TraceSchemaError(f"event {i}: unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise TraceSchemaError(f"event {i}: ts must be a non-negative number")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise TraceSchemaError(
                    f"event {i}: complete event needs non-negative dur")
        for key in ("pid", "tid"):
            if not isinstance(ev[key], int):
                raise TraceSchemaError(f"event {i}: {key} must be an int")
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            raise TraceSchemaError(f"event {i}: args must be an object")
    return len(events)


def check_span_nesting(doc: dict, *, tol_us: float = 1.0) -> None:
    """Assert the per-thread span-stack invariant on a trace document: two
    spans on one (pid, tid) track either nest (one contains the other) or
    are disjoint — partial overlap means broken stack discipline (spans
    recorded with mismatched enter/exit) and renders garbage in Perfetto.

    ``tol_us`` absorbs clock granularity at the touching endpoints."""
    by_track: dict[tuple, list] = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] != "X":
            continue
        by_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for track, events in by_track.items():
        # sort by start asc, end desc: containers come before their children
        events.sort(key=lambda e: (e["ts"], -(e["ts"] + e.get("dur", 0.0))))
        stack: list[tuple[float, float, str]] = []
        for ev in events:
            t0, t1 = ev["ts"], ev["ts"] + ev.get("dur", 0.0)
            while stack and stack[-1][1] <= t0 + tol_us:
                stack.pop()
            if stack and t1 > stack[-1][1] + tol_us:
                raise TraceSchemaError(
                    f"track {track}: span {ev['name']!r} [{t0:.1f}, {t1:.1f}]us "
                    f"partially overlaps enclosing {stack[-1][2]!r} "
                    f"[{stack[-1][0]:.1f}, {stack[-1][1]:.1f}]us")
            stack.append((t0, t1, ev["name"]))
