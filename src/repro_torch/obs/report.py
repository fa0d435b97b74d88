"""Predicted-vs-measured cost reports (this package's copy of the JAX
package's ``repro.obs.report``, on this package's cost model).

Every launch-shaped span the pipeline records carries the cost model's
prediction in its attributes:

- ``launch.disk_block`` (store.residency.DiskExecutor): one launch-schedule
  step's per-block compute out of core, ``predicted_cost`` in slot units
  (``ExecutionPlan.launch_cost``) and ``predicted_s`` via
  cost_model.slot_seconds;
- ``store.fetch`` (store.residency.DiskBlockStore): one shard-slice read,
  ``predicted_s`` via cost_model.disk_io_seconds -- reported under the
  ``disk_io`` kind.

:func:`calibration_summary` joins each launch's measured wall time against
its prediction and reduces to per-kind residuals -- ``ratio`` (measured /
predicted seconds, the constant a calibration pass would fold into
SLOT_TIME_S / DISK_READ_BW) plus the implied measured unit costs.
:func:`bench_obs_doc` packages that with the metrics dump into the JAX
package's ``BENCH_obs.json`` schema.
"""
from __future__ import annotations

import json
import math

import numpy as np

from repro_torch.core import cost_model

__all__ = [
    "collect_launches",
    "calibration_summary",
    "bench_obs_doc",
    "write_bench_obs",
    "format_live_report",
    "format_calibration",
]


def collect_launches(recorder) -> list[dict]:
    """Launch-shaped spans with their predictions, completion order.  Walks
    the recorder's child shards too (per-worker shards of one run belong in
    the same calibration feed)."""
    out = []
    shards = getattr(recorder, "shards", None)
    for rec in (shards() if shards is not None else [recorder]):
        for ev in rec.events:
            name = ev["name"]
            attrs = ev.get("attrs") or {}
            if name.startswith("launch."):
                kind = name[len("launch."):]
            elif name == "store.fetch":
                kind = "disk_io"
            else:
                continue
            out.append({
                "kind": kind,
                "measured_s": ev["dur"],
                "predicted_s": attrs.get("predicted_s"),
                "predicted_cost": attrs.get("predicted_cost"),
                "bytes": attrs.get("bytes"),
                "attrs": attrs,
            })
    return out


def _kind_summary(launches: list[dict]) -> dict:
    measured = float(sum(l["measured_s"] for l in launches))
    with_pred = [l for l in launches if l["predicted_s"]]
    predicted = float(sum(l["predicted_s"] for l in with_pred))
    ratios = [l["measured_s"] / l["predicted_s"] for l in with_pred
              if l["measured_s"] > 0 and l["predicted_s"] > 0]
    # extra launch records (possibly via a JSON round trip) carry only the
    # core keys — tolerate absences
    cost_slots = float(sum(l.get("predicted_cost") or 0.0 for l in launches))
    total_bytes = float(sum(l.get("bytes") or 0.0 for l in launches))
    out = {
        "launches": len(launches),
        "measured_s": measured,
        "predicted_s": predicted,
        # the calibration residual: >1 = the model is optimistic on this
        # backend, <1 = pessimistic; a calibration pass divides it out.
        "ratio": (measured / predicted) if predicted > 0 else None,
        "ratio_median": float(np.median(ratios)) if ratios else None,
        "log10_residual": (math.log10(measured / predicted)
                           if measured > 0 and predicted > 0 else None),
    }
    if cost_slots > 0:
        out["predicted_slots"] = cost_slots
        out["measured_s_per_slot"] = measured / cost_slots  # calibrated unit
    if total_bytes > 0:
        out["bytes"] = total_bytes
        if measured > 0:
            out["measured_bw_bytes_per_s"] = total_bytes / measured
    return out


def calibration_summary(*recorders, extra: list[dict] | None = None) -> dict:
    """Per-kind predicted-vs-measured residuals across one or more
    recorders (e.g. a resident run + a disk-residency run).  ``extra``
    merges in launch-shaped records built outside span capture."""
    by_kind: dict[str, list[dict]] = {}
    for rec in recorders:
        for launch in collect_launches(rec):
            by_kind.setdefault(launch["kind"], []).append(launch)
    for launch in extra or ():
        by_kind.setdefault(launch["kind"], []).append(launch)
    return {kind: _kind_summary(ls) for kind, ls in sorted(by_kind.items())}


def bench_obs_doc(recorders: dict, *, overhead: dict | None = None,
                  meta: dict | None = None,
                  extra_launches: list[dict] | None = None,
                  fleet: dict | None = None) -> dict:
    """The BENCH_obs.json schema: model constants, per-kind calibration
    residuals (merged across the labelled recorders plus any
    ``extra_launches``), per-recorder metric dumps, the obs-overhead
    measurement, and a fleet report when provided."""
    doc = {
        "model": {
            "slot_time_s": cost_model.SLOT_TIME_S,
            # the JAX package's key, for schema parity: the dense tactic's
            # slot advantage (tensor-core / MXU dense cells per ELL slot)
            "mxu_slot_advantage": cost_model.DENSE_SLOT_ADVANTAGE,
            "disk_read_bw": cost_model.DISK_READ_BW,
        },
        "calibration": calibration_summary(*recorders.values(),
                                           extra=extra_launches),
        "metrics": {label: rec.metrics.to_dicts()
                    for label, rec in recorders.items()},
    }
    if overhead is not None:
        doc["overhead"] = overhead
    if meta is not None:
        doc["meta"] = meta
    if fleet is not None:
        doc["fleet"] = fleet
    return doc


def write_bench_obs(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def _series_values(recorder, name: str) -> list[float]:
    inst = recorder.metrics.get(name)
    return list(getattr(inst, "values", []) or [])


def format_live_report(recorder, *, plan=None) -> str:
    """Measured-run section for ``PMVEngine.explain(live=True)``: joins the
    recorder's per-iteration series (and any launch spans) against the
    plan's predictions."""
    lines = ["live (measured):"]
    walls = _series_values(recorder, "pmv.iter_wall_s")
    if walls:
        lines.append(
            f"  iterations={len(walls)}"
            f" median_iter={np.median(walls) * 1e3:.3f} ms"
            f" total={sum(walls) * 1e3:.3f} ms")
        if plan is not None and plan.planned_slots > 0:
            pred = cost_model.slot_seconds(plan.planned_slots)
            lines.append(
                f"  predicted iter compute {pred * 1e3:.3f} ms"
                f" ({plan.planned_slots:.0f} slots)"
                f" -> measured/predicted {np.median(walls) / pred:.2f}x")
    deltas = _series_values(recorder, "pmv.delta")
    if deltas:
        lines.append(
            f"  delta trajectory: {deltas[0]:.3e} -> {deltas[-1]:.3e}"
            f" over {len(deltas)} iters")
    xbytes = _series_values(recorder, "pmv.exchanged_bytes")
    if xbytes and sum(xbytes):
        lines.append(f"  exchange: {np.median(xbytes):.0f} wire B/iter"
                     f" (paper's headline metric, measured)")
    gbytes = _series_values(recorder, "pmv.gathered_bytes")
    if gbytes and sum(gbytes):
        lines.append(f"  gather: {np.median(gbytes):.0f} wire B/iter")
    iobytes = _series_values(recorder, "pmv.io_bytes")
    if iobytes and sum(iobytes):
        overlaps = _series_values(recorder, "pmv.io_overlap")
        lines.append(
            f"  disk I/O: {np.median(iobytes):.0f} B/iter read,"
            f" prefetch overlap {np.median(overlaps):.2f}" if overlaps else
            f"  disk I/O: {np.median(iobytes):.0f} B/iter read")
    calib = calibration_summary(recorder)
    for kind, s in calib.items():
        if s["ratio"] is None:
            continue
        lines.append(
            f"  {kind}: {s['launches']} launches,"
            f" predicted {s['predicted_s'] * 1e3:.3f} ms"
            f" -> measured {s['measured_s'] * 1e3:.3f} ms"
            f" ({s['ratio']:.2f}x)")
    if len(lines) == 1:
        lines.append("  (no measured iterations recorded)")
    return "\n".join(lines)


def format_calibration(doc: dict) -> str:
    """Human-readable table for a BENCH_obs.json document: per-kind ratios,
    the overhead gate numbers, and the fleet straggler digest when the doc
    carries one."""
    lines = ["calibration (measured / predicted):"]
    for kind, s in doc.get("calibration", {}).items():
        ratio = f"{s['ratio']:8.2f}x" if s.get("ratio") is not None else "       -"
        med = (f"  median {s['ratio_median']:8.2f}x"
               if s.get("ratio_median") is not None else "")
        lines.append(f"  {kind:<14} {s['launches']:5d} launches"
                     f"  ratio {ratio}{med}")
    if len(lines) == 1:
        lines.append("  (none)")
    ov = doc.get("overhead")
    if ov:
        lines.append(f"overhead: off {ov['off_ratio']:.3f}x"
                     f"  on {ov['on_ratio']:.3f}x  (vs plain)")
        spmd = ov.get("spmd")
        if spmd:
            lines.append(
                f"overhead[spmd W={spmd.get('workers', '?')}]:"
                f" off {spmd['off_ratio']:.3f}x  on {spmd['on_ratio']:.3f}x")
    fleet = doc.get("fleet")
    if fleet:
        lines.append(
            f"fleet: {fleet['workers']} workers,"
            f" {len(fleet['iterations'])} iterations,"
            f" skew median {fleet['skew']['median']:.2f}x"
            f" worst {fleet['skew']['max']:.2f}x,"
            f" stragglers {fleet['straggler_workers'] or 'none'}")
    return "\n".join(lines)
