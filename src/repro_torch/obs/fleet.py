"""Fleet observability: cross-worker trace merging + straggler attribution
(this package's copy of the JAX package's ``repro.obs.fleet``).

- :func:`merge_traces` lays a recorder and its child shards (``Recorder.child``,
  one per worker or per fetch leg) out as one Chrome trace -- one ``pid``
  lane per shard, named with process-metadata events, timelines aligned
  because every shard shares the parent's clock epoch.  The merged document
  passes the same ``validate_chrome_trace`` / ``check_span_nesting`` gates
  as a single-recorder export.
- :func:`merge_trace_docs` merges already-exported trace *files* (the
  ``python -m repro_torch obs merge`` CLI) by re-numbering each document's
  pid lanes.
- :func:`fleet_report` turns a disk run's per-iteration records into a
  straggler report: per-worker critical-path attribution (fetch / wait /
  compute / combine), per-iteration skew (max/median worker fetch wall),
  flagged stragglers with a slow-disk vs dead-prefetch-thread diagnosis, and
  the measured-vs-``cost_model.predicted_overlap`` join whose residuals feed
  ``BENCH_obs.json`` as the ``spmd_io`` / ``spmd_overlap`` calibration kinds.
  A single-card disk run (the ``store_*`` keys of ``PMVResult.per_iter``)
  folds to one worker.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core import cost_model
from repro_torch.obs.trace import to_chrome_trace

__all__ = [
    "merge_traces",
    "merge_trace_docs",
    "fleet_report",
    "FleetReport",
    "write_fleet_report",
]


# ---------------------------------------------------------------------------
# Trace merging.
# ---------------------------------------------------------------------------

def _process_meta(pid: int, label: str) -> dict:
    return {"name": "process_name", "ph": "M", "ts": 0, "pid": pid, "tid": 0,
            "args": {"name": label}}


def merge_traces(recorder) -> dict:
    """One Chrome trace over ``recorder`` and its child shards: shard i's
    spans land on ``pid=i`` (lane order = ``Recorder.shards()``: the parent
    first, then children by label), each lane named by a process-metadata
    event.  Shards share the parent's epoch, so lanes are time-aligned."""
    shards = recorder.shards()
    events: list[dict] = []
    spans = 0
    for pid, shard in enumerate(shards):
        label = shard.label if shard.label is not None else "main"
        events.append(_process_meta(pid, label))
        sub = to_chrome_trace(shard, pid=pid)["traceEvents"]
        spans += len(sub)
        events.extend(sub)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs.fleet",
                      "shards": len(shards), "spans": spans},
    }


def merge_trace_docs(docs: list[dict], labels: list[str] | None = None) -> dict:
    """Merge exported trace documents into one: document i's (possibly
    multiple) pid lanes are renumbered into a disjoint range and prefixed
    with ``labels[i]`` (default ``doc<i>``) in the lane names."""
    if labels is not None and len(labels) != len(docs):
        raise ValueError(f"{len(labels)} labels for {len(docs)} documents")
    events: list[dict] = []
    spans = 0
    next_pid = 0
    for i, doc in enumerate(docs):
        label = labels[i] if labels is not None else f"doc{i}"
        pid_map: dict[int, int] = {}
        names: dict[int, str] = {}
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                names[ev["pid"]] = (ev.get("args") or {}).get("name", "")
        for ev in doc.get("traceEvents", []):
            pid = ev["pid"]
            if pid not in pid_map:
                pid_map[pid] = next_pid
                sub = names.get(pid)
                lane = f"{label}/{sub}" if sub else label
                events.append(_process_meta(next_pid, lane))
                next_pid += 1
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the prefixed lane name above
            ev = dict(ev)
            ev["pid"] = pid_map[pid]
            if ev.get("ph") == "X":
                spans += 1
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs.fleet",
                      "documents": len(docs), "spans": spans},
    }


# ---------------------------------------------------------------------------
# Straggler attribution.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetReport:
    """Per-iteration per-worker attribution of one disk run."""

    workers: int
    iterations: list[dict]          # per-iteration attribution rows
    stragglers: list[dict]          # flagged (iteration, worker) incidents
    straggler_workers: list[int]    # sorted unique flagged workers
    skew: dict                      # max/median/mean of per-iter skew ratios
    overlap: dict                   # measured vs predicted overlap join
    per_worker: list[dict]          # whole-run totals per worker
    threshold: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def calibration_launches(self) -> list[dict]:
        """Launch-shaped records for ``calibration_summary``'s
        ``extra=``: per-iteration ``spmd_io`` (critical-path worker fetch
        wall vs ``per_host_io_seconds``) and ``spmd_overlap`` (measured
        prefetch overlap vs ``predicted_overlap``)."""
        out = []
        for row in self.iterations:
            io = row["worker_io_s"]
            if not io:
                continue
            out.append({
                "kind": "spmd_io",
                "measured_s": max(io),
                "predicted_s": row["predicted_io_s"],
                "bytes": row["bytes_read"],
                "attrs": {"iteration": row["iteration"],
                          "workers": self.workers},
            })
            if row["measured_overlap"] is not None:
                out.append({
                    "kind": "spmd_overlap",
                    "measured_s": row["measured_overlap"],
                    "predicted_s": row["predicted_overlap"],
                    "bytes": None,
                    "attrs": {"iteration": row["iteration"],
                              "workers": self.workers},
                })
        return out

    def format(self) -> str:
        lines = [f"fleet report: {self.workers} workers,"
                 f" {len(self.iterations)} iterations"]
        lines.append(
            f"  skew (max worker fetch / median, per iter):"
            f" median {self.skew['median']:.2f}x"
            f"  worst {self.skew['max']:.2f}x")
        ov = self.overlap
        if ov["measured_mean"] is not None:
            lines.append(
                f"  prefetch overlap: measured {ov['measured_mean']:.2f}"
                f"  predicted {ov['predicted_mean']:.2f}"
                f"  (model residual {ov['ratio']:.2f}x)"
                if ov["ratio"] is not None else
                f"  prefetch overlap: measured {ov['measured_mean']:.2f}")
        for w in self.per_worker:
            flag = ""
            if w["worker"] in self.straggler_workers:
                flag = "  <-- STRAGGLER"
                if w["prefetch_degraded"]:
                    flag += " (prefetch thread dead)"
            lines.append(
                f"  w{w['worker']}: fetch {w['io_s'] * 1e3:9.2f} ms"
                f"  wait {w['wait_s'] * 1e3:8.2f} ms"
                f"  {w['bytes_read'] / 1e6:8.2f} MB"
                f"  {w['blocks_fetched']:.0f} blocks{flag}")
        for s in self.stragglers:
            lines.append(
                f"  iter {s['iteration']}: w{s['worker']} fetch"
                f" {s['io_s'] * 1e3:.1f} ms vs median"
                f" {s['median_io_s'] * 1e3:.1f} ms"
                f" ({s['ratio']:.1f}x) — {s['cause']}")
        if not self.stragglers:
            lines.append("  no stragglers flagged"
                         f" (threshold {self.threshold:.1f}x median)")
        return "\n".join(lines)


def _worker_lists(rec: dict) -> tuple[list, list, list, list, list]:
    """Per-worker (io_s, wait_s, bytes, blocks, degraded) of one iteration
    record; single-host disk records fold to one 'worker'."""
    io = rec.get("store_worker_io_s")
    if io is None:
        if "store_io_s" not in rec:
            return [], [], [], [], []
        return ([rec["store_io_s"]], [rec["store_wait_s"]],
                [rec.get("store_bytes_read", 0.0)],
                [rec.get("store_blocks_fetched", 0.0)], [0.0])
    wait = rec.get("store_worker_wait_s", [0.0] * len(io))
    by = rec.get("store_worker_bytes_read", [0.0] * len(io))
    blocks = rec.get("store_worker_blocks_fetched", [0.0] * len(io))
    degraded = rec.get("store_worker_prefetch_degraded", [0.0] * len(io))
    return list(io), list(wait), list(by), list(blocks), list(degraded)


def fleet_report(result, *, threshold: float = 2.0,
                 min_excess_s: float = 0.02) -> FleetReport:
    """Straggler attribution over a disk-residency run's per-iteration
    records (``PMVResult`` or its ``per_iter`` list).

    A worker is flagged for an iteration when its fetch wall exceeds
    ``threshold ×`` the workers' median AND the excess over the median
    exceeds ``min_excess_s`` (the absolute floor keeps microsecond noise on
    near-empty blocks from flagging healthy workers).  The cause is
    ``prefetch_degraded`` when that worker's prefetch thread died (the
    per-worker degraded flag), else ``slow_fetch`` — a slow disk."""
    per_iter = getattr(result, "per_iter", result)
    iterations: list[dict] = []
    stragglers: list[dict] = []
    skews: list[float] = []
    measured_ov: list[float] = []
    predicted_ov: list[float] = []
    workers = 0
    for rec in per_iter:
        io, wait, by, blocks, degraded = _worker_lists(rec)
        if not io:
            continue
        workers = max(workers, len(io))
        it = int(rec.get("iteration", len(iterations)))
        wall = float(rec.get("wall_s", 0.0))
        compute_s = float(rec.get("store_compute_s", 0.0))
        # the tail outside the disk leg and per-block compute: exchange,
        # assign, convergence — the mesh-wide "combine" attribution
        combine_s = max(0.0, wall - compute_s - max(wait, default=0.0))
        med = float(np.median(io))
        skew = float(max(io) / max(med, 1e-9))
        skews.append(skew)
        bytes_read = float(rec.get("store_bytes_read", sum(by)))
        pred_io = cost_model.per_host_io_seconds(bytes_read, len(io))
        meas = rec.get("store_overlap")
        meas = None if meas is None else float(meas)
        pred = cost_model.predicted_overlap(pred_io, combine_s, compute_s)
        if meas is not None:
            measured_ov.append(meas)
            predicted_ov.append(pred)
        iterations.append({
            "iteration": it, "wall_s": wall, "compute_s": compute_s,
            "combine_s": combine_s, "bytes_read": bytes_read,
            "worker_io_s": io, "worker_wait_s": wait,
            "worker_bytes_read": by, "worker_blocks_fetched": blocks,
            "worker_prefetch_degraded": degraded,
            "skew": skew, "median_io_s": med,
            "measured_overlap": meas, "predicted_overlap": pred,
            "predicted_io_s": pred_io,
        })
        for w, io_w in enumerate(io):
            if io_w > threshold * med and io_w - med > min_excess_s:
                stragglers.append({
                    "iteration": it, "worker": w, "io_s": float(io_w),
                    "median_io_s": med, "ratio": float(io_w / max(med, 1e-9)),
                    "cause": ("prefetch_degraded"
                              if (w < len(degraded) and degraded[w])
                              else "slow_fetch"),
                })
    per_worker = []
    for w in range(workers):
        rows = [r for r in iterations if w < len(r["worker_io_s"])]
        per_worker.append({
            "worker": w,
            "io_s": sum(r["worker_io_s"][w] for r in rows),
            "wait_s": sum(r["worker_wait_s"][w] for r in rows),
            "bytes_read": sum(r["worker_bytes_read"][w] for r in rows),
            "blocks_fetched": sum(r["worker_blocks_fetched"][w] for r in rows),
            "prefetch_degraded": bool(any(
                r["worker_prefetch_degraded"][w] for r in rows
                if w < len(r["worker_prefetch_degraded"]))),
        })
    mo = float(np.mean(measured_ov)) if measured_ov else None
    po = float(np.mean(predicted_ov)) if predicted_ov else None
    return FleetReport(
        workers=workers,
        iterations=iterations,
        stragglers=stragglers,
        straggler_workers=sorted({s["worker"] for s in stragglers}),
        skew={
            "median": float(np.median(skews)) if skews else 1.0,
            "mean": float(np.mean(skews)) if skews else 1.0,
            "max": float(max(skews)) if skews else 1.0,
        },
        overlap={
            "measured_mean": mo, "predicted_mean": po,
            "ratio": (mo / po) if mo is not None and po else None,
            "per_iter": [
                {"iteration": r["iteration"], "measured": r["measured_overlap"],
                 "predicted": r["predicted_overlap"]}
                for r in iterations if r["measured_overlap"] is not None],
        },
        per_worker=per_worker,
        threshold=threshold,
    )


def write_fleet_report(path: str, report: FleetReport) -> None:
    with open(path, "w") as f:
        json.dump(report.to_dict(), f, indent=1)
