"""The port's ``repro_torch.obs.fleet``, ``repro_torch.obs.live``, the
server's ``telemetry=`` and the ``python -m repro_torch`` CLI.

The first part mirrors every test of the JAX package's
``tests/test_obs_fleet.py`` against the port (synthetic records and fake
clocks, so every window and burn assertion is deterministic).  The second
holds the port against the JAX package on the same inputs: fleet reports,
merged traces, the OpenMetrics text and snapshots under one fake clock, the
served SLO counts, the CLI's exit codes and the cost-model functions the
fleet report calls."""
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import repro.core.cost_model as j_cost
import repro.obs as JO
import repro.serving as JS
import repro_torch.core.cost_model as t_cost
import repro_torch.obs as TO
import repro_torch.serving as TS
from repro.graph import rmat
from repro_torch.cli import main as cli_main
from repro_torch.core import PMVEngine, pagerank
from repro_torch.obs import (
    Histogram,
    LiveTelemetry,
    Recorder,
    SloTracker,
    TelemetryConfig,
    WindowedHistogram,
    WindowedRate,
    as_telemetry,
    check_span_nesting,
    fleet_report,
    format_calibration,
    format_top,
    merge_trace_docs,
    merge_traces,
    openmetrics_text,
    validate_chrome_trace,
)
from repro_torch.obs.recorder import HISTOGRAM_RESERVOIR, NULL_RECORDER
from repro_torch.serving import PMVServer, Query

pytestmark = pytest.mark.filterwarnings("error")
ROOT = Path(__file__).resolve().parents[1]


# -- Histogram reservoir: Algorithm R ----------------------------------------

def test_histogram_reservoir_keeps_late_stream_mass():
    """A full reservoir keeps admitting: after RESERVOIR early 1.0s and
    RESERVOIR late 100.0s, the sample holds ~half late values."""
    h = Histogram("lat")
    for _ in range(HISTOGRAM_RESERVOIR):
        h.observe(1.0)
    for _ in range(HISTOGRAM_RESERVOIR):
        h.observe(100.0)
    late = sum(1 for v in h.values if v == 100.0) / len(h.values)
    assert 0.35 < late < 0.65, late
    assert h.percentile(99) == 100.0
    assert h.count == 2 * HISTOGRAM_RESERVOIR
    assert h.min == 1.0 and h.max == 100.0


def test_histogram_reservoir_is_deterministic():
    def fill(name):
        h = Histogram(name)
        for i in range(3 * HISTOGRAM_RESERVOIR):
            h.observe(float(i))
        return h.values

    assert fill("a") == fill("a")          # seeded by name: reproducible
    assert fill("a") != fill("b")          # distinct streams decorrelate


def test_histogram_under_reservoir_is_exact():
    h = Histogram("x")
    for i in range(100):
        h.observe(float(i))
    assert sorted(h.values) == [float(i) for i in range(100)]
    assert h.percentile(50) == pytest.approx(49.5, abs=1.0)


# -- Recorder child shards ---------------------------------------------------

def test_child_shards_share_clock_and_metrics():
    r = Recorder()
    w0, w1 = r.child("w0"), r.child("w1")
    assert r.child("w0") is w0              # idempotent per label
    assert w0.epoch == r.epoch              # shared anchor: aligned lanes
    assert w0.metrics is r.metrics          # fleet-wide counters
    w0.counter("store.prefetch_degraded").add(1)
    assert r.metrics.get("store.prefetch_degraded") is not None
    assert r.shards() == [r, w0, w1]        # parent first, children by label
    assert NULL_RECORDER.child("w0") is NULL_RECORDER
    assert NULL_RECORDER.shards() == [NULL_RECORDER]


def test_merge_traces_one_lane_per_shard():
    r = Recorder()
    with r.span("main.work"):
        pass
    for w in range(3):
        ch = r.child(f"w{w}")
        with ch.span("store.fetch"):
            with ch.span("inner"):
                pass
    doc = merge_traces(r)
    validate_chrome_trace(doc)
    check_span_nesting(doc)
    lanes = {ev["pid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "process_name"}
    assert sorted(lanes.values()) == ["main", "w0", "w1", "w2"]
    by_pid = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X":
            by_pid.setdefault(lanes[ev["pid"]], []).append(ev["name"])
    assert by_pid["main"] == ["main.work"]
    assert sorted(by_pid["w1"]) == ["inner", "store.fetch"]
    assert doc["otherData"]["producer"] == "repro_torch.obs.fleet"


def test_merge_trace_docs_renumbers_disjoint_lanes():
    docs = []
    for _host in range(2):
        r = Recorder()
        with r.span("solve"):
            pass
        with r.child("w0").span("store.fetch"):
            pass
        docs.append(merge_traces(r))
    merged = merge_trace_docs(docs, labels=["hostA", "hostB"])
    validate_chrome_trace(merged)
    check_span_nesting(merged)
    lanes = {ev["pid"]: ev["args"]["name"] for ev in merged["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "process_name"}
    assert sorted(lanes.values()) == [
        "hostA/main", "hostA/w0", "hostB/main", "hostB/w0"]
    assert len(lanes) == 4                  # pids disjoint after renumbering
    with pytest.raises(ValueError, match="labels"):
        merge_trace_docs(docs, labels=["only-one"])


# -- fleet_report straggler attribution --------------------------------------

def _iter_rec(it, io, wait=None, degraded=None, wall=0.5, compute=0.1):
    w = len(io)
    return {
        "iteration": it, "wall_s": wall, "store_compute_s": compute,
        "store_bytes_read": 4e6, "store_overlap": 0.8,
        "store_worker_io_s": io,
        "store_worker_wait_s": wait or [0.0] * w,
        "store_worker_bytes_read": [1e6] * w,
        "store_worker_blocks_fetched": [8.0] * w,
        "store_worker_prefetch_degraded": degraded or [0.0] * w,
    }


def test_fleet_report_flags_only_the_slow_worker():
    rows = [_iter_rec(0, [0.01, 0.01, 0.3, 0.01]),
            _iter_rec(1, [0.01, 0.012, 0.011, 0.009])]
    rep = fleet_report(rows)
    assert rep.workers == 4
    assert rep.straggler_workers == [2]
    (s,) = rep.stragglers
    assert s["iteration"] == 0 and s["cause"] == "slow_fetch"
    assert rep.skew["max"] == pytest.approx(30.0)
    assert "STRAGGLER" in rep.format()


def test_fleet_report_diagnoses_dead_prefetch_thread():
    rows = [_iter_rec(0, [0.01, 0.25, 0.01, 0.01], degraded=[0.0, 1.0, 0.0, 0.0])]
    rep = fleet_report(rows)
    assert rep.straggler_workers == [1]
    assert rep.stragglers[0]["cause"] == "prefetch_degraded"
    assert rep.per_worker[1]["prefetch_degraded"] is True
    assert "prefetch thread dead" in rep.format()


def test_fleet_report_absolute_floor_suppresses_noise():
    """3x ratio on microsecond fetches is NOT a straggler (min_excess_s)."""
    rep = fleet_report([_iter_rec(0, [1e-5, 1e-5, 3e-5, 1e-5])])
    assert rep.straggler_workers == []


def test_fleet_report_calibration_launches_join_cost_model():
    rep = fleet_report([_iter_rec(0, [0.01, 0.01, 0.01, 0.01])])
    launches = rep.calibration_launches()
    kinds = sorted(x["kind"] for x in launches)
    assert kinds == ["spmd_io", "spmd_overlap"]
    io = next(x for x in launches if x["kind"] == "spmd_io")
    assert io["measured_s"] == pytest.approx(0.01)
    assert io["predicted_s"] > 0
    assert rep.overlap["measured_mean"] == pytest.approx(0.8)
    doc = {"calibration": {}, "fleet": rep.to_dict(),
           "overhead": {"off_ratio": 1.01, "on_ratio": 1.05,
                        "spmd": {"workers": 4, "off_ratio": 1.02, "on_ratio": 1.08}}}
    text = format_calibration(doc)
    assert "fleet: 4 workers" in text and "spmd" in text


SINGLE_HOST = {"iteration": 0, "wall_s": 0.2, "store_io_s": 0.05,
               "store_wait_s": 0.01, "store_bytes_read": 1e6,
               "store_blocks_fetched": 8.0, "store_overlap": 0.9,
               "store_compute_s": 0.1}


def test_fleet_report_single_host_fallback():
    rep = fleet_report([dict(SINGLE_HOST)])
    assert rep.workers == 1
    assert rep.straggler_workers == []


# -- rolling windows ---------------------------------------------------------

class _FakeClock:
    def __init__(self, step=0.0):
        self.t = 1000.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def test_windowed_histogram_forgets_old_samples():
    clk = _FakeClock()
    h = WindowedHistogram("lat", window_s=60.0, clock=clk)
    for v in (1.0, 2.0, 3.0):
        h.observe(v)
    clk.t += 30
    h.observe(100.0)
    s = h.snapshot()
    assert s["count"] == 4 and s["p99"] == 100.0
    clk.t += 45                      # the first three fall out of the window
    s = h.snapshot()
    assert s["count"] == 1 and s["p50"] == 100.0
    assert s["total_count"] == 4     # cumulative survives the window
    clk.t += 120
    s = h.snapshot()
    assert s["count"] == 0 and s["p99"] is None and s["rate_per_s"] == 0.0


def test_windowed_rate():
    clk = _FakeClock()
    r = WindowedRate("retired", window_s=10.0, clock=clk)
    for _ in range(20):
        r.add()
    assert r.snapshot()["rate_per_s"] == pytest.approx(2.0)
    clk.t += 11
    assert r.snapshot()["rate_per_s"] == 0.0
    assert r.snapshot()["total_count"] == 20


# -- SLO burn rate -----------------------------------------------------------

def test_slo_burn_rate_math():
    clk = _FakeClock()
    slo = SloTracker(latency_target_s=0.1, latency_objective=0.99,
                     deadline_objective=0.9, windows=(60.0,), clock=clk)
    for _ in range(95):
        slo.record("completed", 0.05)
    for _ in range(3):
        slo.record("completed", 0.5)             # target miss: latency-bad
    slo.record("deadline_exceeded", 0.2, had_deadline=True)
    slo.record("completed", 0.05, had_deadline=True)
    s = slo.snapshot()
    lat = s["latency"]
    # 4 latency-bad of 100 -> 4% errors against a 1% budget: burn 4x
    assert lat["total"]["error_rate"] == pytest.approx(0.04)
    assert lat["total"]["burn_rate"] == pytest.approx(4.0)
    assert lat["windows"]["60s"]["burn_rate"] == pytest.approx(4.0)
    dl = s["deadline"]
    # 1 bad of 2 deadline-carrying -> 50% against a 10% budget: burn 5x
    assert dl["total"]["events"] == 2
    assert dl["total"]["burn_rate"] == pytest.approx(5.0)
    clk.t += 61                                  # window empties, totals stay
    s = slo.snapshot()
    assert s["latency"]["windows"]["60s"]["events"] == 0
    assert s["latency"]["total"]["error_rate"] == pytest.approx(0.04)


def test_slo_without_target_counts_only_failures():
    slo = SloTracker(windows=(60.0,))
    slo.record("completed", 99.0)                # no target: slow-but-done ok
    slo.record("shed", 0.0)
    assert slo.snapshot()["latency"]["total"]["bad"] == 1


# -- OpenMetrics exposition --------------------------------------------------

def test_openmetrics_text_shape():
    clk = _FakeClock()
    live = LiveTelemetry(TelemetryConfig(latency_target_s=0.1, serve=False), clock=clk)
    live.record_retirement("completed", 0.05, queue_wait_s=0.01)
    live.record_retirement("shed", 0.0)
    live.record_iteration(0.02, active=3)
    live.record_queue_depth(7)
    r = Recorder()
    r.counter("serve.retired").add(2)
    r.histogram("serve.query_latency_s").observe(0.05)
    live.registry = r.metrics
    text = live.openmetrics()
    assert text.endswith("# EOF\n")
    assert "# TYPE pmv_serve_retired_total counter" in text
    assert "pmv_serve_retired_total 2.0" in text       # registry counter
    assert 'pmv_serve_query_latency_seconds{window="60s",quantile="0.99"}' in text
    assert 'pmv_slo_burn_rate{objective="latency",window="total"}' in text
    assert "pmv_serve_queue_depth 7.0" in text
    assert "pmv_serve_active_columns 3.0" in text
    # every sample line parses: name{labels} value
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        assert name and (value == "NaN" or float(value) is not None), line
    assert format_top(live.snapshot())                 # renders


def test_as_telemetry_knob():
    assert as_telemetry(None) is None
    assert as_telemetry(False) is None
    t = as_telemetry(True)
    assert isinstance(t, LiveTelemetry) and t.config.serve is True
    cfg = TelemetryConfig(serve=False, latency_target_s=0.5)
    t2 = as_telemetry(cfg)
    assert t2.slo.latency_target_s == 0.5
    assert as_telemetry(t2) is t2
    with pytest.raises(TypeError):
        as_telemetry(object())


# -- the HTTP exporter + PMVServer integration -------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode(), resp.headers.get("Content-Type", "")


def test_live_telemetry_http_endpoints():
    live = LiveTelemetry(TelemetryConfig(serve=False))
    live.record_retirement("completed", 0.05)
    url = live.start_server()
    try:
        assert url == live.start_server()              # idempotent
        body, ctype = _get(url + "/metrics")
        assert "version=0.0.4" in ctype
        assert body.endswith("# EOF\n")
        body, ctype = _get(url + "/metrics.json")
        assert ctype.startswith("application/json")
        snap = json.loads(body)
        assert snap["retired"]["total_count"] == 1
        body, _ = _get(url + "/snapshot")
        assert json.loads(body)["retired"]["total_count"] == 1
        body, _ = _get(url + "/healthz")
        assert body == "ok\n"
    finally:
        live.close()
    assert live.url is None


def _slo_server(mod, **kw):
    return mod.PMVServer(rmat(8, 1500, seed=3), 256, b=4, strategy="vertical", buckets=(4,),
                         max_queue=2, obs=True, **kw)


SLO_QUERIES = [dict(source=i, tol=1e-6, deadline_s=120.0) for i in range(3)]


def test_server_telemetry_slo_over_retirement_ledger():
    srv = _slo_server(TS, telemetry=TelemetryConfig(latency_target_s=60.0, serve=False),
                      device="cpu")
    try:
        qids = [srv.submit(Query("rwr", **q)) for q in SLO_QUERIES]  # third is shed
        res = srv.drain()
        reasons = sorted(res[q].reason for q in qids)
        assert reasons == ["completed", "completed", "shed"]
        stats = srv.stats()
        slo = stats["slo"]
        assert slo["latency"]["total"]["events"] == 3
        assert slo["latency"]["total"]["bad"] == 1     # the shed query
        assert slo["deadline"]["total"]["events"] == 3
        assert slo["deadline"]["total"]["bad"] == 1
        snap = srv.telemetry.snapshot()
        assert snap["retired"]["total_count"] == 3
        assert snap["latency"]["count"] == 3
        assert snap["iteration_wall"]["count"] > 0
        text = openmetrics_text(live=srv.telemetry, registry=srv.obs.metrics)
        assert "pmv_serve_retired_total" in text
    finally:
        srv.close()


def test_server_telemetry_http_scrape_during_serving():
    srv = PMVServer(rmat(8, 1500, seed=4), 256, b=4, strategy="vertical", buckets=(4,),
                    telemetry=True, device="cpu")
    try:
        url = srv.telemetry.url
        assert url is not None                          # serve=True default
        srv.serve([Query("rwr", source=0, tol=1e-6)])
        body, _ = _get(url + "/metrics")
        assert "pmv_serve_retired_total 1.0" in body
    finally:
        srv.close()
    assert srv.telemetry.url is None                    # the exporter is stopped


def test_server_telemetry_off_by_default():
    srv = PMVServer(rmat(7, 600, seed=5), 128, b=4, strategy="vertical", buckets=(4,),
                    device="cpu")
    assert srv.telemetry is None
    srv.serve([Query("rwr", source=0, tol=1e-6)])
    assert "slo" not in srv.stats()
    srv.close()                                        # no-op, must not raise


# -- the `python -m repro_torch obs` CLI -------------------------------------

def test_cli_obs_merge_and_report(tmp_path, capsys):
    paths = []
    for host in range(2):
        r = Recorder()
        with r.child("w0").span("store.fetch"):
            pass
        p = tmp_path / f"host{host}.json"
        p.write_text(json.dumps(merge_traces(r)))
        paths.append(str(p))
    out = str(tmp_path / "merged.json")
    rc = cli_main(["obs", "merge", out, *paths, "--labels", "hostA", "hostB"])
    assert rc == 0
    with open(out) as f:
        merged = json.load(f)
    validate_chrome_trace(merged)
    assert "2 lanes" in capsys.readouterr().out

    bench = tmp_path / "BENCH_obs.json"
    rep = fleet_report([_iter_rec(0, [0.01, 0.01, 0.3, 0.01])])
    bench.write_text(json.dumps({
        "calibration": {"spmd_io": {"launches": 1, "measured_s": 0.3,
                                    "predicted_s": 0.1, "ratio": 3.0,
                                    "ratio_median": 3.0}},
        "fleet": rep.to_dict()}))
    assert cli_main(["obs", "report", str(bench)]) == 0
    out_text = capsys.readouterr().out
    assert "spmd_io" in out_text and "stragglers [2]" in out_text


def test_cli_obs_top(capsys):
    live = LiveTelemetry(TelemetryConfig(serve=False))
    live.record_retirement("completed", 0.042)
    url = live.start_server()
    try:
        assert cli_main(["obs", "top", url, "--count", "1"]) == 0
        out = capsys.readouterr().out
        assert "pmv serve" in out and "latency" in out
    finally:
        live.close()


# -- bitwise: engine solve unchanged by tracing ------------------------------

def _disk_store(tmp_path):
    from repro_torch.store import ingest_edges

    n, b = 200, 4
    edges = rmat(8, 1200, seed=9)[:1200] % n
    return ingest_edges(edges, n, b, str(tmp_path / "s")), n


def test_single_host_disk_solve_bitwise_with_obs(tmp_path):
    man, n = _disk_store(tmp_path)
    spec = pagerank(n)
    off = PMVEngine.from_store(man, residency="disk", strategy="vertical", device="cpu")
    on = PMVEngine.from_store(man, residency="disk", strategy="vertical", obs=True,
                              device="cpu")
    r_off = off.run(spec, max_iters=3, tol=0.0)
    r_on = on.run(spec, max_iters=3, tol=0.0)
    assert np.array_equal(r_off.v, r_on.v)
    rep = fleet_report(r_on)
    assert rep.workers == 1                   # single-host fold
    doc = merge_traces(on.obs)
    validate_chrome_trace(doc)
    check_span_nesting(doc)


# ---------------------------------------------------------------------------
# The port against the JAX package on the same inputs.
# ---------------------------------------------------------------------------

FLEET_ROWS = {
    "straggler": [_iter_rec(0, [0.01, 0.01, 0.3, 0.01]),
                  _iter_rec(1, [0.01, 0.012, 0.011, 0.009])],
    "degraded": [_iter_rec(0, [0.01, 0.25, 0.01, 0.01], degraded=[0.0, 1.0, 0.0, 0.0])],
    "noise": [_iter_rec(0, [1e-5, 1e-5, 3e-5, 1e-5])],
    "single_host": [dict(SINGLE_HOST), dict(SINGLE_HOST, iteration=1, store_overlap=None)],
}


@pytest.mark.parametrize("case", sorted(FLEET_ROWS))
def test_fleet_report_equals_reference(case):
    """fleet_report's whole document, its calibration launches and its text
    equal the JAX package's on the same records."""
    rows = FLEET_ROWS[case]
    got, want = fleet_report(rows), JO.fleet_report(rows)
    assert got.to_dict() == want.to_dict()
    assert got.calibration_launches() == want.calibration_launches()
    assert got.format() == want.format()


# the fields of a report that do not depend on a clock
def _untimed(rep) -> dict:
    d = rep.to_dict()
    keep = ("iteration", "bytes_read", "worker_bytes_read", "worker_blocks_fetched",
            "worker_prefetch_degraded", "predicted_io_s")
    return {"workers": d["workers"], "stragglers": d["stragglers"],
            "threshold": d["threshold"],
            "iterations": [{k: r[k] for k in keep} for r in d["iterations"]],
            "per_worker": [{k: w[k] for k in ("worker", "bytes_read", "blocks_fetched",
                                              "prefetch_degraded")}
                           for w in d["per_worker"]]}


def test_fleet_report_of_a_disk_run_equals_reference(tmp_path):
    """One single-host disk solve in each package over the same store: the
    reports' fields that no clock sets are equal (one worker, its bytes and
    blocks per iteration, the modeled I/O seconds, no straggler)."""
    import repro.core as J

    man, n = _disk_store(tmp_path)
    r_port = PMVEngine.from_store(man.root, residency="disk", strategy="vertical",
                                  device="cpu").run(pagerank(n), max_iters=3, tol=0.0)
    r_ref = J.PMVEngine.from_store(man.root, residency="disk", strategy="vertical").run(
        J.pagerank(n), max_iters=3, tol=0.0)
    got, want = fleet_report(r_port), JO.fleet_report(r_ref)
    assert _untimed(got) == _untimed(want)
    assert got.workers == 1 and got.stragglers == [] and len(got.iterations) == 3


def _drive(rec):
    """The same spans, in the same order, on a recorder of either package."""
    with rec.span("solve", {"k": 1}):
        with rec.span("inner"):
            pass
    for w in range(2):
        ch = rec.child(f"w{w}")
        with ch.span("store.fetch", {"bytes": 64 * (w + 1)}):
            pass
    return rec


def _same_but_producer(a: dict, b: dict) -> None:
    a, b = json.loads(json.dumps(a)), json.loads(json.dumps(b))
    assert a["otherData"].pop("producer") == "repro_torch.obs.fleet"
    assert b["otherData"].pop("producer") == "repro.obs.fleet"
    assert a == b


def test_merged_traces_equal_reference():
    """merge_traces over recorders driven alike under one fake clock, and
    merge_trace_docs over the same documents, equal the JAX package's
    output but for the producer string."""
    got = merge_traces(_drive(Recorder(clock=_FakeClock(0.001))))
    want = JO.merge_traces(_drive(JO.Recorder(clock=_FakeClock(0.001))))
    _same_but_producer(got, want)
    docs = [want, json.loads(json.dumps(want))]
    _same_but_producer(merge_trace_docs(docs, labels=["a", "b"]),
                       JO.merge_trace_docs(docs, labels=["a", "b"]))
    _same_but_producer(merge_trace_docs(docs), JO.merge_trace_docs(docs))


def _feed(mod, recorder_cls):
    """One event stream into a LiveTelemetry of ``mod`` under a fake clock,
    with a registry carrying the server's counters and histograms."""
    clk = _FakeClock()
    live = mod.LiveTelemetry(mod.TelemetryConfig(latency_target_s=0.1, serve=False,
                                                 burn_windows=(30.0, 90.0)), clock=clk)
    rec = recorder_cls()
    for i in range(40):
        clk.t += 1.7
        reason = ("shed", "deadline_exceeded", "failed", "completed")[i % 4] \
            if i % 5 == 0 else "completed"
        lat = 0.013 * (i % 11)
        live.record_retirement(reason, lat, queue_wait_s=0.002 * (i % 3),
                               had_deadline=i % 2 == 0)
        live.record_iteration(0.004 + 0.001 * (i % 7), active=i % 9)
        live.record_queue_depth(i % 6)
        rec.counter("serve.retired").add(1)
        rec.histogram("serve.query_latency_s").observe(lat)
        rec.gauge("serve.occupancy").set(i / 40)
    live.registry = rec.metrics
    return live, clk


def test_openmetrics_and_snapshot_equal_reference():
    """openmetrics_text, snapshot() and format_top equal the JAX package's
    under one fake clock and one event stream, before and after the
    windows drain."""
    got, t_clk = _feed(TO, Recorder)
    want, j_clk = _feed(JO, JO.Recorder)
    for dt in (0.0, 45.0, 200.0):
        t_clk.t += dt
        j_clk.t += dt
        assert got.snapshot() == want.snapshot()
        assert got.openmetrics() == want.openmetrics()
        assert openmetrics_text(live=got) == JO.openmetrics_text(live=want)
        assert format_top(got.snapshot()) == JO.format_top(want.snapshot())


def test_served_slo_counts_equal_reference_and_answers_bitwise():
    """A served run with telemetry on answers bitwise as with it off, and
    its SLO event and bad counts (a shed query included) equal the JAX
    server's on the same queries."""
    def serve(mod, telemetry, **kw):
        srv = _slo_server(mod, telemetry=telemetry, **kw)
        try:
            qids = [srv.submit(mod.Query("rwr", **q)) for q in SLO_QUERIES]
            res = srv.drain()
            return [res[q] for q in qids], srv.stats()
        finally:
            srv.close()

    def cfg(mod):
        return mod.TelemetryConfig(latency_target_s=60.0, serve=False)

    on, st_on = serve(TS, cfg(TO), device="cpu")
    off, st_off = serve(TS, None, device="cpu")
    ref, st_ref = serve(JS, cfg(JO))
    assert "slo" not in st_off
    for a, b, r in zip(on, off, ref):
        assert a.reason == b.reason == r.reason
        assert a.iterations == b.iterations
        if a.vector is None:
            assert b.vector is None and r.vector is None
        else:
            np.testing.assert_array_equal(a.vector, b.vector)

    def counts(slo):
        return {name: (o["total"]["events"], o["total"]["bad"]) for name, o in slo.items()}

    assert counts(st_on["slo"]) == counts(st_ref["slo"]) == {"latency": (3, 1),
                                                             "deadline": (3, 1)}


def _store_variant(tmp_path, variant: str) -> str:
    from repro_torch.store import ingest_edges
    from repro_torch.store import format as fmt

    root = str(tmp_path / variant)
    ingest_edges(rmat(7, 600, seed=1), 128, 4, root)
    if variant == "corrupt":
        mm = np.load(fmt.stripe_path(root, "vertical", 1, "seg"), mmap_mode="r+")
        mm[2, 0] ^= 1
        mm.flush()
        del mm
    elif variant == "unverifiable":
        path = os.path.join(root, "manifest.json")
        with open(path) as f:
            doc = json.load(f)
        doc.pop("checksums")
        with open(path, "w") as f:
            json.dump(doc, f)
    return root


@pytest.mark.parametrize("variant,code", [("clean", 0), ("corrupt", 1), ("unverifiable", 2)])
def test_cli_store_verify_exit_codes_equal_reference(variant, code, tmp_path):
    """``python -m repro_torch store verify`` exits as ``python -m repro
    store verify`` does on a clean, a corrupted and an unverifiable store,
    with the same report line."""
    root = _store_variant(tmp_path, variant)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = {}
    for mod in ("repro_torch", "repro"):
        r = subprocess.run([sys.executable, "-m", mod, "store", "verify", root],
                           capture_output=True, text=True, env=env, timeout=300)
        out[mod] = (r.returncode, r.stdout)
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][0] == code


def test_cost_model_fleet_functions_equal_reference():
    """per_host_io_seconds, pipelined_iteration_seconds and
    predicted_overlap equal the JAX package's, and both refuse zero
    workers."""
    for by in (0.0, 1.0, 4e6, 1.59e9):
        for w in (1, 3, 8):
            assert t_cost.per_host_io_seconds(by, w) == j_cost.per_host_io_seconds(by, w)
    for io, wire, comp in ((0.0, 0.1, 0.2), (1.0, 0.1, 0.2), (0.2, 0.5, 0.5),
                           (1.78, 0.0, 0.17), (-1.0, 0.0, 0.0)):
        assert t_cost.pipelined_iteration_seconds(io, wire, comp) == \
            j_cost.pipelined_iteration_seconds(io, wire, comp)
        assert t_cost.predicted_overlap(io, wire, comp) == j_cost.predicted_overlap(io, wire,
                                                                                    comp)
    for mod in (t_cost, j_cost):
        with pytest.raises(ValueError, match="workers"):
            mod.per_host_io_seconds(1.0, 0)
