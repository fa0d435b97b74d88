"""repro_torch.obs on the CPU, held against the JAX package's repro.obs:
the recorder, metrics, Chrome trace export and validators; the engine's
obs= knob (bitwise on / off, the same span, counter and series names as
the JAX package's on the same run, the same plan gauges and byte series,
the deltas); the prepare spans; the BENCH_obs document; explain(live=...)
line for line against the JAX package's and its probe recorder; the retry
counters.  The JAX package's profiler, fleet and live modules are not
ported, so their tests have no counterpart here."""
import json
import threading
import tracemalloc

import numpy as np
import pytest
import torch

import repro.core as J
import repro.obs as JO
import repro_torch.core as T
import repro_torch.obs as TO
import repro_torch.obs.recorder as recorder_mod
from _torch_parity import tactic_mix_edges
from repro.graph.generators import erdos_renyi
from repro_torch.obs import (
    NULL_RECORDER,
    NullRecorder,
    Recorder,
    TraceSchemaError,
    as_recorder,
    check_span_nesting,
    validate_chrome_trace,
)
from test_fuzz_parity import TOPOLOGIES, _fuzz_edges


# ---------------------------------------------------------------------------
# Recorder / metrics basics.
# ---------------------------------------------------------------------------

def test_recorder_spans_and_metrics():
    rec = Recorder()
    with rec.span("outer") as sp:
        sp.set("k", 1)
        with rec.span("inner"):
            pass
    rec.counter("c").add(2.0)
    rec.counter("c").add(3.0)
    rec.gauge("g").set(7.0)
    rec.histogram("h").observe(1.0)
    rec.histogram("h").observe(3.0)
    rec.series("s").append(0.5)
    assert [e["name"] for e in rec.events] == ["inner", "outer"]  # finish order
    assert rec.spans("outer")[0]["attrs"] == {"k": 1}
    assert rec.total("outer") >= rec.total("inner") >= 0.0
    assert rec.counter("c").value == 5.0 and rec.counter("c").events == 2
    assert rec.gauge("g").value == 7.0
    h = rec.histogram("h").to_dict()
    assert h["count"] == 2 and h["min"] == 1.0 and h["max"] == 3.0
    assert h["mean"] == 2.0 and h["p50"] in (1.0, 3.0)
    assert rec.series("s").values == [0.5]
    dumps = rec.metrics.to_dicts()
    assert [d["name"] for d in dumps] == ["c", "g", "h", "s"]


def test_metric_kind_mismatch_raises():
    rec = Recorder()
    rec.counter("x").add(1)
    with pytest.raises(TypeError, match="already registered"):
        rec.gauge("x")


def test_as_recorder_normalization():
    assert as_recorder(None) is NULL_RECORDER
    assert as_recorder(False) is NULL_RECORDER
    assert isinstance(as_recorder(True), Recorder)
    rec = Recorder()
    assert as_recorder(rec) is rec
    assert as_recorder(NULL_RECORDER) is NULL_RECORDER
    with pytest.raises(TypeError):
        as_recorder("yes")
    with pytest.raises(TypeError):
        as_recorder(JO.Recorder())   # the JAX package's recorder is not this one


def test_null_recorder_is_allocation_free_singletons():
    """The disabled API hands out module singletons: span / counter / etc.
    never allocate, and fence does NOT synchronize (returns its argument)."""
    nr = NULL_RECORDER
    assert nr.span("a") is nr.span("b")
    assert nr.counter("a") is nr.gauge("b") is nr.histogram("c") is nr.series("d")
    sentinel = object()
    assert nr.fence(sentinel) is sentinel
    t = torch.ones(3)
    assert nr.fence(t) is t
    assert nr.spans() == [] and nr.total("x") == 0.0
    assert isinstance(nr, NullRecorder) and not nr.enabled
    assert nr.child("w0") is nr and nr.shards() == [nr]


def test_disabled_recorder_allocates_nothing_on_hot_path():
    """tracemalloc filtered to the port's recorder module: a traced-shaped
    hot loop against NULL_RECORDER performs zero Python allocations there."""
    nr = NULL_RECORDER
    t = torch.zeros(2)

    def hot_loop():
        for it in range(200):
            with nr.span("pmv.iteration") as sp:
                sp.set("iteration", it)
            nr.counter("pmv.iterations").add(1)
            nr.series("pmv.delta").append(0.0)
            nr.fence(it)
            nr.fence(t)

    hot_loop()  # warm any lazy caches
    filt = tracemalloc.Filter(True, recorder_mod.__file__)
    tracemalloc.start()
    try:
        hot_loop()
        snap = tracemalloc.take_snapshot().filter_traces([filt])
    finally:
        tracemalloc.stop()
    leaks = [(s.traceback, s.size) for s in snap.statistics("lineno") if s.size]
    assert not leaks, leaks


def test_fence_on_cpu_returns_its_argument():
    """Recorder.fence walks tensors, tuples, lists, dicts and None; CPU
    tensors need no wait, and the value comes back as it went in."""
    rec = Recorder()
    x = (torch.ones(2), [torch.zeros(1), None], {"a": torch.arange(3)}, 4)
    assert rec.fence(x) is x
    t = torch.ones(5)
    assert rec.fence(t) is t
    assert rec.fence(None) is None


def test_child_shards_share_epoch_and_metrics():
    rec = Recorder()
    ch = rec.child("w1")
    assert rec.child("w1") is ch and ch.epoch == rec.epoch and ch.metrics is rec.metrics
    with ch.span("x"):
        pass
    ch.counter("n").add(1)
    assert [r.label for r in rec.shards()] == [None, "w1"]
    assert rec.counter("n").value == 1.0 and rec.events == [] and len(ch.events) == 1


def test_threads_get_their_own_trace_tids_and_counters_add_up():
    """Spans from other threads land on their own trace lanes (the disk
    prefetch threads), and concurrent counter adds are not lost."""
    import os
    import sys

    rec = Recorder()
    workers = 2 * (os.cpu_count() or 1) + 2

    def work():
        for _ in range(2000):
            rec.counter("store.bytes_read").add(1)
        with rec.span("store.fetch"):
            pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    with rec.span("main"):
        pass
    assert rec.counter("store.bytes_read").value == 2000.0 * workers
    assert rec.counter("store.bytes_read").events == 2000 * workers
    assert len({e["tid"] for e in rec.events}) >= 2
    check_span_nesting(rec.to_chrome_trace())


def test_histogram_reservoir_matches_the_reference():
    """The Algorithm R reservoir, seeded on the metric name, keeps the same
    values as the JAX package's on the same stream (past its 4096 slots)."""
    values = np.random.default_rng(0).random(10000)
    t, j = Recorder().histogram("serve.query_latency_s"), JO.Recorder().histogram(
        "serve.query_latency_s")
    for v in values:
        t.observe(v)
        j.observe(v)
    assert t.values == j.values
    assert t.to_dict() == j.to_dict()


# ---------------------------------------------------------------------------
# Trace export: schema + nesting.
# ---------------------------------------------------------------------------

def test_chrome_trace_schema_and_nesting(tmp_path):
    rec = Recorder()
    with rec.span("a", {"x": np.int32(3), "t": torch.tensor(2.5)}):
        with rec.span("b"):
            pass
        with rec.span("c"):
            pass
    doc = rec.to_chrome_trace()
    n = validate_chrome_trace(doc)
    assert n == 3
    check_span_nesting(doc)
    assert doc["otherData"] == {"producer": "repro_torch.obs", "spans": 3}
    path = tmp_path / "trace.json"
    rec.write_chrome_trace(str(path))
    reloaded = json.loads(path.read_text())
    assert validate_chrome_trace(reloaded) == 3
    ev_a = next(e for e in reloaded["traceEvents"] if e["name"] == "a")
    assert ev_a["args"] == {"x": 3, "t": 2.5}  # numpy and 0-d tensor attrs became scalars


def test_chrome_trace_schema_rejects_malformed():
    with pytest.raises(TraceSchemaError):
        validate_chrome_trace({"no": "traceEvents"})
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0,
                            "pid": 0, "tid": 0}]}  # X without dur
    with pytest.raises(TraceSchemaError):
        validate_chrome_trace(bad)
    bad = {"traceEvents": [{"name": "x", "ph": "Q", "ts": 0.0, "dur": 1.0,
                            "pid": 0, "tid": 0}]}  # unknown phase
    with pytest.raises(TraceSchemaError):
        validate_chrome_trace(bad)
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0, "dur": 1.0,
                            "pid": 0, "tid": "0"}]}  # tid not an int
    with pytest.raises(TraceSchemaError):
        validate_chrome_trace(bad)


def test_span_nesting_detects_partial_overlap():
    doc = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 100.0, "pid": 0, "tid": 0},
        {"name": "b", "ph": "X", "ts": 50.0, "dur": 100.0, "pid": 0, "tid": 0},
    ]}
    with pytest.raises(Exception, match="overlap"):
        check_span_nesting(doc)
    doc["traceEvents"][1]["tid"] = 1   # on another lane they may overlap
    check_span_nesting(doc)


def test_metrics_jsonl_roundtrip(tmp_path):
    rec = Recorder()
    rec.counter("bytes").add(10)
    rec.series("delta").append(0.25)
    path = tmp_path / "metrics.jsonl"
    rec.write_metrics_jsonl(str(path))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert {r["name"]: r["kind"] for r in rows} == {
        "bytes": "counter", "delta": "series"}


# ---------------------------------------------------------------------------
# Engine: recorder on / off bitwise parity, names and readings vs the JAX package.
# ---------------------------------------------------------------------------

def _max_plus_spec(mod):
    if mod is J:
        import jax.numpy as jnp

        assign = lambda v, r, ctx: jnp.maximum(v, r)  # noqa: E731
    else:
        assign = lambda v, r, ctx: torch.maximum(v, r)  # noqa: E731
    return mod.GimvSpec(name="maxplus", combine2="add", combine_all="max", dtype=np.float32,
                        assign=assign, init=lambda ids, ctx: np.zeros(ids.shape, np.float32))


# semiring -> (spec factory(module, n), symmetrize)
SEMIRINGS = {
    "plus_times": (lambda m, n: m.pagerank(n), False),
    "min_plus": (lambda m, n: m.sssp(0), False),
    "min_src": (lambda m, n: m.connected_components(), True),
    "max_plus": (lambda m, n: _max_plus_spec(m), False),
}
N, B, ITERS = 48, 4, 6

# knob sets beyond the reference's vertical grid, on the 'mixed' topology
CONFIGS = {
    "vertical": dict(strategy="vertical"),
    "horizontal": dict(strategy="horizontal"),
    "hybrid": dict(strategy="hybrid", theta=3.0),
    "packed": dict(strategy="vertical", exchange="packed", scatter="kernel"),
    # 1e-3, not 0.0: at 0.0 a plus_times row is sent when its bits move, and
    # the two packages' float sums differ in the last bits
    "packed_delta": dict(strategy="vertical", exchange="packed", delta_eps=1e-3),
    "stream": dict(strategy="vertical", stream="on", scatter="kernel"),
}

PLAN_GAUGES = ("plan.predicted_slots", "plan.capacity", "plan.tactic.skip", "plan.tactic.ell",
               "plan.tactic.dense", "plan.mean_occupancy", "plan.io_bytes_per_iter")


def names(rec) -> tuple[set, set]:
    """(span names, metric names) of a recorder."""
    return {e["name"] for e in rec.events}, {d["name"] for d in rec.metrics.to_dicts()}


def series(rec, name):
    inst = rec.metrics.get(name)
    return None if inst is None else list(inst.values)


def hold_against_reference(t_rec, j_rec, exact: bool) -> None:
    """The contract's readings: the same span / metric names, plan gauges,
    byte series and (bitwise for selection semirings) delta series."""
    assert names(t_rec) == names(j_rec)
    for g in PLAN_GAUGES:
        jg = j_rec.metrics.get(g)
        tg = t_rec.metrics.get(g)
        assert (tg is None) == (jg is None), g
        if jg is not None:
            assert tg.value == pytest.approx(jg.value, rel=1e-12, abs=0), g
    for name in ("pmv.exchanged_bytes", "pmv.gathered_bytes", "pmv.exchange_payload_bytes",
                 "pmv.exchange_id_bytes_amortized", "pmv.io_bytes"):
        assert series(t_rec, name) == series(j_rec, name), name
    if exact:
        assert series(t_rec, "pmv.delta") == series(j_rec, "pmv.delta")
        assert series(t_rec, "pmv.delta_sent_rows") == series(j_rec, "pmv.delta_sent_rows")
    else:
        np.testing.assert_allclose(series(t_rec, "pmv.delta"), series(j_rec, "pmv.delta"),
                                   rtol=1e-5, atol=1e-7)
    assert t_rec.counter("pmv.iterations").value == j_rec.counter("pmv.iterations").value


def check_onoff(edges, semiring, knobs, *, n=N, b=B, iters=ITERS):
    make_spec, sym = SEMIRINGS[semiring]
    kw = dict(b=b, backend="auto", symmetrize=sym, **knobs)

    def solve(obs):
        return T.PMVEngine(edges, n, obs=obs, device="cpu", **kw).run(
            make_spec(T, n), max_iters=iters)

    r_off = solve(None)
    rec = Recorder()
    r_on = solve(rec)
    np.testing.assert_array_equal(r_off.v, r_on.v)            # bitwise, not allclose
    np.testing.assert_array_equal(r_off.deltas, r_on.deltas)
    assert r_off.iterations == r_on.iterations
    drop = ("wall_s",)
    assert [{k: x for k, x in r.items() if k not in drop} for r in r_off.per_iter] == \
        [{k: x for k, x in r.items() if k not in drop} for r in r_on.per_iter]
    assert rec.spans("pmv.iteration")
    assert len(rec.series("pmv.delta").values) == r_on.iterations
    assert [e["attrs"]["iteration"] for e in rec.spans("pmv.iteration")] == \
        list(range(r_on.iterations))
    doc = rec.to_chrome_trace()
    validate_chrome_trace(doc)
    check_span_nesting(doc)
    j_rec = JO.Recorder()
    J.PMVEngine(edges, n, obs=j_rec, **kw).run(make_spec(J, n), max_iters=iters)
    hold_against_reference(rec, j_rec, exact=semiring != "plus_times")
    return rec


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("semiring", sorted(SEMIRINGS))
def test_recorder_onoff_bitwise_parity(topology, semiring):
    """The reference's grid (n 48, b 4, vertical, backend='auto', 6
    iterations): obs on is bitwise obs off, and the recorded names, plan
    gauges and series are the JAX package's on the same run."""
    seed = TOPOLOGIES.index(topology) * 10 + sorted(SEMIRINGS).index(semiring)
    edges = _fuzz_edges(topology, N, B, np.random.default_rng(seed))
    check_onoff(edges, semiring, CONFIGS["vertical"])


# delta iteration gates on a float sum: the other semirings keep the full
# stream, which the 'packed' cases cover
CONFIG_CASES = [(c, s) for c in CONFIGS if c != "vertical" for s in sorted(SEMIRINGS)
                if c != "packed_delta" or s == "plus_times"]


@pytest.mark.parametrize("config,semiring", CONFIG_CASES,
                         ids=[f"{s}-{c}" for c, s in CONFIG_CASES])
def test_recorder_onoff_bitwise_parity_configs(config, semiring):
    """The same contract for horizontal, hybrid, packed (with and without
    delta iteration) and the bucket-streamed executor."""
    edges = _fuzz_edges("mixed", N, B, np.random.default_rng(7))
    rec = check_onoff(edges, semiring, CONFIGS[config])
    if config in ("packed", "packed_delta"):
        assert rec.spans("prepare.exchange")


def test_recorder_onoff_streamed_tactic_mix():
    """stream='on' on the tactic-mix graph (skip, ell and dense blocks)."""
    rec = check_onoff(tactic_mix_edges(64, 4), "min_plus", CONFIGS["stream"], n=64)
    assert rec.gauge("plan.tactic.dense").value > 0 and rec.gauge("plan.tactic.skip").value > 0


def test_engine_spans_nest_and_cover_prepare(small_graph):
    edges, n = small_graph
    rec = Recorder()
    eng = T.PMVEngine(edges, n, b=4, strategy="vertical", backend="auto", obs=rec,
                      device="cpu")
    spec = T.pagerank(n)
    eng.run(spec, max_iters=3)
    spans = {e["name"] for e in rec.events}
    assert spans == {"prepare.partition", "prepare.stripes", "prepare.plan",
                     "prepare.pack", "prepare.device_put", "pmv.iteration"}
    j_rec = JO.Recorder()
    J.PMVEngine(edges, n, b=4, strategy="vertical", backend="auto", obs=j_rec).run(
        J.pagerank(n), max_iters=3)
    assert spans == {e["name"] for e in j_rec.events}
    doc = rec.to_chrome_trace()
    validate_chrome_trace(doc)
    check_span_nesting(doc)
    assert rec.gauge("plan.predicted_slots").value > 0
    assert rec.counter("pmv.iterations").value == 3
    part = rec.spans("prepare.partition")[0]["attrs"]
    assert part == {"spec": "pagerank", "strategy": "vertical"}
    plan = rec.spans("prepare.plan")[0]["attrs"]
    assert plan["mode"] == "planned" and plan["predicted_slots"] == \
        rec.gauge("plan.predicted_slots").value
    # the prepare spans sit inside prepare_s, one after another
    meta = eng.prepare(spec)[-1]
    prep = sum(e["dur"] for e in rec.spans("prepare."))
    assert 0.0 < prep <= meta["prepare_s"]


def test_prepare_is_traced_once_per_spec(small_graph):
    """The prepare is cached per spec: a second run records iterations only."""
    edges, n = small_graph
    rec = Recorder()
    eng = T.PMVEngine(edges, n, b=4, strategy="hybrid", theta=4.0, backend="auto", obs=rec,
                      device="cpu")
    spec = T.sssp(0)
    eng.run(spec, max_iters=2, tol=0.0)
    eng.run(spec, max_iters=2, tol=0.0)
    assert len(rec.spans("prepare.partition")) == 1
    assert len(rec.spans("pmv.iteration")) == 4
    assert rec.counter("pmv.iterations").value == 4


# ---------------------------------------------------------------------------
# Report, explain, retry.
# ---------------------------------------------------------------------------

def test_bench_obs_doc_schema(small_graph):
    edges, n = small_graph
    rec = Recorder()
    T.PMVEngine(edges, n, b=4, strategy="vertical", backend="auto", obs=rec,
                device="cpu").run(T.pagerank(n), max_iters=3)
    doc = TO.bench_obs_doc({"resident": rec}, overhead={"ratio": 1.0}, meta={"n": n})
    assert set(doc) == {"model", "calibration", "metrics", "overhead", "meta"}
    assert set(doc["model"]) == {"slot_time_s", "mxu_slot_advantage", "disk_read_bw"}
    assert doc["model"]["slot_time_s"] == pytest.approx(8.0 / 3.35e12)
    assert doc["model"]["mxu_slot_advantage"] == 8.0 and doc["model"]["disk_read_bw"] == 2e9
    assert "resident" in doc["metrics"]
    json.dumps(doc)  # fully serializable
    assert TO.format_calibration(doc | {"overhead": {"off_ratio": 1.0, "on_ratio": 1.01}}) \
        .splitlines()[-1] == "overhead: off 1.000x  on 1.010x  (vs plain)"
    j_rec = JO.Recorder()
    J.PMVEngine(edges, n, b=4, strategy="vertical", backend="auto", obs=j_rec).run(
        J.pagerank(n), max_iters=3)
    j_doc = JO.bench_obs_doc({"resident": j_rec}, overhead={"ratio": 1.0}, meta={"n": n})
    assert set(doc) == set(j_doc) and set(doc["model"]) == set(j_doc["model"])
    assert [m["name"] for m in doc["metrics"]["resident"]] == \
        [m["name"] for m in j_doc["metrics"]["resident"]]


def test_calibration_summary_joins_launch_spans():
    """calibration_summary reduces launch-shaped spans per kind, as the JAX
    package's does on the same events."""
    t_rec, j_rec = Recorder(), JO.Recorder()
    for rec in (t_rec, j_rec):
        for k, dur in enumerate((0.002, 0.004)):
            rec.events.append({"name": "launch.disk_block", "ts": 0.0, "dur": dur, "tid": 0,
                               "attrs": {"block": k, "predicted_cost": 1e6,
                                         "predicted_s": 1e6 * 2.4e-12}})
        rec.events.append({"name": "store.fetch", "ts": 0.0, "dur": 0.001, "tid": 1,
                           "attrs": {"block": 0, "bytes": 4e6, "predicted_s": 2e-3}})
        rec.events.append({"name": "pmv.iteration", "ts": 0.0, "dur": 0.01, "tid": 0})
    t_cal, j_cal = TO.calibration_summary(t_rec), JO.calibration_summary(j_rec)
    assert t_cal == j_cal
    assert set(t_cal) == {"disk_block", "disk_io"}
    assert t_cal["disk_block"]["measured_s_per_slot"] == pytest.approx(0.006 / 2e6)
    assert t_cal["disk_io"]["ratio"] == pytest.approx(0.5)


def test_explain_live_appends_measured_section(small_graph):
    edges, n = small_graph
    eng = T.PMVEngine(edges, n, b=4, strategy="vertical", backend="auto", device="cpu")
    spec = T.pagerank(n)
    text = eng.explain(spec, live=True)
    assert "ExecutionPlan:" in text
    assert "live (measured):" in text
    assert "iterations=3" in text
    assert eng.obs is NULL_RECORDER  # probe recorder was restored
    rec = Recorder()
    eng.obs = rec
    eng.explain(spec, live=True)
    # the probe's iterations go to the probe, never to the engine's recorder
    assert eng.obs is rec and rec.events == [] and len(rec.metrics) == 0


@pytest.mark.parametrize("knobs", [
    dict(strategy="vertical"),
    dict(strategy="vertical", exchange="packed", scatter="kernel"),
    dict(strategy="vertical", exchange="auto", delta_eps=0.0),
    dict(strategy="vertical", exchange="sparse", delta_eps=0.0),
    dict(strategy="horizontal"),
    dict(strategy="hybrid", theta=4.0),
    dict(strategy="vertical", stream="on"),
], ids=["vertical", "packed", "auto-delta", "sparse-delta", "horizontal", "hybrid", "stream"])
def test_explain_matches_reference_line_for_line(knobs, small_graph):
    """explain(live=False): the plan rows and the exchange section are the
    JAX package's, line for line, for the same knobs."""
    edges, n = small_graph
    t_text = T.PMVEngine(edges, n, b=4, backend="auto", device="cpu", **knobs).explain(
        T.sssp(0))
    j_text = J.PMVEngine(edges, n, b=4, backend="auto", **knobs).explain(J.sssp(0))
    assert t_text.splitlines() == j_text.splitlines()


def test_retry_counters_match_reference():
    """RetryPolicy.call(obs=) counts fault.retry, fault.retry.<label> and
    fault.recovered as the JAX package's does on the same flaky function."""
    from repro.faults import RetryPolicy as JRetry
    from repro_torch.faults import RetryPolicy as TRetry

    def flaky(fails):
        state = {"n": 0}

        def fn():
            state["n"] += 1
            if state["n"] <= fails:
                raise OSError("transient")
            return state["n"]

        return fn

    readings = []
    for policy_cls, rec in ((TRetry, Recorder()), (JRetry, JO.Recorder())):
        policy = policy_cls(max_attempts=4, base_delay_s=0.0, max_delay_s=0.0)
        assert policy.call(flaky(2), obs=rec, label="fetch") == 3
        assert policy.call(flaky(0), obs=rec, label="fetch") == 1
        with pytest.raises(OSError):
            policy.call(flaky(9), obs=rec)
        readings.append({d["name"]: d["value"] for d in rec.metrics.to_dicts()})
    assert readings[0] == readings[1]
    assert readings[0] == {"fault.retry": 5.0, "fault.retry.fetch": 2.0, "fault.recovered": 1.0}
    # without obs the policy records nothing and still retries
    assert TRetry(base_delay_s=0.0).call(flaky(1)) == 2


def test_obs_knob_rejects_other_types():
    with pytest.raises(TypeError):
        T.PMVEngine(erdos_renyi(32, 64, seed=0), 32, b=2, obs="yes", device="cpu")
