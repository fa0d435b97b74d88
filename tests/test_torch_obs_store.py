"""repro_torch.obs out of core and in the server, on the CPU, held against
the JAX package's repro.obs: the disk engine (vertical over the sparse and
the packed exchange, horizontal, the θ-split hybrid) bitwise with obs on
and off, with the store.fetch / store.wait / launch.disk_block /
pmv.iteration spans, the plan's predictions on every launch, and the
span, counter and series names, plan gauges and store byte counters of the
JAX package's run on the same store; explain(live=True) out of core; the
server's spans, counters and histograms, resident and from a store, and
its answers bitwise with obs off."""
import os
import shutil

import numpy as np
import pytest

import repro.core as J
import repro.obs as JO
import repro.serving as JS
import repro_torch.core as T
import repro_torch.serving as TS
from repro.graph import rmat
from repro_torch.obs import NULL_RECORDER, Recorder, check_span_nesting, validate_chrome_trace
from repro_torch.store import ingest_edges, open_store

N, B, THETA, ITERS = 128, 4, 4.0, 4
EDGES = rmat(7, 900, seed=11)
# name -> engine knobs
DISK = {
    "vertical": dict(strategy="vertical"),
    "packed": dict(strategy="vertical", exchange="packed", scatter="kernel"),
    "horizontal": dict(strategy="horizontal"),
    "hybrid": dict(strategy="hybrid", theta=THETA),
}
ALGOS = {"pagerank": lambda m: m.pagerank(N), "sssp": lambda m: m.sssp(0)}
# per-iteration keys that are host times, not results
TIMES = ("wall_s", "store_io_s", "store_wait_s", "store_compute_s", "store_overlap",
         "store_read_s", "store_verify_s", "store_weights_s", "store_h2d_s")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A port-written θ-split store (byte for byte the JAX package's) that
    both packages read."""
    root = str(tmp_path_factory.mktemp("obs_store") / "s")
    ingest_edges(EDGES, N, B, root, theta=THETA)
    return root


def _pipelines(ex):
    """The live prefetch pipelines of a disk executor, port or JAX package."""
    if hasattr(ex, "legs"):
        return [leg.pipeline for leg in ex.legs if leg.pipeline is not None]
    return [p for p in (ex._pipeline, getattr(ex, "_dense_pipeline", None)) if p is not None]


def settle(ex) -> float:
    """Wait for each pipeline's fetch in flight (the next iteration's first
    block, prefetched behind the last) and return the bytes it read: the
    store counters count it, the per-iteration records bill a slice when an
    iteration consumes it."""
    pending = 0.0
    for p in _pipelines(ex):
        if p._fut is not None:
            pending += float(p._fut[1].result()[0]["nbytes"])
    return pending


def names(rec) -> tuple[set, set]:
    return {e["name"] for e in rec.events}, {d["name"] for d in rec.metrics.to_dicts()}


def results(r) -> list[dict]:
    return [{k: x for k, x in it.items() if k not in TIMES} for it in r.per_iter]


@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("case", sorted(DISK))
def test_recorder_onoff_bitwise_parity_disk(case, algo, store):
    spec_of = ALGOS[algo]

    r_off = T.PMVEngine(None, store=store, residency="disk", device="cpu",
                        **DISK[case]).run(spec_of(T), max_iters=ITERS, tol=0.0)
    rec = Recorder()
    t_eng = T.PMVEngine(None, store=store, residency="disk", obs=rec, device="cpu",
                        **DISK[case])
    spec = spec_of(T)
    r_on = t_eng.run(spec, max_iters=ITERS, tol=0.0)
    np.testing.assert_array_equal(r_off.v, r_on.v)
    np.testing.assert_array_equal(r_off.deltas, r_on.deltas)
    assert results(r_off) == results(r_on)
    meta = t_eng.prepare(spec)[-1]
    pending = settle(meta["executor"])

    doc = rec.to_chrome_trace()
    validate_chrome_trace(doc)
    check_span_nesting(doc)
    spans, metrics = names(rec)
    assert {"store.fetch", "store.wait", "launch.disk_block", "pmv.iteration"} <= spans
    launches = rec.spans("launch.disk_block")
    fetched = int(r_on.totals["store_blocks_fetched"])
    assert len(launches) == fetched
    if meta["plan"] is not None:
        assert all(e["attrs"]["predicted_s"] > 0.0 for e in launches)
    else:   # the hybrid walks a structural schedule: no plan, no prediction
        assert all("attrs" not in e for e in launches)
    for e in rec.spans("store.fetch"):
        assert e["attrs"]["bytes"] > 0 and e["attrs"]["predicted_s"] > 0.0
    # the counters bill every read, the records every consumed slice
    assert rec.counter("store.bytes_read").value == r_on.totals["store_bytes_read"] + pending
    assert rec.counter("store.blocks_fetched").value == fetched + len(_pipelines(meta["executor"]))
    assert rec.series("pmv.io_bytes").values == [it["store_bytes_read"] for it in r_on.per_iter]

    j_rec = JO.Recorder()
    j_eng = J.PMVEngine(None, store=store, residency="disk", obs=j_rec, **DISK[case])
    j_spec = spec_of(J)
    r_ref = j_eng.run(j_spec, max_iters=ITERS, tol=0.0)
    j_pending = settle(j_eng.prepare(j_spec)[-1]["executor"])
    assert (spans, metrics) == names(j_rec)
    for name in ("store.bytes_read", "store.blocks_fetched"):
        assert rec.counter(name).value == j_rec.counter(name).value, name
    assert pending == j_pending
    for g in [m for m in metrics if m.startswith("plan.")]:
        assert rec.gauge(g).value == pytest.approx(j_rec.gauge(g).value, rel=1e-12), g
    assert [e.get("attrs", {}).get("predicted_cost") for e in launches] == \
        [e.get("attrs", {}).get("predicted_cost") for e in j_rec.spans("launch.disk_block")]
    for name in ("pmv.exchanged_bytes", "pmv.gathered_bytes", "pmv.io_bytes"):
        assert rec.series(name).values == j_rec.series(name).values, name
    if algo == "sssp":
        assert rec.series("pmv.delta").values == j_rec.series("pmv.delta").values
        np.testing.assert_array_equal(r_on.v, r_ref.v)
    else:
        np.testing.assert_allclose(rec.series("pmv.delta").values,
                                   j_rec.series("pmv.delta").values, rtol=1e-5, atol=1e-7)


def test_hybrid_fetch_threads_record_on_their_own_lanes(store):
    """The hybrid's two prefetch threads record their fetches on lanes of
    their own, apart from the compute loop's, so the trace nests."""
    rec = Recorder()
    eng = T.PMVEngine(None, store=store, residency="disk", obs=rec, device="cpu",
                      **DISK["hybrid"])
    eng.run(T.sssp(0), max_iters=3, tol=0.0)
    main = {e["tid"] for e in rec.spans("pmv.iteration")}
    fetch_lanes = {e["tid"] for e in rec.spans("store.fetch")} - main
    assert len(main) == 1 and len(fetch_lanes) >= 2
    check_span_nesting(rec.to_chrome_trace())


def test_prepare_spans_out_of_core(store):
    """The disk prepares record the JAX package's spans: plan, exchange
    (packed) and store; the hybrid only store."""
    got = {}
    for case in ("vertical", "packed", "hybrid"):
        rec, j_rec = Recorder(), JO.Recorder()
        T.PMVEngine(None, store=store, residency="disk", obs=rec, device="cpu",
                    **DISK[case]).prepare(T.sssp(0))
        J.PMVEngine(None, store=store, residency="disk", obs=j_rec, **DISK[case]).prepare(
            J.sssp(0))
        got[case] = {e["name"] for e in rec.events}
        assert got[case] == {e["name"] for e in j_rec.events}, case
    assert got["vertical"] == {"prepare.plan", "prepare.store"}
    assert got["packed"] == {"prepare.plan", "prepare.exchange", "prepare.store"}
    assert got["hybrid"] == {"prepare.store"}


@pytest.mark.parametrize("case", ["vertical", "horizontal"])
def test_explain_live_disk_traces_launches(case, store):
    eng = T.PMVEngine(None, store=store, residency="disk", device="cpu", **DISK[case])
    spec = T.pagerank(N)
    text = eng.explain(spec, live=True)
    assert "live (measured):" in text
    assert "iterations=3" in text
    assert "disk_block" in text       # calibration line for the disk launches
    assert "disk I/O" in text
    # the swapped probe recorder must not leak into the engine, executor or store
    meta = eng.prepare(spec)[-1]
    assert eng.obs is NULL_RECORDER
    assert meta["executor"].obs is NULL_RECORDER
    assert meta["store"].obs is NULL_RECORDER
    # explain(live=False) out of core: the plan rows after the header are
    # the JAX package's ('torch' there is the JAX package's 'xla' mode)
    t_lines = eng.explain(spec).splitlines()
    j_lines = J.PMVEngine(None, store=store, residency="disk", **DISK[case]).explain(
        J.pagerank(N)).splitlines()
    assert t_lines[0].replace("mode=torch", "mode=xla") == j_lines[0]
    assert t_lines[1:] == j_lines[1:]


def test_explain_hybrid_disk_restores_recorders(store):
    rec = Recorder()
    eng = T.PMVEngine(None, store=store, residency="disk", obs=rec, device="cpu",
                      **DISK["hybrid"])
    spec = T.sssp(0)
    text = eng.explain(spec, live=True)
    assert text.startswith("hybrid out-of-core: structural schedule")
    assert "iterations=3" in text
    meta = eng.prepare(spec)[-1]
    assert eng.obs is rec and meta["executor"].obs is rec and meta["store"].obs is rec
    assert not rec.spans("pmv.iteration")


# ---------------------------------------------------------------------------
# Server.
# ---------------------------------------------------------------------------

def _server_queries(mod):
    return [mod.Query(spec_kind="pagerank", tol=1e-4),
            mod.Query(spec_kind="rwr", source=3, c=0.2, tol=1e-4)]


def test_server_stats_and_histograms(small_graph):
    edges, n = small_graph
    rec = Recorder()
    srv = TS.PMVServer(edges, n, b=4, strategy="vertical", backend="auto", obs=rec,
                       device="cpu")
    results = srv.serve(_server_queries(TS))
    assert len(results) == 2 and all(r.converged for r in results)
    s = srv.stats()
    assert s["retired"] == 2 and s["requeued"] == 0
    assert s["fallback_events"] == []
    assert 0.0 < s["batch_occupancy"] <= 1.0
    assert s["queue_wait_s"] >= 0.0
    lat = rec.histogram("serve.query_latency_s").to_dict()
    assert lat["count"] == 2 and lat["min"] > 0.0
    assert rec.histogram("serve.queue_wait_s").to_dict()["count"] == 2
    assert rec.histogram("serve.query_iterations").to_dict()["count"] == 2
    assert rec.counter("serve.retired").value == 2
    assert rec.gauge("serve.batch_occupancy").value == s["batch_occupancy"]
    assert {e["name"] for e in rec.events} >= {"serve.batch", "serve.iteration"}
    assert len(rec.spans("serve.iteration")) == s["iterations"]
    doc = rec.to_chrome_trace()
    validate_chrome_trace(doc)
    check_span_nesting(doc)
    # the same span and metric names as the JAX package's server
    j_rec = JO.Recorder()
    JS.PMVServer(edges, n, b=4, strategy="vertical", backend="auto", obs=j_rec).serve(
        _server_queries(JS))
    assert names(rec) == names(j_rec)
    hist = rec.histogram("serve.query_iterations").to_dict()
    j_hist = j_rec.histogram("serve.query_iterations").to_dict()
    assert (hist["count"], hist["min"], hist["max"]) == \
        (j_hist["count"], j_hist["min"], j_hist["max"])


def test_server_obs_off_is_bitwise_identical(small_graph):
    edges, n = small_graph

    def serve(obs):
        srv = TS.PMVServer(edges, n, b=4, strategy="vertical", backend="auto", obs=obs,
                           device="cpu")
        return srv.serve([TS.Query(spec_kind="pagerank", tol=1e-4),
                          TS.Query(spec_kind="sssp", source=1, tol=0.5)])

    r_off = serve(None)
    r_on = serve(Recorder())
    for a, b_ in zip(r_off, r_on):
        np.testing.assert_array_equal(a.vector, b_.vector)
        assert a.iterations == b_.iterations


def test_server_shed_and_deadline_counters(small_graph):
    """serve.shed counts the queries refused at admission, and
    serve.deadline_exceeded the columns retired by their deadline."""
    edges, n = small_graph
    rec = Recorder()
    srv = TS.PMVServer(edges, n, b=4, strategy="vertical", obs=rec, max_queue=2,
                       device="cpu")
    qs = [TS.Query(spec_kind="sssp", source=i, tol=0.5) for i in range(3)]
    qs.append(TS.Query(spec_kind="rwr", source=0, tol=0.0, deadline_s=0.0))
    for q in qs:
        srv.submit(q)
    srv.drain()
    s = srv.stats()
    assert rec.counter("serve.shed").value == s["shed"] == 2
    srv2 = TS.PMVServer(edges, n, b=4, strategy="vertical", obs=rec, device="cpu")
    out = srv2.serve([TS.Query(spec_kind="rwr", source=0, tol=0.0, deadline_s=0.0)])
    assert out[0].reason == "deadline_exceeded"
    assert rec.counter("serve.deadline_exceeded").value == 1
    assert rec.counter("serve.retired").value == s["retired"] + 1


def test_server_from_disk_store_records_fetches(store):
    """PMVServer(store=..., residency='disk', obs=rec): the batches record
    the store's fetch spans under the server's iteration spans, on the JAX
    package's names, and the latency histogram counts the retired queries."""
    rec = Recorder()
    kw = dict(residency="disk", strategy="vertical", buckets=(4,))
    srv = TS.PMVServer(store=store, obs=rec, device="cpu", **kw)
    qs = [TS.Query("sssp", source=s, tol=0.5) for s in (0, 5, 9)]
    out = srv.serve(qs)
    assert all(r.reason == "completed" for r in out)
    spans, metrics = names(rec)
    assert {"store.fetch", "store.wait", "launch.disk_block", "serve.iteration",
            "serve.batch"} <= spans
    s = srv.stats()
    assert rec.histogram("serve.query_latency_s").to_dict()["count"] == s["retired"] == 3
    off = TS.PMVServer(store=store, device="cpu", **kw).serve(
        [TS.Query("sssp", source=s, tol=0.5) for s in (0, 5, 9)])
    for a, b_ in zip(off, out):
        np.testing.assert_array_equal(a.vector, b_.vector)
    j_rec = JO.Recorder()
    JS.PMVServer(store=store, obs=j_rec, **kw).serve(
        [JS.Query("sssp", source=s, tol=0.5) for s in (0, 5, 9)])
    assert (spans, metrics) == names(j_rec)
    check_span_nesting(rec.to_chrome_trace())


def test_failed_batch_counters(store, tmp_path):
    """A flipped seg byte: every fetch of its block fails verification, the
    retries are counted, and the batch is counted failed."""
    root = str(tmp_path / "s")
    shutil.copytree(store, root)
    man = open_store(root)
    worker = 1
    seg = os.path.join(root, "vertical", f"w{worker}.seg.npy")
    arr = np.load(seg, mmap_mode="r")
    block = int(np.flatnonzero(np.asarray(man.array("nnz"))[:, worker])[0])
    offset = os.path.getsize(seg) - arr.nbytes + arr[0].nbytes * block
    with open(seg, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([byte ^ 0xFF]))
    rec = Recorder()
    srv = TS.PMVServer(store=root, residency="disk", strategy="vertical", buckets=(4,),
                       obs=rec, device="cpu")
    out = srv.serve([TS.Query("sssp", source=0, tol=0.5)])
    assert out[0].reason == "failed"
    assert rec.counter("serve.failed_batches").value == 1
    assert rec.counter("store.verify_failures").value >= 3      # every attempt
    assert rec.counter("fault.retry").value >= 2
    assert rec.counter("fault.retry.fetch").value == rec.counter("fault.retry").value
    failed = [e for e in rec.spans("serve.batch") if "failed" in (e.get("attrs") or {})]
    assert [e["attrs"]["failed"] for e in failed] == ["ShardCorruptError"]
