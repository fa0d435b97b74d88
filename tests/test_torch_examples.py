"""The eight PMV examples ported onto ``repro_torch`` (``examples/*_torch.py``)
at CPU-test size: each ``main([... '--device', 'cpu'])`` summary against the
JAX package's API called with the same knobs on the same graph (the JAX
example files are module-level scripts and are not run).  SSSP, CC,
iteration counts, θ, capacity, strategy, I/O counts, fault counters and
the plan's tactic per block are equal; PageRank and RWR allclose, as the
reference's own kernel paths are.  The fleet example's SPMD disk solve (its
own spawn of 4 gloo ranks) is held to the JAX package's single-host disk
run, as ``tests/test_torch_spmd_disk.py`` does.  With no ``--device`` and no
card, every example raises before it runs.  Each summary also passes the
JAX-free oracles of ``chip_smoke.py``'s examples phase."""
from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import cost_model as jcost
from repro.faults import CorruptFetch, FaultPlan, InjectedKill, KillAtIteration, RetryPolicy
from repro.faults import TransientIO
from repro.graph.stats import compute_stats as jstats
from repro.obs import Recorder as JRecorder
from repro.obs import calibration_summary as jcalibration
from repro.serving import PMVServer as JServer
from repro.serving import Query as JQuery
from repro.store import ingest_edges as jingest
import scipy.sparse as sp
from scipy.sparse import csgraph

from repro_torch.obs import validate_chrome_trace

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)
NAMES = ("quickstart", "graph_mining", "explain_plan", "serve_queries", "serve_batch",
         "trace_run", "chaos_run", "fleet_trace")
PLUS_TIMES = dict(rtol=1e-5, atol=1e-7)


def example(name: str):
    """``examples/<name>_torch.py`` as a module (``examples/`` is no package)."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the graphs here are small, and xdist's workers
    share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _oracle(name: str, s: dict) -> None:
    """The smoke's examples phase holds the same summary on the card to
    these JAX-free oracles (scipy, bitwise, the trace schema)."""
    checks = smoke.example_checks(np, sp, csgraph, name, s)
    assert checks and all(ok for _, ok in checks), checks


def _disk(store, **kw):
    return J.PMVEngine(None, store=store, residency="disk", strategy="vertical", **kw)


def _landed(engine) -> None:
    """Wait for the block fetch that each prepared disk executor of the JAX
    engine ``engine`` still has in flight after ``run`` (the next
    iteration's first block): it records a ``store.fetch`` span, a
    'disk_io' launch of the calibration feed, when it lands.  The port's
    example waits for its own with ``PMVEngine.close``."""
    for *_, meta in engine._prep_cache.values():
        pipe = getattr(meta.get("executor"), "_pipeline", None)
        if pipe is not None and pipe._fut is not None:
            pipe._fut[1].result()


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_a_card(name, monkeypatch):
    """No ``--device`` and no CUDA device: the example raises the port's
    device error before it runs anything (it never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        example(name).main([])


def test_quickstart_matches_jax():
    s = example("quickstart").main(["--log2n", "9", "--edges", "4000", "--device", "cpu"])
    _oracle("quickstart", s)
    n, edges = s["n"], s["edges"]
    r = J.PMVEngine(edges, n, b=8, strategy="hybrid", theta="auto").run(
        J.pagerank(n), max_iters=120, tol=1e-6)
    assert (s["iterations"], s["converged"], s["strategy"], s["theta"]) == \
        (r.iterations, r.converged, r.strategy, r.theta)
    assert s["io_elems"] == r.per_iter[-1]["io_elems"]
    np.testing.assert_allclose(s["v"], r.v, **PLUS_TIMES)


def test_graph_mining_matches_jax(tmp_path):
    s = example("graph_mining").main(["--log2n", "9", "--edges", "12000", "--b", "8",
                                      "--device", "cpu"])
    _oracle("graph_mining", s)
    n, edges, b = s["n"], s["edges"], s["b"]
    assert s["strategy"] == jcost.select_strategy(b, n, len(edges))
    theta, cost = jcost.theta_star(b, n, jstats(edges, n))
    assert (s["theta_star"], s["cost"]) == (theta, cost)
    runs = {
        "PageRank": (J.pagerank(n), None, dict(max_iters=100, tol=1e-6), {}),
        "RWR(src=7)": (J.random_walk_with_restart(n, 7), J.rwr_context(n, 7),
                       dict(max_iters=100, tol=1e-6), {}),
        "SSSP(src=0)": (J.sssp(0), None, dict(max_iters=n, tol=0.5), {}),
        "ConnectedComponents": (J.connected_components(), None, dict(max_iters=n, tol=0.5),
                                dict(symmetrize=True)),
    }
    assert list(s["runs"]) == list(runs)
    for name, (spec, ctx, kw, ekw) in runs.items():
        r = J.PMVEngine(edges, n, b=b, strategy="hybrid", theta="auto", **ekw).run(
            spec, ctx, checkpoint_dir=str(tmp_path / name), checkpoint_every=10, **kw)
        got = s["runs"][name]
        assert (got["iterations"], got["converged"], got["theta"], got["capacity"],
                got["io_elems"]) == (r.iterations, r.converged, r.theta, r.capacity,
                                     r.per_iter[-1]["io_elems"]), name
        if name.startswith(("SSSP", "Connected")):
            np.testing.assert_array_equal(got["v"], r.v)
        else:
            np.testing.assert_allclose(got["v"], r.v, **PLUS_TIMES)


def test_explain_plan_matches_jax():
    s = example("explain_plan").main(["--device", "cpu"])
    _oracle("explain_plan", s)
    n, edges = s["n"], s["edges"]

    def tactics(eng, spec):
        return [(bp.i, bp.j, bp.tactic) for bp in eng.prepare(spec)[-1]["plan"].blocks]

    for strategy in ("vertical", "hybrid"):
        eng = J.PMVEngine(edges, n, b=4, strategy=strategy, theta="auto", backend="auto")
        assert s["tactics"][strategy] == tactics(eng, J.pagerank(n)), strategy
        assert s["explain"][strategy] == eng.explain(J.pagerank(n)), strategy
    eng = J.PMVEngine(edges, n, b=4, strategy="vertical", backend="auto")
    assert s["tactics"]["sssp"] == tactics(eng, J.sssp(0))
    assert {t for _, _, t in s["tactics"]["vertical"]} == {"ell", "dense"}
    r = J.PMVEngine(edges, n, b=4, strategy="vertical").run(J.sssp(0), max_iters=64, tol=0.0)
    assert s["iterations"] == r.iterations
    np.testing.assert_array_equal(s["v"], r.v)
    assert s["reachable"] == int(np.isfinite(r.v).sum())


def test_serve_queries_matches_jax():
    s = example("serve_queries").main(["--scale", "9", "--edges", "3000", "--queries", "16",
                                       "--device", "cpu"])
    _oracle("serve_queries", s)
    n, edges = s["n"], s["edges"]
    queries = [JQuery(r["kind"], source=r["source"], tol=1e-6 if r["kind"] == "rwr" else 0.5)
               for r in s["results"]]
    assert [q.spec_kind for q in queries] == ["rwr", "sssp"] * 8
    want = JServer(edges, n, b=4, strategy="selective", buckets=(16, 32, 64),
                   max_iters=500).serve(queries)
    for got, w in zip(s["results"], want):
        assert (got["iterations"], got["converged"]) == (w.iterations, w.converged)
        if got["kind"] == "sssp":
            np.testing.assert_array_equal(got["vector"], w.vector)
        else:
            np.testing.assert_allclose(got["vector"], w.vector, **PLUS_TIMES)


def test_serve_batch_matches_jax_greedy_decode():
    """mamba2-130m's smoke config: the example's greedy tokens (the port's
    seed-0 weights, its synthetic prompts) equal the JAX package's
    serve_step decode with those weights and prompts."""
    from repro import configs as jcfgs
    from repro.models.model import build_model as jbuild
    from repro_torch import configs as tcfgs
    from repro_torch.launch.serve import synthetic_batch
    from repro_torch.models.convert import params_to_tree
    from repro_torch.models.model import build_model

    arch, B, P, G = "mamba2_130m", 2, 6, 8
    s = example("serve_batch").main(["--archs", arch, "--batch", str(B), "--prompt-len", str(P),
                                     "--gen", str(G), "--device", "cpu"])
    _oracle("serve_batch", s)
    assert list(s) == [arch] and s[arch].shape == (B, G)
    tcfg = tcfgs.smoke_config(arch)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          params_to_tree(build_model(tcfg, "cpu").params(), tcfg))
    prompts = np.asarray(synthetic_batch(tcfg, B, P, device="cpu")["tokens"])
    jm = jbuild(jcfgs.smoke_config(arch))
    step = jax.jit(jm.serve_step)
    cache = jm.init_cache(B, P + G)
    for t in range(P):
        lg, cache = step(params, cache, jnp.asarray(prompts[:, t:t + 1]), t)
    toks = []
    for t in range(P, P + G):
        tok = jnp.argmax(lg[:, -1:], axis=-1)
        toks.append(np.asarray(tok))
        lg, cache = step(params, cache, tok, t)
    np.testing.assert_array_equal(s[arch], np.concatenate(toks, axis=1))


def test_trace_run_matches_jax(tmp_path):
    s = example("trace_run").main(["--log2n", "9", "--edges", "4000",
                                   "--out", str(tmp_path / "out"), "--device", "cpu"])
    _oracle("trace_run", s)
    n = s["n"]
    with open(s["trace_path"]) as f:
        assert validate_chrome_trace(json.load(f)) == s["spans"] > 0
    assert os.path.getsize(s["metrics_path"]) > 0
    store = str(tmp_path / "jstore")
    jingest(s["edges"], n, s["b"], store)
    rec = JRecorder()
    jeng = _disk(store, obs=rec)
    r = jeng.run(J.pagerank(n), max_iters=30, tol=1e-6)
    _landed(jeng)
    assert (s["iterations"], s["converged"]) == (r.iterations, r.converged)
    assert s["io_elems"] == [x["io_elems"] for x in r.per_iter]
    assert s["store_bytes_read"] == r.totals["store_bytes_read"]
    np.testing.assert_allclose(s["v"], r.v, **PLUS_TIMES)
    want = jcalibration(rec)
    assert {k: v["launches"] for k, v in s["calibration"].items()} == \
        {k: v["launches"] for k, v in want.items()}
    assert "live (measured)" in s["explain"]


def test_chaos_run_matches_jax(tmp_path):
    s = example("chaos_run").main(["--log2n", "9", "--edges", "4000", "--device", "cpu"])
    _oracle("chaos_run", s)
    n = s["n"]
    assert s["bitwise"] and np.array_equal(s["v"], s["clean_v"]) and s["killed"]
    assert s["audit"][1] and s["remaining"] == 0
    store = str(tmp_path / "jstore")
    jingest(s["edges"], n, s["b"], store)
    clean = _disk(store).run(J.pagerank(n), max_iters=20, tol=0.0)
    np.testing.assert_allclose(s["clean_v"], clean.v, **PLUS_TIMES)
    plan = FaultPlan(events=(CorruptFetch(block=2, array="seg"), TransientIO(block=3),
                             TransientIO(block=5), KillAtIteration(iteration=10)), seed=7)
    rec = JRecorder()
    eng = _disk(store, faults=plan, io_retry=RetryPolicy(max_attempts=3, base_delay_s=1e-3),
                obs=rec)
    kw = dict(max_iters=20, tol=0.0, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
    with pytest.raises(InjectedKill):
        eng.run(J.pagerank(n), **kw)
    r = eng.run(J.pagerank(n), resume=True, **kw)
    assert s["iterations"] == r.iterations
    np.testing.assert_array_equal(clean.v, r.v)
    want = {k: rec.metrics.get(k).to_dict()["value"] for k in s["counters"]}
    assert s["counters"] == want and set(want) == {
        "fault.injected.corrupt_fetch", "fault.injected.transient_io", "fault.injected.kill",
        "fault.retry", "fault.recovered", "store.verify_failures"}


def test_fleet_trace_matches_jax_single_host_disk(tmp_path):
    """W = 4 gloo ranks (one spawn): bitwise the clean SPMD solve, PageRank
    within rtol 1e-6 of the JAX package's single-host disk run with equal
    iterations and I/O counts, one trace lane per worker, worker 2 flagged
    for a slow fetch; the server's /metrics scraped on localhost."""
    s = example("fleet_trace").main(["--out", str(tmp_path / "out"), "--device", "cpu"])
    _oracle("fleet_trace", s)
    n = s["n"]
    store = str(tmp_path / "jstore")
    jingest(s["edges"], n, s["b"], store)
    r = _disk(store).run(J.pagerank(n), max_iters=6, tol=1e-6)
    assert s["bitwise"] and (s["iterations"], s["converged"]) == (r.iterations, r.converged)
    assert s["io_elems"] == [x["io_elems"] for x in r.per_iter]
    np.testing.assert_allclose(s["v"], r.v, rtol=1e-6, atol=1e-9)
    assert sorted(s["lanes"]) == ["main", "w0", "w1", "w2", "w3"]
    assert s["workers"] == 4 and 2 in s["straggler_workers"]
    assert s["causes"] and set(s["causes"]) == {"slow_fetch"}
    with open(s["trace_path"]) as f:
        assert validate_chrome_trace(json.load(f)) > 0
    with open(s["report_path"]) as f:
        assert json.load(f)
    assert s["scrape_lines"] > 0 and s["slo_lines"]
    assert len(s["served"]) == 4
