"""The port's out-of-core SPMD path (``PMVEngine(store=..., residency='disk',
mesh=...)``, ``PMVServer`` likewise: one gloo rank per mesh worker on the
CPU, each reading its own shard view of the store, ``tests/_torch_spmd.py``)
and the physical shard round trip (``split_store`` / ``merge_stores``).

It mirrors the JAX package's tests/test_spmd_residency.py.  Those run the
JAX package's own SPMD disk solve, which fails under jax 0.9.0 (its mesh
axes are Explicit and the sparse exchange's reshape raises); so the port's
results are held to what that suite says they must equal: the JAX
package's single-host disk and resident results (SSSP and CC element for
element, PageRank within rtol 1e-6), and, bitwise, the port's own
single-process disk result, its per-iteration stats included (the delta of
plus_times within rtol 1e-6: its sum runs in another order).

One spawn of W ranks per mesh size W in {1, 2, 4, 8} runs every case of
that W; the references are computed while the ranks run.  The parity grid
is the JAX suite's: n = 240, b = 8, the fuzz topologies, psi cyclic /
range, theta off / on (4.0), PageRank / CC / SSSP, 4 iterations at tol 0,
a per-worker budget of 3 weighted stripe slices (below the block set);
theta off adds the packed exchange, the kernel scatter and a horizontal
PageRank.  At W = 4 also the chaos, trace, straggler, checkpoint and serve
cases on a random graph.
"""
import os
import re
import tempfile

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import _torch_spmd as S
import repro.core as J
import repro.serving as JS
import repro.store as JST
import repro_torch.core as T
from repro_torch.core import cost_model
from repro_torch.store import format as fmt
from repro_torch.store import (
    ingest_edges,
    merge_stores,
    open_store,
    split_store,
    verify_store,
)
from test_fuzz_parity import TOPOLOGIES, _fuzz_edges

N, B = 240, 8
WORLDS = (1, 2, 4, 8)
RUN = dict(max_iters=4, tol=0.0)
STORES = [(psi, theta_on) for psi in ("cyclic", "range") for theta_on in (False, True)]
EXACT = {"pagerank": False, "sssp": True, "cc": True}
# timing keys, which differ from run to run, and the per-worker lists
VARYING = {"wall_s", "store_io_s", "store_wait_s", "store_compute_s", "store_overlap",
           "store_read_s", "store_verify_s", "store_weights_s", "store_h2d_s"}
WORKER_KEYS = ("store_worker_bytes_read", "store_worker_io_s", "store_worker_wait_s",
               "store_worker_overlap", "store_worker_blocks_fetched",
               "store_worker_prefetch_degraded")
# the random graph of the W = 4 cases: block 1 holds edges for the straggler
MISC = dict(n=240, b=8, edges=3000, seed=3)


def _grid_cases(theta_on: bool) -> list:
    """(name, algo, engine knobs) of one store of the grid: the JAX suite's
    three, plus the packed exchange, the kernel scatter and a horizontal
    PageRank where theta is off."""
    if theta_on:
        hybrid = dict(strategy="hybrid", theta=4.0)
        return [(algo, algo, hybrid) for algo in ("pagerank", "cc", "sssp")]
    return [("pagerank", "pagerank", dict(strategy="vertical")),
            ("cc", "cc", dict(strategy="horizontal")),
            ("sssp", "sssp", dict(strategy="vertical")),
            ("pagerank-packed", "pagerank", dict(strategy="vertical", exchange="packed",
                                                 scatter="kernel")),
            ("sssp-packed", "sssp", dict(strategy="vertical", exchange="packed")),
            ("sssp-kernel", "sssp", dict(strategy="vertical", scatter="kernel")),
            ("pagerank-horizontal", "pagerank", dict(strategy="horizontal"))]


def _spec(mod, algo, n):
    if algo == "pagerank":
        return mod.pagerank(n)
    if algo == "sssp":
        return mod.sssp(0)
    return mod.connected_components()


def _misc_cases(root: str, mesh) -> list:
    """The W = 4 cases beyond the grid, by name: (case, extras)."""
    base = dict(store=root, strategy="vertical", mesh=mesh)
    return {
        "degraded": dict(engine=dict(base, faults=[("BreakPrefetch", {"worker": 1})], obs=True),
                         algo="pagerank", run=RUN, extras=("obs",)),
        "traced": dict(engine=dict(base, obs=True), algo="pagerank", run=RUN,
                       extras=("trace", "obs", "fleet")),
        "straggler": dict(engine=dict(base, obs=True, faults=[
            ("SlowFetch", {"block": 1, "delay_s": 0.3, "worker": 2})]),
            algo="pagerank", run=RUN, extras=("fleet",)),
        "checkpoint": dict(engine=dict(base, faults=[("KillAtIteration", {"iteration": 2})]),
                           algo="sssp", run=dict(max_iters=6, tol=0.0), extras=("checkpoint",)),
        "unnamed_faults": dict(engine=dict(base, obs=True, faults=UNNAMED_FAULTS),
                               algo="pagerank", run=RUN, extras=("faults",)),
    }


# fetch faults that name no worker: each fires once across the fleet (on
# worker index 0's rank), as once in the JAX package's single-host run
UNNAMED_FAULTS = [("TransientIO", {"block": 1, "times": 2}),
                  ("CorruptFetch", {"block": 2, "array": "seg"}),
                  ("CorruptFetch", {"block": 3, "array": "gat"})]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The grid's four stores (the port's ingest, byte-identical to the JAX
    package's), each with its per-worker budget, and the misc stores."""
    rng = np.random.default_rng(7)
    edges = np.concatenate([_fuzz_edges(t, N, B, rng)
                            for t in ("star_hub", "chain", "self_loops", "empty_stripe",
                                      "isolated", "multi_edge", "mixed")], axis=0)
    out = {"edges": edges, "grid": {}}
    for psi, theta_on in STORES:
        root = str(tmp_path_factory.mktemp(f"spmd_disk_{psi}_{int(theta_on)}") / "s")
        man = ingest_edges(edges, N, B, root, psi=psi, theta=4.0 if theta_on else None)
        e_caps = [man.e_cap_of(s) for s in man.stripings()]
        budget = 3 * cost_model.stripe_slice_bytes(B, max(e_caps), has_w=True)
        total = sum(man.total_shard_bytes(s) for s in man.stripings())
        assert budget < total, "graph too small to exceed the per-worker budget"
        out["grid"][psi, theta_on] = (root, budget)
    rng = np.random.default_rng(MISC["seed"])
    misc = rng.integers(0, MISC["n"], size=(MISC["edges"], 2)).astype(np.int64)
    root = str(tmp_path_factory.mktemp("spmd_disk_misc") / "s")
    man = ingest_edges(misc, MISC["n"], MISC["b"], root)
    assert np.asarray(man.array(fmt.nnz_array_of("vertical")))[1].any(), \
        "destination block 1 must hold edges"
    out["misc"] = (misc, root)
    root6 = str(tmp_path_factory.mktemp("spmd_disk_b6") / "s")
    ingest_edges(np.random.default_rng(0).integers(0, 60, size=(300, 2)), 60, 6, root6)
    out["b6"] = root6
    return out


def _payload(world: int, stores, ckpt_dir: str) -> dict:
    mesh = ((world,), ("workers",))
    cases, names = [], []
    for key, (root, budget) in stores["grid"].items():
        for name, algo, kw in _grid_cases(key[1]):
            cases.append(dict(engine=dict(kw, store=root, store_budget_bytes=budget, mesh=mesh),
                              algo=algo, run=RUN))
            names.append(("grid", key, name))
    payload = dict(cases=cases, dir=ckpt_dir)
    if world == 4:
        for name, case in _misc_cases(stores["misc"][1], mesh).items():
            cases.append(case)
            names.append(("misc", name))
        cases.append(dict(engine=dict(store=stores["b6"], strategy="vertical", mesh=mesh),
                          algo="pagerank", run=RUN, raises=True))
        names.append(("misc", "b6"))
        root, _ = stores["grid"]["cyclic", True]
        payload["serve"] = dict(mesh=mesh, store=root, queries=SERVE_QUERIES,
                                server=dict(strategy="hybrid", theta=4.0, scatter="kernel"))
    return payload, names


SERVE_QUERIES = ([("sssp", s, 0.5, None) for s in (0, 7, 33, 121)]
                 + [("rwr", s, 0.0, 6) for s in (3, 50, 199)])


def _single(root, algo, kw, **extra):
    """The port's single-process disk run of a case."""
    eng = T.PMVEngine(None, store=root, residency="disk", device="cpu", **kw, **extra)
    try:
        return eng.run(_spec(T, algo, eng.n), **RUN)
    finally:
        eng.prepare(_spec(T, algo, eng.n))[-1]["executor"].close()


def _references(stores) -> dict:
    """The port's single-process disk runs and the JAX package's single-host
    disk and resident runs of every grid case."""
    refs = {}
    edges = stores["edges"]
    for (psi, theta_on), (root, budget) in stores["grid"].items():
        for name, algo, kw in _grid_cases(theta_on):
            port = T.PMVEngine(None, store=root, residency="disk", store_budget_bytes=budget,
                               device="cpu", **kw)
            spec = _spec(T, algo, N)
            single = port.run(spec, **RUN)
            port.prepare(spec)[-1]["executor"].close()
            jkw = {k: x for k, x in kw.items() if k != "scatter"}
            jspec = _spec(J, algo, N)
            jdisk = J.PMVEngine.from_store(root, residency="disk", store_budget_bytes=budget,
                                           **jkw).run(jspec, **RUN)
            jres = J.PMVEngine(edges, N, b=B, psi=psi, **jkw).run(jspec, **RUN)
            refs[psi, theta_on, name] = (single, jdisk, jres)
    return refs


@pytest.fixture(scope="module")
def spmd(stores, tmp_path_factory):
    """Every W's ranks' results (two waves of spawns: 8 and 1, then 4 and
    2), with the references computed while the first wave runs."""
    ckpt = str(tmp_path_factory.mktemp("spmd_disk_ckpt"))
    out, names = {}, {}
    for wave in ((8, 1), (4, 2)):
        spawned = {}
        for w in wave:
            payload, names[w] = _payload(w, stores, os.path.join(ckpt, f"w{w}"))
            spawned[w] = S.spawn("disk_group", w, payload, timeout=240)
        if wave == (8, 1):
            refs = _references(stores)
        for w, sp in spawned.items():
            out[w] = sp.results()
    return {"names": names, "ranks": out, "refs": refs}


def _case(spmd, world, key):
    """Each rank's result of the case named ``key`` at mesh size ``world``."""
    i = spmd["names"][world].index(key)
    return [r["cases"][i] for r in spmd["ranks"][world]]


def _assert_vs_reference(v, ref, algo):
    if EXACT[algo]:
        np.testing.assert_array_equal(v, ref.v)
    else:
        np.testing.assert_allclose(v, ref.v, rtol=1e-6, atol=1e-9)


def _assert_stats_equal(got: list, want, algo: str, world: int):
    """An SPMD run's per-iteration records against the single-process
    disk run's: the same keys (plus the W-long store_worker_* lists), every
    count equal."""
    assert len(got) == len(want.per_iter)
    for g, w in zip(got, want.per_iter):
        assert set(g) == (set(w) - {"wall_s"}) | set(WORKER_KEYS)
        for k in set(w) - VARYING:
            if k == "delta" and not EXACT[algo]:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6)
            else:
                assert g[k] == w[k], (k, g[k], w[k])
        for k in WORKER_KEYS:
            assert len(g[k]) == world, (k, g[k])
        assert sum(g["store_worker_bytes_read"]) == g["store_bytes_read"] > 0
        assert max(g["store_worker_blocks_fetched"]) == g["store_blocks_fetched"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("psi,theta_on", STORES, ids=[f"{p}-theta{int(t)}" for p, t in STORES])
def test_spmd_disk_bitwise_parity_grid(spmd, stores, psi, theta_on, world):
    """Every case of one store at mesh size W: every rank returns the whole
    vector, bitwise the port's single-process disk run, with its stats;
    equal to the JAX package's single-host disk and resident runs (SSSP and
    CC element for element, PageRank within rtol 1e-6); each worker's peak
    resident bytes within its own budget."""
    _root, budget = stores["grid"][psi, theta_on]
    for name, algo, _kw in _grid_cases(theta_on):
        single, jdisk, jres = spmd["refs"][psi, theta_on, name]
        ranks = _case(spmd, world, ("grid", (psi, theta_on), name))
        for r in ranks:
            np.testing.assert_array_equal(r["v"], single.v, err_msg=f"{name} W={world}")
            assert r["iterations"] == single.iterations == RUN["max_iters"]
            _assert_stats_equal(r["per_iter"], single, algo, world)
            for peak, cap, degraded in r["io"].values():
                assert 0 < peak <= cap == budget and not degraded
        _assert_vs_reference(ranks[0]["v"], jdisk, algo)
        _assert_vs_reference(ranks[0]["v"], jres, algo)


def test_spmd_disk_mesh_must_divide_b(spmd):
    """A mesh of 4 over a store of b = 6 raises ValueError naming 'divide',
    on every rank."""
    for got in _case(spmd, 4, ("misc", "b6")):
        assert got[0] == "ValueError" and "divide" in got[1], got


def test_spmd_disk_degraded_worker_still_bitwise(stores, spmd):
    """BreakPrefetch on worker 1 only: bitwise the clean run; the degraded
    counter is 1 on rank 1 and 0 elsewhere, and every record's degraded
    list names worker 1 alone."""
    _edges, root = stores["misc"]
    clean = _single(root, "pagerank", dict(strategy="vertical"))
    ranks = _case(spmd, 4, ("misc", "degraded"))
    for r in ranks:
        np.testing.assert_array_equal(r["v"], clean.v)
        for rec in r["per_iter"]:
            assert rec["store_worker_prefetch_degraded"] == [0.0, 1.0, 0.0, 0.0]
    assert [r["degraded"] for r in ranks] == [0, 1, 0, 0]
    assert sum(r["degraded"] for r in ranks) == 1


def test_spmd_disk_merged_trace_one_lane_per_worker(stores, spmd):
    """obs=True does not change the solve; the W ranks' traces merge into one
    Chrome trace with lanes w0..w3 plus main, store.fetch spans on the
    worker lanes only, time-aligned; fleet_report sees W workers; the
    per-worker pmv.io_*.w{k} series are recorded."""
    _edges, root = stores["misc"]
    clean = _single(root, "pagerank", dict(strategy="vertical"))
    ranks = _case(spmd, 4, ("misc", "traced"))
    W = 4
    for r in ranks:
        np.testing.assert_array_equal(r["v"], clean.v)
        assert r["fleet"]["workers"] == W and r["fleet"]["iterations"] == r["iterations"]
        assert sorted(r["series"]) == sorted(["pmv.io_bytes", "pmv.io_overlap"] + [
            f"pmv.io_{k}.w{w}" for w in range(W) for k in ("s", "wait_s", "overlap")])
        assert all(len(x) == r["iterations"] for x in r["series"].values())
    doc = ranks[0]["trace"]
    lanes = {ev["pid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "process_name"}
    worker_lanes = sorted(x for x in lanes.values() if re.fullmatch(r"w\d+", x))
    assert worker_lanes == [f"w{i}" for i in range(W)], lanes
    assert sorted(lanes.values()) == ["main"] + worker_lanes
    fetch_pids = {ev["pid"] for ev in doc["traceEvents"]
                  if ev.get("ph") == "X" and ev["name"] == "store.fetch"}
    assert fetch_pids == {pid for pid, lab in lanes.items() if re.fullmatch(r"w\d+", lab)}
    # aligned: every worker's fetches lie inside main's iterations' time range
    spans = [ev for ev in doc["traceEvents"] if ev.get("ph") == "X"]
    main_pid = next(pid for pid, lab in lanes.items() if lab == "main")
    its = [ev for ev in spans if ev["pid"] == main_pid and ev["name"] == "pmv.iteration"]
    assert len(its) == ranks[0]["iterations"]
    lo = min(ev["ts"] for ev in spans if ev["pid"] == main_pid)
    hi = max(ev["ts"] + ev["dur"] for ev in its)
    for ev in spans:
        if ev["name"] == "store.fetch":
            assert lo <= ev["ts"] <= hi, (ev, lo, hi)


def test_spmd_disk_straggler_attributed_to_injected_worker(stores, spmd):
    """A 0.3 s SlowFetch on worker 2's block 1: bitwise the clean run, and
    fleet_report on any rank flags worker 2 alone, cause slow_fetch, with
    the spmd_io and spmd_overlap calibration kinds."""
    _edges, root = stores["misc"]
    clean = _single(root, "pagerank", dict(strategy="vertical"))
    for r in _case(spmd, 4, ("misc", "straggler")):
        np.testing.assert_array_equal(r["v"], clean.v)
        fl = r["fleet"]
        assert fl["straggler_workers"] == [2], fl
        assert fl["causes"] and all(c == "slow_fetch" for c in fl["causes"])
        assert fl["skew"]["max"] > 2.0, fl["skew"]
        assert set(fl["kinds"]) >= {"spmd_io", "spmd_overlap"}
        assert fl["text"]


def test_spmd_disk_unnamed_faults_fire_once(stores, spmd):
    """A plan of fetch events that name no worker (TransientIO twice on one
    block, a corrupt seg and a corrupt gat slice) under a mesh of 4: the
    fleet's ``fault.injected*`` and ``store.verify_failures`` sums equal the
    JAX package's single-host disk run of the same plan (each event fires
    once, on worker index 0's rank: the other ranks drop it), and every
    rank's answer is bitwise the clean run."""
    from repro import faults as JF

    _edges, root = stores["misc"]
    clean = _single(root, "pagerank", dict(strategy="vertical"))
    plan = JF.FaultPlan(events=tuple(getattr(JF, kind)(**kw) for kind, kw in UNNAMED_FAULTS),
                        seed=0)
    jeng = J.PMVEngine.from_store(root, residency="disk", strategy="vertical", faults=plan,
                                  obs=True)
    jeng.run(J.pagerank(jeng.n), **RUN)
    want = {k: jeng.obs.counter(k).value for k in S.FAULT_COUNTERS}
    assert want["fault.injected"] == 4 and want["store.verify_failures"] == 2, want
    ranks = _case(spmd, 4, ("misc", "unnamed_faults"))
    for r in ranks:
        np.testing.assert_array_equal(r["v"], clean.v)
    assert {k: sum(r["faults"][k] for r in ranks) for k in S.FAULT_COUNTERS} == want
    assert all(x == 0 for r in ranks[1:] for x in r["faults"].values())


def test_spmd_disk_checkpoint_resumes_bitwise(stores, spmd):
    """A kill before iteration 2 under a mesh of 4 over disk, resumed from
    the checkpoint worker 0 wrote, is bitwise the clean single-process
    disk run."""
    _edges, root = stores["misc"]
    eng = T.PMVEngine(None, store=root, residency="disk", strategy="vertical", device="cpu")
    clean = eng.run(T.sssp(0), max_iters=6, tol=0.0)
    eng.prepare(T.sssp(0))[-1]["executor"].close()
    for r in _case(spmd, 4, ("misc", "checkpoint")):
        assert r["killed"]
        np.testing.assert_array_equal(r["v"], clean.v)
        assert r["iterations"] == 6 and r["per_iter"][0]["iteration"] == 2


def test_spmd_disk_server_matches_jax_disk_serve(stores, spmd):
    """``PMVServer(store=, residency='disk', mesh=)`` (hybrid, theta 4) on
    every rank: SSSP answers equal the JAX package's single-host disk
    serve element for element, RWR within rtol 1e-6, with its iteration
    counts."""
    root, _ = stores["grid"]["cyclic", True]
    srv = JS.PMVServer(store=root, residency="disk", strategy="hybrid", theta=4.0)
    want = srv.serve([JS.Query(k, source=s, tol=t, max_iters=m)
                      for k, s, t, m in SERVE_QUERIES])
    for rank in spmd["ranks"][4]:
        got = rank["serve"]
        assert len(got) == len(want)
        for (vec, its, conv, reason), w, q in zip(got, want, SERVE_QUERIES):
            assert reason == "completed" and its == w.iterations and conv == w.converged
            if q[0] == "sssp":
                np.testing.assert_array_equal(vec, w.vector)
            else:
                np.testing.assert_allclose(vec, w.vector, rtol=1e-6, atol=1e-9)


# -- physical shard round trip ----------------------------------------------

def _tree_bytes(root: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@given(topo=st.sampled_from(TOPOLOGIES),
       count=st.sampled_from([1, 2, 4, 8]),
       theta_on=st.sampled_from([False, True]),
       seed=st.integers(min_value=0, max_value=2 ** 16))
@settings(max_examples=6, deadline=None)
def test_split_merge_roundtrip_bitwise(topo, count, theta_on, seed):
    """The port's split_store of a store the JAX package ingested is, tree
    for tree, byte-identical to the JAX package's split_store; each shard
    passes verify_store alone and owns its range; merge_stores reproduces
    the original store byte for byte, manifest.json included."""
    n, b = 96, 8
    edges = _fuzz_edges(topo, n, b, np.random.default_rng(seed))
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "orig")
        JST.ingest_edges(edges, n, b, root, theta=3.0 if theta_on else None)
        shards = split_store(root, os.path.join(d, "shards"), count)
        JST.split_store(root, os.path.join(d, "jax_shards"), count)
        assert _tree_bytes(os.path.join(d, "shards")) == _tree_bytes(
            os.path.join(d, "jax_shards"))
        assert len(shards) == count
        for shard in shards:
            rep = verify_store(shard)
            assert rep.ok, rep.summary()
            assert list(shard.owned_workers()) == list(
                range(shard.worker_shard["lo"], shard.worker_shard["hi"]))
        merged_root = os.path.join(d, "merged")
        merged = merge_stores([s.root for s in shards[::-1]], merged_root)
        assert merged.worker_shard is None
        assert _tree_bytes(root) == _tree_bytes(merged_root)
        assert verify_store(merged_root).ok


def test_merge_rejects_incomplete_or_foreign_shards(tmp_path):
    n, b = 64, 4
    rng = np.random.default_rng(1)
    edges = rng.integers(0, n, size=(400, 2)).astype(np.int64)
    root = str(tmp_path / "s")
    ingest_edges(edges, n, b, root)
    shards = split_store(root, str(tmp_path / "shards"), 4)
    with pytest.raises(ValueError, match="incomplete"):
        merge_stores([shards[0].root, shards[2].root], str(tmp_path / "m1"))
    with pytest.raises(ValueError, match="duplicates"):
        merge_stores([s.root for s in shards] + [shards[0].root], str(tmp_path / "m4"))
    other_root = str(tmp_path / "other")
    ingest_edges(edges[:200], n, b, other_root)
    other = split_store(other_root, str(tmp_path / "other_shards"), 4)
    mix = [s.root for s in shards[:3]] + [other[3].root]
    with pytest.raises(ValueError, match="different stores"):
        merge_stores(mix, str(tmp_path / "m2"))
    with pytest.raises(ValueError, match="shard"):
        split_store(shards[0].root, str(tmp_path / "m3"), 2)
    with pytest.raises(ValueError, match="not a per-host shard"):
        merge_stores([root], str(tmp_path / "m5"))


def test_shard_view_owns_only_its_range(tmp_path):
    """A shard view owns its contiguous stripe range; a DiskBlockStore over
    it opens only those stripes' files and fetches only their rows."""
    from repro_torch.store import DiskBlockStore

    n, b = 64, 8
    rng = np.random.default_rng(2)
    edges = rng.integers(0, n, size=(500, 2)).astype(np.int64)
    root = str(tmp_path / "s")
    man = ingest_edges(edges, n, b, root)
    view = man.worker_shard_view(1, 4)
    assert list(view.owned_workers()) == [2, 3]
    with pytest.raises(ValueError, match="divide"):
        man.worker_shard_view(0, 3)
    whole = DiskBlockStore(man, "vertical", T.pagerank(n))
    part = DiskBlockStore(view, "vertical", T.pagerank(n))
    assert part.workers == [2, 3]
    for k in range(b):
        sw, sp = whole.fetch(k), part.fetch(k)
        for name in ("seg", "gat", "w", "cnt"):
            np.testing.assert_array_equal(sp[name].numpy(), sw[name][2:4].numpy())
    assert open_store(root).worker_shard is None
