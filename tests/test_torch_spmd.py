"""The port's SPMD path (``PMVEngine(mesh=...)``, ``PMVServer(mesh=...)``: one
gloo rank per worker on the CPU, ``tests/_torch_spmd.py``) against the JAX
package's emulated engine and server on the same inputs, and against the
port's own emulated run.

Engine grid, on erdos_renyi(128, 700) and an RMAT graph, each at W = b = 8
and W = b = 4: PageRank, RWR, SSSP and CC x horizontal / vertical (sparse,
dense, packed, packed with delta_eps=0.0) / hybrid (sparse, packed) x
backend 'torch' / 'auto' x stream 'off' / 'on'.  The selection semirings and
the int32 labels must equal the JAX package's element for element,
plus_times within rtol 1e-6, atol 1e-9 (the tolerance of the JAX package's
own SPMD-vs-emulation test); every per-iteration stat must equal the port's
emulated run (the delta of plus_times within rtol 1e-6: its sum runs in
another order), and every rank must return the same answer.

The refusals' spawn also runs the meshes the JAX package takes beyond one
flat axis (dims outside axis_name as replicas, workers against rank order),
backend='pallas' under a mesh, make_step under a mesh and a server on the
replica mesh, each against the JAX package's emulated engine or server.
"""
import os

import jax
import numpy as np
import pytest

import _torch_spmd as S
import repro.core as J
import repro_torch.core as T
from repro.graph import erdos_renyi, rmat

ALGOS = ("pagerank", "rwr", "sssp", "cc")
EXACT = {"pagerank": False, "rwr": False, "sssp": True, "cc": True}
RUN = {"pagerank": dict(max_iters=12, tol=0.0), "rwr": dict(max_iters=12, tol=0.0),
       "sssp": dict(max_iters=60, tol=0.5), "cc": dict(max_iters=60, tol=0.5)}
# (strategy, exchange, delta_eps)
PLACEMENTS = (("horizontal", "sparse", None), ("vertical", "sparse", None),
              ("vertical", "dense", None), ("vertical", "packed", None),
              ("vertical", "packed", 0.0), ("hybrid", "sparse", None),
              ("hybrid", "packed", None))
GRAPHS = {"er": (lambda: erdos_renyi(128, 700, seed=21), 128, 4.0),
          "rmat": (lambda: rmat(9, 4 << 9, seed=21), 512, 12.0)}
WORLDS = (8, 4)
CASES = [(algo, strategy, exchange, delta, backend, stream)
         for algo in ALGOS for strategy, exchange, delta in PLACEMENTS
         for backend in ("torch", "auto") for stream in ("off", "on")]


def _case_id(c):
    algo, strategy, exchange, delta, backend, stream = c
    return "-".join([algo, strategy, exchange + ("-delta0" if delta is not None else ""),
                     backend, "stream_" + stream])


def _engine_kw(strategy, exchange, delta, backend, stream, theta):
    kw = dict(strategy=strategy, exchange=exchange, backend=backend, stream=stream,
              theta=theta)
    if delta is not None:
        kw["delta_eps"] = delta
    return kw


def _algo(mod, name, n):
    if name == "pagerank":
        return mod.pagerank(n), None, False
    if name == "rwr":
        return mod.random_walk_with_restart(n, 1), mod.rwr_context(n, 1), False
    if name == "sssp":
        return mod.sssp(0), None, False
    return mod.connected_components(), None, True


def _run(mod, edges, n, b, algo, **kw):
    spec, ctx, sym = _algo(mod, algo, n)
    extra = {} if mod is J else {"device": "cpu"}
    return mod.PMVEngine(edges, n, b=b, symmetrize=sym, **kw, **extra).run(spec, ctx,
                                                                          **RUN[algo])


def assert_matches_reference(got, want, algo):
    """``got`` (a rank's result dict) against a PMVResult of the JAX package."""
    assert got["v"].dtype == want.v.dtype and got["v"].shape == want.v.shape
    if EXACT[algo]:
        np.testing.assert_array_equal(got["v"], want.v)
        assert got["iterations"] == want.iterations
        assert got["converged"] == want.converged
    else:
        np.testing.assert_allclose(got["v"], want.v, rtol=1e-6, atol=1e-9)


def assert_stats_match(got, want, algo):
    """Per-iteration stats of a rank against a port PMVResult (emulated)."""
    want_iter = [{k: x for k, x in r.items() if k != "wall_s"} for r in want.per_iter]
    assert len(got) == len(want_iter)
    for g, w in zip(got, want_iter):
        assert set(g) == set(w)
        for k in w:
            if k == "delta" and not EXACT[algo]:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6)
            else:
                assert g[k] == w[k], (k, g[k], w[k])


@pytest.fixture(scope="module", params=[(g, w) for g in GRAPHS for w in WORLDS],
                ids=lambda p: f"{p[0]}-W{p[1]}")
def grid(request):
    """The whole case grid on W ranks (one spawn), with the JAX package's
    emulated references computed while the ranks run."""
    name, world = request.param
    make, n, theta = GRAPHS[name]
    edges = make()
    cases = [dict(algo=c[0], run=RUN[c[0]], **_engine_kw(*c[1:], theta)) for c in CASES]
    spawned = S.spawn("engine_cases", world, dict(
        mesh=((world,), ("workers",)), axis_name="workers", edges=edges, n=n, b=world,
        cases=cases), timeout=240)
    refs = {}
    for algo in ALGOS:
        for strategy, exchange, delta in PLACEMENTS:
            for backend in ("torch", "auto"):
                kw = _engine_kw(strategy, exchange, delta,
                                {"torch": "xla", "auto": "auto"}[backend], "off", theta)
                refs[algo, strategy, exchange, delta, backend] = _run(J, edges, n, world,
                                                                      algo, **kw)
    ranks = spawned.results()
    return dict(edges=edges, n=n, b=world, theta=theta, refs=refs, ranks=ranks)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_spmd_engine_matches_jax(grid, case):
    algo, strategy, exchange, delta, backend, stream = case
    i = CASES.index(case)
    got = grid["ranks"][0][i]
    for other in grid["ranks"][1:]:                     # the whole solve on every rank
        np.testing.assert_array_equal(other[i]["v"], got["v"])
        assert other[i]["per_iter"] == got["per_iter"]
    assert_matches_reference(got, grid["refs"][algo, strategy, exchange, delta, backend], algo)
    emulated = _run(T, grid["edges"], grid["n"], grid["b"], algo,
                    **_engine_kw(strategy, exchange, delta, backend, stream, grid["theta"]))
    if EXACT[algo]:
        np.testing.assert_array_equal(got["v"], emulated.v)
    assert_stats_match(got["per_iter"], emulated, algo)
    want_stream = ("on" if stream == "on" and backend == "auto"
                   and exchange in ("sparse", "packed") and strategy != "horizontal" else "off")
    assert got["meta"]["stream"] == want_stream
    assert got["meta"]["backend"] == ("planned" if backend == "auto" else "torch")


# -- the server ---------------------------------------------------------------

SERVE_N = 128
SERVE_QUERIES = ([("rwr", s, 1e-7) for s in (3, 50, 101)]
                 + [("sssp", 2, 1e-6), ("cc", 0, 1e-6), ("pagerank", 0, 1e-7)])


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_spmd_server_matches_jax_emulated_server(backend):
    """``PMVServer(mesh=...)`` on the queries of the JAX package's
    test_serving_spmd_batched_matches_emulation (hybrid, theta=8, one
    Q = 4 bucket, so two batches and mid-batch admissions) against the JAX
    emulated server: SSSP and CC exactly, the rest within 1e-5."""
    import repro.serving as JS

    edges = erdos_renyi(SERVE_N, 700, seed=9)
    server = dict(strategy="hybrid", theta=8.0, buckets=(4,), backend=backend)
    spawned = S.spawn("serve", 8, dict(mesh=((8,), ("workers",)), axis_name="workers",
                                       edges=edges, n=SERVE_N, b=8, server=server,
                                       queries=SERVE_QUERIES))
    jserver = dict(server, backend={"torch": "xla", "auto": "auto"}[backend])
    want = JS.PMVServer(edges, SERVE_N, b=8, **jserver).serve(
        [JS.Query(k, source=s, tol=t) for k, s, t in SERVE_QUERIES])
    ranks = spawned.results()
    for got in ranks[1:]:
        for (v, it, conv, reason), (v0, it0, conv0, reason0) in zip(got, ranks[0]):
            np.testing.assert_array_equal(v, v0)
            assert (it, conv, reason) == (it0, conv0, reason0)
    for (kind, _, _), (v, it, conv, reason), w in zip(SERVE_QUERIES, ranks[0], want):
        assert reason == "completed" and conv
        if kind in ("sssp", "cc"):
            np.testing.assert_array_equal(v, w.vector)
            assert it == w.iterations
        else:
            np.testing.assert_allclose(v, w.vector, rtol=1e-5, atol=1e-7)


# -- obs= under a mesh ----------------------------------------------------------

def test_spmd_obs_records_each_rank():
    """obs=True under a mesh: each rank's recorder holds its own
    pmv.iteration spans, the pmv.iterations counter and the per-iteration
    byte series of its run, and the answer is bitwise the untraced one."""
    n, b = 128, 4
    edges = erdos_renyi(n, 700, seed=21)
    case = dict(algo="sssp", run=RUN["sssp"], strategy="vertical", backend="auto")
    ranks = S.run("engine_cases", b, dict(mesh=((b,), ("workers",)), axis_name="workers",
                                          edges=edges, n=n, b=b,
                                          cases=[case, dict(case, obs=True)]))
    for off, on in ranks:
        np.testing.assert_array_equal(on["v"], off["v"])
        iters = on["iterations"]
        assert on["obs"]["iterations"] == iters
        assert on["obs"]["spans"].count("pmv.iteration") == iters
        assert on["obs"]["exchanged_bytes"] == [r["exchanged_bytes"] for r in on["per_iter"]]


# -- checkpoints --------------------------------------------------------------

@pytest.mark.parametrize("algo,strategy", [("pagerank", "vertical"), ("sssp", "hybrid")])
def test_spmd_checkpoint_resume(tmp_path, algo, strategy):
    """A kill before iteration 3 under a mesh, resumed from the checkpoint
    worker 0 wrote, is bitwise the clean SPMD run; the same pmv_state.npz
    resumes in the JAX package's emulated engine to its clean answer."""
    n, b = 128, 8
    edges = erdos_renyi(n, 700, seed=21)
    engine = dict(strategy=strategy, theta=4.0, backend="auto")
    run = dict(max_iters=10, tol=0.0) if algo == "pagerank" else dict(max_iters=60, tol=0.5)
    out = S.run("checkpoint", b, dict(mesh=((b,), ("workers",)), axis_name="workers",
                                      edges=edges, n=n, b=b, algo=algo, engine=engine,
                                      run=run, kill_at=3, dir=str(tmp_path / "ckpt")))
    for r in out:
        assert r["killed"]
        np.testing.assert_array_equal(r["resumed"]["v"], r["clean"]["v"])
        np.testing.assert_array_equal(r["resumed"]["v"], out[0]["resumed"]["v"])
        assert r["resumed"]["iterations"] == r["clean"]["iterations"]
    assert out[0]["saved"]["it"] == 3 and out[0]["saved"]["v"].shape == (b, n // b)
    # the port's checkpoint in the JAX package's emulated engine
    jdir = tmp_path / "jax"
    jdir.mkdir()
    np.savez(jdir / "pmv_state.npz", v=out[0]["saved"]["v"], it=out[0]["saved"]["it"])
    spec, ctx, sym = _algo(J, algo, n)
    jeng = J.PMVEngine(edges, n, b=b, symmetrize=sym, **engine)
    resumed = jeng.run(spec, ctx, checkpoint_dir=str(jdir), resume=True, **run)
    clean = jeng.run(spec, ctx, **run)
    if EXACT[algo]:
        np.testing.assert_array_equal(resumed.v, clean.v)
        np.testing.assert_array_equal(out[0]["clean"]["v"], clean.v)
    else:
        np.testing.assert_allclose(resumed.v, clean.v, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(out[0]["clean"]["v"], clean.v, rtol=1e-6, atol=1e-9)


# -- refusals -----------------------------------------------------------------

REFUSALS = [
    ("b_ne_mesh", "engine", dict(b=4), "ValueError", "b=4"),
    ("b_ne_mesh_server", "server", dict(b=4), "ValueError", "b=4"),
    ("hier_flat_axis", "engine", dict(b=8, exchange="hier"), "ValueError", "tuple axis_name"),
    ("hier_flat_axis_server", "server", dict(b=8, exchange="hier"), "ValueError",
     "tuple axis_name"),
    ("host", "engine", dict(b=8, residency="host", store="unused"), "NotImplementedError",
     "residency='host'"),
    ("disk", "engine", dict(residency="disk", store="b4"), "ValueError", "must divide b=4"),
    ("disk_server", "server", dict(residency="disk", store="b4"), "ValueError",
     "must divide b=4"),
    ("axis_not_a_dim", "engine", dict(b=8, axis_name="pods"), "ValueError", "'pods'"),
]

# -- meshes the JAX package takes: a dim outside axis_name (replicas), an
# axis_name out of rank order, ranks out of order; backend='pallas' under a
# mesh; make_step under a mesh.  All in the refusals' one 8-rank spawn. ----

MESH_N = 128
REPLICA = dict(b=4, mesh=((2, 4), ("data", "model")), axis_name="model")
REORDERED = dict(mesh=((2, 4), ("pod", "workers")), axis_name=("workers", "pod"))
PERMUTED = dict(mesh=((8,), ("workers",), (3, 1, 7, 5, 0, 2, 6, 4)), axis_name="workers")
FLAT = dict(mesh=((8,), ("workers",)), axis_name="workers")
# name -> engine case (knobs, 'algo', the mesh); 'hier' is held against the
# JAX package's emulated sparse exchange
MESH_CASES = {
    "replica-sssp-vertical": dict(algo="sssp", strategy="vertical", backend="auto",
                                  scatter="kernel", **REPLICA),
    "replica-cc-hybrid": dict(algo="cc", strategy="hybrid", backend="torch", **REPLICA),
    "replica-rwr-vertical-packed": dict(algo="rwr", strategy="vertical", exchange="packed",
                                        backend="auto", **REPLICA),
    "replica-pagerank-horizontal-pallas": dict(algo="pagerank", strategy="horizontal",
                                               backend="pallas", **REPLICA),
    "reordered-sssp-vertical": dict(algo="sssp", strategy="vertical", backend="auto",
                                    scatter="kernel", **REORDERED),
    "reordered-cc-hybrid-pallas": dict(algo="cc", strategy="hybrid", backend="pallas",
                                       **REORDERED),
    "reordered-pagerank-vertical-dense": dict(algo="pagerank", strategy="vertical",
                                              exchange="dense", backend="torch", **REORDERED),
    "reordered-sssp-hier": dict(algo="sssp", strategy="vertical", exchange="hier",
                                backend="auto", **REORDERED),
    "permuted-sssp-vertical-pallas": dict(algo="sssp", strategy="vertical", backend="pallas",
                                          scatter="kernel", **PERMUTED),
    "permuted-rwr-hybrid": dict(algo="rwr", strategy="hybrid", backend="auto", **PERMUTED),
}
PALLAS_STRATEGIES = ("horizontal", "vertical", "hybrid")
for _s in PALLAS_STRATEGIES:
    MESH_CASES[f"pallas-pagerank-{_s}"] = dict(algo="pagerank", strategy=_s, backend="pallas",
                                               **FLAT)
# a PMVServer on the replica mesh (two replicas of b = 4), against the JAX
# package's emulated server: one Q = 4 bucket, so a mid-batch admission
MESH_SERVER = dict(strategy="hybrid", theta=4.0, buckets=(4,), backend="pallas",
                   scatter="kernel")
MESH_QUERIES = [("rwr", s, 1e-7) for s in (3, 50)] + [("sssp", 2, 1e-6), ("cc", 0, 1e-6),
                                                       ("sssp", 77, 1e-6)]
# a kill before iteration 3 on the replica mesh, resumed from the checkpoint
# replica 0's worker 0 wrote (both replicas share the directory)
REPLICA_CKPT = dict(algo="sssp", engine=dict(strategy="vertical", theta=4.0, backend="auto"),
                    run=dict(max_iters=60, tol=0.5), kill_at=3)
# (mesh, axis_name) whose collectives.barrier must wait for every rank of the mesh
BARRIERS = {"replica-model": (REPLICA["mesh"], "model"),
            "replica-data": (REPLICA["mesh"], "data"),
            "flat": (FLAT["mesh"], "workers")}
BARRIER_SLEEP_S = 1.5
# (engine knobs of a PageRank make_step under a mesh)
MAKE_STEP = {
    "horizontal-pallas": dict(strategy="horizontal", backend="pallas", **FLAT),
    "vertical-auto": dict(strategy="vertical", backend="auto", **FLAT),
    "hybrid-pallas": dict(strategy="hybrid", backend="pallas", **FLAT),
    "vertical-packed-delta": dict(strategy="vertical", backend="auto", exchange="packed",
                                  delta_eps=0.0, **FLAT),
    "replica-vertical-torch": dict(strategy="vertical", backend="torch", **REPLICA),
}


# (mesh, axis_name) whose WorkerAxis and collectives are held against emulation
AXES = {"replica-model": (REPLICA["mesh"], "model"),
        "replica-data": (REPLICA["mesh"], "data"),
        "reordered": (REORDERED["mesh"], REORDERED["axis_name"]),
        "permuted": (PERMUTED["mesh"], "workers")}


def _mesh_engine_kw(case):
    """The engine knobs of a MESH_CASES entry, without the mesh."""
    return {k: x for k, x in case.items() if k not in ("algo", "mesh", "axis_name", "b")}


def _make_step_v(b, seed):
    n_local = -(-MESH_N // b)
    return (np.random.default_rng(seed).random((b, n_local)) / MESH_N).astype(np.float32)


@pytest.fixture(scope="module")
def refused(tmp_path_factory):
    """The refusals, the MESH_CASES solves and the MAKE_STEP steps on 8 gloo
    ranks (one spawn), with the references computed while the ranks run."""
    from repro_torch.store import ingest_edges

    n = 64
    edges = rmat(6, 200, seed=0)
    stores = {}
    for label, b in (("unused", 8), ("b4", 4)):
        stores[label] = str(tmp_path_factory.mktemp(f"spmd_store_{label}"))
        ingest_edges(edges, n, b, stores[label])
    cases = []
    for name, cls, kw, _, _ in REFUSALS:
        if "store" in kw:   # a real store, so that only the mesh is refused
            cases.append((name, cls, dict(kw, store=stores[kw["store"]], b=None)))
        else:
            cases.append((name, cls, dict(kw, edges=edges, n=n)))
    mesh_edges = erdos_renyi(MESH_N, 700, seed=21)
    engine = [dict(_mesh_engine_kw(c), algo=c["algo"], run=RUN[c["algo"]], theta=4.0,
                   **{k: c[k] for k in ("mesh", "axis_name", "b") if k in c})
              for c in MESH_CASES.values()]
    steps = [dict(c, theta=4.0, v=_make_step_v(c.get("b", 8), i))
             for i, c in enumerate(MAKE_STEP.values())]
    serve = dict(mesh=REPLICA["mesh"], axis_name="model", edges=mesh_edges, n=MESH_N,
                 b=REPLICA["b"], server=MESH_SERVER, queries=MESH_QUERIES)
    ckpt = dict(REPLICA_CKPT, mesh=REPLICA["mesh"], axis_name="model", edges=mesh_edges,
                n=MESH_N, b=REPLICA["b"], dir=str(tmp_path_factory.mktemp("replica_ckpt")))
    spawned = S.spawn("mesh_cases", 8, dict(mesh=((8,), ("workers",)), refusals=cases,
                                            edges=mesh_edges, n=MESH_N, b=8, cases=engine,
                                            make_step=steps, axes=list(AXES.values()),
                                            serve=serve, checkpoint=ckpt,
                                            barriers=list(BARRIERS.values()),
                                            sleep_s=BARRIER_SLEEP_S), timeout=240)
    refs = {}
    for name, c in MESH_CASES.items():
        kw = _mesh_engine_kw(c)
        kw["backend"] = {"torch": "xla"}.get(kw["backend"], kw["backend"])
        if kw.get("exchange") == "hier":
            kw["exchange"] = "sparse"
        refs[name] = _run(J, mesh_edges, MESH_N, c.get("b", 8), c["algo"], theta=4.0, **kw)
    ranks = spawned.results()
    return {"refusals": [r["refusals"] for r in ranks], "axes": [r["axes"] for r in ranks],
            "engine": [r["engine"] for r in ranks], "serve": [r["serve"] for r in ranks],
            "make_step": [r["make_step"] for r in ranks],
            "checkpoint": [r["checkpoint"] for r in ranks],
            "barrier": [r["barrier"] for r in ranks], "refs": refs, "edges": mesh_edges,
            "steps": steps}


@pytest.mark.parametrize("name,cls,kw,exc,text", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_spmd_refusals(refused, name, cls, kw, exc, text):
    """b other than the mesh size (both numbers named), 'hier' on a flat
    axis, host residency under a mesh, disk residency on a store whose b the
    mesh size does not divide (the engine and the server), an axis name that
    is not a dim: each rank raises the same exception.  (A mesh dim outside
    axis_name, refused here before, is a replica now:
    ``test_spmd_mesh_cases_match_jax``.)"""
    for r in refused["refusals"]:
        got_exc, msg = r[name]
        assert got_exc == exc, (got_exc, msg)
        assert text in msg, msg
        if name.startswith("b_ne_mesh"):
            assert "8" in msg


@pytest.mark.parametrize("name", list(AXES))
def test_worker_axis_of_replicas_and_reordered_meshes(refused, name):
    """The WorkerAxis of a mesh with dims outside axis_name (replicas: the
    ranks sharing the outside coordinates, e.g. {0, 4}, {1, 5}, ... for
    axis_name='data' on ('data', 'model')) and of workers against rank
    order: the worker index is the row-major position over the axis_name
    dims, the group's members are permuted where its rank order differs
    (``order``), and all_gather / all_to_all / all_gather_object give every
    replica the emulated results in worker order."""
    (shape, names, *perm), axis_name = AXES[name]
    grid = np.arange(8) if not perm else np.asarray(perm[0])
    grid = grid.reshape(shape)
    axis_dims = [names.index(a) for a in ((axis_name,) if isinstance(axis_name, str)
                                          else axis_name)]
    outside = [d for d in range(len(names)) if d not in axis_dims]
    replicas = grid.transpose(outside + axis_dims).reshape(-1, int(np.prod(
        [shape[d] for d in axis_dims])))
    size = replicas.shape[1]
    x = np.random.default_rng(size).standard_normal((size, size, 3)).astype(np.float32)
    reordered = False
    for rank, rows in enumerate(refused["axes"]):
        got = rows[list(AXES).index(name)]
        k = next(i for i, r in enumerate(replicas) if rank in r)
        assert got["replica"] == k and tuple(got["ranks"]) == tuple(replicas[k])
        assert got["index"] == list(replicas[k]).index(rank)
        np.testing.assert_array_equal(got["all_gather"], x)
        np.testing.assert_array_equal(got["all_to_all"],
                                      x.transpose(1, 0, 2)[got["index"]:got["index"] + 1])
        assert got["objects"] == list(range(size))
        reordered |= got["order"] is not None
    assert reordered == (name in ("reordered", "permuted"))


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_spmd_mesh_cases_match_jax(refused, name):
    """Meshes the JAX package takes and the port refused before: a (2, 4)
    ('data', 'model') mesh with axis_name='model' and b = 4 (two replicas of
    four workers, each over its own process group), axis_name ('workers',
    'pod') on a ('pod', 'workers') mesh (workers against rank order; 'hier'
    then has 4 pods of 2, its sub-groups out of rank order too), and a 1-d
    mesh whose ranks are permuted.  Every rank returns the same answer, the
    JAX package's emulated engine's on the same graph and knobs ('hier' the
    emulated sparse exchange's): the selection semirings element for
    element, with the same iterations."""
    i = list(MESH_CASES).index(name)
    got = refused["engine"][0][i]
    for other in refused["engine"][1:]:
        np.testing.assert_array_equal(other[i]["v"], got["v"])
        assert other[i]["per_iter"] == got["per_iter"]
    assert_matches_reference(got, refused["refs"][name], MESH_CASES[name]["algo"])
    backend = MESH_CASES[name]["backend"]
    assert got["meta"]["backend"] == {"auto": "planned"}.get(backend, backend)


def test_spmd_server_on_replica_mesh_matches_jax(refused):
    """``PMVServer(mesh=...)`` on the (2, 4) ('data', 'model') mesh with
    axis_name='model' (two replicas of b = 4, backend='pallas'): every rank
    returns the JAX package's emulated b = 4 pallas server's answers, SSSP
    and CC exactly with their iterations, RWR within rtol 1e-5."""
    import repro.serving as JS

    jserver = dict(MESH_SERVER)
    jserver.pop("scatter")
    want = JS.PMVServer(refused["edges"], MESH_N, b=REPLICA["b"], **jserver).serve(
        [JS.Query(k, source=s, tol=t) for k, s, t in MESH_QUERIES])
    for got in refused["serve"]:
        for (kind, _, _), (v, it, conv, reason), w in zip(MESH_QUERIES, got, want):
            assert reason == "completed" and conv
            if kind in ("sssp", "cc"):
                np.testing.assert_array_equal(v, w.vector)
                assert it == w.iterations
            else:
                np.testing.assert_allclose(v, w.vector, rtol=1e-5, atol=1e-7)


def test_spmd_checkpoint_resume_on_replica_mesh(refused):
    """A kill before iteration 3 on the (2, 4) ('data', 'model') replica
    mesh, resumed from the one checkpoint replica 0's worker 0 writes: every
    rank of both replicas read the iteration-3 checkpoint after the kill
    (the save's barrier spans the mesh, not one replica) and resumes to its
    clean run's vector and iterations, the same on all 8 ranks."""
    first = refused["checkpoint"][0]
    for r in refused["checkpoint"]:
        assert r["killed"]
        assert r["saved"]["it"] == REPLICA_CKPT["kill_at"]
        np.testing.assert_array_equal(r["saved"]["v"], first["saved"]["v"])
        np.testing.assert_array_equal(r["resumed"]["v"], r["clean"]["v"])
        np.testing.assert_array_equal(r["resumed"]["v"], first["resumed"]["v"])
        assert r["resumed"]["iterations"] == r["clean"]["iterations"] == \
            first["resumed"]["iterations"]
    assert first["saved"]["v"].shape == (REPLICA["b"], MESH_N // REPLICA["b"])


@pytest.mark.parametrize("name", list(BARRIERS))
def test_spmd_barrier_spans_the_mesh(refused, name):
    """``collectives.barrier`` waits for every rank of the mesh: with rank 0
    asleep for BARRIER_SLEEP_S before it, every other rank, those of the
    other replica too, stays in the barrier at least half that long."""
    i = list(BARRIERS).index(name)
    for rank, waits in enumerate(refused["barrier"][1:], start=1):
        assert waits[i] >= BARRIER_SLEEP_S / 2, (rank, waits[i])


@pytest.mark.parametrize("strategy", PALLAS_STRATEGIES)
def test_pallas_spmd_matches_emulation(refused, strategy):
    """backend='pallas' PageRank on the 8-rank flat mesh against the port's
    emulated pallas engine (rtol 1e-6, atol 1e-9, the JAX package's own
    tolerance for this test), with the same per-iteration stats, and against
    the JAX package's emulated pallas engine (within its 1e-6 too)."""
    name = f"pallas-pagerank-{strategy}"
    got = refused["engine"][0][list(MESH_CASES).index(name)]
    emulated = _run(T, refused["edges"], MESH_N, 8, "pagerank", theta=4.0,
                    **_mesh_engine_kw(MESH_CASES[name]))
    np.testing.assert_allclose(got["v"], emulated.v, rtol=1e-6, atol=1e-9)
    assert_stats_match(got["per_iter"], emulated, "pagerank")
    assert got["iterations"] == emulated.iterations


@pytest.mark.parametrize("name", list(MAKE_STEP))
def test_spmd_make_step_matches_emulation(refused, name):
    """``repro_torch.core.make_step`` under a mesh: one step from the same
    blocked v gives, on every rank, the v_new, delta and stats (summed over
    the axis) of the JAX package's emulated ``make_step`` on the same knobs
    (v_new and delta within rtol 1e-5, the counts exactly), and with delta
    iteration the same new state."""
    from repro.core.engine import make_step as j_make_step

    i = list(MAKE_STEP).index(name)
    case = refused["steps"][i]
    b = case.get("b", 8)
    kw = {k: x for k, x in case.items() if k not in ("mesh", "axis_name", "b", "v")}
    kw["backend"] = {"torch": "xla"}.get(kw["backend"], kw["backend"])
    eng = J.PMVEngine(refused["edges"], MESH_N, b=b, **kw)
    spec = J.pagerank(MESH_N)
    _, matrix, _, _, mask, meta = eng.prepare(spec)
    cfg = meta["cfg"]
    extra = ()
    if cfg.delta_eps is not None:
        extra = (np.zeros((b, b, cfg.xplan.p_dev), np.float32),)
    want = jax.jit(j_make_step(spec, cfg))(matrix, case["v"], {}, mask, *extra)
    for r in refused["make_step"]:
        got = r[i]
        np.testing.assert_allclose(got["v"], np.asarray(want[0]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["delta"], float(want[1]), rtol=1e-5)
        for key, x in want[2].items():
            if key != "logical_elems":
                assert got["stats"][key] == float(x), key
        assert ("state" in got) == bool(extra)
        if extra:
            np.testing.assert_allclose(got["state"], np.asarray(want[3]), rtol=1e-5, atol=1e-7)
    assert refused["make_step"][0][i]["v"].shape == (b, -(-MESH_N // b))


@pytest.fixture(scope="module")
def collective_rows():
    """Each rank's all_gather / all_to_all at b_w = 1, 2, 4 on a mesh of 4."""
    return S.run("collectives_rows", 4, dict(mesh=((4,), ("workers",)), b_ws=(1, 2, 4)))


@pytest.mark.parametrize("b_w", [1, 2, 4])
def test_collectives_take_several_workers_a_rank(collective_rows, b_w):
    """With b_w workers on each of 4 ranks (the out-of-core path's shard
    views): all_to_all gives each rank its destinations' rows of the
    emulated transpose, all_gather the whole [b, ...] in worker order; at
    b_w = 1 all_to_all is bitwise the resident path's single-row exchange."""
    world = 4
    b = world * b_w
    x = np.random.default_rng(b_w).standard_normal((b, b, 3)).astype(np.float32)
    emulated = x.transpose(1, 0, 2)
    for rank, got in enumerate(collective_rows):
        g = got[b_w]
        np.testing.assert_array_equal(g["all_to_all"], emulated[rank * b_w:(rank + 1) * b_w])
        np.testing.assert_array_equal(g["all_gather"], x)
        if b_w == 1:
            assert g["all_to_all"].tobytes() == g["rows"].tobytes()


def test_hier_without_mesh_raises():
    """exchange='hier' needs a mesh (ValueError where the JAX package asserts)."""
    with pytest.raises(ValueError, match="tuple axis_name"):
        T.PMVEngine(rmat(6, 200, seed=0), 64, b=2, exchange="hier", device="cpu")


def test_spmd_helpers_have_no_jax():
    """The rank side imports no JAX: the helper module is jax-free."""
    src = open(os.path.join(os.path.dirname(__file__), "_torch_spmd.py")).read()
    assert "import jax" not in src and "from jax" not in src and "repro." not in src.replace(
        "repro_torch", "")
