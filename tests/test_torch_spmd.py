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
"""
import os

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
    ("dim_outside_axis", "engine",
     dict(b=4, axis_name="model", mesh=((2, 4), ("data", "model"))), "NotImplementedError",
     "'data'"),
]


@pytest.fixture(scope="module")
def refused(tmp_path_factory):
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
    return S.run("refusals", 8, dict(mesh=((8,), ("workers",)), cases=cases))


@pytest.mark.parametrize("name,cls,kw,exc,text", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_spmd_refusals(refused, name, cls, kw, exc, text):
    """b other than the mesh size (both numbers named), 'hier' on a flat
    axis, host residency under a mesh, disk residency on a store whose b the
    mesh size does not divide (the engine and the server), an axis name that
    is not a dim, a mesh dim outside axis_name: each rank raises the same
    exception."""
    for r in refused:
        got_exc, msg = r[name]
        assert got_exc == exc, (got_exc, msg)
        assert text in msg, msg
        if name.startswith("b_ne_mesh"):
            assert "8" in msg


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
