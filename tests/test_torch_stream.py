"""The bucket-streamed planned executor of the PyTorch port (``stream='on'``)
against the port's fused executor and the JAX package's streamed one.

- ``blocks.pack_streamed_stripe`` / ``stack_streamed`` give the JAX
  package's arrays, array for array (both worker axes).
- One streamed step is BITWISE the port's fused step (``stream='off'``) on
  the tactic-mix graph (skip, ell and dense blocks), for every semiring,
  single-vector and Q = 5: vertical sparse, vertical packed with and
  without ``delta_eps=0.0`` (two steps, the carried state too), hybrid
  sparse and hybrid packed; the logical and overflow counters agree.
- Full solves (PageRank, SSSP, CC; vertical and hybrid, sparse and packed)
  and a served RWR batch equal the JAX package's ``stream='on'`` solves:
  selection semirings and int32 exactly, plus_times at the engine-parity
  tolerance (rtol 1e-5, atol 1e-7); and bitwise the port's fused solves.
- ``ExecutionPlan.launch_schedule`` against the streamed pack's per-block
  rows, and ``FlatStreamed``'s launches per step against it.
- ``format_plan``'s memory-profile line against the JAX package's golden
  string.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import ALGOS, tactic_mix_edges

import repro.core as J
import repro.serving as JS
import repro_torch.core as T
import repro_torch.serving as TS
from repro.core import blocks as j_blocks
from repro.graph import erdos_renyi
from repro_torch.core import blocks as t_blocks
from repro_torch.core import planner as t_planner
from repro_torch.kernels.block_gimv import semiring_of

N, B = 64, 4
MIX = tactic_mix_edges(N, B)
THETA = 40.0


def _max_plus_spec():
    return T.GimvSpec(name="maxplus", combine2="add", combine_all="max", dtype=np.float32,
                      assign=lambda v, r, ctx: torch.maximum(v, r),
                      init=lambda ids, ctx: np.zeros(ids.shape, np.float32))


SPECS = {
    "plus_times": lambda: T.pagerank(N),
    "min_plus": lambda: T.sssp(0),
    "max_plus": _max_plus_spec,
    "min_src": T.connected_components,
}


def _plan_and_stripes(edges, n, b, spec, strategy="vertical", theta=None):
    eng = T.PMVEngine(edges, n, b=b, strategy=strategy, theta=theta, backend="auto",
                      stream="on", device="cpu")
    meta = eng.prepare(spec)[-1]
    stripes = meta["pm"].vertical if strategy == "vertical" else meta["hm"].sparse_vertical
    return meta["plan"], stripes, meta["part"].n_local


def _assert_stripes_equal(got, want):
    assert got.layout == want.layout == "streamed"
    assert got.rows_out == want.rows_out
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        for f in ("rows", "cols", "w"):
            a, e = getattr(g, f), getattr(w, f)
            assert (a is None) == (e is None), f
            if a is not None:
                assert a.dtype == np.asarray(e).dtype, f
                np.testing.assert_array_equal(a, np.asarray(e), err_msg=f)
    assert (got.dense is None) == (want.dense is None)
    if got.dense is not None:
        np.testing.assert_array_equal(got.dense.matrix, np.asarray(want.dense.matrix))
        np.testing.assert_array_equal(got.dense.index, np.asarray(want.dense.index))


@pytest.mark.parametrize("semiring", sorted(SPECS))
@pytest.mark.parametrize("graph", ["mix", "er"])
def test_pack_and_stack_streamed_equal_reference(graph, semiring):
    if graph == "mix":
        edges, n, b, strategy = MIX, N, B, "vertical"
    else:
        edges, n, b, strategy = erdos_renyi(256, 900, seed=4), 256, 8, "hybrid"
    spec = SPECS[semiring]()
    if semiring == "plus_times":
        spec = T.pagerank(n)
    plan, stripes, nl = _plan_and_stripes(edges, n, b, spec, strategy, theta=THETA)
    sr = semiring_of(spec.combine2, spec.combine_all)
    got, want = [], []
    for w, s in enumerate(stripes):
        kw = dict(boundaries=plan.boundaries, semiring=sr)
        tactics = plan.tactics_for_worker(w, "vertical")
        got.append(t_blocks.pack_streamed_stripe(s, tactics, nl, **kw))
        want.append(j_blocks.pack_streamed_stripe(s, tactics, nl, **kw))
        _assert_stripes_equal(got[-1], want[-1])
    for axis in (0, 1):
        _assert_stripes_equal(t_blocks.stack_streamed(got, sr, worker_axis=axis),
                              j_blocks.stack_streamed(want, sr, worker_axis=axis))


# (strategy, exchange, delta_eps)
STEP_PATHS = {
    "vertical_sparse": ("vertical", "sparse", None),
    "vertical_packed": ("vertical", "packed", None),
    "vertical_packed_delta0": ("vertical", "packed", 0.0),
    "hybrid_sparse": ("hybrid", "sparse", None),
    "hybrid_packed": ("hybrid", "packed", None),
}


def _rand_state(spec, shape, rng):
    if np.dtype(spec.dtype) == np.int32:
        return torch.from_numpy(rng.integers(0, N, shape).astype(np.int32))
    return torch.from_numpy(rng.random(shape).astype(np.float32))


@pytest.mark.parametrize("semiring", sorted(SPECS))
@pytest.mark.parametrize("path", sorted(STEP_PATHS))
def test_streamed_step_bitwise_fused(path, semiring):
    strategy, exchange, delta_eps = STEP_PATHS[path]
    spec = SPECS[semiring]()
    out = {}
    for stream in ("off", "on"):
        eng = T.PMVEngine(MIX, N, b=B, strategy=strategy, theta=THETA, backend="auto",
                          exchange=exchange, delta_eps=delta_eps, scatter="kernel",
                          stream=stream, device="cpu")
        matrix, _v, ctx, mask, meta = eng.prepare(spec)
        plan, cfg = meta["plan"], meta["cfg"]
        assert plan.stream == stream and plan.tactic_counts()["dense"] > 0
        key = "streamed" if stream == "on" else "planned"
        assert (key if strategy == "vertical" else key + "_sparse") in matrix
        # delta iteration is gated to a float 'sum' combineAll
        assert (cfg.delta_eps is not None) == (delta_eps is not None and
                                               semiring == "plus_times")
        rng = np.random.default_rng(7)
        for q in (None, 5):
            v = _rand_state(spec, (B, meta["part"].n_local) + ((q,) if q else ()), rng)
            if cfg.delta_eps is None:
                out[stream, q] = T.placement_call(spec, cfg, matrix, v, ctx, mask)
                continue
            state = torch.full((B, B, cfg.xplan.p_dev) + ((q,) if q else ()), spec.identity,
                               dtype=spec.torch_dtype)
            steps = []
            for _ in range(2):   # the second step suppresses the unmoved rows
                v, r, stats, state = T.placement_call(spec, cfg, matrix, v, ctx, mask, state)
                steps.append((v, r, stats, state))
            out[stream, q] = steps
    for q in (None, 5):
        off, on = out["off", q], out["on", q]
        pairs = zip(off, on) if isinstance(off, list) else [(off, on)]
        for o, s in pairs:
            assert torch.equal(s[0], o[0]) and torch.equal(s[1], o[1])
            for k in ("logical_elems", "overflow", "delta_sent_rows"):
                if k in o[2]:
                    assert float(s[2][k]) == float(o[2][k]), k
            if len(o) == 4:
                assert torch.equal(s[3], o[3])


def _engines(edges, n, algo, **kw):
    mk, ctx_mk, sym, _exact, run_kw = ALGOS[algo]
    kw = dict(kw, b=B, symmetrize=sym, backend="auto", scatter="kernel")
    ref = J.PMVEngine(edges, n, stream="on", **kw)
    port = T.PMVEngine(edges, n, stream="on", device="cpu", **kw)
    fused = T.PMVEngine(edges, n, stream="off", device="cpu", **kw)
    spec, ctx = mk(T, n), (None if ctx_mk is None else ctx_mk(T, n))
    r_ref = ref.run(mk(J, n), None if ctx_mk is None else ctx_mk(J, n), **run_kw)
    assert port.prepare(spec, ctx)[-1]["plan"].stream == "on"
    return r_ref, port.run(spec, ctx, **run_kw), fused.run(spec, ctx, **run_kw)


SOLVES = [("pagerank", "vertical", "sparse"), ("sssp", "vertical", "sparse"),
          ("cc", "vertical", "sparse"), ("pagerank", "hybrid", "sparse"),
          ("sssp", "hybrid", "sparse"), ("cc", "hybrid", "packed"),
          ("pagerank", "vertical", "packed"), ("sssp", "vertical", "packed")]


@pytest.mark.parametrize("algo,strategy,exchange", SOLVES)
def test_streamed_solve_matches_jax_and_fused(algo, strategy, exchange):
    edges, n = erdos_renyi(96, 420, seed=3), 96
    r_ref, r_on, r_off = _engines(edges, n, algo, strategy=strategy, theta=4.0,
                                  exchange=exchange)
    np.testing.assert_array_equal(r_on.v, r_off.v)
    assert r_on.iterations == r_off.iterations
    assert [r["logical_elems"] for r in r_on.per_iter] == \
        [r["logical_elems"] for r in r_off.per_iter]
    assert r_on.v.dtype == r_ref.v.dtype
    if ALGOS[algo][3]:
        np.testing.assert_array_equal(r_on.v, r_ref.v)
        assert r_on.iterations == r_ref.iterations and r_on.converged == r_ref.converged
        assert [r["logical_elems"] for r in r_on.per_iter] == \
            [float(r["logical_elems"]) for r in r_ref.per_iter]
    else:
        np.testing.assert_allclose(r_on.v, r_ref.v, rtol=1e-5, atol=1e-7)


def test_streamed_serve_matches_jax_server_and_fused():
    """RWR served at Q = 8 through the streamed Q-wide executor (vertical,
    the tactic-mix graph, so the dense blocks run their Q-wide launches)."""
    sources = list(range(0, N, 5))[:8]
    kw = dict(b=B, strategy="vertical", backend="auto", scatter="kernel", buckets=(8,))

    def queries(mod):
        return [mod.Query("rwr", source=s, tol=1e-6) for s in sources]

    want = JS.PMVServer(MIX, N, stream="on", **kw).serve(queries(JS))
    server = TS.PMVServer(MIX, N, stream="on", device="cpu", **kw)
    got = server.serve(queries(TS))
    eng, spec = server.engine_for(got[0].query)
    assert eng.prepare(spec)[-1]["plan"].stream == "on"
    fused = TS.PMVServer(MIX, N, stream="off", device="cpu", **kw).serve(queries(TS))
    for g, w, f in zip(got, want, fused):
        assert g.reason == w.reason == "completed" and g.converged
        np.testing.assert_allclose(g.vector, w.vector, rtol=1e-5, atol=1e-7)
        assert abs(g.iterations - w.iterations) <= 1
        np.testing.assert_array_equal(g.vector, f.vector)
        assert g.iterations == f.iterations


def test_launch_schedule_matches_streamed_pack_rows():
    """launch_schedule(worker) covers each destination block of the
    worker's stripe as pack_streamed_stripe packs it: an ell block's valid
    rows per bucket, a dense block in the dense group, a skip block
    nowhere; and the flattened layout launches, per step, the buckets
    that hold a row of the block on some worker."""
    spec = T.pagerank(N)
    plan, stripes, nl = _plan_and_stripes(MIX, N, B, spec)
    sr = semiring_of(spec.combine2, spec.combine_all)
    expected_launches = [set() for _ in range(B)]
    for j, s in enumerate(stripes):
        packed = t_blocks.pack_streamed_stripe(s, plan.tactics_for_worker(j, "vertical"), nl,
                                               boundaries=plan.boundaries, semiring=sr)
        dense = [] if packed.dense is None else list(packed.dense.index)
        sched = plan.launch_schedule(j)
        assert len(sched) == B
        for i, entry in enumerate(sched):
            assert entry[0] == plan.block(i, j).tactic
            rows = [int((bk.rows[i] >= 0).sum()) for bk in packed.buckets]
            if entry[0] == "ell":
                assert tuple(rows) == tuple(entry[1])
                assert sum(rows) == plan.block(i, j).rows
                expected_launches[i] |= {kk for kk, r in enumerate(entry[1]) if r}
            else:
                assert sum(rows) == 0
            assert (i in dense) == (entry[0] == "dense")
    eng = T.PMVEngine(MIX, N, b=B, strategy="vertical", backend="auto", stream="on",
                      device="cpu")
    fs = eng.prepare(spec)[0]["streamed"]
    assert [len(a) for a in fs.active] == [len(e) for e in expected_launches]
    assert fs.launches_per_step() == sum(len(e) for e in expected_launches)
    assert fs.dense_blocks == tuple(
        tuple(i for i, e in enumerate(plan.launch_schedule(j)) if e[0] == "dense")
        for j in range(B))


def _golden_plan():
    blocks = (
        t_planner.BlockPlan(i=0, j=0, tactic="dense", nnz=200, rows=16, d_max=16,
                            occupancy=0.7812, cost=32.0),
        t_planner.BlockPlan(i=0, j=1, tactic="ell", nnz=12, rows=8, d_max=3,
                            occupancy=0.5, cost=20.0, bucket_rows=(5, 2, 1)),
        t_planner.BlockPlan(i=1, j=0, tactic="skip", nnz=0, rows=0, d_max=0,
                            occupancy=0.0, cost=0.0),
        t_planner.BlockPlan(i=1, j=1, tactic="ell", nnz=6, rows=4, d_max=2,
                            occupancy=0.75, cost=7.0, bucket_rows=(2, 2, 0)),
    )
    return t_planner.ExecutionPlan(
        strategy="vertical", mode="planned", b=2, n_local=16, theta=None,
        capacity=8, boundaries=(1, 2, 4), blocks=blocks, scatter="segment",
        stream="on")


def test_format_plan_memory_profile_line_golden():
    """The JAX package's golden string (tests/test_planner.py), and the
    line left out of horizontal plans."""
    plan = _golden_plan()
    assert plan.memory_profile() == {"materialized_elems": 32, "streamed_elems": 32,
                                     "savings": 1.0, "stream": "on"}
    report = t_planner.format_plan(plan)
    assert ("  memory profile: materialized 32 elems -> streamed 32 elems"
            " (1.00x) [stream=on]") in report
    assert report.splitlines()[3].startswith("  memory profile:")
    hplan = dataclasses.replace(plan, strategy="horizontal", capacity=None)
    assert "memory profile" not in t_planner.format_plan(hplan)
