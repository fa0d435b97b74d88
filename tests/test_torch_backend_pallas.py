"""The port's forced flat-ELL backend (``backend='pallas'``), its 'xla' alias,
``pallas_interpret=`` and ``make_step``, against the JAX package's
``backend='pallas'`` in interpret mode (as its own ``tests/test_backend_pallas.py``
runs it) and against the port's own ``backend='torch'`` on the same graph.

Tolerances: exact for min_plus, max_plus and min_src (the selection
semirings and int32 labels); plus_times within rtol 1e-5 (atol 1e-6 on
steps, 1e-7 on solves): the merged horizontal table folds all source
blocks' edges in slot order, where 'torch' tree-folds the blocks, as in the
JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.core as J
import repro_torch.core as T
from repro.core.engine import make_step as j_make_step
from repro.core.engine import placement_call as j_placement_call
from repro.graph import erdos_renyi
from repro_torch.core import placement, sparse_exchange

N, B = 96, 4
EDGES = erdos_renyi(N, 420, seed=3)
STRATEGIES = ["horizontal", "vertical", "hybrid"]


def _max_plus_spec(mod, xp):
    return mod.GimvSpec(name="maxplus", combine2="add", combine_all="max", dtype=np.float32,
                        assign=lambda v, r, ctx: xp.maximum(v, r),
                        init=lambda ids, ctx: np.zeros(ids.shape, np.float32))


# semiring -> (spec factory(module, array module), symmetrize, exact)
SEMIRINGS = {
    "plus_times": (lambda m, xp: m.pagerank(N), False, False),
    "min_plus": (lambda m, xp: m.sssp(0), False, True),
    "min_src": (lambda m, xp: m.connected_components(), True, True),
    "max_plus": (_max_plus_spec, False, True),
}


def _specs(semiring):
    mk, sym, exact = SEMIRINGS[semiring]
    return mk(J, jnp), mk(T, torch), sym, exact


def _close(exact, got, want, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _port(spec, backend, sym, **kw):
    eng = T.PMVEngine(EDGES, N, b=B, theta=4.0, symmetrize=sym, backend=backend, device="cpu",
                      **kw)
    matrix, _v0, _ctx, mask, meta = eng.prepare(spec)
    return matrix, mask, meta


def _jax(spec, backend, sym, **kw):
    eng = J.PMVEngine(EDGES, N, b=B, theta=4.0, symmetrize=sym, backend=backend, **kw)
    _, matrix, _v0, _ctx, mask, meta = eng.prepare(spec)
    return matrix, mask, meta


def _rand_v(spec, shape, rng):
    if np.dtype(spec.dtype) == np.int32:
        return rng.integers(0, N, shape).astype(np.int32)
    return rng.random(shape).astype(np.float32)


def _steps(strategy, semiring, nq, seed, **kw):
    """One step of the port's 'pallas', the port's 'torch' and the JAX
    package's interpret-mode 'pallas' from the same random v: (outputs,
    stats) of each, and the port's pallas meta."""
    j_spec, t_spec, sym, _ = _specs(semiring)
    kw = dict(strategy=strategy, **kw)
    tp, tp_mask, tp_meta = _port(t_spec, "pallas", sym, **kw)
    tt, tt_mask, tt_meta = _port(t_spec, "torch", sym, **kw)
    jm, j_mask, j_meta = _jax(j_spec, "pallas", sym, **kw)
    nl = tp_meta["part"].n_local
    v = _rand_v(t_spec, (B, nl) + (() if nq is None else (nq,)), np.random.default_rng(seed))
    out = {}
    for name, (m, mask, meta) in {"pallas": (tp, tp_mask, tp_meta),
                                  "torch": (tt, tt_mask, tt_meta)}.items():
        v_new, r, stats = T.placement_call(t_spec, meta["cfg"], m, torch.from_numpy(v), {},
                                           mask)
        out[name] = (v_new.numpy(), r.numpy(), {k: float(x) for k, x in stats.items()})
    step = jax.jit(lambda m, vv, mask: j_placement_call(j_spec, j_meta["cfg"], m, vv, {},
                                                        mask, None))
    v_new, r, stats = step(jm, jnp.asarray(v), j_mask)
    out["jax"] = (np.asarray(v_new), np.asarray(r), {k: float(x) for k, x in stats.items()})
    return out, dict(tp_meta, matrix_keys=set(tp)), j_meta


def _check_steps(out, exact):
    for other in ("torch", "jax"):
        _close(exact, out["pallas"][0], out[other][0])
        _close(exact, out["pallas"][1], out[other][1])
    # wire / compute accounting is backend-independent
    for key in ("gathered_elems", "exchanged_elems", "gathered_bytes", "exchanged_bytes"):
        assert out["pallas"][2][key] == out["torch"][2][key] == out["jax"][2][key], key


@pytest.mark.parametrize("semiring", sorted(SEMIRINGS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pallas_step_single_query(strategy, semiring):
    out, meta, j_meta = _steps(strategy, semiring, None, 0)
    assert meta["backend"] == "pallas" and j_meta["backend"] == "pallas"
    assert meta["cfg"].interpret and j_meta["cfg"].interpret   # CPU: the plain versions
    assert ("ell" if strategy != "hybrid" else "sparse_ell") in meta.get("matrix_keys", ())
    _check_steps(out, SEMIRINGS[semiring][2])


@pytest.mark.parametrize("semiring", sorted(SEMIRINGS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pallas_step_batched(strategy, semiring):
    """The Q-wide path (Q = 5 columns, one traversal of the flat tables)."""
    out, _, _ = _steps(strategy, semiring, 5, 1)
    _check_steps(out, SEMIRINGS[semiring][2])


@pytest.mark.parametrize("semiring", sorted(SEMIRINGS))
@pytest.mark.parametrize("nq", [None, 3])
def test_ell_block_partials_match_dense_exchange(semiring, nq):
    """vertical + exchange='dense' runs every destination block's table in
    one launch (``_ell_block_partials``)."""
    out, _, _ = _steps("vertical", semiring, nq, 7, exchange="dense")
    _check_steps(out, SEMIRINGS[semiring][2])


@pytest.mark.parametrize("strategy,exchange", [("vertical", "packed"), ("hybrid", "packed")])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_pallas_packed_step(strategy, exchange, semiring):
    """The flat-ELL partials gathered at the packed send rows, a block at a
    time (``_ell_partials_payload``), under the packed scatter kernel."""
    out, meta, _ = _steps(strategy, semiring, None, 3, exchange=exchange, scatter="kernel")
    assert meta["exchange"] == "packed"
    _check_steps(out, SEMIRINGS[semiring][2])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_run_parity(strategy):
    """PageRank solves converge to the same vector on the port's 'pallas',
    its 'torch' and the JAX package's 'pallas', in as many iterations."""
    kw = dict(b=B, strategy=strategy, theta=4.0)
    rj = J.PMVEngine(EDGES, N, backend="pallas", **kw).run(J.pagerank(N), max_iters=25,
                                                            tol=1e-9)
    rp = T.PMVEngine(EDGES, N, backend="pallas", device="cpu", **kw).run(
        T.pagerank(N), max_iters=25, tol=1e-9)
    rt = T.PMVEngine(EDGES, N, backend="xla", device="cpu", **kw).run(
        T.pagerank(N), max_iters=25, tol=1e-9)
    assert rp.iterations == rj.iterations == rt.iterations
    np.testing.assert_allclose(rp.v, rj.v, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rp.v, rt.v, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("algo", ["sssp", "cc"])
def test_engine_run_selection_semirings_exact(strategy, algo):
    """SSSP and CC under 'pallas' (scatter='kernel') equal the JAX package's
    'pallas' and the port's 'torch' element for element, with the same
    iteration counts and per-iteration logical elements."""
    sym = algo == "cc"
    kw = dict(b=B, strategy=strategy, theta=4.0, symmetrize=sym, scatter="kernel")
    j_spec = J.sssp(0) if algo == "sssp" else J.connected_components()
    t_spec = T.sssp(0) if algo == "sssp" else T.connected_components()
    rj = J.PMVEngine(EDGES, N, backend="pallas", **kw).run(j_spec, max_iters=60, tol=0.5)
    rp = T.PMVEngine(EDGES, N, backend="pallas", device="cpu", **kw).run(t_spec, max_iters=60,
                                                                        tol=0.5)
    rt = T.PMVEngine(EDGES, N, backend="torch", device="cpu", **kw).run(t_spec, max_iters=60,
                                                                       tol=0.5)
    for other in (rj, rt):
        np.testing.assert_array_equal(rp.v, other.v)
        assert rp.iterations == other.iterations and rp.converged == other.converged
    assert ([r.get("logical_elems") for r in rp.per_iter]
            == [r.get("logical_elems") for r in rj.per_iter])


def test_unsupported_semiring_resolves_to_torch():
    """(mul, min) has no kernel semiring: a forced 'pallas' resolves to the
    plain backend ('torch' here, 'xla' in the JAX package) and packs no ELL
    table."""
    def spec(mod, xp):
        return mod.GimvSpec(name="mulmin", combine2="mul", combine_all="min",
                            dtype=np.float32, assign=lambda v, r, ctx: xp.minimum(v, r),
                            init=lambda ids, ctx: np.ones(ids.shape, np.float32))

    edges = erdos_renyi(64, 300, seed=1)
    ref = J.PMVEngine(edges, 64, b=4, strategy="vertical", backend="pallas")
    port = T.PMVEngine(edges, 64, b=4, strategy="vertical", backend="pallas", device="cpu")
    j_spec, t_spec = spec(J, jnp), spec(T, torch)
    _, j_matrix, _, _, _, j_meta = ref.prepare(j_spec)
    matrix, _, _, _, meta = port.prepare(t_spec)
    assert j_meta["backend"] == "xla" and meta["backend"] == "torch"
    assert "ell" not in j_matrix and "ell" not in matrix
    np.testing.assert_array_equal(port.run(t_spec, max_iters=20, tol=0.5).v,
                                  ref.run(j_spec, max_iters=20, tol=0.5).v)


def test_serving_pallas_matches_jax():
    """PMVServer(backend='pallas') answers as the JAX package's pallas server
    (interpret mode) and as the port's 'torch' server: RWR within rtol 1e-5
    (its iteration count may differ by the one iteration a float summation
    order moves across tol), SSSP exactly, in as many iterations."""
    import repro.serving as JS
    import repro_torch.serving as TS

    n = 256
    edges = erdos_renyi(n, 1200, seed=9)
    queries = [("rwr", s, 1e-7) for s in (3, 50, 101)] + [("sssp", 2, 0.5)]
    kw = dict(b=4, strategy="hybrid", theta=8.0, buckets=(4,))
    want = JS.PMVServer(edges, n, backend="pallas", **kw).serve(
        [JS.Query(k, source=s, tol=t) for k, s, t in queries])
    got = {}
    for be in ("pallas", "torch"):
        srv = TS.PMVServer(edges, n, backend=be, device="cpu", **kw)
        try:
            got[be] = srv.serve([TS.Query(k, source=s, tol=t) for k, s, t in queries])
        finally:
            srv.close()
    for (kind, _, _), p, t, w in zip(queries, got["pallas"], got["torch"], want):
        assert p.converged and p.reason == "completed"
        for other in (t, w):
            if kind == "sssp":
                np.testing.assert_array_equal(p.vector, other.vector)
                assert p.iterations == other.iterations
            else:
                np.testing.assert_allclose(p.vector, other.vector, rtol=1e-5, atol=1e-7)


def test_plan_built_for_forced_backends_too():
    """Forced 'xla' / 'pallas' still carry the measured tactic table (the
    JAX package's tests/test_planner.py::test_plan_built_for_forced_backends_too),
    block for block the JAX package's, and pack no planned tables."""
    edges = erdos_renyi(64, 300, seed=1)
    for be, mode, j_mode in (("xla", "torch", "xla"), ("pallas", "pallas", "pallas")):
        eng = T.PMVEngine(edges, 64, b=4, strategy="vertical", backend=be, device="cpu")
        matrix, _v0, _ctx, _mask, meta = eng.prepare(T.pagerank(64))
        _, _, _, _, _, j_meta = J.PMVEngine(edges, 64, b=4, strategy="vertical",
                                            backend=be).prepare(J.pagerank(64))
        assert meta["plan"].mode == mode and j_meta["plan"].mode == j_mode
        assert len(meta["plan"].blocks) == 16
        assert "planned" not in matrix
        assert [(bp.tactic, bp.nnz, bp.d_max) for bp in meta["plan"].blocks] == \
            [(bp.tactic, bp.nnz, bp.d_max) for bp in j_meta["plan"].blocks]
        assert meta["backend"] == mode


@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
def test_pallas_out_of_core_raises(tmp_path, strategy):
    """residency='disk' has no flat-ELL path: ValueError naming 'pallas' in
    both packages (the JAX package's tests/test_residency.py)."""
    import repro_torch.store as TST

    edges = erdos_renyi(64, 300, seed=1)
    root = str(tmp_path / "s")
    TST.ingest_edges(edges, 64, 4, root, theta=4.0)
    kw = dict(store=root, residency="disk", strategy=strategy, backend="pallas")
    with pytest.raises(ValueError, match="pallas"):
        J.PMVEngine(None, **kw).prepare(J.sssp(0))
    with pytest.raises(ValueError, match="pallas"):
        T.PMVEngine(None, device="cpu", **kw).prepare(T.sssp(0))


def test_pallas_interpret_false_on_cpu_raises():
    """pallas_interpret=False asks for the CUDA kernels: the engine and the
    server refuse it on the CPU, naming the knob."""
    import repro_torch.serving as TS

    with pytest.raises(ValueError, match="pallas_interpret"):
        T.PMVEngine(EDGES, N, b=B, backend="pallas", pallas_interpret=False, device="cpu")
    with pytest.raises(ValueError, match="pallas_interpret"):
        TS.PMVServer(EDGES, N, b=B, backend="pallas", pallas_interpret=False, device="cpu")


@pytest.mark.parametrize("backend,strategy,scatter", [
    ("pallas", "vertical", "kernel"), ("pallas", "hybrid", "kernel"),
    ("pallas", "horizontal", "segment"), ("auto", "vertical", "kernel"),
    ("auto", "hybrid", "kernel")])
def test_pallas_interpret_true_equals_the_default(backend, strategy, scatter):
    """pallas_interpret=True resolves as None does on the CPU (the plain
    versions; ``meta['cfg'].interpret``) and gives the same answer."""
    got = {}
    for interpret in (True, None):
        eng = T.PMVEngine(EDGES, N, b=B, strategy=strategy, theta=4.0, backend=backend,
                          scatter=scatter, pallas_interpret=interpret, device="cpu")
        got[interpret] = eng.run(T.sssp(0), max_iters=60, tol=0.5)
        assert eng.prepare(T.sssp(0))[-1]["cfg"].interpret
    np.testing.assert_array_equal(got[True].v, got[None].v)
    assert got[True].iterations == got[None].iterations


def test_interpret_calls_the_plain_versions_where_a_kernel_would_launch(monkeypatch):
    """Inside ``plain_versions`` (the step under ``StepConfig.interpret``) a
    caller takes the ``ref.py`` function itself on a CUDA tensor (the
    wrapper would launch there; ``tests/test_torch_cuda.py`` holds that
    nothing launches) and leaves the call to the wrapper on a CPU tensor,
    which runs the plain version anyway; outside it, and after it, the
    wrappers are called; ``placement_call`` sets it from the step's config
    and restores it after the step."""
    from repro_torch.kernels import plain_versions, runs_plain

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert not runs_plain(cuda) and not runs_plain(cpu)
    with plain_versions(True):
        assert runs_plain(cuda)
        assert not runs_plain(cpu)
        with plain_versions(False):
            assert not runs_plain(cuda)
        assert runs_plain(cuda)
    assert not runs_plain(cuda)
    seen = []
    eng = T.PMVEngine(EDGES, N, b=B, strategy="vertical", backend="pallas",
                      pallas_interpret=True, device="cpu")
    spec = T.sssp(0)
    matrix, v, ctx, mask, meta = eng.prepare(spec)
    real = placement.ell_gimv_call
    monkeypatch.setattr(placement, "ell_gimv_call",
                        lambda *a: seen.append(runs_plain(cuda)) or real(*a))
    T.placement_call(spec, meta["cfg"], matrix, v, ctx, mask)
    assert seen and all(seen)
    assert not runs_plain(cuda)


# -- make_step -------------------------------------------------------------

MAKE_STEP_CASES = [(s, ex, d) for s in STRATEGIES for ex, d in (("sparse", None),
                                                                ("packed", 0.0))
                   if not (s == "horizontal" and ex == "packed")]


@pytest.mark.parametrize("strategy,exchange,delta_eps", MAKE_STEP_CASES,
                         ids=[f"{s}-{ex}-{d}" for s, ex, d in MAKE_STEP_CASES])
@pytest.mark.parametrize("backend", ["torch", "pallas"])
def test_make_step_matches_jax(strategy, exchange, delta_eps, backend):
    """``repro_torch.core.make_step`` against the JAX package's ``make_step``
    on the same graph, knobs and v: v_new, delta and stats over two steps;
    with ``delta_eps`` (active on the vertical packed solve) the carried
    state too."""
    j_backend = {"torch": "xla"}.get(backend, backend)
    kw = dict(strategy=strategy, exchange=exchange, delta_eps=delta_eps)
    t_spec, j_spec = T.pagerank(N), J.pagerank(N)
    tm, t_mask, t_meta = _port(t_spec, backend, False, **kw)
    jm, j_mask, j_meta = _jax(j_spec, j_backend, False, **kw)
    t_cfg, j_cfg = t_meta["cfg"], j_meta["cfg"]
    assert (t_cfg.delta_eps is None) == (j_cfg.delta_eps is None)
    assert (t_cfg.delta_eps is not None) == (strategy == "vertical" and delta_eps is not None)
    t_step, j_step = T.make_step(t_spec, t_cfg), jax.jit(j_make_step(j_spec, j_cfg))
    v = _rand_v(t_spec, (B, t_meta["part"].n_local), np.random.default_rng(5)) / N
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    ts = js = None
    if t_cfg.delta_eps is not None:
        shape = (B, B, t_cfg.xplan.p_dev)
        ts = torch.zeros(shape, dtype=torch.float32)
        js = jnp.zeros(shape, jnp.float32)
    for _ in range(2):
        t_out = t_step(tm, tv, {}, t_mask, *(() if ts is None else (ts,)))
        j_out = j_step(jm, jv, {}, j_mask, *(() if js is None else (js,)))
        assert len(t_out) == len(j_out) == (3 if ts is None else 4)
        _close(False, t_out[0].numpy(), j_out[0], atol=1e-7)
        np.testing.assert_allclose(float(t_out[1]), float(j_out[1]), rtol=1e-5, atol=1e-9)
        for key, x in j_out[2].items():
            if key != "logical_elems":
                assert float(t_out[2][key]) == float(x), key
        if ts is not None:
            _close(False, t_out[3].numpy(), j_out[3], atol=1e-7)
            ts, js = t_out[3], j_out[3]
        tv, jv = t_out[0], j_out[0]


def test_core_exports_make_step():
    assert T.make_step is T.engine.make_step
    assert T.__all__ == J.__all__


# -- the flat tables and the block-at-a-time compaction ----------------------

@pytest.mark.parametrize("strategy", ["horizontal", "vertical"])
def test_ell_tables_equal_the_jax_packages(strategy):
    """The port's ``stripe_to_ell`` / ``stack_ells`` on a partition carried
    over with ``from_reference`` give the JAX package's tables (merged for
    horizontal stripes, per block for vertical ones); ``flatten_ell`` folds
    the worker axis in with every row still left-packed."""
    import repro.core.blocks as JB
    from repro.core.partition import partition_graph

    pm, _ = partition_graph(EDGES, N, B, J.pagerank(N))
    nl = pm.part.n_local
    stripes = pm.horizontal if strategy == "horizontal" else pm.vertical
    stride = nl if strategy == "horizontal" else None
    want = JB.stack_ells([JB.stripe_to_ell(s, nl, merge_col_stride=stride) for s in stripes])
    got = T.blocks.stack_ells([T.blocks.stripe_to_ell(T.from_reference(s), nl,
                                                      merge_col_stride=stride)
                               for s in stripes])
    carried = T.from_reference(want)
    assert isinstance(carried, T.blocks.EllStripe)
    for a in (got, carried):
        np.testing.assert_array_equal(a.cols, np.asarray(want.cols))
        np.testing.assert_array_equal(a.w, np.asarray(want.w))
    flat = placement.flatten_ell(got, nl, "merged" if stride else "vertical", "cpu")
    cols = flat.cols.reshape(-1, flat.cols.shape[-1])
    assert int((cols >= 0).sum()) == int((got.cols >= 0).sum())


@given(data=st.data())
@settings(max_examples=20, deadline=None)
def test_block_at_a_time_compaction_equals_whole(data):
    """``_ell_partials_compact`` (one destination block's table a launch,
    compacted at once) gives the buffers and counters of one
    ``compact_partials`` over all the partials (``_ell_block_partials``),
    also when the capacity overflows."""
    spec = T.sssp(0)
    rng = np.random.default_rng(data.draw(st.integers(0, 1000)))
    b_w, b, nl, d = 2, 3, data.draw(st.integers(2, 12)), data.draw(st.integers(1, 5))
    deg = rng.integers(0, d + 1, (b, b_w * nl))
    cols = np.full((b, b_w * nl, d), -1, np.int32)
    for k in range(b):
        for r in range(b_w * nl):
            cols[k, r, :deg[k, r]] = (r // nl) * nl + rng.integers(0, nl, deg[k, r])
    ell = T.blocks.EllStripe(cols=torch.from_numpy(cols),
                             w=torch.from_numpy(rng.random(cols.shape).astype(np.float32)))
    v = rng.random((b_w, nl)).astype(np.float32)
    v[rng.random(v.shape) < 0.3] = np.inf
    v = torch.from_numpy(v)
    cap = data.draw(st.integers(1, nl))
    got = placement._ell_partials_compact(spec, ell, v, nl, cap)
    want = sparse_exchange.compact_partials(
        spec, placement._ell_block_partials(spec, ell, v, nl), cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
