"""The packed exchange of the PyTorch port (``repro_torch.exchange``,
``exchange='packed'`` / ``'auto'``, ``delta_eps``) against the JAX package's
``repro.exchange`` on the same inputs.

- Codec and plan: the port's numpy copies give the reference's arrays and
  ``ExchangePlan`` on the same stripes, over the fuzz topologies.
- ``prefer_packed_exchange`` and its byte models agree on a grid.
- Engine: ``PMVEngine(exchange='packed')`` equals the JAX engine for
  PageRank, SSSP and CC, vertical and hybrid, backends 'torch' (the JAX
  package's 'xla') and 'auto', scatter 'segment' and 'kernel': SSSP and CC
  exactly with equal iteration counts, PageRank allclose (rtol 1e-5, atol
  1e-7, the float summation order differs); the per-iteration wire stats
  are equal.
- Under segment scatter the port's packed exchange is BITWISE its sparse
  exchange, on every fuzz topology and semiring (the contract the JAX
  package's tests/test_exchange.py holds for itself).
- Delta iteration: delta_eps=0.0 is bitwise the full stream; delta_eps=1e-3
  sends the JAX engine's rows per iteration and lands within atol 1e-6.
  The gating reasons, the 'auto' decision and the totals (packed ids
  counted once) equal the reference's.
- One batched placement step with packed equals the reference's, and
  ``PMVServer(exchange='packed')`` answers as the JAX server does.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_parity import assert_results_match, run_both
from test_fuzz_parity import SEMIRING_CASES, TOPOLOGIES, _fuzz_edges
from test_torch_placement_batched import _check_step

import repro.core as J
import repro.serving as JS
import repro_torch.core as T
import repro_torch.serving as TS
from repro.core import cost_model as j_cost
from repro.core.partition import partition_graph as j_partition
from repro.exchange import codec as j_codec
from repro.exchange import plan as j_plan
from repro.graph import rmat
from repro_torch.core import cost_model as t_cost
from repro_torch.core.partition import partition_graph as t_partition
from repro_torch.exchange import codec as t_codec
from repro_torch.exchange import plan as t_plan

N, B = 128, 4
GRAPH = rmat(7, 700, seed=13)


# ---------------------------------------------------------------------------
# Codec and plan.
# ---------------------------------------------------------------------------

def _assert_plans_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "ExchangePlan"
    for f in ("b", "n_local", "p_cap", "p_dev", "width_dev", "payload_slots", "id_bytes",
              "bitmap_bytes", "pair_rows", "pair_widths"):
        assert getattr(got, f) == getattr(want, f), f


@given(data=st.data())
@settings(max_examples=12, deadline=None)
def test_codec_and_plan_equal_reference_on_fuzz_topologies(data):
    topology = data.draw(st.sampled_from(TOPOLOGIES), label="topology")
    b = data.draw(st.sampled_from([2, 4]), label="b")
    n = b * data.draw(st.integers(3, 12), label="n_over_b")
    seed = data.draw(st.integers(0, 10_000), label="seed")
    edges = _fuzz_edges(topology, n, b, np.random.default_rng(seed))
    spec_j, spec_t = J.sssp(0), T.sssp(0)
    pm_j, _ = j_partition(edges, n, b, spec_j)
    pm_t, _ = t_partition(edges, n, b, spec_t)
    nl = pm_t.part.n_local
    sets_j = j_plan.row_sets_from_stripes(pm_j.vertical, b)
    sets_t = t_plan.row_sets_from_stripes(pm_t.vertical, b)
    assert t_codec.device_width(nl) == j_codec.device_width(nl)
    for i in range(b):
        for j in range(b):
            np.testing.assert_array_equal(sets_t[i][j], sets_j[i][j])
            pk_t, pk_j = t_codec.pack_ids(sets_t[i][j], nl), j_codec.pack_ids(sets_j[i][j], nl)
            np.testing.assert_array_equal(pk_t.words, pk_j.words)
            assert (pk_t.count, pk_t.width, t_codec.packed_nbytes(pk_t)) == \
                (pk_j.count, pk_j.width, j_codec.packed_nbytes(pk_j))
            np.testing.assert_array_equal(t_codec.unpack_ids(pk_t), sets_j[i][j])
    for scatter in ("segment", "kernel"):
        xp_t, arr_t = t_plan.build_exchange(sets_t, nl, scatter=scatter)
        xp_j, arr_j = j_plan.build_exchange(sets_j, nl, scatter=scatter)
        _assert_plans_equal(xp_t, xp_j)
        assert sorted(arr_t) == sorted(arr_j)
        for k in arr_j:
            assert arr_t[k].dtype == arr_j[k].dtype, k
            np.testing.assert_array_equal(arr_t[k], arr_j[k])
        if scatter == "kernel":
            np.testing.assert_array_equal(
                t_codec.unpack_uniform(arr_t["recv_words"], xp_t.width_dev, b * xp_t.p_dev),
                arr_j["recv_rows"].reshape(b, -1))
    sizes = [[len(sets_t[i][j]) for j in range(b)] for i in range(b)]
    _assert_plans_equal(t_plan.summarize_row_sizes(sizes, nl),
                        j_plan.summarize_row_sizes(sizes, nl))
    kw = dict(mode="packed", decision="forced", capacity=max(xp_j.p_cap, 1), itemsize=4,
              delta_eps=1e-3)
    assert t_plan.format_exchange(xp_t, **kw) == j_plan.format_exchange(xp_j, **kw)


def test_codec_uniform_widths_equal_reference():
    rng = np.random.default_rng(4)
    for width in t_codec.DEVICE_WIDTHS:
        ids = rng.integers(0, 2 ** min(width, 31), (3, 64))
        words = t_codec.pack_uniform(ids, width)
        np.testing.assert_array_equal(words, j_codec.pack_uniform(ids, width))
        np.testing.assert_array_equal(t_codec.unpack_uniform(words, width, 64),
                                      j_codec.unpack_uniform(words, width, 64))
    for n_local in (1, 15, 16, 255, 256, 65535, 65536, 131072):
        assert t_codec.device_width(n_local) == j_codec.device_width(n_local)


def test_prefer_packed_exchange_equals_reference_on_a_grid():
    assert t_cost.PACKED_ID_AMORTIZATION_ITERS == j_cost.PACKED_ID_AMORTIZATION_ITERS
    for b in (2, 4, 8):
        for cap in (1, 7, 100):
            for slots in (0, b * cap, b * (b - 1) * cap):
                for id_bytes in (0, 100, 10**4, 10**9):
                    for nq in (None, 8):
                        args = (b, cap, slots, id_bytes, nq, 4)
                        assert t_cost.prefer_packed_exchange(*args) == \
                            j_cost.prefer_packed_exchange(*args), args
                assert t_cost.padded_exchange_bytes(b, cap, 8, 4) == \
                    j_cost.padded_exchange_bytes(b, cap, 8, 4)
                assert t_cost.packed_exchange_bytes(slots, 8, 4) == \
                    j_cost.packed_exchange_bytes(slots, 8, 4)


# ---------------------------------------------------------------------------
# Engine parity with the JAX package.
# ---------------------------------------------------------------------------

ENGINE_CASES = [(algo, strategy, backend, scatter)
                for algo in ("pagerank", "sssp", "cc")
                for strategy in ("vertical", "hybrid")
                for backend in ("torch", "auto")
                for scatter in ("segment", "kernel")]


@pytest.mark.parametrize("algo,strategy,backend,scatter", ENGINE_CASES,
                         ids=["-".join(c) for c in ENGINE_CASES])
def test_engine_packed_matches_jax(algo, strategy, backend, scatter):
    r_ref, r_port, meta = run_both(GRAPH, N, B, algo, strategy=strategy, backend=backend,
                                   scatter=scatter, theta=6.0, exchange="packed")
    assert meta["exchange"] == "packed" and meta["plan"].scatter == scatter
    assert_results_match(r_ref, r_port, algo)
    for key in ("exchange_payload_bytes", "exchange_id_bytes", "overflow"):
        assert r_port.per_iter[-1][key] == float(r_ref.per_iter[-1][key]), key
    for key in ("exchange_id_bytes", "exchange_payload_bytes", "wire_bytes"):
        assert r_port.totals[key] == float(r_ref.totals[key]), key


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_port_packed_is_bitwise_port_sparse_under_segment(topology):
    rng = np.random.default_rng(len(topology))
    for b in (2, 4):
        n = b * 7
        edges = _fuzz_edges(topology, n, b, rng)
        for name, (_mk, sym, _exact) in SEMIRING_CASES.items():
            spec = _max_plus_spec() if name == "max_plus" else {
                "plus_times": lambda: T.pagerank(n), "min_plus": lambda: T.sssp(0),
                "min_src": T.connected_components}[name]()
            for strategy in ("vertical", "hybrid"):
                kw = dict(b=b, strategy=strategy, theta=3.0, scatter="segment",
                          symmetrize=sym, device="cpu")
                rs = T.PMVEngine(edges, n, exchange="sparse", **kw).run(spec, max_iters=6,
                                                                       tol=0.0)
                rp = T.PMVEngine(edges, n, exchange="packed", **kw).run(spec, max_iters=6,
                                                                       tol=0.0)
                np.testing.assert_array_equal(rp.v, rs.v)
                assert [r["logical_elems"] for r in rp.per_iter] == \
                    [r["logical_elems"] for r in rs.per_iter]


def _max_plus_spec():
    return T.GimvSpec(name="maxplus", combine2="add", combine_all="max", dtype=np.float32,
                      assign=lambda v, r, ctx: torch.maximum(v, r),
                      init=lambda ids, ctx: np.zeros(ids.shape, np.float32))


# ---------------------------------------------------------------------------
# Delta iteration, gating, 'auto', totals.
# ---------------------------------------------------------------------------

def test_delta_eps0_is_bitwise_the_full_stream():
    kw = dict(b=B, strategy="vertical", exchange="packed", scatter="kernel", device="cpu")
    full = T.PMVEngine(GRAPH, N, **kw).run(T.pagerank(N), max_iters=25, tol=1e-7)
    d0 = T.PMVEngine(GRAPH, N, delta_eps=0.0, **kw).run(T.pagerank(N), max_iters=25, tol=1e-7)
    np.testing.assert_array_equal(d0.v, full.v)
    assert d0.iterations == full.iterations
    xp = T.PMVEngine(GRAPH, N, **kw).prepare(T.pagerank(N))[-1]["cfg"].xplan
    assert d0.totals["delta_sent_rows"] + d0.totals["delta_suppressed_rows"] == \
        d0.iterations * xp.payload_slots


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_delta_eps_matches_jax(backend):
    r_ref, r_port, meta = run_both(GRAPH, N, B, "pagerank", strategy="vertical",
                                   backend=backend, scatter="segment", exchange="packed",
                                   delta_eps=1e-3)
    assert meta["delta_eps"] == 1e-3 and meta["delta_reason"] == "active"
    assert r_port.iterations == r_ref.iterations
    assert [r["delta_sent_rows"] for r in r_port.per_iter] == \
        [float(r["delta_sent_rows"]) for r in r_ref.per_iter]
    assert [r["delta_suppressed_rows"] for r in r_port.per_iter] == \
        [float(r["delta_suppressed_rows"]) for r in r_ref.per_iter]
    np.testing.assert_allclose(r_port.v, r_ref.v, rtol=0, atol=1e-6)
    for key in ("delta_sent_rows", "delta_suppressed_rows", "exchange_payload_bytes",
                "exchange_id_bytes", "wire_bytes"):
        assert r_port.totals[key] == float(r_ref.totals[key]), key


def _sum_int_spec(mod, xp):
    return mod.GimvSpec(name="intsum", combine2="mul", combine_all="sum", dtype=np.int32,
                        assign=lambda v, r, c: r, init=lambda ids, c: ids.astype(np.int32))


@pytest.mark.parametrize("case", ["sparse", "hybrid", "selection", "integer", "horizontal",
                                  "auto", "auto-hybrid"])
def test_delta_gating_and_auto_decision_equal_reference(case):
    import jax.numpy as jnp

    kw = dict(b=B, strategy="vertical", exchange="packed", delta_eps=0.0)
    spec = {"j": J.pagerank(N), "t": T.pagerank(N)}
    if case == "sparse":
        kw["exchange"] = "sparse"
    elif case == "hybrid":
        kw.update(strategy="hybrid", theta=6.0)
    elif case == "selection":
        spec = {"j": J.sssp(0), "t": T.sssp(0)}
    elif case == "integer":
        spec = {"j": _sum_int_spec(J, jnp), "t": _sum_int_spec(T, torch)}
    elif case == "horizontal":
        kw["strategy"] = "horizontal"
    elif case == "auto":
        kw["exchange"] = "auto"
    else:
        kw.update(exchange="auto", strategy="hybrid", theta=6.0)
    mj = J.PMVEngine(GRAPH, N, **kw).prepare(spec["j"])[-1]
    mt = T.PMVEngine(GRAPH, N, device="cpu", **kw).prepare(spec["t"])[-1]
    for key in ("exchange", "exchange_decision", "delta_eps", "delta_reason"):
        assert mt.get(key) == mj.get(key), key
    assert mt["cfg"].exchange == mj["cfg"].exchange
    assert (mt["cfg"].xplan is None) == (mj["cfg"].xplan is None)
    if mj["cfg"].xplan is not None:
        _assert_plans_equal(mt["cfg"].xplan, mj["cfg"].xplan)


def test_packed_totals_count_ids_once():
    kw = dict(b=B, strategy="vertical", scatter="segment", device="cpu")
    rs = T.PMVEngine(GRAPH, N, exchange="sparse", **kw).run(T.pagerank(N), max_iters=5, tol=0.0)
    rp = T.PMVEngine(GRAPH, N, exchange="packed", **kw).run(T.pagerank(N), max_iters=5, tol=0.0)
    assert rs.totals["exchange_id_bytes"] == 5 * rs.per_iter[0]["exchange_id_bytes"]
    assert rp.totals["exchange_id_bytes"] == rp.per_iter[0]["exchange_id_bytes"]
    assert rp.totals["wire_bytes"] < rs.totals["wire_bytes"]
    np.testing.assert_array_equal(rp.v, rs.v)


# ---------------------------------------------------------------------------
# Batched step and serving.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,strategy,backend,scatter", [
    ("rwr", "vertical", "auto", "kernel"), ("sssp", "hybrid", "auto", "kernel"),
    ("cc", "vertical", "torch", "segment"), ("pagerank", "hybrid", "torch", "kernel")])
def test_batched_packed_step_matches_jax(algo, strategy, backend, scatter):
    _check_step(GRAPH, N, B, algo, strategy, backend, scatter, theta=6.0, exchange="packed")


def _queries(mod, sources):
    out = []
    for i in range(len(sources) // 2):
        out.append(mod.Query("rwr", source=int(sources[2 * i]), tol=1e-6))
        out.append(mod.Query("sssp", source=int(sources[2 * i + 1]), tol=0.5))
    return out


def test_server_packed_matches_jax_server_and_port_sparse():
    sources = np.random.default_rng(0).choice(N, 20)
    kw = dict(b=B, strategy="hybrid", theta=6.0, stream="off", buckets=(4, 8))
    want = JS.PMVServer(GRAPH, N, backend="auto", scatter="kernel", exchange="packed",
                        **kw).serve(_queries(JS, sources))
    got = TS.PMVServer(GRAPH, N, backend="auto", scatter="kernel", exchange="packed",
                       device="cpu", **kw).serve(_queries(TS, sources))
    seg = TS.PMVServer(GRAPH, N, backend="auto", scatter="segment", exchange="packed",
                       device="cpu", **kw).serve(_queries(TS, sources))
    sparse = TS.PMVServer(GRAPH, N, backend="auto", scatter="segment", exchange="sparse",
                          device="cpu", **kw).serve(_queries(TS, sources))
    for g, w, p, s in zip(got, want, seg, sparse):
        assert g.reason == w.reason == "completed" and g.converged == w.converged
        if g.query.spec_kind == "sssp":
            np.testing.assert_array_equal(g.vector, w.vector)
            assert g.iterations == w.iterations
        else:
            np.testing.assert_allclose(g.vector, w.vector, rtol=1e-5, atol=1e-7)
            assert abs(g.iterations - w.iterations) <= 1
        np.testing.assert_array_equal(p.vector, s.vector)
        assert p.iterations == s.iterations
