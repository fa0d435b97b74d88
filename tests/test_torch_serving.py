"""repro_torch.serving: the port's PMVServer (device='cpu') against the JAX
package's PMVServer on the same query stream, and the serving protocol on
the port alone: continuous batching, deadlines, shedding, failure
containment, resubmission and the batcher's bucket / FIFO policy.

Parity: 24 RWR + 24 SSSP queries, interleaved, with buckets (8, 16) so that
each family fills a 16-wide batch and admits 8 queries mid-batch.  Per qid,
SSSP vectors and iteration counts are equal, RWR vectors allclose (rtol
1e-5, atol 1e-7: the float summation order differs) with iteration counts
within 1, and every ``converged`` flag is equal; ``stats()`` batches and
mid-batch admissions are equal."""
import numpy as np
import pytest
import torch

import repro.serving as JS
import repro_torch.serving as TS
from repro.graph import rmat
from repro.graph.generators import chain_graph
from repro_torch.core import PMVEngine, random_walk_with_restart, rwr_context

N, B = 256, 4
EDGES = rmat(8, 1500, seed=3)
SOURCES = np.random.default_rng(0).choice(N, 48)


def _queries(mod):
    out = []
    for i in range(24):
        out.append(mod.Query("rwr", source=int(SOURCES[i]), tol=1e-6))
        out.append(mod.Query("sssp", source=int(SOURCES[24 + i]), tol=0.5))
    return out


@pytest.mark.parametrize("strategy,backend,ref_backend,scatter", [
    ("vertical", "torch", "xla", "segment"),
    ("hybrid", "auto", "auto", "kernel"),
    ("horizontal", "auto", "auto", "auto"),
])
def test_server_matches_jax_server(strategy, backend, ref_backend, scatter):
    kw = dict(b=B, strategy=strategy, theta=8.0, scatter=scatter, stream="off",
              buckets=(8, 16))
    ref = JS.PMVServer(EDGES, N, backend=ref_backend, **kw)
    port = TS.PMVServer(EDGES, N, backend=backend, device="cpu", **kw)
    want = ref.serve(_queries(JS))
    got = port.serve(_queries(TS))
    assert [r.qid for r in got] == [r.qid for r in want]
    for g, w in zip(got, want):
        assert g.reason == w.reason == "completed"
        assert g.converged == w.converged
        assert g.vector.dtype == w.vector.dtype and g.vector.shape == (N,)
        if g.query.spec_kind == "sssp":
            np.testing.assert_array_equal(g.vector, w.vector)
            assert g.iterations == w.iterations
        else:
            np.testing.assert_allclose(g.vector, w.vector, rtol=1e-5, atol=1e-7)
            assert abs(g.iterations - w.iterations) <= 1
    s_ref, s_port = ref.stats(), port.stats()
    for key in ("batches", "admitted_mid_batch", "queries", "retired"):
        assert s_port[key] == s_ref[key], key
    assert s_port["admitted_mid_batch"] == 16
    assert s_port["retirement_reasons"] == s_ref["retirement_reasons"]
    assert len(s_port["iter_wall_s"]) == s_port["iterations"]


def test_batched_rwr_matches_independent_engine_solves():
    """Each served RWR column equals the port's own single-query solve."""
    srv = TS.PMVServer(EDGES, N, b=B, strategy="vertical", backend="auto", stream="off",
                       buckets=(8,), device="cpu")
    sources = [int(s) for s in SOURCES[:5]]
    res = srv.serve([TS.Query("rwr", source=s, tol=1e-7) for s in sources])
    eng = PMVEngine(EDGES, N, b=B, strategy="vertical", backend="auto", stream="off",
                    device="cpu")
    for s, r in zip(sources, res):
        one = eng.run(random_walk_with_restart(N, s), rwr_context(N, s), max_iters=200,
                      tol=1e-7)
        assert r.converged and one.converged
        np.testing.assert_allclose(r.vector, one.v, rtol=1e-5, atol=1e-7)


def test_continuous_batching_retire_and_admit():
    """A converged column is retired and a waiting query admitted mid-loop
    without disturbing in-flight columns: one batch serves 7 queries
    through 4 slots, per-query iteration counts differ, every answer is
    exact."""
    n = 64
    srv = TS.PMVServer(chain_graph(n), n, b=4, strategy="vertical", buckets=(4,),
                       max_iters=300, device="cpu")
    sources = [0, 40, 55, 60, 62, 10, 30]
    res = srv.serve([TS.Query("sssp", source=s, tol=0.5) for s in sources])
    for s, r in zip(sources, res):
        np.testing.assert_array_equal(r.vector, np.where(np.arange(n) >= s, np.arange(n) - s,
                                                         np.inf))
    iters = [r.iterations for r in res]
    stats = srv.stats()
    assert stats["batches"] == 1 and stats["admitted_mid_batch"] == 3
    assert len(set(iters)) > 1 and max(iters[4:]) < max(iters[:4])


def test_mixed_kinds_grouped_into_separate_batches():
    srv = TS.PMVServer(EDGES, N, b=B, strategy="vertical", buckets=(8,), device="cpu")
    res = srv.serve([TS.Query("rwr", source=i, tol=1e-7) for i in range(3)]
                    + [TS.Query("cc"), TS.Query("pagerank", tol=1e-7)])
    assert srv.stats()["batches"] == 3       # one per family, never mixed
    assert all(r.reason == "completed" and r.converged for r in res)
    assert res[3].vector.dtype == np.int32


def test_resubmitting_same_query_object_yields_two_results():
    n = 64
    srv = TS.PMVServer(chain_graph(n), n, b=4, strategy="vertical", buckets=(4,),
                       device="cpu")
    q = TS.Query("sssp", source=3, tol=0.5)
    res = srv.serve([q, q])
    assert len(res) == 2 and res[0].qid != res[1].qid
    np.testing.assert_array_equal(res[0].vector, res[1].vector)
    res2 = srv.serve([q])
    np.testing.assert_array_equal(res2[0].vector, res[0].vector)


def test_deadline_returns_partial_iterate():
    srv = TS.PMVServer(EDGES, N, b=B, device="cpu")
    qid = srv.submit(TS.Query("pagerank", tol=0.0, max_iters=50, deadline_s=0.0))
    r = srv.drain()[qid]
    assert r.reason == "deadline_exceeded" and not r.converged
    assert r.vector is not None and r.iterations >= 1
    assert srv.stats()["retirement_reasons"]["deadline_exceeded"] == 1


def test_sheds_over_max_queue():
    srv = TS.PMVServer(EDGES, N, b=B, max_queue=2, device="cpu")
    qids = [srv.submit(TS.Query("pagerank", tol=1e-5)) for _ in range(5)]
    res = srv.drain()
    assert [res[q].reason for q in qids] == ["completed"] * 2 + ["shed"] * 3
    assert all(res[q].vector is None for q in qids[2:])
    st = srv.stats()
    assert st["shed"] == 3 and st["queries"] == 5 and st["retired"] == 2
    assert st["retirement_reasons"] == {"completed": 2, "deadline_exceeded": 0, "shed": 3,
                                        "failed": 0}


def test_failed_batch_keeps_server_alive(monkeypatch):
    """An OSError while a batch runs fails that batch's queries with the
    error's text; the server answers the next batch."""
    srv = TS.PMVServer(EDGES, N, b=B, device="cpu")
    real = PMVEngine.prepare
    calls = []

    def flaky(self, spec, ctx=None):
        calls.append(spec.name)
        if len(calls) == 1:
            raise OSError("shard vanished")
        return real(self, spec, ctx)

    monkeypatch.setattr(PMVEngine, "prepare", flaky)
    qid = srv.submit(TS.Query("pagerank", tol=1e-5))
    r = srv.drain()[qid]
    assert r.reason == "failed" and r.vector is None and "shard vanished" in r.error
    qid2 = srv.submit(TS.Query("pagerank", tol=1e-5))
    r2 = srv.drain()[qid2]
    assert r2.reason == "completed" and r2.vector is not None
    st = srv.stats()
    assert st["failed_batches"] == 1 and st["retirement_reasons"]["failed"] == 1


def test_batcher_bucket_policy_and_fifo():
    qb = TS.QueryBatcher(buckets=(8, 16, 32))
    assert qb.bucket_for(3) == 8 and qb.bucket_for(9) == 16 and qb.bucket_for(64) == 32
    qb.add(TS.Query("rwr", source=1))
    qb.add(TS.Query("sssp", source=2))
    qb.add(TS.Query("rwr", source=3))
    key, batch = qb.next_batch()
    assert key[0] == "rwr" and [q.source for q in batch] == [1, 3]
    assert qb.pop_waiting(key) is None
    key2, batch2 = qb.next_batch()
    assert key2 == ("sssp",) and batch2[0].source == 2
    assert qb.next_batch() is None


def test_per_query_delta_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    v = rng.random((3, 7, 5)).astype(np.float32)
    w = v.copy()
    w[:, :, 1] += 0.5
    w[0, 2, 3] = np.inf
    for kind in ("abs", "count"):
        got = TS.per_query_delta(torch.from_numpy(v), torch.from_numpy(w), delta_kind=kind)
        want = JS.per_query_delta(jnp.asarray(v), jnp.asarray(w), delta_kind=kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_server_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.PMVServer(EDGES, N, b=B)
    with pytest.raises(ValueError, match="source"):
        TS.PMVServer(EDGES, N, b=B, device="cpu").submit(TS.Query("sssp", source=N))


def test_served_columns_equal_single_query_runs_on_the_family_engine():
    """engine_for + PMVEngine.run(v0=...): each served answer equals the
    single-vector solve of the same query on its family's resident matrix
    (SSSP exact with equal iterations, RWR allclose)."""
    srv = TS.PMVServer(EDGES, N, b=B, strategy="hybrid", theta=8.0, backend="auto",
                       scatter="kernel", stream="off", buckets=(8,), device="cpu")
    queries = [TS.Query("sssp", source=int(s), tol=0.5) for s in SOURCES[:6]]
    queries += [TS.Query("rwr", source=int(s), tol=1e-6) for s in SOURCES[6:12]]
    res = srv.serve(queries)
    for q, r in zip(queries, res):
        eng, spec = srv.engine_for(q)
        fam = TS.FAMILIES[q.spec_kind]
        one = eng.run(spec, fam.ctx_columns(N, q) or None, max_iters=200, tol=q.tol,
                      v0=fam.init_column(N, q))
        assert one.converged == r.converged
        if q.spec_kind == "sssp":
            np.testing.assert_array_equal(one.v, r.vector)
            assert one.iterations == r.iterations
        else:
            np.testing.assert_allclose(one.v, r.vector, rtol=1e-5, atol=1e-7)
