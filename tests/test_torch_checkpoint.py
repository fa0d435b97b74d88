"""The port's engine satellites of the fault-tolerance layer on the CPU, held
against the JAX package (n = 96, b = 4): atomic checkpoint / resume (the
JAX package's ``pmv_state.npz``, which either package resumes), a kill
between checkpoints on a resident engine, the bfloat16 wire
(``payload_dtype``), ``capacity='model'`` with its overflow fallback on the
engine and the server's requeue, and prepare caching."""
import warnings

import numpy as np
import pytest

import repro.core as J
import repro.faults as JF
import repro.serving as JS
import repro_torch.core as T
import repro_torch.faults as TF
import repro_torch.serving as TS
from repro.graph import erdos_renyi, star_graph
from repro_torch.core.engine import (CheckpointCorruptWarning, _ckpt_load, _ckpt_path,
                                     _ckpt_save)


def _graph():
    n = 96
    return erdos_renyi(n, 420, seed=3), n


def _eng(mod, edges, n, **kw):
    extra = {"device": "cpu"} if mod is T else {}
    return mod.PMVEngine(edges, n, b=kw.pop("b", 4), **kw, **extra)


# ---------------------------------------------------------------------------
# Checkpoint / resume.

def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Interrupt at iteration 10, resume, land bitwise on the uninterrupted
    vector; only iterations 10..19 re-run."""
    edges, n = _graph()
    spec = T.pagerank(n)
    ck = str(tmp_path / "ck")
    full = _eng(T, edges, n, strategy="vertical").run(spec, max_iters=20, tol=0.0)
    eng = _eng(T, edges, n, strategy="vertical")
    partial = eng.run(spec, max_iters=10, tol=0.0, checkpoint_dir=ck, checkpoint_every=5)
    assert partial.iterations == 10
    resumed = eng.run(spec, max_iters=20, tol=0.0, checkpoint_dir=ck, checkpoint_every=5,
                      resume=True)
    assert resumed.iterations == 20
    assert len(resumed.per_iter) == 10
    assert [r["iteration"] for r in resumed.per_iter] == list(range(10, 20))
    np.testing.assert_array_equal(resumed.v, full.v)


def test_checkpoint_resume_converges_to_same_vector(tmp_path):
    """A resumed hybrid run converges to the uninterrupted run's fixed
    point."""
    edges, n = _graph()
    spec = T.pagerank(n)
    ck = str(tmp_path / "ck")
    full = _eng(T, edges, n, strategy="hybrid", theta=4.0).run(spec, max_iters=100, tol=1e-8)
    assert full.converged
    eng = _eng(T, edges, n, strategy="hybrid", theta=4.0)
    eng.run(spec, max_iters=7, tol=0.0, checkpoint_dir=ck, checkpoint_every=7)
    resumed = eng.run(spec, max_iters=100, tol=1e-8, checkpoint_dir=ck, checkpoint_every=7,
                      resume=True)
    assert resumed.converged
    np.testing.assert_allclose(resumed.v, full.v, atol=1e-7)


def test_checkpoint_save_is_atomic_commit(tmp_path):
    """A crash mid-save leaves the old or the new complete state: a stale
    truncated temp file never shadows the live checkpoint."""
    ck = str(tmp_path / "ck")
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    _ckpt_save(ck, v, 7)
    with open(tmp_path / "ck" / "pmv_state.tmp.npz", "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    v_loaded, it = _ckpt_load(ck)
    np.testing.assert_array_equal(v_loaded, v)
    assert it == 7


def test_truncated_checkpoint_resume_restarts_clean(tmp_path):
    """A truncated state file is detected: the resumed run warns and restarts
    from the start vector, landing bitwise on the uninterrupted result."""
    edges, n = _graph()
    spec = T.pagerank(n)
    ck = str(tmp_path / "ck")
    eng = _eng(T, edges, n, strategy="vertical")
    full = eng.run(spec, max_iters=12, tol=0.0)
    eng.run(spec, max_iters=6, tol=0.0, checkpoint_dir=ck, checkpoint_every=3)
    path = _ckpt_path(ck)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.warns(CheckpointCorruptWarning, match="corrupt checkpoint"):
        resumed = eng.run(spec, max_iters=12, tol=0.0, checkpoint_dir=ck, checkpoint_every=3,
                          resume=True)
    assert len(resumed.per_iter) == 12
    np.testing.assert_array_equal(resumed.v, full.v)


@pytest.mark.parametrize("writer,reader", [(T, J), (J, T)], ids=["port-to-jax", "jax-to-port"])
@pytest.mark.parametrize("algo", ["pagerank", "sssp"])
def test_checkpoint_resumes_across_packages(writer, reader, algo, tmp_path):
    """A checkpoint written by one package resumes in the other: the file
    holds the blocked [b, n_local] iterate in the spec dtype and the
    iteration, and the resumed run lands on the reader's uninterrupted
    answer (SSSP exactly, PageRank within rtol 1e-5)."""
    edges, n = _graph()
    mk = (lambda M: M.pagerank(n)) if algo == "pagerank" else (lambda M: M.sssp(0))
    ck = str(tmp_path / "ck")
    _eng(writer, edges, n, strategy="vertical").run(
        mk(writer), max_iters=4, tol=0.0, checkpoint_dir=ck, checkpoint_every=2)
    v, it = _ckpt_load(ck)
    assert it == 4 and v.shape == (4, 24) and v.dtype == np.float32
    resumed = _eng(reader, edges, n, strategy="vertical").run(
        mk(reader), max_iters=9, tol=0.0, checkpoint_dir=ck, checkpoint_every=2, resume=True)
    full = _eng(reader, edges, n, strategy="vertical").run(mk(reader), max_iters=9, tol=0.0)
    assert resumed.iterations == 9 and len(resumed.per_iter) == 5
    if algo == "pagerank":
        np.testing.assert_allclose(resumed.v, full.v, rtol=1e-5, atol=1e-9)
    else:
        np.testing.assert_array_equal(resumed.v, full.v)
    assert _ckpt_load(ck)[1] == 8


def test_resume_wins_over_v0(tmp_path):
    """``v0`` (the port's parity hook) and ``resume`` do not combine: a
    checkpoint that resume loads wins, and v0 starts only a solve that finds
    none."""
    edges, n = _graph()
    spec = T.sssp(0)
    ck = str(tmp_path / "ck")
    eng = _eng(T, edges, n, strategy="vertical")
    v0 = np.full(n, np.inf, np.float32)
    v0[5] = 0.0
    from_5 = eng.run(spec, max_iters=30, tol=0.5, v0=v0)
    eng.run(spec, max_iters=2, tol=0.0, checkpoint_dir=ck, checkpoint_every=1)
    resumed = eng.run(spec, max_iters=30, tol=0.5, checkpoint_dir=ck, resume=True, v0=v0)
    np.testing.assert_array_equal(resumed.v, eng.run(spec, max_iters=30, tol=0.5).v)
    assert resumed.per_iter[0]["iteration"] == 2
    none_yet = eng.run(spec, max_iters=30, tol=0.5, checkpoint_dir=str(tmp_path / "empty"),
                       resume=True, v0=v0)
    np.testing.assert_array_equal(none_yet.v, from_5.v)


def test_kill_between_checkpoints_on_a_resident_engine(tmp_path):
    """``faults=`` on a resident engine: a KillAtIteration stops the run at
    the boundary, the resume on the same engine (the kill consumed) is
    bitwise the uninterrupted run, and the JAX package's does the same."""
    edges, n = _graph()
    for mod, F in ((T, TF), (J, JF)):
        spec = mod.sssp(0)
        full = _eng(mod, edges, n, strategy="hybrid", theta=4.0).run(spec, max_iters=30, tol=0.5)
        eng = _eng(mod, edges, n, strategy="hybrid", theta=4.0, obs=True,
                   faults=F.FaultPlan(events=(F.KillAtIteration(iteration=2),)))
        ck = str(tmp_path / mod.__name__)
        with pytest.raises(F.InjectedKill):
            eng.run(spec, max_iters=30, tol=0.5, checkpoint_dir=ck, checkpoint_every=1)
        assert _ckpt_load(ck)[1] == 2
        resumed = eng.run(spec, max_iters=30, tol=0.5, checkpoint_dir=ck, checkpoint_every=1,
                          resume=True)
        np.testing.assert_array_equal(resumed.v, full.v)
        assert resumed.iterations == full.iterations
        assert eng.obs.counter("fault.injected.kill").value == 1


@pytest.mark.parametrize("delta", [False, True])
def test_delta_state_restarts_at_identity_on_resume(delta, tmp_path):
    """As in the JAX package, the delta-iteration state is not checkpointed:
    a resumed packed run restarts it at the identity, so its first resumed
    iteration re-sends every moved row.  Its per-iteration sent rows equal
    the JAX package's resumed run's, and its answer lies within rtol 1e-5
    of it."""
    edges, n = _graph()
    kw = dict(strategy="vertical", exchange="packed", delta_eps=0.0 if delta else None)
    out = {}
    for mod in (T, J):
        ck = str(tmp_path / mod.__name__)
        spec = mod.pagerank(n)
        eng = _eng(mod, edges, n, **kw)
        eng.run(spec, max_iters=5, tol=0.0, checkpoint_dir=ck, checkpoint_every=5)
        out[mod] = eng.run(spec, max_iters=10, tol=0.0, checkpoint_dir=ck, resume=True)
    key = "delta_sent_rows" if delta else "exchange_payload_bytes"
    assert [r[key] for r in out[T].per_iter] == [float(r[key]) for r in out[J].per_iter]
    np.testing.assert_allclose(out[T].v, out[J].v, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# The bfloat16 wire.

@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
def test_payload_dtype_threaded_and_close_to_f32(strategy):
    """payload_dtype='bfloat16' reaches the step config, moves the answer
    (bf16 really is on the wire) within 5e-3 of the float32 wire's, and
    lies within rtol 1e-5 of the JAX package's bf16 run."""
    edges, n = _graph()
    eng16 = _eng(T, edges, n, strategy=strategy, theta=4.0, payload_dtype="bfloat16")
    spec = T.pagerank(n)
    assert eng16.prepare(spec)[-1]["cfg"].payload_dtype == "bfloat16"
    r16 = eng16.run(spec, max_iters=15, tol=0.0)
    r32 = _eng(T, edges, n, strategy=strategy, theta=4.0).run(T.pagerank(n), max_iters=15,
                                                               tol=0.0)
    np.testing.assert_allclose(r16.v, r32.v, atol=5e-3)
    assert np.abs(r16.v - r32.v).max() > 0
    ref = _eng(J, edges, n, strategy=strategy, theta=4.0, payload_dtype="bfloat16").run(
        J.pagerank(n), max_iters=15, tol=0.0)
    np.testing.assert_allclose(r16.v, ref.v, rtol=1e-5, atol=1e-8)


BF16_CASES = [
    ("sssp", dict(strategy="vertical")),
    ("sssp", dict(strategy="vertical", exchange="packed")),
    ("sssp", dict(strategy="vertical", backend="auto", scatter="kernel", stream="on")),
    ("sssp", dict(strategy="hybrid", theta=4.0, backend="auto")),
    ("cc", dict(strategy="vertical")),
    ("cc", dict(strategy="hybrid", theta=4.0, exchange="packed")),
    ("rwr", dict(strategy="vertical", backend="auto")),
    ("pagerank", dict(strategy="vertical", exchange="packed", delta_eps=0.0)),
]


@pytest.mark.parametrize("algo,kw", BF16_CASES,
                         ids=[f"{a}-{i}" for i, (a, _) in enumerate(BF16_CASES)])
def test_bf16_wire_matches_reference(algo, kw):
    """The bf16 wire against the JAX package's on the sparse and packed
    exchanges, resident vertical and hybrid, plain and planned backends:
    the selection semirings (SSSP, CC on int32 labels) equal element for
    element, PageRank / RWR within rtol 1e-5; equal per-iteration payload
    bytes and delta rows, the payload half the float32 wire's."""
    edges, n = _graph()
    sym = algo == "cc"
    mk = {"sssp": lambda M: M.sssp(0), "cc": lambda M: M.connected_components(),
          "pagerank": lambda M: M.pagerank(n),
          "rwr": lambda M: M.random_walk_with_restart(n, 3)}[algo]
    ctx = (lambda M: M.rwr_context(n, 3)) if algo == "rwr" else (lambda M: None)
    ref_kw = dict(kw, backend="auto" if kw.get("backend") == "auto" else "xla")
    res = {}
    for mod, knobs in ((T, kw), (J, ref_kw)):
        res[mod] = _eng(mod, edges, n, symmetrize=sym, payload_dtype="bfloat16", **knobs).run(
            mk(mod), ctx(mod), max_iters=12, tol=0.0)
    r32 = _eng(T, edges, n, symmetrize=sym, **kw).run(mk(T), ctx(T), max_iters=12, tol=0.0)
    if algo in ("sssp", "cc"):
        np.testing.assert_array_equal(res[T].v, res[J].v)
    else:
        np.testing.assert_allclose(res[T].v, res[J].v, rtol=1e-5, atol=1e-8)
    assert res[T].iterations == res[J].iterations
    for key in ("exchange_payload_bytes", "delta_sent_rows"):
        if key in res[T].per_iter[0]:
            assert [r[key] for r in res[T].per_iter] == \
                [float(r[key]) for r in res[J].per_iter], key
    if "delta_sent_rows" not in res[T].per_iter[0]:
        assert res[T].per_iter[0]["exchange_payload_bytes"] * 2 == \
            r32.per_iter[0]["exchange_payload_bytes"]
        if "exchange_id_bytes" in r32.per_iter[0]:
            assert res[T].per_iter[0]["exchange_id_bytes"] == r32.per_iter[0]["exchange_id_bytes"]


def test_bf16_wire_gates_delta_and_prices_auto():
    """The delta state takes the wire dtype; 'auto' weighs the exchanges at
    the wire itemsize, and resolves as the JAX package does."""
    edges, n = _graph()
    for mod in (T, J):
        eng = _eng(mod, edges, n, strategy="vertical", exchange="auto",
                   payload_dtype="bfloat16", delta_eps=0.0)
        meta = eng.prepare(mod.pagerank(n))[-1]
        if mod is T:
            got = (meta["exchange"], meta["exchange_decision"], meta["delta_reason"])
        else:
            assert got == (meta["exchange"], meta["exchange_decision"], meta["delta_reason"])
    text = _eng(T, edges, n, strategy="vertical", payload_dtype="bfloat16").explain(
        T.pagerank(n))
    ref = _eng(J, edges, n, strategy="vertical", payload_dtype="bfloat16").explain(
        J.pagerank(n))
    pick = [ln for ln in text.splitlines() if "bytes" in ln and "iter" in ln]
    assert pick and pick == [ln for ln in ref.splitlines() if "bytes" in ln and "iter" in ln]


# ---------------------------------------------------------------------------
# capacity='model' and the overflow fallback.

@pytest.mark.parametrize("strategy,label", [("vertical", "dense"),
                                            ("hybrid", "structural_capacity")])
@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_overflow_falls_back(strategy, label, backend):
    """A too-tight model capacity overflows; the engine retries once with an
    overflow-free configuration instead of raising, as the JAX package
    does (the same label, counters, and answer within rtol 1e-5)."""
    n = 64
    edges = star_graph(n)   # hub 0 -> all: the partials are maximally dense
    out = {}
    for mod in (T, J):
        bk = {"torch": "xla"}.get(backend, backend) if mod is J else backend
        eng = _eng(mod, edges, n, strategy=strategy, theta=1e9, capacity="model", slack=0.01,
                   backend=bk, obs=True)
        out[mod] = eng.run(mod.pagerank(n), max_iters=10, tol=0.0)
        assert out[mod].totals["fallback"] == label
        assert eng.obs.counter(f"pmv.fallback_events.{label}").value == 1
        assert eng.obs.counter("pmv.fallbacks").value == 1
    ref = _eng(T, edges, n, strategy=strategy, theta=1e9, backend=backend).run(
        T.pagerank(n), max_iters=10, tol=0.0)
    np.testing.assert_allclose(out[T].v, ref.v, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(out[T].v, out[J].v, rtol=1e-5, atol=1e-9)


def test_overflow_without_fallback_still_raises():
    n = 64
    eng = _eng(T, star_graph(n), n, strategy="vertical", capacity="model", slack=0.01)
    with pytest.raises(RuntimeError, match="overflow"):
        eng.run(T.pagerank(n), max_iters=10, tol=0.0, _allow_fallback=False)
    assert _eng(T, star_graph(n), n, strategy="vertical", exchange="dense",
                capacity="model").fallback_overrides("vertical") is None


def test_model_capacity_matches_reference_and_streams_alike():
    """capacity='model' sizes the compact exchange from the cost model as the
    JAX package does, and stream='auto' resolves on that capacity as it
    does; the streamed compaction counts overflow, so a forced stream='on'
    that overflows falls back too."""
    edges = erdos_renyi(1024, 1500, seed=3)
    for slack in (0.05, 1.5, 4.0):
        kw = dict(strategy="vertical", backend="auto", capacity="model", slack=slack)
        meta_t = _eng(T, edges, 1024, b=8, **kw).prepare(T.sssp(0))[-1]
        meta_j = _eng(J, edges, 1024, b=8, **kw).prepare(J.sssp(0))[-1]
        assert meta_t["capacity"] == meta_j["capacity"]
        assert meta_t["plan"].stream == meta_j["cfg"].stream
    n = 64
    out = {}
    for mod in (T, J):
        eng = _eng(mod, star_graph(n), n, strategy="vertical", backend="auto", stream="on",
                   capacity="model", slack=0.01)
        spec = mod.sssp(0)
        meta = eng.prepare(spec)[-1]
        assert (meta["cfg"].stream if mod is J else meta["plan"].stream) == "on"
        out[mod] = eng.run(spec, max_iters=10, tol=0.5)
        assert out[mod].totals["fallback"] == "dense"
    np.testing.assert_array_equal(out[T].v, out[J].v)


@pytest.mark.parametrize("strategy,label", [("vertical", "dense"),
                                            ("hybrid", "structural_capacity")])
def test_served_overflow_requeues(strategy, label):
    """A served batch that overflows a model capacity is discarded, the
    family rebuilt on the fallback and the queries requeued under their
    qids: the JAX server's fallback_events and requeued counts, and the
    answers of a structural server."""
    n = 64
    edges = star_graph(n)
    st = {}
    for mod, qmod in ((T, TS), (J, JS)):
        kw = dict(b=4, strategy=strategy, theta=1e9, capacity="model", slack=0.01, obs=True)
        if mod is T:
            kw["device"] = "cpu"
        srv = qmod.PMVServer(edges, n, **kw)
        qs = [qmod.Query("sssp", source=0, tol=0.5), qmod.Query("sssp", source=0, tol=0.5),
              qmod.Query("rwr", source=0, c=0.85, tol=1e-6)]
        res = srv.serve(qs)
        assert [r.reason for r in res] == ["completed"] * 3
        assert [r.qid for r in res] == [0, 1, 2]
        st[mod] = (srv.stats(), res, srv.obs.counter("serve.fallbacks").value)
    (s_t, r_t, c_t), (s_j, r_j, c_j) = st[T], st[J]
    assert s_t["fallback_events"] == s_j["fallback_events"] and label in s_t["fallback_events"]
    assert (s_t["requeued"], s_t["overflow_fallbacks"], c_t) == \
        (s_j["requeued"], s_j["overflow_fallbacks"], c_j)
    want = TS.PMVServer(edges, n, b=4, strategy=strategy, theta=1e9, device="cpu").serve(
        [TS.Query("sssp", source=0, tol=0.5), TS.Query("rwr", source=0, c=0.85, tol=1e-6)])
    np.testing.assert_array_equal(r_t[0].vector, want[0].vector)
    np.testing.assert_allclose(r_t[2].vector, want[1].vector, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(r_t[0].vector, r_j[0].vector)


def test_prepare_is_cached_per_spec():
    edges, n = _graph()
    spec = T.pagerank(n)
    eng = _eng(T, edges, n, strategy="vertical")
    m1, *_ = eng.prepare(spec)
    m2, *_ = eng.prepare(spec)
    assert m1 is m2
    assert eng.prepare(T.pagerank(n))[0] is not m1


def test_no_warning_without_checkpoint(tmp_path):
    """resume=True against an empty directory starts fresh without a
    warning; checkpoint_every=0 writes nothing."""
    edges, n = _graph()
    eng = _eng(T, edges, n, strategy="vertical")
    ck = tmp_path / "ck"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = eng.run(T.sssp(0), max_iters=5, tol=0.0, checkpoint_dir=str(ck), resume=True)
    assert len(res.per_iter) == 5 and not ck.exists()
