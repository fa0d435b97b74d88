"""The port's fault-tolerance layer (``repro_torch.faults``, ``faults=`` on the
engine, the server and the disk store) on the CPU, held against the JAX
package's on the same graph and store (n = 256, b = 8).

The contract, as in the JAX package: a run under a recoverable seeded plan
(a corrupt shard slice caught by the checksums, transient I/O errors
absorbed by the retry policy, a straggler, a dead prefetch thread, a kill
between checkpoints resumed on the same engine) is bitwise the fault-free
run; every fault shows in the obs counters, and those counters equal the
JAX package's under the same plan.  Both injectors flip the same byte for
the same plan and seed.  Plus the disk overflow retry (``capacity='model'``)
and the serving tier's failed batch and chaos serve."""
import numpy as np
import pytest

import repro.core as J
import repro.faults as JF
import repro.serving as JS
import repro_torch.core as T
import repro_torch.faults as TF
import repro_torch.serving as TS
from repro.graph.generators import rmat, star_graph
from repro_torch.store import DiskBlockStore, ShardCorruptError, ingest_edges, open_store
from repro_torch.store import format as fmt

N, B = 256, 8
THETA = 4.0

# fast retry policies: the full budget, negligible wall time
FAST = {mod: F.RetryPolicy(max_attempts=3, base_delay_s=1e-4, max_delay_s=1e-3)
        for mod, F in ((T, TF), (J, JF))}
FAULTS = {T: TF, J: JF}


@pytest.fixture(scope="module")
def graph():
    return rmat(8, 2500, seed=17)


@pytest.fixture(scope="module")
def stores(graph, tmp_path_factory):
    """Port-written stores that both packages read: plain and symmetrized
    (with the θ-split shards, so the hybrid runs from them too)."""
    out = {}
    for sym in (False, True):
        root = str(tmp_path_factory.mktemp(f"faults_sym{int(sym)}") / "s")
        ingest_edges(graph, N, B, root, chunk_edges=333, symmetrize=sym, theta=THETA)
        out[sym] = root
    return out


def _counters(rec) -> dict:
    """The fault counters and the store's integrity counters of a run."""
    return {d["name"]: d["value"] for d in rec.metrics.to_dicts()
            if d["name"].startswith("fault.")
            or d["name"] in ("store.verify_failures", "store.prefetch_degraded")}


def _engine(mod, root, sym=False, **kw):
    extra = {"device": "cpu"} if mod is T else {}
    return mod.PMVEngine(None, store=root, residency="disk", symmetrize=sym, **kw, **extra)


ALGOS = {"pagerank": (lambda M: M.pagerank(N), False),
         "sssp": (lambda M: M.sssp(0), False),
         "cc": (lambda M: M.connected_components(), True)}


def _chaos(mod, root, mk, sym, ck, strategy, events, iters=8):
    """(fault-free run, the run resumed after the plan's kill, its engine)."""
    F = FAULTS[mod]
    clean = _engine(mod, root, sym, strategy=strategy, theta=THETA).run(
        mk(mod), max_iters=iters, tol=0.0)
    plan = F.FaultPlan(events=events(F), seed=11)
    eng = _engine(mod, root, sym, strategy=strategy, theta=THETA, faults=plan,
                  io_retry=FAST[mod], obs=True)
    with pytest.raises(F.InjectedKill):
        eng.run(mk(mod), max_iters=iters, tol=0.0, checkpoint_dir=ck, checkpoint_every=1)
    # resume on the SAME engine: the consumed kill stays consumed
    resumed = eng.run(mk(mod), max_iters=iters, tol=0.0, checkpoint_dir=ck,
                      checkpoint_every=1, resume=True)
    return clean, resumed, eng


def _grid_events(F):
    return (F.CorruptFetch(block=2, array="seg"), F.TransientIO(block=3),
            F.TransientIO(block=5), F.KillAtIteration(iteration=4))


CHAOS = [("pagerank", "vertical"), ("sssp", "vertical"), ("cc", "vertical"),
         ("sssp", "hybrid")]


@pytest.mark.parametrize("algo,strategy", CHAOS, ids=["-".join(c) for c in CHAOS])
def test_chaos_recoverable_plan_is_bitwise_identical(algo, strategy, stores, tmp_path):
    """Disk PageRank / SSSP / CC (and the hybrid's two legs on SSSP) under one
    corrupt seg slice, two transient IOErrors and a kill at iteration 4:
    killed, then resumed on the same engine, the answer is bitwise the
    fault-free one with the same iteration count; every event fired, one
    retry and one recovery per fetch fault.  The JAX package under the same
    plan on the same store gives the same counters and the same answer
    (selection semirings exactly, plus_times within rtol 1e-5)."""
    mk, sym = ALGOS[algo]
    root = stores[sym]
    clean, resumed, eng = _chaos(T, root, mk, sym, str(tmp_path / "t"), strategy, _grid_events)
    np.testing.assert_array_equal(resumed.v, clean.v)
    assert resumed.iterations == clean.iterations == 8
    assert len(resumed.per_iter) == 4                   # iterations 4..7 re-ran
    assert eng._fault_injector.remaining == 0
    got = _counters(eng.obs)
    assert got["fault.injected"] == 4 and got["fault.injected.kill"] == 1
    assert got["fault.injected.corrupt_fetch"] == 1 == got["store.verify_failures"]
    assert got["fault.injected.transient_io"] == 2
    assert got["fault.retry"] == got["fault.recovered"] == 3
    assert FAST[T].retry_budget >= 1

    r_clean, r_resumed, ref = _chaos(J, root, mk, sym, str(tmp_path / "j"), strategy,
                                     _grid_events)
    np.testing.assert_array_equal(r_resumed.v, r_clean.v)
    assert _counters(ref.obs) == got
    if algo == "pagerank":
        np.testing.assert_allclose(resumed.v, r_resumed.v, rtol=1e-5, atol=1e-8)
    else:
        np.testing.assert_array_equal(resumed.v, r_resumed.v)


def _full_events(F):
    """Every kind at once: the smoke's chaos plan at this size."""
    return (F.CorruptFetch(block=1, array="seg"), F.CorruptFetch(block=4, array="gat"),
            F.TransientIO(block=6, times=2), F.SlowFetch(block=2, delay_s=0.01),
            F.BreakPrefetch(), F.KillAtIteration(iteration=3))


def test_every_fault_kind_at_once(stores, tmp_path):
    """The smoke's plan (a corrupt seg and a corrupt gat slice, TransientIO
    twice on one block, a slow fetch, a broken prefetch thread, a kill at
    iteration 3) on the disk SSSP: bitwise the clean run after the resume,
    each ``fault.injected.<kind>`` equal to ``plan.counts()``, the prefetch
    degraded once, the corrupt slices caught once each -- and the JAX
    package's counters under the same plan equal the port's."""
    mk, _ = ALGOS["sssp"]
    clean, resumed, eng = _chaos(T, stores[False], mk, False, str(tmp_path / "t"), "vertical",
                                 _full_events)
    np.testing.assert_array_equal(resumed.v, clean.v)
    assert resumed.iterations == clean.iterations
    assert eng._fault_injector.remaining == 0
    got = _counters(eng.obs)
    counts = TF.FaultPlan(events=_full_events(TF)).counts()
    assert counts == {"corrupt_fetch": 2, "transient_io": 2, "slow_fetch": 1,
                      "break_prefetch": 1, "kill": 1}
    assert all(got[f"fault.injected.{k}"] == v for k, v in counts.items())
    assert got["store.verify_failures"] == 2 and got["store.prefetch_degraded"] == 1
    assert got["fault.recovered"] == 3          # two corrupt fetches, one twice-failed block
    assert got["fault.retry"] == 4
    _, r_resumed, ref = _chaos(J, stores[False], mk, False, str(tmp_path / "j"), "vertical",
                               _full_events)
    assert _counters(ref.obs) == got
    np.testing.assert_array_equal(resumed.v, r_resumed.v)


def test_slow_fetch_is_absorbed(stores):
    """A straggler read delays but never corrupts: bitwise the fault-free
    run, the event consumed and counted."""
    plan = TF.FaultPlan(events=(TF.SlowFetch(block=1, delay_s=0.02),), seed=3)
    r0 = _engine(T, stores[False], strategy="vertical").run(T.pagerank(N), max_iters=4, tol=0.0)
    eng = _engine(T, stores[False], strategy="vertical", faults=plan, obs=True)
    r1 = eng.run(T.pagerank(N), max_iters=4, tol=0.0)
    np.testing.assert_array_equal(r0.v, r1.v)
    assert eng._fault_injector.remaining == 0
    assert _counters(eng.obs)["fault.injected.slow_fetch"] == 1
    slow = eng.obs.spans("fault.slow_fetch")
    assert len(slow) == 1 and slow[0]["dur"] >= 0.02


def test_faults_none_keeps_hot_path_clean(graph, stores):
    """faults=None with checksums on: the store verifies (it carries
    digests), injects nothing, and the solve is bitwise the resident one."""
    dstore = DiskBlockStore(open_store(stores[False]), "vertical", T.pagerank(N))
    assert dstore.verify and dstore.faults is None and dstore.fault_scope is None
    e_disk = _engine(T, stores[False], strategy="vertical", obs=True)
    r_disk = e_disk.run(T.pagerank(N), max_iters=6, tol=0.0)
    r_dev = T.PMVEngine(graph, N, b=B, strategy="vertical", device="cpu").run(
        T.pagerank(N), max_iters=6, tol=0.0)
    np.testing.assert_array_equal(r_dev.v, r_disk.v)
    assert e_disk._fault_injector is None
    assert e_disk.obs.counter("fault.injected").value == 0
    assert e_disk.obs.counter("fault.retry").value == 0


def test_random_plan_counts_and_determinism():
    """FaultPlan.random draws the JAX package's events for the same seed;
    as_injector passes None and a shared injector through and refuses
    anything else with a TypeError."""
    kw = dict(blocks=range(B), n_corrupt=1, n_transient=2, n_slow=1, kill_at=3)
    plan = TF.FaultPlan.random(42, **kw)
    assert plan.counts() == {"corrupt_fetch": 1, "transient_io": 2, "slow_fetch": 1,
                             "break_prefetch": 0, "kill": 1}
    assert plan == TF.FaultPlan.random(42, **kw)
    ref = JF.FaultPlan.random(42, **kw)
    assert [(type(e).__name__, vars(e)) for e in plan.events] == \
        [(type(e).__name__, vars(e)) for e in ref.events]
    assert TF.as_injector(None) is None
    inj = plan.build()
    assert TF.as_injector(inj) is inj
    assert isinstance(TF.as_injector(plan), TF.FaultInjector)
    with pytest.raises(TypeError):
        TF.as_injector("chaos")
    with pytest.raises(TypeError):
        TF.FaultPlan(events=("not an event",))
    assert issubclass(TF.InjectedIOError, OSError)
    assert issubclass(TF.InjectedKill, RuntimeError) and not issubclass(TF.InjectedKill, OSError)


@pytest.mark.parametrize("array,occurrence", [("seg", 1), ("gat", 1), ("gat", 2)])
def test_both_injectors_flip_the_same_byte(array, occurrence):
    """For one plan and seed the two injectors flip the same byte of the
    same array on the same fetch attempt ([b_w, e_cap] int32 slices, as
    both stores hand them over), and count the same events."""
    rng = np.random.default_rng(0)
    base = {"seg": rng.integers(0, 1 << 20, (B, 37), dtype=np.int32),
            "gat": rng.integers(0, 1 << 20, (B, 37), dtype=np.int32)}
    got = {}
    for mod, F in ((T, TF), (J, JF)):
        plan = F.FaultPlan(events=(F.CorruptFetch(block=3, array=array, occurrence=occurrence),
                                   F.CorruptFetch(block=5, array="seg")), seed=7)
        inj = plan.build()
        arrays = [{k: a.copy() for k, a in base.items()} for _ in range(3)]
        for attempt in range(3):
            for k in (3, 5):
                inj.on_fetch(k)
                inj.corrupt_slice(k, arrays[attempt] if k == 3 else {"seg": arrays[2]["seg"]})
        got[mod] = (arrays, dict(inj.injected), inj.remaining)
    (a_t, inj_t, rem_t), (a_j, inj_j, rem_j) = got[T], got[J]
    assert inj_t == inj_j and rem_t == rem_j == 0
    for x, y in zip(a_t, a_j):
        for k in base:
            np.testing.assert_array_equal(x[k], y[k])
    flipped = [k for k in base if not np.array_equal(a_t[occurrence - 1][k], base[k])]
    assert array in flipped


def test_store_fetch_names_the_injected_corruption(stores):
    """A CorruptFetch through each package's DiskBlockStore fails the fetch
    with a ShardCorruptError naming the same file, worker and block; the
    re-fetch is clean."""
    from repro.store import DiskBlockStore as JDiskBlockStore

    errs = {}
    for mod, F, cls in ((T, TF, DiskBlockStore), (J, JF, JDiskBlockStore)):
        plan = F.FaultPlan(events=(F.CorruptFetch(block=2, array="gat"),), seed=4)
        dstore = cls(stores[False], "vertical", mod.pagerank(N), faults=plan)
        with pytest.raises(Exception) as ei:
            dstore.fetch(2)
        errs[mod] = ei.value
        dstore.fetch(2)                             # the event is consumed
    assert isinstance(errs[T], ShardCorruptError)
    assert (errs[T].path, errs[T].worker, errs[T].block, errs[T].array) == \
        (errs[J].path, errs[J].worker, errs[J].block, errs[J].array)


# ---------------------------------------------------------------------------
# Prefetch-thread degradation.

def test_break_prefetch_degrades_to_sync(stores):
    """A scheduled BreakPrefetch degrades the next pipeline to synchronous
    fetches: same bits, the downgrade counted once, as in the JAX package;
    the hybrid's second leg keeps its prefetch thread."""
    r0 = _engine(T, stores[True], True, strategy="hybrid", theta=THETA).run(
        T.sssp(0), max_iters=6, tol=0.0)
    got = {}
    for mod, F in ((T, TF), (J, JF)):
        eng = _engine(mod, stores[True], True, strategy="hybrid", theta=THETA,
                      faults=F.FaultPlan(events=(F.BreakPrefetch(),)), obs=True)
        spec = mod.sssp(0)
        res = eng.run(spec, max_iters=6, tol=0.0)
        np.testing.assert_array_equal(res.v, r0.v)
        got[mod] = _counters(eng.obs)
        if mod is T:
            legs = eng.prepare(spec)[-1]["executor"].legs
            assert sorted(leg.store.prefetch_degraded for leg in legs) == [False, True]
    assert got[T] == got[J]
    assert got[T]["store.prefetch_degraded"] == 1 == got[T]["fault.injected.break_prefetch"]


def test_prefetch_thread_failure_degrades_to_sync(stores, monkeypatch):
    """When the prefetch pool cannot take work at all, the executor falls
    back to synchronous fetches -- same bits, no deadlock -- and counts the
    downgrade."""
    from repro_torch.store import residency as res_mod

    r0 = _engine(T, stores[False], strategy="vertical").run(T.pagerank(N), max_iters=4, tol=0.0)

    class BrokenPool:
        def __init__(self, *a, **k):
            pass

        def submit(self, fn, *a, **k):
            raise RuntimeError("cannot schedule new futures")

        def shutdown(self, *a, **k):
            pass

    monkeypatch.setattr(res_mod, "ThreadPoolExecutor", BrokenPool)
    eng = _engine(T, stores[False], strategy="vertical", obs=True)
    r1 = eng.run(T.pagerank(N), max_iters=4, tol=0.0)
    np.testing.assert_array_equal(r0.v, r1.v)
    assert eng.obs.counter("store.prefetch_degraded").value >= 1


# ---------------------------------------------------------------------------
# The disk overflow retry.

@pytest.fixture(scope="module")
def star_store(tmp_path_factory):
    n, b = 64, 4
    root = str(tmp_path_factory.mktemp("star") / "s")
    ingest_edges(star_graph(n), n, b, root)
    return root


def test_disk_overflow_retry_succeeds_and_is_counted(star_store):
    """Disk vertical with a too-tight model capacity: the engine retries once
    with the structural capacity, matches the clean result bitwise, and the
    fallback lands in the counters -- as in the JAX package."""
    n = 64
    out = {}
    for mod in (T, J):
        eng = _engine(mod, star_store, strategy="vertical", capacity="model", slack=0.01,
                      obs=True)
        res = eng.run(mod.pagerank(n), max_iters=6, tol=0.0)
        assert res.totals["fallback"] == "structural_capacity"
        assert eng.obs.counter("pmv.fallbacks").value == 1
        assert eng.obs.counter("pmv.fallback_events.structural_capacity").value == 1
        out[mod] = res
    ref = T.PMVEngine(star_graph(n), n, b=4, strategy="vertical", device="cpu").run(
        T.pagerank(n), max_iters=6, tol=0.0)
    np.testing.assert_array_equal(ref.v, out[T].v)
    np.testing.assert_allclose(out[T].v, out[J].v, rtol=1e-5, atol=1e-8)
    assert out[T].iterations == out[J].iterations


def test_disk_overflow_still_overflowing_raises(star_store):
    """With the fallback disabled (the retry itself runs so) a persistent
    overflow raises; the structural capacity has no fallback."""
    eng = _engine(T, star_store, strategy="vertical", capacity="model", slack=0.01)
    assert eng.prepare(T.pagerank(64))[-1]["capacity"] < open_store(star_store).partial_cap
    with pytest.raises(RuntimeError, match="overflow"):
        eng.run(T.pagerank(64), max_iters=6, tol=0.0, _allow_fallback=False)
    structural = _engine(T, star_store, strategy="vertical", capacity="structural")
    assert structural.fallback_overrides("vertical") is None
    with pytest.raises(ValueError, match="payload_dtype"):
        _engine(T, star_store, strategy="vertical", payload_dtype="bfloat16").run(
            T.pagerank(64), max_iters=2)


# ---------------------------------------------------------------------------
# Serving.

def test_serving_failed_batch_keeps_server_alive(stores):
    """Persistent on-disk corruption fails the batch with the typed diagnosis
    in each result, and once the shard is restored the server answers the
    next query."""
    root = stores[False]
    path = fmt.stripe_path(root, "vertical", 0, "seg")
    mm = np.load(path, mmap_mode="r+")
    mm.view(np.uint8).reshape(-1)[7] ^= 0xFF
    mm.flush()
    try:
        srv = TS.PMVServer(store=root, residency="disk", strategy="vertical",
                           io_retry=TF.RetryPolicy(max_attempts=2, base_delay_s=1e-4),
                           obs=True, device="cpu")
        qid = srv.submit(TS.Query(spec_kind="pagerank", tol=1e-5))
        r = srv.drain()[qid]
        assert r.reason == "failed" and r.vector is None
        assert "checksum mismatch" in r.error
        st = srv.stats()
        assert st["failed_batches"] == 1 and st["retirement_reasons"]["failed"] == 1
        assert srv.obs.counter("serve.failed_batches").value == 1
    finally:
        mm.view(np.uint8).reshape(-1)[7] ^= 0xFF
        mm.flush()
        del mm
    qid2 = srv.submit(TS.Query(spec_kind="pagerank", tol=1e-5))
    r2 = srv.drain()[qid2]
    assert r2.reason == "completed" and r2.vector is not None


@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
def test_serving_chaos_plan_is_transparent(strategy, stores):
    """A recoverable plan behind the serving tier (shared by every family
    engine): answers bitwise the fault-free serve's, every fault absorbed
    below the query API, and the counters the JAX server's under the same
    plan."""
    root = stores[False]
    got = {}
    for mod, qmod, F in ((T, TS, TF), (J, JS, JF)):
        kw = dict(store=root, residency="disk", strategy=strategy, theta=THETA)
        if mod is T:
            kw["device"] = "cpu"
        queries = [qmod.Query(spec_kind="sssp", source=s, tol=0.5) for s in (0, 3, 9)] + \
            [qmod.Query(spec_kind="rwr", source=3, c=0.7, tol=1e-5)]
        r0 = qmod.PMVServer(**kw).serve(queries)
        plan = F.FaultPlan(events=(F.CorruptFetch(block=1, array="gat"),
                                   F.TransientIO(block=2)), seed=9)
        srv = qmod.PMVServer(**kw, faults=plan, io_retry=FAST[mod], obs=True)
        r1 = srv.serve(queries)
        for a, c in zip(r1, r0):
            assert a.reason == "completed"
            np.testing.assert_array_equal(a.vector, c.vector)
            assert a.iterations == c.iterations
        got[mod] = (_counters(srv.obs), r1)
    cnt = got[T][0]
    assert cnt["fault.injected"] == 2 and cnt["fault.recovered"] == 2
    assert cnt == got[J][0]
    for a, c in zip(got[T][1][:3], got[J][1][:3]):
        np.testing.assert_array_equal(a.vector, c.vector)
