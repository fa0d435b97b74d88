"""residency='disk' / 'host' of the PyTorch port on the CPU: the port's disk
engine against the JAX package's on the same store (PageRank, RWR, SSSP,
CC; vertical with the sparse and packed exchanges under the segment and
kernel scatters, horizontal, and the θ-split hybrid from the shards of
``ingest_edges(theta=...)``), and bitwise against the port's own resident
backend='torch' engine; the residency budget (per leg for the hybrid), the
skipped empty blocks, the store_* accounting, the prefetch pipeline's
downgrade, reversed schedules, the hybrid's argument checks, the basic
stripings unchanged by theta=, and 'host' == 'device'.  On the CPU the
kernel scatter runs its plain version.  Small graphs (n = 256, b = 8)."""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.graph import rmat
from repro_torch.core import cost_model
from repro_torch.store import DiskBlockStore, ingest_edges, open_store

N, B = 256, 8
ITERS = 6

# name: (spec maker, ctx maker or None, symmetrized store)
ALGOS = {
    "pagerank": (lambda M: M.pagerank(N), None, False),
    "rwr": (lambda M: M.random_walk_with_restart(N, 3), lambda M: M.rwr_context(N, 3), False),
    "sssp": (lambda M: M.sssp(0), None, False),
    "cc": (lambda M: M.connected_components(), None, True),
}
# (strategy, exchange, scatter)
PLACEMENTS = [("vertical", "sparse", "segment"), ("vertical", "sparse", "kernel"),
              ("vertical", "packed", "segment"), ("vertical", "packed", "kernel"),
              ("horizontal", "sparse", "segment")]


@pytest.fixture(scope="module")
def graph():
    return rmat(8, 2500, seed=17)


@pytest.fixture(scope="module")
def stores(graph, tmp_path_factory):
    """Port-written stores (plain and symmetrized) that both packages read."""
    out = {}
    for sym in (False, True):
        root = str(tmp_path_factory.mktemp(f"store_sym{int(sym)}") / "s")
        ingest_edges(graph, N, B, root, chunk_edges=333, symmetrize=sym)
        out[sym] = root
    return out


def _run(mod, algo, *, iters=ITERS, **kw):
    mk, mk_ctx, _ = ALGOS[algo]
    extra = {} if mod is J else {"device": "cpu"}
    eng = mod.PMVEngine(**kw, **extra)
    return eng.run(mk(mod), None if mk_ctx is None else mk_ctx(mod), max_iters=iters, tol=0.0)


@pytest.mark.parametrize("placement", PLACEMENTS, ids=["-".join(p) for p in PLACEMENTS])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_disk_matches_reference_and_resident(algo, placement, graph, stores):
    """The port's disk engine equals the JAX package's disk engine on the
    same store (selection semirings and int32 labels exactly, plus_times
    within rtol 1e-5) and is bitwise the port's resident backend='torch'
    engine on the edge list."""
    strategy, exchange, scatter = placement
    sym = ALGOS[algo][2]
    kw = dict(strategy=strategy, exchange=exchange, scatter=scatter)
    r_ref = _run(J, algo, edges=None, store=stores[sym], residency="disk", **kw)
    r_disk = _run(T, algo, edges=None, store=stores[sym], residency="disk", **kw)
    r_res = _run(T, algo, edges=graph, n=N, b=B, symmetrize=sym, backend="torch", **kw)
    np.testing.assert_array_equal(r_disk.v, r_res.v)
    assert r_disk.iterations == r_res.iterations == r_ref.iterations == ITERS
    if algo in ("pagerank", "rwr"):
        np.testing.assert_allclose(r_disk.v, r_ref.v, rtol=1e-5, atol=1e-8)
    else:
        np.testing.assert_array_equal(r_disk.v, r_ref.v)
    for key in ("gathered_elems", "exchanged_elems", "exchanged_bytes", "logical_elems",
                "store_bytes_read", "store_blocks_fetched", "store_blocks_skipped"):
        assert r_disk.per_iter[-1].get(key, 0.0) == float(r_ref.per_iter[-1].get(key, 0.0)), key


def _tight_budget(root, spec):
    """The smallest budget the store accepts: two weighted block slices."""
    man = open_store(root)
    return 2 * cost_model.stripe_slice_bytes(B, man.e_cap, has_w=spec.needs_weights)


@pytest.mark.parametrize("algo", ["pagerank", "cc"])
def test_disk_under_budget_and_budget_below_two_slices_raises(algo, graph, stores):
    """Under the tightest budget the store accepts (two block slices, below
    the striping's bytes) the disk solve stays bitwise the resident one and
    its peak resident bytes stay within the budget; one byte less raises,
    at the store and at the engine's prepare."""
    mk, _, sym = ALGOS[algo]
    root = stores[sym]
    spec = mk(T)
    budget = _tight_budget(root, spec)
    eng = T.PMVEngine(None, store=root, residency="disk", strategy="vertical",
                      store_budget_bytes=budget, device="cpu")
    r = eng.run(spec, max_iters=ITERS, tol=0.0)
    ref = _run(T, algo, edges=graph, n=N, b=B, symmetrize=sym, strategy="vertical")
    np.testing.assert_array_equal(r.v, ref.v)
    dstore, *_, meta = eng.prepare(spec)
    assert meta["residency"] == "disk" and dstore is meta["store"]
    assert 0 < dstore.peak_resident_bytes <= budget < dstore.total_bytes
    assert dstore.device_buffer_bytes == 0           # the CPU uses the host arrays in place
    with pytest.raises(ValueError, match="budget"):
        DiskBlockStore(root, "vertical", mk(T), budget_bytes=budget - 1)
    with pytest.raises(ValueError, match="budget"):
        T.PMVEngine(None, store=root, residency="disk", strategy="vertical",
                    store_budget_bytes=budget - 1, device="cpu").prepare(mk(T))


@pytest.mark.parametrize("strategy", ["vertical", "horizontal"])
def test_disk_skips_empty_blocks(strategy, tmp_path):
    """Only blocks with edges are fetched: every destination id in block 0
    (vertical skips 3 of 4 destination blocks), every source id in block 1
    (horizontal skips 3 of 4 source blocks); bitwise the resident solve."""
    n, b = 64, 4
    rng = np.random.default_rng(0)
    ids = rng.integers(0, n, 200)
    fixed = 4 * rng.integers(0, n // 4, 200) + (0 if strategy == "vertical" else 1)
    edges = np.stack([ids, fixed] if strategy == "vertical" else [fixed, ids], axis=1)
    root = str(tmp_path / "s")
    ingest_edges(edges, n, b, root)
    res = T.PMVEngine(None, store=root, residency="disk", strategy=strategy,
                      device="cpu").run(T.pagerank(n), max_iters=3, tol=0.0)
    rec = res.per_iter[-1]
    assert (rec["store_blocks_fetched"], rec["store_blocks_skipped"]) == (1, b - 1)
    ref = T.PMVEngine(edges, n, b=b, strategy=strategy, device="cpu").run(
        T.pagerank(n), max_iters=3, tol=0.0)
    np.testing.assert_array_equal(ref.v, res.v)


def test_store_stats_and_totals(graph, stores):
    """Every disk iteration carries the store_* keys: fetched + skipped = b,
    the bytes read equal the plan's model, overlap within [0, 1]; the
    totals sum them (and a resident run reports them zeroed, overlap 1.0).
    A delta_eps keeps the full stream out of core and says why; the
    horizontal placement resolves 'packed' to 'sparse'."""
    eng = T.PMVEngine(None, store=stores[False], residency="disk", strategy="vertical",
                      exchange="packed", delta_eps=0.0, device="cpu")
    spec = T.pagerank(N)
    res = eng.run(spec, max_iters=4, tol=0.0)
    meta = eng.prepare(spec)[-1]
    assert meta["delta_eps"] is None
    assert meta["delta_reason"] == "residency='disk' keeps the full stream"
    assert meta["exchange"] == "packed" and meta["backend"] == "torch"
    assert meta["plan"].residency == "disk" and meta["prepare_s"] > 0
    keys = ("store_bytes_read", "store_blocks_fetched", "store_blocks_skipped", "store_io_s",
            "store_wait_s", "store_compute_s", "store_overlap", "store_read_s",
            "store_verify_s", "store_weights_s", "store_h2d_s")
    for rec in res.per_iter:
        assert set(keys) <= set(rec)
        assert rec["store_blocks_fetched"] + rec["store_blocks_skipped"] == B
        assert rec["store_bytes_read"] == meta["plan"].io_bytes_per_iter() > 0
        assert 0.0 <= rec["store_overlap"] <= 1.0
        assert rec["store_io_s"] > 0 and rec["store_wait_s"] >= 0 and rec["store_compute_s"] > 0
        assert 0 < rec["store_read_s"] + rec["store_verify_s"] + rec["store_weights_s"] \
            <= rec["store_io_s"]
        assert rec["store_h2d_s"] == 0.0               # the CPU copies nothing
        assert "delta_sent_rows" not in rec
    assert res.totals["store_bytes_read"] == sum(r["store_bytes_read"] for r in res.per_iter)
    resident = T.PMVEngine(graph, N, b=B, strategy="vertical", device="cpu").run(
        T.pagerank(N), max_iters=2, tol=0.0)
    assert resident.totals["store_bytes_read"] == 0.0
    assert resident.totals["store_overlap"] == 1.0
    hmeta = T.PMVEngine(None, store=stores[False], residency="disk", strategy="horizontal",
                        exchange="packed", device="cpu").prepare(T.pagerank(N))[-1]
    assert (hmeta["exchange"], hmeta["exchange_decision"]) == ("sparse", "n/a")


@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("strategy", ["vertical", "horizontal", "hybrid"])
def test_host_residency_equals_device(strategy, backend, graph, stores):
    """from_store (residency='host' by default) and residency='device' load
    the store back and solve bitwise as the engine on the edge list."""
    kw = dict(strategy=strategy, theta=4.0, backend=backend, stream="off", device="cpu")
    spec = T.sssp(0)
    host = T.PMVEngine.from_store(stores[False], **kw)
    assert host.residency == "host"
    r_host = host.run(spec, max_iters=ITERS, tol=0.0)
    r_dev = T.PMVEngine(None, store=stores[False], residency="device", **kw).run(
        spec, max_iters=ITERS, tol=0.0)
    r_edges = T.PMVEngine(graph, N, b=B, **kw).run(spec, max_iters=ITERS, tol=0.0)
    np.testing.assert_array_equal(r_host.v, r_dev.v)
    np.testing.assert_array_equal(r_host.v, r_edges.v)
    assert host.prepare(spec)[-1]["residency"] == "host"


def test_prefetch_degrades_to_synchronous_fetches(stores):
    """A prefetch pool that refuses work downgrades the pipeline to inline
    fetches (prefetch_degraded), and the solve carries on with the same
    bits; reversing the launch schedule changes no bit either."""
    spec = T.pagerank(N)
    want = T.PMVEngine(None, store=stores[False], residency="disk", strategy="vertical",
                       device="cpu").run(spec, max_iters=ITERS, tol=0.0)
    eng = T.PMVEngine(None, store=stores[False], residency="disk", strategy="vertical",
                      device="cpu")
    first = eng.run(spec, max_iters=ITERS, tol=0.0)
    ex = eng.prepare(spec)[-1]["executor"]
    assert not ex.store.prefetch_degraded
    ex.legs[0].pipeline._ex.shutdown(wait=True)
    second = eng.run(spec, max_iters=ITERS, tol=0.0)
    assert ex.store.prefetch_degraded
    np.testing.assert_array_equal(first.v, want.v)
    np.testing.assert_array_equal(second.v, want.v)
    assert second.per_iter[-1]["store_blocks_fetched"] == want.per_iter[-1]["store_blocks_fetched"]
    ex.close()
    for strategy in ("vertical", "horizontal"):
        eng = T.PMVEngine(None, store=stores[False], residency="disk", strategy=strategy,
                          device="cpu")
        ex = eng.prepare(spec)[-1]["executor"]
        leg = ex.legs[0]
        leg.schedule = list(reversed(leg.schedule))
        rev = eng.run(spec, max_iters=ITERS, tol=0.0)
        base = T.PMVEngine(None, store=stores[False], residency="disk", strategy=strategy,
                           device="cpu").run(spec, max_iters=ITERS, tol=0.0)
        np.testing.assert_array_equal(rev.v, base.v)


def test_store_argument_checks(graph, stores):
    """The JAX package's argument checks: a store excludes edges and
    base_weights, n / b / psi must match it, symmetrize needs a symmetrized
    store, a residency other than 'device' needs a store, the dense
    exchange does not stream out of core."""
    root = stores[False]
    with pytest.raises(ValueError, match="either edges or store"):
        T.PMVEngine(graph, store=root, device="cpu")
    for kw, msg in ((dict(n=7), "n=7"), (dict(b=3), "b=3"), (dict(psi="range"), "psi"),
                    (dict(symmetrize=True), "symmetrize"),
                    (dict(base_weights=np.ones(3)), "base_weights")):
        with pytest.raises(ValueError, match=msg):
            T.PMVEngine(None, store=root, device="cpu", **kw)
    with pytest.raises(ValueError, match="needs store"):
        T.PMVEngine(graph, N, b=B, residency="disk", device="cpu")
    with pytest.raises(ValueError, match="residency"):
        T.PMVEngine(None, store=root, residency="ssd", device="cpu")
    with pytest.raises(ValueError, match="exchange"):
        T.PMVEngine(None, store=root, residency="disk", strategy="vertical", exchange="dense",
                    device="cpu").prepare(T.pagerank(N))


# ---------------------------------------------------------------------------
# strategy='hybrid' out of core: the θ-split shards of ingest_edges(theta=...)
# ---------------------------------------------------------------------------

THETA = 4.0


@pytest.fixture(scope="module")
def hybrid_stores(graph, tmp_path_factory):
    """Port-written θ-split stores (plain and symmetrized)."""
    out = {}
    for sym in (False, True):
        root = str(tmp_path_factory.mktemp(f"hybrid_sym{int(sym)}") / "s")
        ingest_edges(graph, N, B, root, chunk_edges=333, symmetrize=sym, theta=THETA)
        out[sym] = root
    return out


def _hybrid_disk(mod, algo, root, **kw):
    return _run(mod, algo, edges=None, store=root, residency="disk", strategy="hybrid",
                theta=THETA, **kw)


@pytest.mark.parametrize("scatter", ["segment", "kernel"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_hybrid_disk_matches_reference_and_resident(algo, scatter, graph, hybrid_stores):
    """The port's hybrid disk engine equals the JAX package's on the same
    store (selection semirings and int32 labels exactly, plus_times within
    rtol 1e-5), is bitwise the port's resident hybrid backend='torch'
    engine, reports the same per-iteration stats, and accounts both
    stripings' blocks: fetched + skipped = 2 b."""
    sym = ALGOS[algo][2]
    r_ref = _hybrid_disk(J, algo, hybrid_stores[sym], scatter=scatter)
    r_disk = _hybrid_disk(T, algo, hybrid_stores[sym], scatter=scatter)
    r_res = _run(T, algo, edges=graph, n=N, b=B, symmetrize=sym, strategy="hybrid",
                 theta=THETA, backend="torch", scatter=scatter)
    np.testing.assert_array_equal(r_disk.v, r_res.v)
    assert r_disk.iterations == r_res.iterations == r_ref.iterations == ITERS
    if algo in ("pagerank", "rwr"):
        np.testing.assert_allclose(r_disk.v, r_ref.v, rtol=1e-5, atol=1e-8)
    else:
        np.testing.assert_array_equal(r_disk.v, r_ref.v)
    for rec, ref in zip(r_disk.per_iter, r_ref.per_iter):
        for key in ("gathered_elems", "exchanged_elems", "gathered_bytes", "exchanged_bytes",
                    "exchange_id_bytes", "exchange_payload_bytes", "logical_elems",
                    "store_bytes_read", "store_blocks_fetched", "store_blocks_skipped"):
            assert rec[key] == float(ref[key]), key
        assert rec["store_blocks_fetched"] + rec["store_blocks_skipped"] == 2 * B
        assert rec["store_bytes_read"] > 0 and rec["overflow"] == 0.0
    assert r_disk.totals["physical_elems"] == float(r_ref.totals["physical_elems"])


@pytest.mark.parametrize("algo", ["pagerank", "sssp"])
def test_hybrid_disk_schedules_and_prefetch_change_no_bit(algo, hybrid_stores):
    """Reversed or rotated schedules of both legs change no bit
    (both legs key their blocks by index and fold in block order; a
    rotation also catches a fold in arrival order, which a reversal of a
    full power-of-two tree would not), and neither does a dense-leg
    prefetch pool that refuses work (the leg degrades to inline fetches,
    the sparse leg keeps its thread)."""
    mk = ALGOS[algo][0]
    base = _hybrid_disk(T, algo, hybrid_stores[False])
    spec = mk(T)
    for order in (lambda s: s[::-1], lambda s: s[1:] + s[:1]):
        eng = T.PMVEngine(None, store=hybrid_stores[False], residency="disk",
                          strategy="hybrid", theta=THETA, device="cpu")
        ex = eng.prepare(spec)[-1]["executor"]
        sparse, dense = ex.legs
        assert len(sparse.schedule) > 1 and len(dense.schedule) > 1
        sparse.schedule = order(sparse.schedule)
        dense.schedule = order(dense.schedule)
        np.testing.assert_array_equal(eng.run(spec, max_iters=ITERS, tol=0.0).v, base.v)
    dense.pipeline._ex.shutdown(wait=True)
    again = eng.run(spec, max_iters=ITERS, tol=0.0)
    assert dense.store.prefetch_degraded and not sparse.store.prefetch_degraded
    np.testing.assert_array_equal(again.v, base.v)
    ex.close()
    assert sparse.pipeline is None and dense.pipeline is None


def test_hybrid_disk_meta_budget_and_legs(graph, hybrid_stores):
    """meta carries the JAX package's keys (the sparse leg's store; no plan),
    every iteration the store_* keys summed over both legs; under the
    tightest budget both legs accept (two weighted slices of the larger
    leg) each leg's peak resident bytes stay within it, the answer stays
    bitwise the resident one, and one byte below a leg's double buffer
    raises at prepare."""
    root = hybrid_stores[False]
    man = open_store(root)
    legs = {s: 2 * cost_model.stripe_slice_bytes(B, man.e_cap_of(s), has_w=True)
            for s in ("sparse_vertical", "dense_horizontal")}
    budget = max(legs.values())
    spec = T.pagerank(N)
    eng = T.PMVEngine(None, store=root, residency="disk", strategy="hybrid", theta=THETA,
                      store_budget_bytes=budget, delta_eps=0.0, device="cpu")
    res = eng.run(spec, max_iters=ITERS, tol=0.0)
    ref = _run(T, "pagerank", edges=graph, n=N, b=B, strategy="hybrid", theta=THETA)
    np.testing.assert_array_equal(res.v, ref.v)
    dstore, *_, meta = eng.prepare(spec)
    ex = meta["executor"]
    stores = [leg.store for leg in ex.legs]
    assert dstore is meta["store"] is stores[0] and meta["plan"] is None
    # each leg's run totals split the run's summed bytes
    assert sum(leg.run_stats().bytes_read for leg in ex.legs) == res.totals["store_bytes_read"]
    assert all(leg.run_stats().io_s > 0 for leg in ex.legs)
    assert (meta["strategy"], meta["theta"], meta["backend"], meta["residency"]) == \
        ("hybrid", THETA, "torch", "disk")
    assert meta["capacity"] == man.hybrid["sparse_partial_cap"]
    assert meta["n_dense"] == man.dense_region()[0].d_count.sum() > 0
    assert (meta["exchange"], meta["delta_eps"]) == ("sparse", None)
    assert meta["delta_reason"] == "residency='disk' keeps the full stream"
    assert meta["exchange_decision"] == "hybrid disk: compact sparse-region stream"
    for st in stores:
        assert 0 < st.peak_resident_bytes <= budget
        assert st.device_buffer_bytes == 0
    assert [st.striping for st in stores] == ["sparse_vertical", "dense_horizontal"]
    for rec in res.per_iter:
        assert rec["store_io_s"] > 0 and 0.0 <= rec["store_overlap"] <= 1.0
        assert rec["store_compute_s"] > 0 and rec["store_h2d_s"] == 0.0
    bytes_per_iter = {rec["store_bytes_read"] for rec in res.per_iter}
    assert len(bytes_per_iter) == 1
    with pytest.raises(ValueError, match="budget"):
        T.PMVEngine(None, store=root, residency="disk", strategy="hybrid", theta=THETA,
                    store_budget_bytes=budget - 1, device="cpu").prepare(T.pagerank(N))
    gather_idx = man.dense_region()[0].gather_idx
    for striping, need in legs.items():
        with pytest.raises(ValueError, match="budget"):
            DiskBlockStore(root, striping, spec, budget_bytes=need - 1,
                           dense_gather_idx=gather_idx)
    with pytest.raises(ValueError, match="dense_gather_idx"):
        DiskBlockStore(root, "dense_horizontal", spec)


@pytest.mark.parametrize("case", ["theta-less store", "theta mismatch", "exchange packed",
                                  "exchange dense"])
def test_hybrid_disk_argument_errors(case, stores, hybrid_stores):
    """As in the JAX package: a store without θ-split shards names the
    re-ingest, a θ other than the store's does not match, and the hybrid
    disk path streams only the compact sparse exchange."""
    root, kw, msg = {
        "theta-less store": (stores[False], dict(theta=THETA), "re-ingest"),
        "theta mismatch": (hybrid_stores[False], dict(theta=9.0), "does not match"),
        "exchange packed": (hybrid_stores[False], dict(theta=THETA, exchange="packed"),
                            "exchange"),
        "exchange dense": (hybrid_stores[False], dict(theta=THETA, exchange="dense"),
                           "exchange"),
    }[case]
    for mod, extra in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match=msg):
            mod.PMVEngine(None, store=root, residency="disk", strategy="hybrid", **kw,
                          **extra).prepare(mod.pagerank(N))


@pytest.mark.parametrize("sym", [False, True], ids=["plain", "symmetrized"])
def test_theta_leaves_basic_stripings_byte_identical(sym, stores, hybrid_stores):
    """Ingesting with theta= adds the θ-split shards and changes no byte of
    the vertical and horizontal stripings, so one store serves the basic
    disk solves and the hybrid ones."""
    import filecmp
    import os

    plain, split = stores[sym], hybrid_stores[sym]
    for striping in ("vertical", "horizontal"):
        names = sorted(os.listdir(os.path.join(plain, striping)))
        assert names == sorted(os.listdir(os.path.join(split, striping))) and names
        for name in names:
            assert filecmp.cmp(os.path.join(plain, striping, name),
                               os.path.join(split, striping, name), shallow=False), name
    for striping in ("sparse_vertical", "dense_horizontal"):
        assert not os.path.exists(os.path.join(plain, striping))
        assert os.listdir(os.path.join(split, striping))
    assert open_store(plain).hybrid is None and open_store(split).hybrid_theta() == THETA
