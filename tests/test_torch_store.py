"""The out-of-core block store of the PyTorch port against the JAX package's:
the port's ``ingest_edges`` writes the same bytes (every file, the manifest
included), it opens and loads stores the JAX package wrote (equal to its own
``partition_graph``), it audits them (``verify_store``), names a corrupted
row exactly, refuses the packed exchange on a format-1 store, and rebuilds
the same plans from a manifest.  Small graphs (n <= 512, b <= 8)."""
import gzip
import json
import os

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.graph import erdos_renyi, rmat
from repro.graph import io as jio
from repro.store import ingest_edges as j_ingest
from repro.store import plan_from_manifest as j_plan_from_manifest
from repro_torch.core import planner as tplanner
from repro_torch.core.partition import partition_graph
from repro_torch.faults import FetchDeadlineError, RetryPolicy
from repro_torch.graph import io as tio
from repro_torch.graph import symmetrize_edges
from repro_torch.store import (DiskBlockStore, ManifestCorruptError, ManifestVersionError,
                               ShardCorruptError, ingest_edges, load_partitioned, open_store,
                               plan_from_manifest, verify_store)
from repro_torch.store import format as fmt

GRAPHS = {
    "er": (lambda: erdos_renyi(300, 2400, seed=4), 300, 6),
    "rmat": (lambda: rmat(9, 4000, seed=7), 512, 8),
}
# ingest variants: (symmetrize, theta)
VARIANTS = {"plain": (False, None), "symmetrize": (True, None), "theta": (False, 5.0),
            "theta_auto_sym": (True, "auto")}


def _files(root):
    out = []
    for dp, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(dp, f), root) for f in fs]
    return sorted(out)


@pytest.fixture(scope="module")
def ref_stores(tmp_path_factory):
    """Stores the JAX package wrote, one per (graph, variant), on demand."""
    cache = {}

    def get(graph, variant):
        if (graph, variant) not in cache:
            mk, n, b = GRAPHS[graph]
            sym, theta = VARIANTS[variant]
            root = str(tmp_path_factory.mktemp(f"ref_{graph}_{variant}") / "s")
            j_ingest(mk(), n, b, root, chunk_edges=777, symmetrize=sym, theta=theta)
            cache[graph, variant] = root
        return cache[graph, variant]

    return get


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_ingest_writes_the_reference_bytes(graph, variant, ref_stores, tmp_path):
    """Every file of the tree -- the stripe shards of all four stripings,
    the packed index shards, the degree and measurement arrays, and
    manifest.json with its checksums -- is byte for byte the JAX package's."""
    mk, n, b = GRAPHS[graph]
    sym, theta = VARIANTS[variant]
    ref = ref_stores(graph, variant)
    man = ingest_edges(mk(), n, b, str(tmp_path / "s"), chunk_edges=777, symmetrize=sym,
                       theta=theta)
    assert man.version == fmt.FORMAT_VERSION == 2
    got, want = _files(man.root), _files(ref)
    assert got == want
    assert "manifest.json" in got and "vertical/w0.pidx.words.npy" in got
    assert ("sparse_vertical/w0.seg.npy" in got) == (theta is not None)
    for f in got:
        with open(os.path.join(man.root, f), "rb") as a, open(os.path.join(ref, f), "rb") as r:
            assert a.read() == r.read(), f


def test_ingest_from_a_path_and_the_chunked_reader(tmp_path):
    """A tsv (and gzip) path streams through the port's graph.io the way
    the JAX package's reader streams it; ingesting from the path writes the
    JAX package's bytes (the manifest records the same source path)."""
    edges = rmat(7, 900, seed=3)
    tsv = str(tmp_path / "e.tsv")
    jio.save_edges(tsv, edges)
    gz = str(tmp_path / "e.tsv.gz")
    with gzip.open(gz, "wt") as f:
        f.write("# comment\n" + "\n".join(f"{s}\t{d}\t7" for s, d in edges) + "\n")
    for path in (tsv, gz):
        np.testing.assert_array_equal(tio.load_edges(path), jio.load_edges(path))
        got = list(tio.iter_edges(path, chunk_edges=100))
        want = list(jio.iter_edges(path, chunk_edges=100))
        assert len(got) == len(want) == 9
        for a, r in zip(got, want):
            np.testing.assert_array_equal(a, r)
    assert tio.infer_n(edges) == jio.infer_n(edges)
    with pytest.raises(ValueError, match="negative vertex id"):
        tio.infer_n(np.array([[0, -1]]))
    man = ingest_edges(tsv, 128, 4, str(tmp_path / "t"), chunk_edges=250)
    ref = j_ingest(tsv, 128, 4, str(tmp_path / "j"), chunk_edges=250)
    for f in _files(ref.root):
        with open(os.path.join(man.root, f), "rb") as a, open(os.path.join(ref.root, f), "rb") as r:
            assert a.read() == r.read(), f
    with pytest.raises(ValueError, match="out of range"):
        ingest_edges(edges, 64, 4, str(tmp_path / "bad"))


@pytest.mark.parametrize("variant", ["plain", "symmetrize", "theta"])
@pytest.mark.parametrize("spec_name", ["pagerank", "cc"])
def test_port_loads_a_reference_store(spec_name, variant, ref_stores):
    """The port opens a store the JAX package wrote; load_partitioned gives
    the arrays of the port's own partition_graph on the same edges (after
    symmetrize where the store was ingested so), the hybrid θ-split too."""
    mk, n, b = GRAPHS["rmat"]
    sym, theta = VARIANTS[variant]
    spec = T.pagerank(n) if spec_name == "pagerank" else T.connected_components()
    edges = symmetrize_edges(mk()) if sym else mk()
    man = open_store(ref_stores("rmat", variant))
    assert (man.n, man.b, man.psi, man.symmetrized) == (n, b, "cyclic", sym)
    pm1, hm1 = load_partitioned(man, spec, theta=theta)
    pm0, hm0 = partition_graph(edges, n, b, spec, theta=theta)
    assert pm1.part == pm0.part and pm1.partial_cap == pm0.partial_cap
    for a in ("block_nnz", "partial_nnz"):
        np.testing.assert_array_equal(getattr(pm1, a), getattr(pm0, a))
    np.testing.assert_array_equal(pm1.stats.out_deg, pm0.stats.out_deg)
    pairs = list(zip(pm1.vertical + pm1.horizontal, pm0.vertical + pm0.horizontal))
    if theta is not None:
        pairs += list(zip(hm1.sparse_vertical + hm1.dense_horizontal,
                          hm0.sparse_vertical + hm0.dense_horizontal))
        np.testing.assert_array_equal(hm1.dense.gather_idx, hm0.dense.gather_idx)
        assert (hm1.sparse_partial_cap, hm1.dense.d_cap) == (hm0.sparse_partial_cap,
                                                             hm0.dense.d_cap)
    else:
        assert hm1 is None
    for s1, s0 in pairs:
        for f in ("seg_local", "gat_local", "count"):
            np.testing.assert_array_equal(getattr(s1, f), getattr(s0, f))
        if s0.w is None:
            assert s1.w is None
        else:
            np.testing.assert_array_equal(s1.w, s0.w)


@pytest.mark.parametrize("variant", ["plain", "theta"])
def test_verify_store_passes(variant, ref_stores, tmp_path):
    """verify_store audits every digest of a port-written store and of a
    JAX-written one, and reports a missing shard."""
    mk, n, b = GRAPHS["er"]
    sym, theta = VARIANTS[variant]
    man = ingest_edges(mk(), n, b, str(tmp_path / "s"), symmetrize=sym, theta=theta)
    for root in (man.root, ref_stores("er", variant)):
        rep = verify_store(root)
        assert rep.ok, rep.summary()
        stripings = 4 if theta is not None else 2
        assert rep.checked == (7 + 2 * (theta is not None)
                               + stripings * b * (2 * b + 1) + 2 * b)
    os.remove(fmt.stripe_path(man.root, "horizontal", 2, "gat"))
    rep = verify_store(man.root)
    assert not rep.ok and rep.missing == [fmt.stripe_path(man.root, "horizontal", 2, "gat")]


def _flip_seg_byte(root, striping, worker, block):
    path = fmt.stripe_path(root, striping, worker, "seg")
    mm = np.load(path, mmap_mode="r+")
    mm[block, 0] ^= 1
    mm.flush()
    del mm
    return path


@pytest.mark.parametrize("striping,worker,block", [("vertical", 3, 5), ("horizontal", 0, 2)])
def test_flipped_seg_byte_names_file_worker_and_block(striping, worker, block, tmp_path):
    """One flipped bit in a seg row: the fetch of that block raises
    ShardCorruptError naming the shard file, the worker and the block row
    (other blocks still fetch clean), verify_store reports exactly that
    row, and a disk solve fails with the same diagnosis once its retries
    (which re-read the row) are spent."""
    mk, n, b = GRAPHS["er"]
    man = ingest_edges(mk(), n, b, str(tmp_path / "s"))
    path = _flip_seg_byte(man.root, striping, worker, block)
    store = DiskBlockStore(man, striping, T.pagerank(n))
    with pytest.raises(ShardCorruptError) as e:
        store.fetch(block)
    assert (e.value.path, e.value.array, e.value.worker, e.value.block) == (
        path, "seg", worker, block)
    assert f"worker {worker}, block row {block}" in str(e.value)
    store.fetch((block + 1) % b)
    rep = verify_store(man.root)
    assert rep.mismatches and all(m.startswith(f"{path} [row {block}]") for m in rep.mismatches)
    eng = T.PMVEngine(None, store=man.root, residency="disk", strategy=striping, device="cpu",
                      io_retry=RetryPolicy(max_attempts=2, base_delay_s=0.0))
    with pytest.raises(ShardCorruptError, match=f"block row {block}"):
        eng.run(T.pagerank(n), max_iters=2, tol=0.0)


def test_retry_policy():
    """Transient OSErrors are retried within the budget; FileNotFoundError
    and non-I/O errors fail at once; the deadline chains the last error."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert RetryPolicy(max_attempts=3, base_delay_s=0.0).call(flaky) == "ok"
    assert len(calls) == 3
    for exc in (FileNotFoundError("gone"), KeyError("x")):
        n_calls = []

        def fails(exc=exc, n_calls=n_calls):
            n_calls.append(1)
            raise exc

        with pytest.raises(type(exc)):
            RetryPolicy(base_delay_s=0.0).call(fails)
        assert len(n_calls) == 1
    with pytest.raises(FetchDeadlineError) as e:
        RetryPolicy(max_attempts=5, base_delay_s=0.0, deadline_s=0.0).call(
            lambda: (_ for _ in ()).throw(OSError("slow disk")))
    assert isinstance(e.value.__cause__, OSError)
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)


def test_manifest_versions_and_corruption(tmp_path):
    """A format-1 manifest: exchange='packed' out of core raises
    ManifestVersionError at prepare, 'auto' keeps the padded stream and
    says why.  A newer version, another format and a truncated manifest are
    refused with their own errors."""
    mk, n, b = GRAPHS["er"]
    man = ingest_edges(mk(), n, b, str(tmp_path / "s"))
    mpath = os.path.join(man.root, "manifest.json")
    with open(mpath) as f:
        doc = json.load(f)
    with open(mpath, "w") as f:
        json.dump(dict(doc, version=1), f)
    assert not open_store(man.root).has_packed_index
    eng = T.PMVEngine(None, store=man.root, residency="disk", strategy="vertical",
                      exchange="packed", device="cpu")
    with pytest.raises(ManifestVersionError, match="version 1") as e:
        eng.prepare(T.pagerank(n))
    assert (e.value.found, e.value.needed) == (1, 2)
    meta = T.PMVEngine(None, store=man.root, residency="disk", strategy="vertical",
                       exchange="auto", device="cpu").prepare(T.pagerank(n))[-1]
    assert meta["exchange"] == "sparse"
    assert meta["exchange_decision"] == "auto: store format v1 has no packed index shards"
    with open(mpath, "w") as f:
        json.dump(dict(doc, version=99), f)
    with pytest.raises(ValueError, match="newer than this reader"):
        open_store(man.root)
    with open(mpath, "w") as f:
        json.dump(dict(doc, format="other"), f)
    with pytest.raises(ValueError, match="format"):
        open_store(man.root)
    with open(mpath, "w") as f:
        f.write(json.dumps(doc)[:40])
    with pytest.raises(ManifestCorruptError, match="corrupt manifest"):
        open_store(man.root)
    with pytest.raises(FileNotFoundError, match="not a block-store"):
        open_store(str(tmp_path / "nope"))


@pytest.mark.parametrize("residency", ["disk", "device"])
@pytest.mark.parametrize("strategy", ["vertical", "horizontal"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plan_from_manifest_equals_reference(graph, strategy, residency, ref_stores):
    """The plan rebuilt from the manifest (no shard read) is the JAX
    package's, block for block: tactic, measurements, cost (with the disk
    I/O term), bucket rows, boundaries, scatter, stream, e_cap, modeled
    bytes per iteration, launch schedule and launch costs; and, resident,
    the port's own plan measured from the loaded stripes."""
    mk, n, b = GRAPHS[graph]
    root = ref_stores(graph, "plain")
    man = open_store(root)
    cap = man.partial_cap if strategy == "vertical" else None
    kw = dict(strategy=strategy, theta=None, capacity=cap, scatter="kernel",
              stream="on" if strategy == "vertical" else "off", residency=residency)
    tplan = plan_from_manifest(root, mode="torch", **kw)
    jplan = j_plan_from_manifest(root, mode="xla", **kw)
    assert tplan.mode == "torch" and jplan.mode == "xla"
    for f in ("strategy", "b", "n_local", "theta", "capacity", "boundaries", "scatter",
              "stream", "residency", "e_cap"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    for tb, jb in zip(tplan.blocks, jplan.blocks):
        assert (tb.i, tb.j, tb.tactic, tb.nnz, tb.rows, tb.d_max, tb.occupancy, tb.cost,
                tb.bucket_rows) == (jb.i, jb.j, jb.tactic, jb.nnz, jb.rows, jb.d_max,
                                    jb.occupancy, jb.cost, jb.bucket_rows)
    assert tplan.io_bytes_per_iter() == jplan.io_bytes_per_iter()
    assert tplan.io_bytes_per_iter(has_w=True) == jplan.io_bytes_per_iter(has_w=True)
    assert (tplan.io_bytes_per_iter() > 0) == (residency == "disk")
    axis = "dest" if strategy == "vertical" else "src"
    for k in range(b):
        assert tplan.launch_schedule(k) == jplan.launch_schedule(k)
        assert tplan.launch_cost(k, axis=axis) == jplan.launch_cost(k, axis=axis)
        assert tplan.launch_attrs(k, axis=axis)["predicted_cost"] == \
            jplan.launch_attrs(k, axis=axis)["predicted_cost"]
    assert tplanner.format_plan(tplan).splitlines()[-b * b:] == \
        J.planner.format_plan(jplan).splitlines()[-b * b:]
    if residency == "device":
        pm, _ = load_partitioned(root, T.pagerank(n))
        measured = tplanner.plan_execution(pm, None, mode="torch", **kw)
        assert measured.blocks == tplan.blocks and measured.e_cap == tplan.e_cap
    with pytest.raises(NotImplementedError, match="basic strategies"):
        plan_from_manifest(root, strategy="hybrid")
