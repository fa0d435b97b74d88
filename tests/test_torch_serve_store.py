"""PMVServer(store=...) of the PyTorch port on the CPU: the port's server and
the JAX package's serve the same mixed PageRank / RWR / SSSP queries from
one ingested θ-split store in every residency ('disk', 'host', 'device') and
placement (vertical over the sparse and the packed exchange, horizontal,
hybrid): equal iteration counts, SSSP answers exactly equal, PageRank and
RWR within rtol 1e-5.  On the port alone: the disk serve is bitwise the
edges-based serve on the vertical path; a flipped byte in a seg shard
fails its batch with the checksum diagnosis and the server answers the next
batch once the shard is restored; the argument errors of the JAX package.
Small graph (n = 256, b = 4)."""
import os
import shutil

import numpy as np
import pytest

import repro.serving as JS
import repro_torch.serving as TS
from repro.graph import rmat
from repro_torch.store import ingest_edges, open_store

N, B, THETA = 256, 4, 8.0
EDGES = rmat(8, 1500, seed=3)
SOURCES = np.random.default_rng(0).choice(N, 12)
# (strategy, exchange)
PLACEMENTS = [("vertical", "sparse"), ("vertical", "packed"), ("horizontal", "sparse"),
              ("hybrid", "sparse")]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_store") / "s")
    ingest_edges(EDGES, N, B, root, theta=THETA)
    return root


def _queries(mod):
    out = [mod.Query("pagerank", tol=1e-6)]
    for i in range(6):
        out.append(mod.Query("rwr", source=int(SOURCES[i]), tol=1e-6))
        out.append(mod.Query("sssp", source=int(SOURCES[6 + i]), tol=0.5))
    return out


def _assert_same_answers(got, want, *, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.query.spec_kind, g.query.source) == (w.query.spec_kind, w.query.source)
        assert g.reason == w.reason == "completed" and g.converged == w.converged
        assert g.iterations == w.iterations, (g.query, g.iterations, w.iterations)
        assert g.vector.dtype == w.vector.dtype and g.vector.shape == (N,)
        if exact or g.query.spec_kind == "sssp":
            np.testing.assert_array_equal(g.vector, w.vector)
        else:
            np.testing.assert_allclose(g.vector, w.vector, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("placement", PLACEMENTS, ids=["-".join(p) for p in PLACEMENTS])
@pytest.mark.parametrize("residency", ["disk", "host", "device"])
def test_store_server_matches_jax_server(residency, placement, store):
    """The same queries through both servers from one store: equal iteration
    counts and answers; a disk serve sums its store_* I/O into stats()."""
    strategy, exchange = placement
    kw = dict(store=store, residency=residency, strategy=strategy, exchange=exchange,
              theta=THETA, buckets=(8,), stream="off")
    want = JS.PMVServer(**kw).serve(_queries(JS))
    srv = TS.PMVServer(device="cpu", **kw)
    got = srv.serve(_queries(TS))
    _assert_same_answers(got, want)
    st = srv.stats()
    assert st["batches"] == 3 and st["retirement_reasons"]["completed"] == 13
    if residency == "disk":
        assert st["store_bytes_read"] > 0 and st["store_io_s"] > 0
        assert 0.0 <= st["store_overlap"] <= 1.0
    else:
        assert st["store_bytes_read"] == 0.0 and st["store_overlap"] == 1.0
    srv.close()


def test_disk_serve_bitwise_the_edges_serve(store):
    """As the JAX package's test_disk_serving_from_manifest_path: the disk
    serve on the vertical path is bitwise the server on the edge list, with
    the same iteration counts."""
    disk = TS.PMVServer(store=store, residency="disk", strategy="vertical", device="cpu")
    edges = TS.PMVServer(EDGES, N, b=B, strategy="vertical", device="cpu")
    _assert_same_answers(disk.serve(_queries(TS)), edges.serve(_queries(TS)), exact=True)


@pytest.mark.parametrize("strategy,striping", [("vertical", "vertical"),
                                               ("hybrid", "sparse_vertical")])
def test_corrupt_shard_fails_the_batch_and_the_server_recovers(strategy, striping, store,
                                                              tmp_path):
    """A flipped byte in a seg shard survives the fetch retries: the batch's
    queries retire 'failed' with the checksum diagnosis, and once the shard
    is restored the same server answers the next batch as a clean one."""
    root = str(tmp_path / "s")
    shutil.copytree(store, root)
    man = open_store(root)
    worker = 1
    seg = os.path.join(root, striping, f"w{worker}.seg.npy")
    arr = np.load(seg, mmap_mode="r")
    block = int(np.flatnonzero(np.asarray(man.array("sparse_nnz" if strategy == "hybrid"
                                                    else "nnz"))[:, worker])[0])
    offset = os.path.getsize(seg) - arr.nbytes + arr[0].nbytes * block
    clean = open(seg, "rb").read()
    kw = dict(residency="disk", strategy=strategy, theta=THETA, buckets=(8,), device="cpu")
    want = TS.PMVServer(store=store, **kw).serve(_queries(TS)[1:3])
    srv = TS.PMVServer(store=root, **kw)
    with open(seg, "r+b") as f:
        f.seek(offset)
        f.write(bytes([clean[offset] ^ 0xFF]))
    lost = srv.serve(_queries(TS)[1:3])
    assert all(r.reason == "failed" and r.vector is None for r in lost)
    assert all("checksum mismatch" in r.error and seg in r.error for r in lost)
    assert srv.stats()["failed_batches"] == 2
    with open(seg, "wb") as f:
        f.write(clean)
    _assert_same_answers(srv.serve(_queries(TS)[1:3]), want, exact=True)
    st = srv.stats()
    assert st["retirement_reasons"]["failed"] == 2 and st["retirement_reasons"]["completed"] == 2


def test_store_server_argument_errors(store):
    """The JAX package's checks, in both packages: edges and a store
    together, n or b other than the store's, and a CC query on a store
    ingested without symmetrize (raised when its family is built)."""
    for mod, extra in ((JS, {}), (TS, {"device": "cpu"})):
        with pytest.raises(ValueError, match="either edges or store"):
            mod.PMVServer(EDGES, store=store, **extra)
        with pytest.raises(ValueError, match="n=7"):
            mod.PMVServer(store=store, n=7, **extra)
        with pytest.raises(ValueError, match="b=3"):
            mod.PMVServer(store=store, b=3, **extra)
        srv = mod.PMVServer(store=store, residency="disk", strategy="vertical", **extra)
        with pytest.raises(ValueError, match="symmetrize=True"):
            srv.serve([mod.Query("cc")])
