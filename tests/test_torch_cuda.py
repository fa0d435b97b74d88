"""The Hopper kernels against their plain versions, on the card.  Marked
``cuda``: they skip on a host without a GPU, and this file imports neither
JAX nor the JAX package so that it runs where only PyTorch is installed:

    python3 -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import block_gimv, ell_spmv, scatter_combine

SEMIRINGS = ["plus_times", "min_plus", "max_plus", "min_src"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_match(got, want, semiring, dtype):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if semiring == "plus_times" and dtype == np.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, want)


def _values(rng, shape, dtype):
    return (rng.integers(-50, 50, shape) if dtype == np.int32 else rng.random(shape)).astype(dtype)


def _compacted(rng, sets, senders, cap, n_local):
    """Each (s, k) row: strictly ascending unique indices padded with n_local."""
    idx = np.full((sets, senders, cap), n_local, np.int32)
    for s in range(sets):
        for k in range(senders):
            cnt = int(rng.integers(0, min(cap, n_local) + 1))
            idx[s, k, :cnt] = np.sort(rng.choice(n_local, cnt, replace=False))
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_kernels_match_plain_versions(cuda_device, semiring, dtype):
    rng = np.random.default_rng(11)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    before = kernels.launch_counts()

    deg = rng.integers(0, 71, 1000)
    cols = np.where(np.arange(70)[None, :] < deg[:, None], rng.integers(0, 3000, (1000, 70)), -1)
    w = (rng.integers(1, 4, cols.shape) if dtype == np.int32 else rng.random(cols.shape))
    args = (put(cols.astype(np.int32)), put(w.astype(np.float32)), put(_values(rng, 3000, dtype)))
    _assert_match(ell_spmv.ell_gimv(*args, semiring=semiring),
                  ell_spmv.ell_gimv_ref(*args, semiring=semiring), semiring, dtype)

    m = rng.random((999, 1232))
    m = (m > 0.7) if semiring == "min_src" else (np.round(m * 6) - 3 if dtype == np.int32 else m)
    m, v = put(m.astype(np.float32)), put(_values(rng, 1232, dtype))
    _assert_match(block_gimv.dense_gimv(m, v, semiring=semiring),
                  block_gimv.dense_gimv_ref(m, v, semiring=semiring), semiring, dtype)

    idx = put(_compacted(rng, 8, 8, 300, 500))
    val = put(_values(rng, tuple(idx.shape), dtype))
    _assert_match(scatter_combine.scatter_combine_gimv(idx, val, 500, semiring=semiring),
                  scatter_combine.scatter_combine_ref(idx, val, 500, semiring=semiring),
                  semiring, dtype)
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1 for k in ("ell_gimv", "dense_gimv", "scatter_combine"))


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [5, 64, 67])
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_multi_kernels_match_plain_versions(cuda_device, semiring, dtype, nq):
    """The Q-wide kernels at an odd Q, at 64 and past one 64-column tile;
    column 0 of every block is all identity (a padded serving column)."""
    rng = np.random.default_rng(12)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    ident = {"plus_times": 0, "min_plus": np.inf, "max_plus": -np.inf, "min_src": np.inf}
    ident = ident[semiring] if dtype == np.float32 else \
        {"plus_times": 0, "max_plus": -2**31}.get(semiring, 2**31 - 1)

    def block(shape):
        x = _values(rng, shape, dtype)
        x[:, 0] = ident
        return x

    before = kernels.launch_counts()
    deg = rng.integers(0, 71, 1000)
    cols = np.where(np.arange(70)[None, :] < deg[:, None], rng.integers(0, 3000, (1000, 70)), -1)
    w = (rng.integers(1, 4, cols.shape) if dtype == np.int32 else rng.random(cols.shape))
    args = (put(cols.astype(np.int32)), put(w.astype(np.float32)), put(block((3000, nq))))
    _assert_match(ell_spmv.ell_gimv_multi(*args, semiring=semiring),
                  ell_spmv.ell_gimv_multi_ref(*args, semiring=semiring), semiring, dtype)
    _assert_match(ell_spmv.ell_gimv_multi(args[0], None, args[2], semiring=semiring),
                  ell_spmv.ell_gimv_multi_ref(args[0], None, args[2], semiring=semiring),
                  semiring, dtype)

    m = rng.random((999, 1233))
    m = (m > 0.7) if semiring == "min_src" else (np.round(m * 6) - 3 if dtype == np.int32 else m)
    m, v = put(m.astype(np.float32)), put(block((1233, nq)))
    _assert_match(block_gimv.dense_gimv_multi(m, v, semiring=semiring),
                  block_gimv.dense_gimv_multi_ref(m, v, semiring=semiring), semiring, dtype)

    idx = put(_compacted(rng, 8, 8, 300, 500))
    val = put(block((8 * 8 * 300, nq)).reshape(8, 8, 300, nq))
    got = scatter_combine.scatter_combine_gimv_multi(idx, val, 500, semiring=semiring)
    _assert_match(got, scatter_combine.scatter_combine_multi_ref(idx, val, 500, semiring=semiring),
                  semiring, dtype)
    # a fixed fold in sender order: the same bits from run to run
    assert torch.equal(got, scatter_combine.scatter_combine_gimv_multi(idx, val, 500,
                                                                       semiring=semiring))
    after = kernels.launch_counts()
    assert after["ell_gimv_multi"] == before["ell_gimv_multi"] + 2
    assert after["dense_gimv_multi"] == before["dense_gimv_multi"] + 1
    assert after["scatter_combine_multi"] == before["scatter_combine_multi"] + 2


@pytest.mark.cuda
def test_cuda_engine_runs_on_the_kernels(cuda_device):
    """A small planned solve on the card launches the kernels and equals the
    same solve through the plain versions on the host."""
    from repro_torch.core import PMVEngine, sssp
    from repro_torch.graph import rmat

    edges = rmat(12, 8 << 12, seed=3)
    kw = dict(b=4, strategy="vertical", backend="auto", scatter="kernel", stream="off")
    kernels.reset_launch_counts()
    on_card = PMVEngine(edges, 1 << 12, device="cuda", **kw).run(sssp(0), tol=0.5)
    counts = kernels.launch_counts()
    on_host = PMVEngine(edges, 1 << 12, device="cpu", **kw).run(sssp(0), tol=0.5)
    assert counts["ell_gimv"] > 0 and counts["scatter_combine"] > 0
    np.testing.assert_array_equal(on_card.v, on_host.v)
    assert on_card.iterations == on_host.iterations


@pytest.mark.cuda
def test_cuda_server_runs_on_the_multi_kernels(cuda_device):
    """A small hybrid serve on the card goes through the three Q-wide
    kernels only and equals the same serve through the plain versions."""
    from repro_torch.graph import rmat
    from repro_torch.serving import PMVServer, Query

    n = 1 << 12
    edges = rmat(12, 8 << 12, seed=3)
    queries = [Query("sssp", source=s, tol=0.5) for s in range(0, 40, 4)]
    queries += [Query("rwr", source=s, tol=1e-6) for s in range(1, 41, 4)]
    kw = dict(b=4, strategy="hybrid", theta=40.0, backend="auto", scatter="kernel",
              stream="off", buckets=(8,))
    kernels.reset_launch_counts()
    on_card = PMVServer(edges, n, device="cuda", **kw).serve(queries)
    counts = kernels.launch_counts()
    on_host = PMVServer(edges, n, device="cpu", **kw).serve(queries)
    assert all(counts[k] > 0 for k in ("ell_gimv_multi", "dense_gimv_multi",
                                       "scatter_combine_multi"))
    assert all(counts[k] == 0 for k in ("ell_gimv", "dense_gimv", "scatter_combine"))
    for a, h in zip(on_card, on_host):
        assert a.converged and h.converged
        if a.query.spec_kind == "sssp":
            np.testing.assert_array_equal(a.vector, h.vector)
            assert a.iterations == h.iterations
        else:
            np.testing.assert_allclose(a.vector, h.vector, rtol=1e-5, atol=1e-7)


# the packed kernels' widths, each with the largest id domain it holds (the
# sentinel n_local takes the top code)
PACKED_WIDTHS = {4: 15, 8: 255, 16: 65535, 32: 131072}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("width", sorted(PACKED_WIDTHS))
def test_cuda_packed_kernels_match_plain_and_sparse_kernels(cuda_device, width, semiring,
                                                            dtype):
    """Kernels 7 and 8 (ids decoded in the kernel) against their plain
    versions at the four widths, single-vector and Q in {5, 64, 67}, and
    bitwise against the sparse kernels (3 and 6) fed the same rows as int32
    indices: both fold the senders of a set in order."""
    from repro_torch.exchange import codec

    n_local = PACKED_WIDTHS[width]
    sets, senders, k = 4, 8, 32 // width
    p = -(-300 // k) * k
    rng = np.random.default_rng(width)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    rows = _compacted(rng, sets, senders, p, n_local)
    words = put(codec.pack_uniform(rows, width).reshape(-1))
    idx = put(rows)
    n_out = sets * (n_local + 1)
    kw = dict(set_slots=senders * p, n_local=n_local, width=width, semiring=semiring,
              senders=senders)
    ident = {"plus_times": 0, "min_plus": np.inf, "max_plus": -np.inf, "min_src": np.inf}
    ident = ident[semiring] if dtype == np.float32 else \
        {"plus_times": 0, "max_plus": -2**31}.get(semiring, 2**31 - 1)
    before = kernels.launch_counts()
    for nq in (None, 5, 64, 67):
        shape = rows.shape + (() if nq is None else (nq,))
        x = _values(rng, shape, dtype)
        x[(rows >= n_local) if nq is None else np.broadcast_to((rows >= n_local)[..., None],
                                                                shape)] = ident
        val = put(x)
        if nq is None:
            got = scatter_combine.packed_scatter_combine_gimv(words, val.reshape(-1), n_out, **kw)
            want = scatter_combine.packed_scatter_combine_ref(
                words, val.reshape(-1), n_out, **{a: kw[a] for a in kw if a != "senders"})
            sparse = scatter_combine.scatter_combine_gimv(idx, val, n_local, semiring=semiring)
        else:
            got = scatter_combine.packed_scatter_combine_gimv_multi(
                words, val.reshape(-1, nq), n_out, **kw)
            want = scatter_combine.packed_scatter_combine_multi_ref(
                words, val.reshape(-1, nq), n_out, **{a: kw[a] for a in kw if a != "senders"})
            sparse = scatter_combine.scatter_combine_gimv_multi(idx, val, n_local,
                                                                semiring=semiring)
        _assert_match(got, want, semiring, dtype)
        seg = got.reshape((sets, n_local + 1) + (() if nq is None else (nq,)))
        assert torch.equal(seg[:, :n_local], sparse)
        # a fixed fold in sender order: the same bits from run to run
        again = (scatter_combine.packed_scatter_combine_gimv(words, val.reshape(-1), n_out, **kw)
                 if nq is None else scatter_combine.packed_scatter_combine_gimv_multi(
                     words, val.reshape(-1, nq), n_out, **kw))
        assert torch.equal(got, again)
    after = kernels.launch_counts()
    assert after["packed_scatter_combine"] == before["packed_scatter_combine"] + 2
    assert after["packed_scatter_combine_multi"] == before["packed_scatter_combine_multi"] + 6


@pytest.mark.cuda
def test_cuda_engine_packed_runs_on_the_packed_kernel(cuda_device):
    """A small packed PageRank with delta iteration on the card launches the
    packed kernel (not the sparse one) and equals the host's solve."""
    from repro_torch.core import PMVEngine, pagerank
    from repro_torch.graph import rmat

    n = 1 << 12
    edges = rmat(12, 8 << 12, seed=3)
    kw = dict(b=4, strategy="vertical", backend="auto", scatter="kernel", stream="off",
              exchange="packed", delta_eps=0.0)
    kernels.reset_launch_counts()
    on_card = PMVEngine(edges, n, device="cuda", **kw).run(pagerank(n), tol=1e-7)
    counts = kernels.launch_counts()
    on_host = PMVEngine(edges, n, device="cpu", **kw).run(pagerank(n), tol=1e-7)
    assert counts["packed_scatter_combine"] > 0 and counts["scatter_combine"] == 0
    np.testing.assert_allclose(on_card.v, on_host.v, rtol=1e-5, atol=1e-9)
    assert [r["delta_sent_rows"] for r in on_card.per_iter[:3]] == \
        [r["delta_sent_rows"] for r in on_host.per_iter[:3]]


@pytest.mark.cuda
def test_cuda_server_packed_runs_on_the_packed_multi_kernel(cuda_device):
    """A small packed hybrid serve on the card goes through the Q-wide packed
    kernel and equals the same serve through the plain versions."""
    from repro_torch.graph import rmat
    from repro_torch.serving import PMVServer, Query

    n = 1 << 12
    edges = rmat(12, 8 << 12, seed=3)
    queries = [Query("sssp", source=s, tol=0.5) for s in range(0, 40, 4)]
    kw = dict(b=4, strategy="hybrid", theta=40.0, backend="auto", scatter="kernel",
              stream="off", buckets=(8,), exchange="packed")
    kernels.reset_launch_counts()
    on_card = PMVServer(edges, n, device="cuda", **kw).serve(queries)
    counts = kernels.launch_counts()
    on_host = PMVServer(edges, n, device="cpu", **kw).serve(queries)
    assert counts["packed_scatter_combine_multi"] > 0 and counts["scatter_combine_multi"] == 0
    for a, h in zip(on_card, on_host):
        assert a.converged and h.converged and a.iterations == h.iterations
        np.testing.assert_array_equal(a.vector, h.vector)


# kernel 4's two paths: tensor cores (plus_times, float32) and CUDA cores
# (the rest); every row, k and Q edge of the 128 x 64 / 256 x 64 block tiles,
# the 32 / 16 k steps and the 16-byte copies (k % 4)
DENSE_CASES = [("plus_times", np.float32), ("min_plus", np.float32), ("max_plus", np.float32),
               ("min_src", np.float32), ("min_src", np.int32)]


def _identity_np(semiring, dtype):
    if semiring == "plus_times":
        return dtype(0)
    if dtype == np.float32:
        return np.float32(-np.inf if semiring == "max_plus" else np.inf)
    return np.int32(-2**31 if semiring == "max_plus" else 2**31 - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 127, 129, 1000])
@pytest.mark.parametrize("semiring,dtype", DENSE_CASES, ids=[f"{s}-{np.dtype(d).name}"
                                                            for s, d in DENSE_CASES])
def test_cuda_dense_multi_both_paths_at_tile_edges(cuda_device, semiring, dtype, rows):
    """dense_gimv_multi against its plain version at k in {1, 31, 33, 1232}
    and Q in {1, 5, 8, 63, 64, 67, 130}; column 0 of V is all identity and
    min/max_plus see the dense region's +-inf fill; plus_times is the same
    bits twice (fixed k order, no split-K)."""
    rng = np.random.default_rng(rows)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    ident = _identity_np(semiring, dtype)
    before = kernels.launch_counts()["dense_gimv_multi"]
    calls = 0
    for k in (1, 31, 33, 1232):
        m = rng.random((rows, k))
        if semiring == "min_src":
            m = m > 0.7
        elif semiring in ("min_plus", "max_plus"):
            m[rng.random((rows, k)) < 0.5] = np.inf if semiring == "min_plus" else -np.inf
        m = put(m.astype(np.float32))
        for nq in (1, 5, 8, 63, 64, 67, 130):
            x = _values(rng, (k, nq), dtype)
            x[:, 0] = ident
            x[rng.random((k, nq)) < 0.1] = ident
            v = put(x)
            got = block_gimv.dense_gimv_multi(m, v, semiring=semiring)
            _assert_match(got, block_gimv.dense_gimv_multi_ref(m, v, semiring=semiring),
                          semiring, dtype)
            calls += 1
            if semiring == "plus_times":
                assert torch.equal(got, block_gimv.dense_gimv_multi(m, v, semiring=semiring))
                calls += 1
    assert kernels.launch_counts()["dense_gimv_multi"] == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["matrix", "vectors"])
def test_cuda_dense_multi_plus_times_infinite_operand(cuda_device, where):
    """The stated limit of the 3xTF32 path: an infinite operand (plus_times
    values are finite on every path of the engine) makes its whole output
    row (an inf in M) or column (an inf in V) non-finite -- NaN, where the
    plain version gives inf or NaN -- and leaves every other cell equal to
    the plain version's at the usual tolerance."""
    rng = np.random.default_rng(3)
    rows, k, nq = 300, 200, 67
    m = rng.random((rows, k)).astype(np.float32)
    x = rng.random((k, nq)).astype(np.float32)
    if where == "matrix":
        m[17, 40] = np.inf
    else:
        x[40, 5] = np.inf
    m_d, v_d = torch.from_numpy(m).to(cuda_device), torch.from_numpy(x).to(cuda_device)
    got = block_gimv.dense_gimv_multi(m_d, v_d, semiring="plus_times").cpu()
    want = block_gimv.dense_gimv_multi_ref(m_d, v_d, semiring="plus_times").cpu()
    hit = torch.zeros((rows, nq), dtype=torch.bool)
    if where == "matrix":
        hit[17, :] = True
    else:
        hit[:, 5] = True
    assert not torch.isfinite(got[hit]).any() and not torch.isfinite(want[hit]).any()
    _assert_match(got[~hit], want[~hit], "plus_times", np.float32)


def _straddling_rows(rng, sets, senders, p, n_local):
    """Sender rows in the exchange's layout (ascending unique ids below
    n_local, then the sentinel), cycling through four kinds: empty (all
    sentinel), full (no sentinel where n_local >= p), the two ends of the id
    domain alone, and random ids with both ends."""
    rows = np.full((sets, senders, p), n_local, np.int64)
    cap = min(p, n_local)
    for s in range(sets):
        for k in range(senders):
            kind = (s + k) % 4
            if kind == 0:
                continue
            if kind == 1:
                ids = np.sort(rng.choice(n_local, cap, replace=False))
            elif kind == 2:
                ids = np.unique([0, n_local - 1])
            else:
                cnt = int(rng.integers(1, cap + 1))
                ids = np.unique(np.concatenate([rng.choice(n_local, cnt, replace=False),
                                                [0, n_local - 1]]))[:cap]
            rows[s, k, :len(ids)] = ids
    return rows


# (width, n_local): each width at the top of its domain; for 16 and 32 bits
# n_local + 1 at (4095), just past (4096, 4097) and well past (5000) the
# 4096-row tile of kernel 7, and inside one tile (2047, 2048)
STRADDLE = [(4, 15), (4, 6), (8, 255), (8, 100), (16, 2047), (16, 2048), (16, 4095),
            (16, 4096), (16, 5000), (16, 65535), (32, 4097), (32, 131072)]


@pytest.mark.cuda
@pytest.mark.parametrize("semiring,dtype", DENSE_CASES, ids=[f"{s}-{np.dtype(d).name}"
                                                            for s, d in DENSE_CASES])
@pytest.mark.parametrize("width,n_local", STRADDLE)
def test_cuda_packed_kernel_at_tile_edges(cuda_device, width, n_local, semiring, dtype):
    """Kernel 7 (one launch: a block per 4096-row tile of a set) against its
    plain version and bitwise against the sparse kernel on the same rows,
    with empty, full and (0, n_local - 1) sender rows, at n_out equal to, a
    set and a half under, one row under and 3000 rows over the sets'
    n_sets * (n_local + 1); plus_times the same bits twice."""
    from repro_torch.exchange import codec

    sets, senders = 3, 5
    per = 32 // width
    p = -(-min(n_local, 3000) // per) * per
    rng = np.random.default_rng(n_local * 100 + width)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    rows = _straddling_rows(rng, sets, senders, p, n_local)
    assert (rows[..., 0] == 0).any() and (rows == n_local - 1).any()
    words = put(codec.pack_uniform(rows, width).reshape(-1))
    x = _values(rng, rows.shape, dtype)
    x[rows >= n_local] = _identity_np(semiring, dtype)
    val = put(x)
    kw = dict(set_slots=senders * p, n_local=n_local, width=width, semiring=semiring)
    full = sets * (n_local + 1)
    before = kernels.launch_counts()["packed_scatter_combine"]
    calls = 0
    for n_out in (full, full - (n_local + 1) - (n_local + 1) // 2, full - 1, full + 3000):
        if n_out <= 0:
            continue
        got = scatter_combine.packed_scatter_combine_gimv(words, val.reshape(-1), n_out,
                                                          senders=senders, **kw)
        _assert_match(got, scatter_combine.packed_scatter_combine_ref(words, val.reshape(-1),
                                                                      n_out, **kw),
                      semiring, dtype)
        calls += 1
        if n_out == full:
            sparse = scatter_combine.scatter_combine_gimv(put(rows.astype(np.int32)), val,
                                                          n_local, semiring=semiring)
            assert torch.equal(got.reshape(sets, n_local + 1)[:, :n_local], sparse)
            if semiring == "plus_times":
                assert torch.equal(got, scatter_combine.packed_scatter_combine_gimv(
                    words, val.reshape(-1), n_out, senders=senders, **kw))
                calls += 1
    assert kernels.launch_counts()["packed_scatter_combine"] == before + calls


# Kernels 6 and 8 (one launch: a block per tile of a set's output rows and
# slab of up to 64 query columns; the tile is 128 rows at Q >= 64, 8192 / Q
# rows below, at most 4096): Q of one column, inside one slab, at its edge,
# one past it and two slabs and a bit; n_local below, at and past a 128-row
# tile (kernel 8 adds each set's drop row), past two of them, and one row
# past the 1638-row tile of Q = 5 and past two of them
SCATTER_MULTI_Q = (1, 5, 64, 67, 130)
SCATTER_MULTI_NL = (127, 128, 129, 257, 1639, 3277)


@pytest.mark.cuda
@pytest.mark.parametrize("semiring,dtype", DENSE_CASES, ids=[f"{s}-{np.dtype(d).name}"
                                                            for s, d in DENSE_CASES])
@pytest.mark.parametrize("n_local", SCATTER_MULTI_NL)
@pytest.mark.parametrize("nq", SCATTER_MULTI_Q)
def test_cuda_scatter_multi_kernels_at_tile_edges(cuda_device, nq, n_local, semiring, dtype):
    """Kernels 6 and 8 against their plain versions, and kernel 8 bitwise
    against kernel 6 on the same rows, with empty, full and (0, n_local - 1)
    sender rows; kernel 8 also at n_out a set and a half under and 700 rows
    over the sets' outputs.  One launch a call; plus_times the same bits
    twice."""
    from repro_torch.exchange import codec

    sets, senders = 3, 5
    width = codec.device_width(n_local)
    per = 32 // width
    p = -(-min(n_local, 600) // per) * per
    rng = np.random.default_rng(nq * 10000 + n_local)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    rows = _straddling_rows(rng, sets, senders, p, n_local)
    idx, words = put(rows.astype(np.int32)), put(codec.pack_uniform(rows, width).reshape(-1))
    x = _values(rng, rows.shape + (nq,), dtype)
    x[np.broadcast_to((rows >= n_local)[..., None], x.shape)] = _identity_np(semiring, dtype)
    val = put(x)
    before = kernels.launch_counts()
    got = scatter_combine.scatter_combine_gimv_multi(idx, val, n_local, semiring=semiring)
    _assert_match(got, scatter_combine.scatter_combine_multi_ref(idx, val, n_local,
                                                                 semiring=semiring),
                  semiring, dtype)
    kw = dict(set_slots=senders * p, n_local=n_local, width=width, semiring=semiring)
    full = sets * (n_local + 1)
    flat = val.reshape(-1, nq)
    for n_out in (full, full - (n_local + 1) - (n_local + 1) // 2, full + 700):
        packed = scatter_combine.packed_scatter_combine_gimv_multi(words, flat, n_out,
                                                                   senders=senders, **kw)
        _assert_match(packed, scatter_combine.packed_scatter_combine_multi_ref(words, flat,
                                                                               n_out, **kw),
                      semiring, dtype)
        if n_out == full:
            assert torch.equal(packed.reshape(sets, n_local + 1, nq)[:, :n_local], got)
    calls = 1
    if semiring == "plus_times":
        assert torch.equal(got, scatter_combine.scatter_combine_gimv_multi(
            idx, val, n_local, semiring=semiring))
        calls = 2
    after = kernels.launch_counts()
    assert after["scatter_combine_multi"] == before["scatter_combine_multi"] + calls
    assert after["packed_scatter_combine_multi"] == before["packed_scatter_combine_multi"] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [5, 64, 67])
@pytest.mark.parametrize("semiring,dtype", DENSE_CASES, ids=[f"{s}-{np.dtype(d).name}"
                                                            for s, d in DENSE_CASES])
def test_cuda_scatter_multi_kernels_without_slots(cuda_device, semiring, dtype, nq):
    """No slot reaches an output: kernel 6 with cap = 0 and kernel 8 with
    every sender row all sentinel give the identity everywhere, in one
    launch each."""
    from repro_torch.exchange import codec

    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    n_local, sets, senders = 300, 3, 4
    ident = _identity_np(semiring, dtype)
    before = kernels.launch_counts()
    idx = torch.empty((sets, senders, 0), dtype=torch.int32, device=cuda_device)
    val = torch.empty((sets, senders, 0, nq), dtype=torch.from_numpy(np.zeros(1, dtype)).dtype,
                      device=cuda_device)
    got = scatter_combine.scatter_combine_gimv_multi(idx, val, n_local, semiring=semiring)
    assert torch.equal(got.cpu(), torch.from_numpy(np.full((sets, n_local, nq), ident, dtype)))
    rows = np.full((sets, senders, 32), n_local, np.int64)
    words = put(codec.pack_uniform(rows, 16).reshape(-1))
    flat = put(_values(np.random.default_rng(nq), (rows.size, nq), dtype))
    n_out = sets * (n_local + 1)
    got = scatter_combine.packed_scatter_combine_gimv_multi(
        words, flat, n_out, set_slots=senders * 32, n_local=n_local, width=16,
        semiring=semiring, senders=senders)
    assert torch.equal(got.cpu(), torch.from_numpy(np.full((n_out, nq), ident, dtype)))
    after = kernels.launch_counts()
    assert after["scatter_combine_multi"] == before["scatter_combine_multi"] + 1
    assert after["packed_scatter_combine_multi"] == before["packed_scatter_combine_multi"] + 1


# The ELL kernels stop at a row's first chunk that holds a pad (32 slots; 16
# on the Q-wide kernel's half-warp rows, buckets up to 256 wide at Q % 4 ==
# 0) and split a row wider than 1024 slots over a block of warps: widths
# below, at and above both edges, a power of two past the split, and two
# that are not a multiple of 32 (the widest buckets of the RMAT-20 serve
# and PageRank)
ELL_WIDTHS = (70, 256, 257, 1023, 1024, 1025, 2048, 24570, 69017)


def _ell_table(rng, width, n_src, dtype, degrees=None):
    """A left-packed table: rows of degree 0 (empty, all pad), 15, 16, 17,
    31, 32, 33 and 64 (each side of the chunk edges), the width less one, the
    full width, and five at random, then one more all-pad row."""
    if degrees is None:
        degrees = [0, 15, 16, 17, 31, 32, 33, 64, width - 1, width,
                   *rng.integers(0, width + 1, 5), 0]
    deg = np.minimum(np.asarray(degrees), width)
    cols = np.where(np.arange(width)[None, :] < deg[:, None],
                    rng.integers(0, n_src, (len(deg), width)), -1).astype(np.int32)
    w = rng.integers(1, 4, cols.shape) if dtype == np.int32 else rng.random(cols.shape)
    return cols, w.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_ell_gimv_at_chunk_and_split_edges(cuda_device, semiring, dtype):
    """ell_gimv against its plain version at every width of ELL_WIDTHS, with
    and without weights, and on a table of all-pad rows (the identity);
    plus_times gives the same bits twice."""
    rng = np.random.default_rng(31)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    before = kernels.launch_counts()["ell_gimv"]
    calls = 0
    for width in ELL_WIDTHS:
        cols, w = _ell_table(rng, width, 3000, dtype)
        c, v = put(cols), put(_values(rng, 3000, dtype))
        for ww in (put(w), None):
            got = ell_spmv.ell_gimv(c, ww, v, semiring=semiring)
            _assert_match(got, ell_spmv.ell_gimv_ref(c, ww, v, semiring=semiring), semiring, dtype)
            calls += 1
            if semiring == "plus_times":
                assert torch.equal(got, ell_spmv.ell_gimv(c, ww, v, semiring=semiring))
                calls += 1
        pads = put(np.full((3, width), -1, np.int32))
        got = ell_spmv.ell_gimv(pads, put(w[:3]), v, semiring=semiring).cpu()
        assert torch.equal(got, torch.full((3,), _identity_np(semiring, dtype).item(),
                                           dtype=got.dtype))
        calls += 1
    assert kernels.launch_counts()["ell_gimv"] == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 5, 32, 33, 64, 67])
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_ell_gimv_multi_at_chunk_and_split_edges(cuda_device, semiring, dtype, nq):
    """ell_gimv_multi against its plain version at every width of
    ELL_WIDTHS (one query tile and two: Q = 67), with and without weights,
    and on all-pad rows; plus_times gives the same bits twice."""
    rng = np.random.default_rng(nq)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    before = kernels.launch_counts()["ell_gimv_multi"]
    calls = 0
    for width in ELL_WIDTHS:
        cols, w = _ell_table(rng, width, 3000, dtype)
        c, v = put(cols), put(_values(rng, (3000, nq), dtype))
        for ww in (put(w), None):
            got = ell_spmv.ell_gimv_multi(c, ww, v, semiring=semiring)
            _assert_match(got, ell_spmv.ell_gimv_multi_ref(c, ww, v, semiring=semiring),
                          semiring, dtype)
            calls += 1
            if semiring == "plus_times":
                assert torch.equal(got, ell_spmv.ell_gimv_multi(c, ww, v, semiring=semiring))
                calls += 1
        pads = put(np.full((3, width), -1, np.int32))
        got = ell_spmv.ell_gimv_multi(pads, put(w[:3]), v, semiring=semiring).cpu()
        assert torch.equal(got, torch.full((3, nq), _identity_np(semiring, dtype).item(),
                                           dtype=got.dtype))
        calls += 1
    assert kernels.launch_counts()["ell_gimv_multi"] == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("width,rows", [(70, 20000), (300, 20000), (1025, 700)])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_ell_kernels_with_more_rows_than_resident_warps(cuda_device, semiring, width, rows):
    """More rows than the card holds warps (a warp or a half-warp a row) or
    blocks (a block a row), so the kernels' loops over rows and their
    prefetch of the next row run; both kernels against their plain versions
    (Q = 64)."""
    rng = np.random.default_rng(rows)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    cols, w = _ell_table(rng, width, 5000, np.float32, rng.integers(0, width + 1, rows))
    c, ww = put(cols), put(w)
    v = put(_values(rng, 5000, np.float32))
    _assert_match(ell_spmv.ell_gimv(c, ww, v, semiring=semiring),
                  ell_spmv.ell_gimv_ref(c, ww, v, semiring=semiring), semiring, np.float32)
    vq = put(_values(rng, (5000, 64), np.float32))
    _assert_match(ell_spmv.ell_gimv_multi(c, ww, vq, semiring=semiring),
                  ell_spmv.ell_gimv_multi_ref(c, ww, vq, semiring=semiring), semiring, np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [100, 4000, 20000])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_ell_wide_bucket_of_short_rows(cuda_device, semiring, rows):
    """A bucket wider than the split (2048) whose rows are mostly shorter
    than one chunk, as the lowest bucket of a graph whose longest row is
    over 128 times the split would be, with long rows among them (every
    97th and a run of 300).  Fewer rows than resident blocks (100: a block
    a row on the split path), fewer than the card's resident warps (4000:
    the split path, a warp per short row, several rows a pass) and more
    (20000: one warp a row); both kernels against their plain versions
    (Q = 5 and 64), plus_times the same bits twice."""
    rng = np.random.default_rng(rows + 7)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    width = 2048
    deg = rng.integers(0, 40, rows)
    deg[::97] = rng.integers(1025, width + 1, len(deg[::97]))
    run = slice(rows // 2, rows // 2 + 300)
    deg[run] = rng.integers(33, width + 1, len(deg[run]))
    cols, w = _ell_table(rng, width, 5000, np.float32, deg)
    c, ww = put(cols), put(w)
    v = put(_values(rng, 5000, np.float32))
    got = ell_spmv.ell_gimv(c, ww, v, semiring=semiring)
    _assert_match(got, ell_spmv.ell_gimv_ref(c, ww, v, semiring=semiring), semiring, np.float32)
    if semiring == "plus_times":
        assert torch.equal(got, ell_spmv.ell_gimv(c, ww, v, semiring=semiring))
    for nq in (5, 64):
        vq = put(_values(rng, (5000, nq), np.float32))
        got = ell_spmv.ell_gimv_multi(c, ww, vq, semiring=semiring)
        _assert_match(got, ell_spmv.ell_gimv_multi_ref(c, ww, vq, semiring=semiring), semiring,
                      np.float32)
        if semiring == "plus_times":
            assert torch.equal(got, ell_spmv.ell_gimv_multi(c, ww, vq, semiring=semiring))
