"""The Hopper kernels against their plain versions, on the card.  Marked
``cuda``: they skip on a host without a GPU, and this file imports neither
JAX nor the JAX package so that it runs where only PyTorch is installed:

    python3 -m pytest -m cuda tests/test_torch_cuda.py
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_graphs import tactic_mix_edges
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
# n_local + 1 at (4095), just past (4096, 4097) and well past (5000) a
# multiple of kernel 7's tile rows (kScalarTileRows, a power of two up to
# 4096), and at and past half of 4096 (2047, 2048)
STRADDLE = [(4, 15), (4, 6), (8, 255), (8, 100), (16, 2047), (16, 2048), (16, 4095),
            (16, 4096), (16, 5000), (16, 65535), (32, 4097), (32, 131072)]


@pytest.mark.cuda
@pytest.mark.parametrize("semiring,dtype", DENSE_CASES, ids=[f"{s}-{np.dtype(d).name}"
                                                            for s, d in DENSE_CASES])
@pytest.mark.parametrize("width,n_local", STRADDLE)
def test_cuda_packed_kernel_at_tile_edges(cuda_device, width, n_local, semiring, dtype):
    """Kernel 7 (one launch: a block per tile of a set's rows) against its
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


def _scalar_tile_rows() -> int:
    """kScalarTileRows of csrc/scatter_tile.cuh: the output rows of a block
    of kernels 3 and 7."""
    hdr = Path(scatter_combine.__file__).resolve().parents[1] / "csrc" / "scatter_tile.cuh"
    return int(re.search(r"constexpr int kScalarTileRows = (\d+);", hdr.read_text()).group(1))


# Kernels 3 and 7 (one launch: a block per tile of R = kScalarTileRows output
# rows of a set): n_local at R - 1, R, R + 1 and 2R + 1, as (multiple of R,
# offset); fewer senders than a block has warps, and more
SCALAR_NL = ((1, -1), (1, 0), (1, 1), (2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("semiring,dtype", DENSE_CASES, ids=[f"{s}-{np.dtype(d).name}"
                                                            for s, d in DENSE_CASES])
@pytest.mark.parametrize("senders", [5, 9])
@pytest.mark.parametrize("tiles,extra", SCALAR_NL, ids=["R-1", "R", "R+1", "2R+1"])
def test_cuda_scatter_combine_at_tile_edges(cuda_device, tiles, extra, senders, semiring,
                                            dtype):
    """Kernel 3 against its plain version at n_local around its tile edges,
    with empty, full and (0, n_local - 1) sender rows, and bitwise against
    kernel 7 on the same rows (both run the Q = 1 tile fold); one launch a
    call each, plus_times the same bits twice."""
    from repro_torch.exchange import codec

    n_local = tiles * _scalar_tile_rows() + extra
    sets = 3
    width = codec.device_width(n_local)
    per = 32 // width
    p = -(-min(n_local, 3000) // per) * per
    rng = np.random.default_rng(n_local * 10 + senders)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    rows = _straddling_rows(rng, sets, senders, p, n_local)
    idx = put(rows.astype(np.int32))
    x = _values(rng, rows.shape, dtype)
    x[rows >= n_local] = _identity_np(semiring, dtype)
    val = put(x)
    before = kernels.launch_counts()
    got = scatter_combine.scatter_combine_gimv(idx, val, n_local, semiring=semiring)
    _assert_match(got, scatter_combine.scatter_combine_ref(idx, val, n_local,
                                                           semiring=semiring),
                  semiring, dtype)
    words = put(codec.pack_uniform(rows, width).reshape(-1))
    packed = scatter_combine.packed_scatter_combine_gimv(
        words, val.reshape(-1), sets * (n_local + 1), set_slots=senders * p, n_local=n_local,
        width=width, semiring=semiring, senders=senders)
    assert torch.equal(packed.reshape(sets, n_local + 1)[:, :n_local], got)
    calls = 1
    if semiring == "plus_times":
        assert torch.equal(got, scatter_combine.scatter_combine_gimv(idx, val, n_local,
                                                                     semiring=semiring))
        calls = 2
    after = kernels.launch_counts()
    assert after["scatter_combine"] == before["scatter_combine"] + calls
    assert after["packed_scatter_combine"] == before["packed_scatter_combine"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("semiring,dtype", DENSE_CASES, ids=[f"{s}-{np.dtype(d).name}"
                                                            for s, d in DENSE_CASES])
def test_cuda_scatter_combine_empty_full_and_negative_rows(cuda_device, semiring, dtype):
    """Kernel 3 against its plain version with cap = 0 (identities only), and
    with cap = n_local past one tile: an empty row (all sentinel), a full row
    (every index), a row whose ids start below 0 (dropped) and a random
    row; one launch a call."""
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    n_local, sets, senders = _scalar_tile_rows() * 2 - 120, 2, 4
    rng = np.random.default_rng(len(semiring))
    before = kernels.launch_counts()["scatter_combine"]
    idx = torch.empty((sets, senders, 0), dtype=torch.int32, device=cuda_device)
    val = put(np.zeros((sets, senders, 0), dtype))
    got = scatter_combine.scatter_combine_gimv(idx, val, n_local, semiring=semiring)
    assert torch.equal(got.cpu(), torch.from_numpy(
        np.full((sets, n_local), _identity_np(semiring, dtype), dtype)))
    rows = np.full((sets, senders, n_local), n_local, np.int64)
    for s in range(sets):
        rows[s, 1] = np.arange(n_local)
        neg = np.r_[[-900, -33, -1], np.sort(rng.choice(n_local, n_local // 2, replace=False))]
        rows[s, 2, :len(neg)] = neg
        cnt = int(rng.integers(1, n_local))
        rows[s, 3, :cnt] = np.sort(rng.choice(n_local, cnt, replace=False))
    idx = put(rows.astype(np.int32))
    val = put(_values(rng, rows.shape, dtype))
    got = scatter_combine.scatter_combine_gimv(idx, val, n_local, semiring=semiring)
    _assert_match(got, scatter_combine.scatter_combine_ref(idx, val, n_local,
                                                           semiring=semiring),
                  semiring, dtype)
    assert kernels.launch_counts()["scatter_combine"] == before + 2


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


# ---------------------------------------------------------------------------
# The out-of-core store on the card: pinned double buffer, side-stream copies.
# ---------------------------------------------------------------------------

DISK_N, DISK_B, DISK_ITERS = 1 << 14, 8, 6
# the stores carry θ-split shards too (the vertical and horizontal stripings
# are byte for byte those of a store ingested without theta=): 128 of the
# 16384 vertices reach out-degree 200 and hold a third of the edges
DISK_THETA = 200.0
# (name, spec maker, symmetrized store, strategy, exchange, scatter, kernel launched)
DISK_CASES = [
    ("sssp-vertical-sparse-kernel", lambda T: T.sssp(0), False, "vertical", "sparse", "kernel",
     "scatter_combine"),
    ("pagerank-vertical-packed-kernel", lambda T: T.pagerank(DISK_N), False, "vertical",
     "packed", "kernel", "packed_scatter_combine"),
    ("pagerank-horizontal", lambda T: T.pagerank(DISK_N), False, "horizontal", "sparse",
     "segment", None),
    ("cc-vertical-sparse-segment", lambda T: T.connected_components(), True, "vertical",
     "sparse", "segment", None),
]


@pytest.fixture(scope="module")
def disk_stores(tmp_path_factory):
    """RMAT-14 (16 edges a vertex) stores with θ-split shards, plain and
    symmetrized (built only where the tests that read them run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    from repro_torch.graph import rmat
    from repro_torch.store import ingest_edges

    edges = rmat(14, 16 << 14, seed=1)
    out = {"edges": edges}
    for sym in (False, True):
        root = str(tmp_path_factory.mktemp(f"cuda_store{int(sym)}") / "s")
        ingest_edges(edges, DISK_N, DISK_B, root, symmetrize=sym, theta=DISK_THETA)
        out[sym] = root
    return out


def _disk_solve(eng, spec):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = eng.run(spec, max_iters=DISK_ITERS, tol=0.0)
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated()


def _assert_same_answer(got, want, name):
    if name.startswith("pagerank"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DISK_CASES, ids=[c[0] for c in DISK_CASES])
def test_cuda_disk_pipeline_matches_resident(cuda_device, disk_stores, case):
    """residency='disk' on the card: fetched slices staged in two pinned host
    buffers and copied on a side stream; over several iterations the result
    equals the resident backend='torch' engine's (plus_times to rtol 1e-5:
    the card's segment sums use atomics), the receive kernel launches on the
    disk path under scatter='kernel', and the peak device memory stays
    below the resident engine's."""
    import repro_torch.core as T

    name, mk, sym, strategy, exchange, scatter, kernel = case
    kw = dict(strategy=strategy, exchange=exchange, scatter=scatter, device=cuda_device)
    resident, peak_resident = _disk_solve(
        T.PMVEngine(disk_stores["edges"], DISK_N, b=DISK_B, symmetrize=sym, backend="torch",
                    **kw), mk(T))
    eng = T.PMVEngine(None, store=disk_stores[sym], residency="disk", **kw)
    spec = mk(T)
    meta = eng.prepare(spec)[-1]
    before = kernels.launch_counts()
    disk, peak_disk = _disk_solve(eng, spec)
    after = kernels.launch_counts()
    _assert_same_answer(disk.v, resident.v, name)
    if kernel is not None:
        assert after[kernel] - before[kernel] == DISK_ITERS
    store = meta["store"]
    assert all(t.is_pinned() for slot in store._staging.slots for t in slot.values()
               if t is not None)
    assert store.device_buffer_bytes > 0 and not store.prefetch_degraded
    assert disk.per_iter[-1]["store_blocks_fetched"] > 0
    assert peak_disk < peak_resident, (peak_disk, peak_resident)


@pytest.mark.cuda
def test_cuda_disk_slow_fetch_leaves_no_torn_slice(cuda_device, disk_stores, monkeypatch):
    """Every other fetch sleeps before it reads, so the compute runs ahead
    of the prefetch and the two pinned buffers turn over at uneven times:
    the answers stay those of the unslowed run (SSSP and CC exactly)."""
    import time

    import repro_torch.core as T
    from repro_torch.store import DiskBlockStore

    def solve(sym, spec):
        eng = T.PMVEngine(None, store=disk_stores[sym], residency="disk", strategy="vertical",
                          scatter="kernel", device=cuda_device)
        return eng.run(spec, max_iters=DISK_ITERS, tol=0.0)

    want = {name: solve(sym, mk(T)).v for name, mk, sym in (
        ("sssp", lambda T: T.sssp(0), False), ("cc", lambda T: T.connected_components(), True))}
    read = DiskBlockStore._read
    calls = []

    def slow_read(self, k, *args):
        calls.append(k)
        if len(calls) % 2:
            time.sleep(0.02)
        return read(self, k, *args)

    monkeypatch.setattr(DiskBlockStore, "_read", slow_read)
    np.testing.assert_array_equal(solve(False, T.sssp(0)).v, want["sssp"])
    np.testing.assert_array_equal(solve(True, T.connected_components()).v, want["cc"])
    assert len(calls) >= 2 * DISK_ITERS


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_cuda_host_residency_copies_pinned_stripes(cuda_device, disk_stores, backend):
    """residency='host' keeps the prepared matrix in pinned host memory and
    copies it to the card inside each step: the same answer as 'device'."""
    import repro_torch.core as T

    kw = dict(strategy="vertical", scatter="kernel", backend=backend, stream="off",
              device=cuda_device)
    spec = T.sssp(0)
    host = T.PMVEngine.from_store(disk_stores[False], **kw)
    matrix = host.prepare(spec)[0]
    leaves = [matrix["stripe"].gat_local] if backend == "torch" else \
        [bk.cols for bk in matrix["planned"].buckets]
    assert all(t.device.type == "cpu" and t.is_pinned() for t in leaves)
    dev = T.PMVEngine(None, store=disk_stores[False], residency="device", **kw)
    np.testing.assert_array_equal(host.run(spec, max_iters=DISK_ITERS, tol=0.0).v,
                                  dev.run(T.sssp(0), max_iters=DISK_ITERS, tol=0.0).v)


# (name, spec maker, symmetrized store, scatter, kernel launched)
HYBRID_DISK_CASES = [
    ("sssp-kernel", lambda T: T.sssp(0), False, "kernel", "scatter_combine"),
    ("pagerank-segment", lambda T: T.pagerank(DISK_N), False, "segment", None),
    ("cc-kernel", lambda T: T.connected_components(), True, "kernel", "scatter_combine"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", HYBRID_DISK_CASES, ids=[c[0] for c in HYBRID_DISK_CASES])
def test_cuda_hybrid_disk_matches_resident(cuda_device, disk_stores, case):
    """strategy='hybrid' under residency='disk' on the card, both legs'
    pipelines live (each with its own pinned slots and side stream): over
    several iterations the result equals the resident hybrid backend='torch'
    engine's (plus_times to rtol 1e-5), kernel 3 launches once an iteration
    under scatter='kernel', and the peak device memory stays below the
    resident engine's."""
    import repro_torch.core as T

    name, mk, sym, scatter, kernel = case
    kw = dict(strategy="hybrid", theta=DISK_THETA, scatter=scatter, device=cuda_device)
    resident, peak_resident = _disk_solve(
        T.PMVEngine(disk_stores["edges"], DISK_N, b=DISK_B, symmetrize=sym, backend="torch",
                    **kw), mk(T))
    eng = T.PMVEngine(None, store=disk_stores[sym], residency="disk", **kw)
    spec = mk(T)
    ex = eng.prepare(spec)[-1]["executor"]
    before = kernels.launch_counts()
    disk, peak_disk = _disk_solve(eng, spec)
    after = kernels.launch_counts()
    _assert_same_answer(disk.v, resident.v, name)
    if kernel is not None:
        assert after[kernel] - before[kernel] == DISK_ITERS
    assert len(ex.legs) == 2 and all(leg.pipeline is not None for leg in ex.legs)
    for store in (leg.store for leg in ex.legs):
        assert all(t.is_pinned() for slot in store._staging.slots for t in slot.values()
                   if t is not None)
        assert store.device_buffer_bytes > 0 and not store.prefetch_degraded
        assert store.stats.blocks_fetched > 0
    rec = disk.per_iter[-1]
    assert rec["store_blocks_fetched"] + rec["store_blocks_skipped"] == 2 * DISK_B
    assert rec["store_h2d_s"] > 0
    assert peak_disk < peak_resident, (peak_disk, peak_resident)
    ex.close()


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["sparse_vertical", "dense_horizontal"])
def test_cuda_hybrid_disk_slow_fetch_leaves_no_torn_slice(cuda_device, disk_stores,
                                                          monkeypatch, leg):
    """Every other fetch of one hybrid leg sleeps before it reads, so that
    leg's pinned buffers turn over at uneven times while the other leg runs
    at full speed: SSSP and CC stay those of the unslowed run, exactly."""
    import time

    import repro_torch.core as T
    from repro_torch.store import DiskBlockStore

    def solve(sym, spec):
        eng = T.PMVEngine(None, store=disk_stores[sym], residency="disk", strategy="hybrid",
                          theta=DISK_THETA, scatter="kernel", device=cuda_device)
        return eng.run(spec, max_iters=DISK_ITERS, tol=0.0)

    want = {name: solve(sym, mk(T)).v for name, mk, sym in (
        ("sssp", lambda T: T.sssp(0), False), ("cc", lambda T: T.connected_components(), True))}
    read = DiskBlockStore._read
    calls = []

    def slow_read(self, k, *args):
        if self.striping == leg:
            calls.append(k)
            if len(calls) % 2:
                time.sleep(0.02)
        return read(self, k, *args)

    monkeypatch.setattr(DiskBlockStore, "_read", slow_read)
    np.testing.assert_array_equal(solve(False, T.sssp(0)).v, want["sssp"])
    np.testing.assert_array_equal(solve(True, T.connected_components()).v, want["cc"])
    assert len(calls) >= 2 * DISK_ITERS


@pytest.mark.cuda
def test_cuda_disk_serve_matches_resident_serve(cuda_device, disk_stores):
    """PMVServer(store=..., residency='disk', strategy='hybrid',
    scatter='kernel') on the card: 16 SSSP queries in one Q = 16 batch
    (kernel 6 launches) answer exactly as the resident serve does, with the
    same iteration counts, 8 RWR queries of 10 iterations agree with the
    resident serve's to rtol 1e-4 (the resident one sums on the ELL and dense
    kernels), and the peak device memory stays below the resident serve's."""
    import repro_torch.serving as TS

    edges = disk_stores["edges"]
    sources = np.flatnonzero(np.bincount(edges[:, 0], minlength=DISK_N))[:16]
    queries = [TS.Query("sssp", source=int(s), tol=0.5) for s in sources]
    queries += [TS.Query("rwr", source=int(s), tol=0.0, max_iters=10) for s in sources[:8]]
    kw = dict(strategy="hybrid", theta=DISK_THETA, scatter="kernel", backend="auto",
              stream="off", buckets=(16,), device=cuda_device)

    def serve(srv):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts()
        out = srv.serve([TS.Query(q.spec_kind, source=q.source, tol=q.tol,
                                  max_iters=q.max_iters) for q in queries])
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        srv.close()
        return out, torch.cuda.max_memory_allocated(), \
            after["scatter_combine_multi"] - before["scatter_combine_multi"]

    resident, peak_resident, _ = serve(TS.PMVServer(edges, DISK_N, b=DISK_B, **kw))
    disk, peak_disk, launches = serve(TS.PMVServer(store=disk_stores[False], residency="disk",
                                                   **kw))
    assert launches > 0
    for got, want in zip(disk, resident):
        assert got.reason == want.reason == "completed"
        assert got.iterations == want.iterations
        if got.query.spec_kind == "sssp":
            np.testing.assert_array_equal(got.vector, want.vector)
        else:
            np.testing.assert_allclose(got.vector, want.vector, rtol=1e-4, atol=1e-9)
    assert peak_disk < peak_resident, (peak_disk, peak_resident)


# ---------------------------------------------------------------------------
# The bucket-streamed planned executor (stream='on') on the card.
# ---------------------------------------------------------------------------

def _step_peak(T, eng, spec):
    """Peak device bytes of one placement step above what was allocated
    before it (the resident matrix and the state), after a warm-up step."""
    matrix, v, ctx, mask, meta = eng.prepare(spec)
    T.placement_call(spec, meta["cfg"], matrix, v, ctx, mask)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = T.placement_call(spec, meta["cfg"], matrix, v, ctx, mask)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak, meta


@pytest.mark.cuda
def test_cuda_streamed_step_cuts_peak_bytes_4x(cuda_device):
    """The JAX package's memory contract (tests/test_memory_profile.py) on
    the card: PageRank, vertical, b = 32 on erdos_renyi(4096, 8192, seed=5):
    the streamed step's peak bytes above resident are at least 4x lower
    than the fused step's."""
    import repro_torch.core as T
    from repro_torch.graph import erdos_renyi

    edges = erdos_renyi(4096, 8192, seed=5)
    peaks = {}
    for stream in ("off", "on"):
        eng = T.PMVEngine(edges, 4096, b=32, strategy="vertical", backend="auto",
                          stream=stream, device=cuda_device)
        peaks[stream], meta = _step_peak(T, eng, T.pagerank(4096))
        assert meta["plan"].stream == stream
        del eng
    assert meta["plan"].memory_profile()["savings"] >= 4.0
    assert peaks["off"] >= 4 * peaks["on"] > 0, peaks


def _max_plus_spec(T):
    return T.GimvSpec(name="maxplus", combine2="add", combine_all="max", dtype=np.float32,
                      assign=lambda v, r, ctx: torch.maximum(v, r),
                      init=lambda ids, ctx: np.zeros(ids.shape, np.float32))


# (strategy, exchange, scatter kernel that must launch: single, Q-wide)
STREAM_PATHS = {
    "vertical-sparse": ("vertical", "sparse", "scatter_combine", "scatter_combine_multi"),
    "vertical-packed": ("vertical", "packed", "packed_scatter_combine",
                        "packed_scatter_combine_multi"),
    "hybrid-sparse": ("hybrid", "sparse", "scatter_combine", "scatter_combine_multi"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [None, 5], ids=["single", "q5"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("path", sorted(STREAM_PATHS))
def test_cuda_streamed_step_matches_fused(cuda_device, path, semiring, nq):
    """One streamed step against the fused step on the card, on the
    tactic-mix graph (skip, ell and dense blocks): the streamed step
    launches the ELL kernel per (block, bucket), the dense kernel per dense
    (worker, block) (kernel 2 or 4) and the path's receive fold (kernels 3,
    6, 7 or 8); the selection semirings and int32 give the fused step's
    bits, plus_times lies within rtol 1e-5 (the per-block ELL tables may
    take other kernel paths)."""
    import repro_torch.core as T

    strategy, exchange, fold, fold_multi = STREAM_PATHS[path]
    spec = {"plus_times": lambda: T.pagerank(64), "min_plus": lambda: T.sssp(0),
            "max_plus": lambda: _max_plus_spec(T),
            "min_src": T.connected_components}[semiring]()
    out, launched = {}, {}
    for stream in ("off", "on"):
        rng = np.random.default_rng(3)
        eng = T.PMVEngine(tactic_mix_edges(), 64, b=4, strategy=strategy, theta=40.0,
                          backend="auto", exchange=exchange, scatter="kernel", stream=stream,
                          device=cuda_device)
        matrix, _v, ctx, mask, meta = eng.prepare(spec)
        assert meta["plan"].stream == stream and meta["plan"].tactic_counts()["dense"] > 0
        shape = (4, meta["part"].n_local) + ((nq,) if nq else ())
        if np.dtype(spec.dtype) == np.int32:
            v = rng.integers(0, 64, shape).astype(np.int32)
        else:
            v = rng.random(shape).astype(np.float32)
        before = kernels.launch_counts()
        o, r, stats = T.placement_call(spec, meta["cfg"], matrix, torch.from_numpy(v).to(
            cuda_device), ctx, mask)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        launched[stream] = {k: after[k] - before[k] for k in after}
        out[stream] = (o.cpu(), r.cpu(), float(stats["logical_elems"]))
    got = launched["on"]
    multi = nq is not None
    assert got["ell_gimv_multi" if multi else "ell_gimv"] > 0
    assert got[fold_multi if multi else fold] == 1
    assert got["dense_gimv_multi" if multi else "dense_gimv"] > 0
    assert got["ell_gimv" if multi else "ell_gimv_multi"] == 0
    for (a, b_) in zip(out["on"][:2], out["off"][:2]):
        if semiring == "plus_times":
            torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-7)
        else:
            assert torch.equal(a, b_)
    if semiring != "plus_times":
        assert out["on"][2] == out["off"][2]


# ---------------------------------------------------------------------------
# Observability (repro_torch.obs) on the card.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_fence_makes_a_span_cover_queued_device_work(cuda_device):
    """Recorder.fence synchronizes the devices of the tensors it is given, so
    a span that fences covers the device work queued inside it; the null
    recorder's fence is the identity, and a span around the same queued
    work ends long before the device does."""
    from repro_torch.obs import NULL_RECORDER, Recorder

    x = torch.zeros(4, device=cuda_device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(200_000_000)
    end.record()
    end.synchronize()
    sleep_s = start.elapsed_time(end) / 1e3
    assert sleep_s > 0.02
    rec = Recorder()
    for name, fence in (("fenced", rec.fence), ("unfenced", NULL_RECORDER.fence)):
        torch.cuda.synchronize()
        with rec.span(name):
            torch.cuda._sleep(200_000_000)
            y = (x + 1, {"v": [x * 2, None]})
            assert fence(y) is y
        torch.cuda.synchronize()
    dur = {e["name"]: e["dur"] for e in rec.events}
    assert dur["fenced"] >= 0.8 * sleep_s, (dur, sleep_s)
    assert dur["unfenced"] < 0.5 * sleep_s, (dur, sleep_s)
    assert rec.fence(torch.ones(2)).device.type == "cpu"


OBS_PATHS = {
    "vertical": dict(strategy="vertical", scatter="kernel", stream="off"),
    "stream": dict(strategy="vertical", scatter="kernel", stream="on"),
    "packed": dict(strategy="vertical", exchange="packed", scatter="kernel"),
    "hybrid": dict(strategy="hybrid", theta=40.0, stream="off"),
    "horizontal": dict(strategy="horizontal"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("path", sorted(OBS_PATHS))
def test_cuda_engine_obs_onoff_bitwise(cuda_device, path, semiring):
    """PMVEngine(backend='auto') on the tactic-mix graph with the recorder
    on and off: the same kernels launch and the answers and deltas are
    bitwise equal (a fence only waits); every iteration has its span."""
    import repro_torch.core as T
    from repro_torch.obs import Recorder, check_span_nesting

    make = {"plus_times": lambda: T.pagerank(64), "min_plus": lambda: T.sssp(0),
            "max_plus": lambda: _max_plus_spec(T),
            "min_src": T.connected_components}[semiring]
    out = {}
    for obs in (None, Recorder()):
        eng = T.PMVEngine(tactic_mix_edges(), 64, b=4, backend="auto", obs=obs,
                          symmetrize=semiring == "min_src", device=cuda_device,
                          **OBS_PATHS[path])
        spec = make()
        eng.prepare(spec)
        before = kernels.launch_counts()
        res = eng.run(spec, max_iters=6, tol=0.0)
        after = kernels.launch_counts()
        out[obs is None] = (res, {k: after[k] - before[k] for k in after})
        if obs is not None:
            assert len(obs.spans("pmv.iteration")) == 6
            assert {e["name"] for e in obs.events} >= {"prepare.plan", "prepare.device_put"}
            check_span_nesting(obs.to_chrome_trace())
    (off, l_off), (on, l_on) = out[True], out[False]
    assert l_off == l_on and sum(l_on.values()) > 0
    np.testing.assert_array_equal(off.v, on.v)
    np.testing.assert_array_equal(off.deltas, on.deltas)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
def test_cuda_disk_obs_onoff_bitwise(cuda_device, disk_stores, strategy):
    """residency='disk' on the card with the recorder on: bitwise the
    untraced run, a fenced launch.disk_block span per fetched block, and the
    store counters bill every read (the consumed slices plus the pending
    prefetch of each leg)."""
    import repro_torch.core as T
    from repro_torch.obs import Recorder, check_span_nesting

    kw = dict(strategy=strategy, scatter="kernel", theta=DISK_THETA, device=cuda_device)
    out = {}
    for obs in (None, Recorder()):
        eng = T.PMVEngine(None, store=disk_stores[False], residency="disk", obs=obs, **kw)
        spec = T.sssp(0)
        res = eng.run(spec, max_iters=DISK_ITERS, tol=0.0)
        ex = eng.prepare(spec)[-1]["executor"]
        pending = sum(float(leg.pipeline._fut[1].result()[0]["nbytes"])
                      for leg in ex.legs if leg.pipeline is not None and leg.pipeline._fut)
        out[obs is None] = res
        ex.close()
        if obs is not None:
            assert len(obs.spans("launch.disk_block")) == res.totals["store_blocks_fetched"]
            assert obs.counter("store.bytes_read").value == \
                res.totals["store_bytes_read"] + pending
            check_span_nesting(obs.to_chrome_trace())
    np.testing.assert_array_equal(out[True].v, out[False].v)
    np.testing.assert_array_equal(out[True].deltas, out[False].deltas)


# ---------------------------------------------------------------------------
# The fault-tolerance layer on the card: chaos plans through the pinned
# staging, checkpoint / resume, the bf16 wire, the overflow fallback.

def _chaos_events(F, with_break):
    events = (F.CorruptFetch(block=2, array="seg"), F.CorruptFetch(block=5, array="gat"),
              F.TransientIO(block=3, times=2), F.SlowFetch(block=6, delay_s=0.02),
              F.KillAtIteration(iteration=2))
    return events + ((F.BreakPrefetch(),) if with_break else ())


@pytest.mark.cuda
@pytest.mark.parametrize("with_break", [False, True], ids=["prefetch", "sync"])
@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
def test_cuda_disk_chaos_resume_bitwise(cuda_device, disk_stores, strategy, with_break,
                                        tmp_path):
    """A recoverable plan on the card's disk path: a corrupt slice read into
    a pinned slot fails its checksum and the retry takes the other slot
    (after that slot's last copy completed), transient I/O errors and a
    straggler are absorbed, and the run killed at iteration 2 and resumed on
    the same engine is bitwise the clean card run; every fault fired."""
    import repro_torch.core as T
    import repro_torch.faults as F

    kw = dict(strategy=strategy, scatter="kernel", theta=DISK_THETA, device=cuda_device)
    clean = T.PMVEngine(None, store=disk_stores[False], residency="disk", **kw).run(
        T.sssp(0), max_iters=DISK_ITERS, tol=0.0)
    plan = F.FaultPlan(events=_chaos_events(F, with_break), seed=3)
    eng = T.PMVEngine(None, store=disk_stores[False], residency="disk", faults=plan,
                      io_retry=F.RetryPolicy(base_delay_s=1e-4), obs=True, **kw)
    spec = T.sssp(0)
    ck = str(tmp_path / "ck")
    with pytest.raises(F.InjectedKill):
        eng.run(spec, max_iters=DISK_ITERS, tol=0.0, checkpoint_dir=ck, checkpoint_every=1)
    res = eng.run(spec, max_iters=DISK_ITERS, tol=0.0, checkpoint_dir=ck, checkpoint_every=1,
                  resume=True)
    eng.prepare(spec)[-1]["executor"].close()
    np.testing.assert_array_equal(res.v, clean.v)
    assert eng._fault_injector.remaining == 0
    assert eng.obs.counter("store.verify_failures").value == 2
    assert eng.obs.counter("fault.recovered").value == 3
    assert eng.obs.counter("store.prefetch_degraded").value == int(with_break)


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["sparse", "packed"])
@pytest.mark.parametrize("algo", ["pagerank", "sssp"])
def test_cuda_bf16_wire_and_resume(cuda_device, algo, exchange, tmp_path):
    """payload_dtype='bfloat16' on the card's planned path (the kernels
    fold the values cast back to float32): the answer equals the CPU bf16
    run's (SSSP exactly, PageRank within rtol 1e-5), the payload bytes are
    half the float32 wire's, and a run checkpointed, stopped and resumed
    on the same engine is bitwise the uninterrupted one."""
    import repro_torch.core as T

    edges = tactic_mix_edges()
    mk = (lambda: T.pagerank(64)) if algo == "pagerank" else (lambda: T.sssp(0))
    kw = dict(strategy="vertical", backend="auto", scatter="kernel", exchange=exchange)
    card = T.PMVEngine(edges, 64, b=4, payload_dtype="bfloat16", device=cuda_device, **kw)
    spec = mk()
    full = card.run(spec, max_iters=8, tol=0.0)
    ck = str(tmp_path / "ck")
    card.run(spec, max_iters=4, tol=0.0, checkpoint_dir=ck, checkpoint_every=2)
    resumed = card.run(spec, max_iters=8, tol=0.0, checkpoint_dir=ck, resume=True)
    np.testing.assert_array_equal(resumed.v, full.v)
    cpu = T.PMVEngine(edges, 64, b=4, payload_dtype="bfloat16", device="cpu", **kw).run(
        mk(), max_iters=8, tol=0.0)
    f32 = T.PMVEngine(edges, 64, b=4, device=cuda_device, **kw).run(mk(), max_iters=8, tol=0.0)
    _assert_same_answer(full.v, cpu.v, algo)
    assert full.per_iter[0]["exchange_payload_bytes"] * 2 == \
        f32.per_iter[0]["exchange_payload_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,label", [("vertical", "dense"),
                                            ("hybrid", "structural_capacity")])
def test_cuda_model_capacity_overflow_falls_back(cuda_device, strategy, label):
    """capacity='model' too tight on the card's planned path: the overflow
    is counted by the compaction the kernel path runs, the engine retries on
    its fallback and answers as the structural engine does."""
    import repro_torch.core as T
    from repro_torch.graph import star_graph

    n = 64
    kw = dict(strategy=strategy, theta=1e9, backend="auto", scatter="kernel",
              device=cuda_device)
    res = T.PMVEngine(star_graph(n), n, b=4, capacity="model", slack=0.01, **kw).run(
        T.sssp(0), max_iters=10, tol=0.5)
    ref = T.PMVEngine(star_graph(n), n, b=4, **kw).run(T.sssp(0), max_iters=10, tol=0.5)
    assert res.totals["fallback"] == label
    np.testing.assert_array_equal(res.v, ref.v)


# ---------------------------------------------------------------------------
# The per-block launch profiler and live telemetry on the card.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
def test_cuda_profiler_launches_both_kernels(cuda_device, strategy, semiring):
    """profile_block_launches on the tactic-mix graph on the card: every
    non-skip block gets its ``launch.ell`` or ``launch.dense`` spans (both
    kinds present), each block's first launch goes through kernels 1 and 2
    and equals their plain versions on the same tables and operand (the
    selection semirings and int32 exactly, plus_times within rtol 1e-5),
    and the spans' block set is the CPU engine's."""
    import repro_torch.core as T
    from repro_torch.obs import calibration_summary, profile_block_launches

    make = {"plus_times": lambda: T.pagerank(64), "min_plus": lambda: T.sssp(0),
            "max_plus": lambda: _max_plus_spec(T),
            "min_src": T.connected_components}[semiring]
    kw = dict(strategy=strategy, theta=40.0, backend="auto", stream="off",
              symmetrize=semiring == "min_src")
    eng = T.PMVEngine(tactic_mix_edges(), 64, b=4, device=cuda_device, **kw)
    spec = make()
    dtype = np.dtype(spec.dtype)
    checked = {"launch.ell": 0, "launch.dense": 0}

    def inspect(rec):
        assert rec["v"].is_cuda and rec["v"].dtype == spec.torch_dtype
        if rec["name"] == "launch.dense":
            want = block_gimv.dense_gimv_ref(rec["operands"], rec["v"], semiring=semiring)
            _assert_match(rec["out"], want, semiring, dtype)
        else:
            for (cols, w), out in zip(rec["operands"], rec["out"]):
                want = ell_spmv.ell_gimv_ref(cols, w if spec.needs_weights else None,
                                             rec["v"], semiring=semiring)
                _assert_match(out, want, semiring, dtype)
        checked[rec["name"]] += 1

    eng.prepare(spec)
    before = kernels.launch_counts()
    rec = profile_block_launches(eng, spec, repeats=2, inspect=inspect)
    after = kernels.launch_counts()
    assert checked["launch.ell"] > 0 and checked["launch.dense"] > 0
    assert after["ell_gimv"] > before["ell_gimv"]
    assert after["dense_gimv"] == before["dense_gimv"] + 3 * checked["launch.dense"]
    cal = calibration_summary(rec)
    assert cal["ell"]["launches"] == 2 * checked["launch.ell"]
    assert cal["dense"]["launches"] == 2 * checked["launch.dense"]
    assert all(c["measured_s"] > 0.0 for c in cal.values())
    cpu = T.PMVEngine(tactic_mix_edges(), 64, b=4, device="cpu", **kw)
    blocks = lambda r: sorted((e["name"], e["attrs"]["i"], e["attrs"]["j"])  # noqa: E731
                              for e in r.spans("launch."))
    assert blocks(rec) == blocks(profile_block_launches(cpu, make(), repeats=2))


@pytest.mark.cuda
def test_cuda_server_telemetry_scrape(cuda_device):
    """A CUDA serve with telemetry on: the exporter answers over HTTP while
    the server lives, the retired count and the SLO events equal the
    queries served, the answers are bitwise the serve with telemetry off,
    and close() stops the exporter."""
    import urllib.request

    from repro_torch.graph import rmat
    from repro_torch.obs import TelemetryConfig
    from repro_torch.serving import PMVServer, Query

    edges = rmat(10, 8 << 10, seed=4)
    queries = [Query("sssp", source=s, tol=0.5) for s in range(0, 24, 3)]
    kw = dict(b=4, strategy="vertical", backend="auto", scatter="kernel", buckets=(8,),
              device=cuda_device)
    srv = PMVServer(edges, 1 << 10, telemetry=TelemetryConfig(latency_target_s=60.0), **kw)
    try:
        on = srv.serve(queries)
        with urllib.request.urlopen(srv.telemetry.url + "/metrics", timeout=10) as resp:
            body = resp.read().decode()
        assert f"pmv_serve_retired_total {float(len(queries))}" in body
        assert srv.stats()["slo"]["latency"]["total"]["events"] == len(queries)
    finally:
        srv.close()
    assert srv.telemetry.url is None
    off_srv = PMVServer(edges, 1 << 10, **kw)
    off = off_srv.serve(queries)
    off_srv.close()
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.vector, b.vector)
        assert a.iterations == b.iterations


@pytest.mark.cuda
def test_cuda_spmd_two_gloo_ranks_equal_emulation(cuda_device):
    """Two gloo ranks sharing cuda:0 (``tests/_torch_spmd.py``), each running
    the kernels on the card on its own worker's rows and gloo moving the
    card's tensors: PMVEngine(mesh=...) at b = 2 equals the emulated b = 2
    engine on the card (SSSP and CC bitwise, PageRank within rtol 1e-5) on
    horizontal, vertical (sparse, packed) and hybrid."""
    import _torch_spmd as S
    from repro_torch.core import PMVEngine, connected_components, pagerank, sssp

    n = 64
    edges = tactic_mix_edges(n, 2)
    cases = [("sssp", "vertical", "sparse"), ("sssp", "vertical", "packed"),
             ("sssp", "hybrid", "sparse"), ("pagerank", "horizontal", "sparse"),
             ("pagerank", "vertical", "sparse"), ("cc", "hybrid", "sparse")]
    run = {"sssp": dict(max_iters=100, tol=0.5), "cc": dict(max_iters=100, tol=0.5),
           "pagerank": dict(max_iters=20, tol=0.0)}
    ranks = S.run("engine_cases", 2, dict(
        mesh=((2,), ("workers",)), axis_name="workers", edges=edges, n=n, b=2, device="cuda",
        cases=[dict(algo=a, run=run[a], strategy=st, exchange=ex, theta=40.0, backend="auto",
                    scatter="kernel") for a, st, ex in cases]), timeout=300)
    specs = {"sssp": lambda: sssp(0), "pagerank": lambda: pagerank(n),
             "cc": connected_components}
    for i, (algo, strategy, exchange) in enumerate(cases):
        want = PMVEngine(edges, n, b=2, strategy=strategy, exchange=exchange, theta=40.0,
                         backend="auto", scatter="kernel", symmetrize=algo == "cc",
                         device=cuda_device).run(specs[algo](), **run[algo])
        for r in ranks:
            got = r[i]["v"]
            if algo == "pagerank":
                np.testing.assert_allclose(got, want.v, rtol=1e-5, atol=1e-8)
            else:
                np.testing.assert_array_equal(got, want.v)
                assert r[i]["iterations"] == want.iterations
