"""The layout the sparse scatter-combine kernels rely on, held on what the
port's compaction (``sparse_exchange.compact_partials``) produces, and the
tile decomposition of the Q-wide scatter kernels emulated on the CPU.

``csrc/scatter_combine_multi.cu`` finds, per sender row, the slots whose
indices fall in its output tile by a search of the row; that needs every
compacted row strictly ascending below ``n_local`` and followed only by the
sentinel ``n_local``.  The layout is checked on the rows the engine and the
server actually compact (single-vector and ``batched=True``, one index set
per row kept where any of the Q columns is not the identity) on the fuzz
topologies of ``test_fuzz_parity``, an RMAT graph and one served family's
steps, and on random partials at random capacities.

The emulation folds per output tile (``csrc/scatter_tile.cuh``): the tile
rows the kernels take (for Q columns on the Q-wide kernels, the
single-vector ones' own at Q = 1), per sender the range of slots found by
``searchsorted`` (the upper bound only within a tile's rows of the lower
one, as the kernels do), folded sender by sender.  It must give the
bits of the plain versions of kernels 6 and 8 for every semiring, int32
included, at Q = 1, 5, 64 and 67, and of kernels 3 and 7 at n_local
around their tile edges.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_fuzz_parity import TOPOLOGIES, _fuzz_edges
from test_torch_packed_layout import _assert_sorted_then_sentinel

import repro_torch.core as T
from repro.graph import rmat
from repro_torch.core import sparse_exchange
from repro_torch.exchange import codec
from repro_torch.kernels import _common
from repro_torch.kernels.scatter_combine import ref as sc_ref
from repro_torch.serving import PMVServer, Query


@pytest.fixture
def compacted(monkeypatch):
    """Every (partials, idx, val, batched) that compact_partials returns while
    the fixture is active."""
    seen = []
    real = sparse_exchange.compact_partials

    def record(spec, partials, capacity, axis=None, *, batched=False):
        out = real(spec, partials, capacity, axis, batched=batched)
        seen.append((spec, partials, out[0], out[1], batched))
        return out
    monkeypatch.setattr(sparse_exchange, "compact_partials", record)
    return seen


def _check_compacted(seen, what: str) -> int:
    """Each recorded idx: the layout, and exactly the first ``cap`` indices
    of its row whose partial is not the identity (in any of the Q columns
    for a batched row), with their values."""
    assert seen, f"{what}: nothing was compacted"
    for spec, partials, idx, val, batched in seen:
        n_local = partials.shape[-2 if batched else -1]
        idx_np = idx.numpy()
        _assert_sorted_then_sentinel(idx_np, n_local, what)
        valid = (partials != spec.identity)
        valid = valid.any(dim=-1) if batched else valid
        cap = idx.shape[-1]
        rows = valid.reshape(-1, n_local).numpy()
        flat_idx = idx_np.reshape(rows.shape[0], cap)
        for r in range(rows.shape[0]):
            want = np.flatnonzero(rows[r])[:cap]
            np.testing.assert_array_equal(flat_idx[r, :len(want)], want)
            assert np.all(flat_idx[r, len(want):] == n_local)
        taken = idx < n_local
        safe = torch.where(taken, idx, 0).to(torch.int64)
        if batched:
            nq = partials.shape[-1]
            got = torch.gather(partials, -2, safe[..., None].expand(*safe.shape, nq))
            assert torch.equal(val[taken], got[taken])
        else:
            assert torch.equal(val[taken], torch.gather(partials, -1, safe)[taken])
    return len(seen)


@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_compacted_rows_on_fuzz_topologies(compacted, topology, b, strategy):
    n = b * 11
    edges = _fuzz_edges(topology, n, b, np.random.default_rng(len(topology) * 10 + b))
    eng = T.PMVEngine(edges, n, b=b, strategy=strategy, theta=3.0, backend="auto",
                      scatter="kernel", stream="off", device="cpu")
    eng.run(T.sssp(0), max_iters=4, tol=-1.0)
    _check_compacted(compacted, f"{topology} b={b} {strategy}")


@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
def test_compacted_rows_on_rmat(compacted, strategy):
    eng = T.PMVEngine(rmat(9, 4000, seed=4), 512, b=4, strategy=strategy, theta=40.0,
                      backend="auto", scatter="kernel", stream="off", device="cpu")
    eng.run(T.pagerank(512), max_iters=3, tol=-1.0)
    eng.run(T.sssp(0), max_iters=3, tol=-1.0)
    _check_compacted(compacted, f"rmat {strategy}")


def test_batched_compacted_rows_on_a_served_family(compacted):
    """A served RWR family's batched steps: one index set per row, any over
    the 8 query columns."""
    edges = rmat(9, 4000, seed=4)
    srv = PMVServer(edges, 512, b=4, strategy="hybrid", theta=40.0, backend="auto",
                    scatter="kernel", stream="off", device="cpu", buckets=(8,), max_iters=6)
    srv.serve([Query("rwr", source=s, c=0.85, tol=1e-6) for s in range(1, 12)])
    assert all(batched and partials.shape[-1] == 8 for _, partials, _, _, batched in compacted)
    assert _check_compacted(compacted, "served rwr") >= 6


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_compacted_rows_on_random_partials(data):
    """Random partials (a random share of identities, a random Q or none)
    at a random capacity, overflowing ones included."""
    n_local = data.draw(st.integers(1, 70))
    b = data.draw(st.integers(1, 4))
    nq = data.draw(st.sampled_from([None, 1, 3, 8]))
    share = data.draw(st.sampled_from([0.0, 0.3, 0.8, 1.0]))
    cap = data.draw(st.integers(0, n_local + 2))
    seed = data.draw(st.integers(0, 2**16))
    rng = np.random.default_rng(seed)
    spec = T.sssp(0)
    shape = (b, b, n_local) + (() if nq is None else (nq,))
    part = rng.random(shape).astype(np.float32)
    part[rng.random(shape) < share] = np.inf
    seen = []
    real = sparse_exchange.compact_partials(spec, torch.from_numpy(part), cap,
                                            batched=nq is not None)
    seen.append((spec, torch.from_numpy(part), real[0], real[1], nq is not None))
    _check_compacted(seen, "random partials")


# ---------------------------------------------------------------------------
# the tile fold of kernels 3, 6, 7 and 8, emulated

_HEADER = (Path(sc_ref.__file__).resolve().parents[1] / "csrc" / "scatter_tile.cuh").read_text()


def _header_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _HEADER).group(1))


TILE_BYTES, SLAB, MAX_ROWS = (_header_int(n) for n in ("kTileBytes", "kSlabCols", "kMaxTileRows"))
SCALAR_ROWS = _header_int("kScalarTileRows")


def tile_rows_for(nq: int) -> int:
    return min(MAX_ROWS, TILE_BYTES // (min(nq, SLAB) * 4))


def tile_fold(ids: np.ndarray, val: torch.Tensor, *, n_sets: int, n_local: int, seg_w: int,
              n_out: int, semiring: str, rows: int | None = None) -> torch.Tensor:
    """ids [S, B, p] sender rows (ascending below n_local, then n_local or
    more); val [S, B, p, Q] -> [n_out, Q] with output row i of set s at
    s * seg_w + i, folded tile by tile as the kernels fold: tiles of
    ``rows`` output rows (the Q-wide kernels' for Q by default)."""
    nq = val.shape[-1]
    rows = rows or tile_rows_for(nq)
    op = {"plus_times": torch.add, "min_plus": torch.minimum, "max_plus": torch.maximum,
          "min_src": torch.minimum}[semiring]
    ident = _common.identity(semiring, val.dtype)
    out = torch.full((n_out, nq), 7, dtype=val.dtype)      # every row must be written
    grid_sets = -(-n_out // seg_w)
    for s in range(grid_sets):
        for i0 in range(0, seg_w, rows):
            n_here = min(rows, seg_w - i0)
            tile = torch.full((n_here, nq), ident, dtype=val.dtype)
            if s < n_sets and i0 < n_local:
                span = min(rows, n_local - i0)
                for k in range(ids.shape[1]):
                    row = ids[s, k]
                    lo = int(np.searchsorted(row, i0, side="left"))
                    top = min(len(row), lo + span)
                    hi = lo + int(np.searchsorted(row[lo:top], i0 + span, side="left"))
                    t = torch.from_numpy(row[lo:hi] - i0)
                    tile[t] = op(tile[t], val[s, k, lo:hi])
            o0 = s * seg_w + i0
            keep = max(0, min(n_here, n_out - o0))
            out[o0:o0 + keep] = tile[:keep]
    return out


def _tile_rows_case(rng, n_local: int, sets: int, senders: int, negative: bool = False):
    """Sender rows crossing the tile edges below n_local: rows empty, full,
    the two ends of the id domain, and random (``negative``: the random
    rows start with ids below 0)."""
    per = 32 // codec.device_width(n_local)
    p = -(-min(600, n_local) // per) * per
    ids = np.full((sets, senders, p), n_local, np.int64)
    for s in range(sets):
        for k in range(senders):
            kind = (s + k) % 4
            if kind == 1:
                row = np.sort(rng.choice(n_local, min(p, n_local), replace=False))
            elif kind == 2:
                row = np.array([0, n_local - 1])
            elif kind == 3:
                cnt = int(rng.integers(1, min(p, n_local)))
                row = np.unique(np.r_[rng.choice(n_local, cnt, replace=False),
                                      [0, n_local - 1], [-40, -3] if negative else []])[:p]
            else:
                continue
            ids[s, k, :len(row)] = row
    return ids, n_local


SWEEP = [("plus_times", np.float32), ("min_plus", np.float32), ("max_plus", np.float32),
         ("min_src", np.float32), ("min_src", np.int32)]


@pytest.mark.parametrize("semiring,dtype", SWEEP, ids=[f"{s}-{np.dtype(d).name}"
                                                       for s, d in SWEEP])
@pytest.mark.parametrize("nq", [1, 5, 64, 67])
@pytest.mark.parametrize("kernel", ["scatter_combine_multi", "packed_scatter_combine_multi"])
def test_tile_fold_equals_plain_versions(kernel, nq, semiring, dtype):
    rng = np.random.default_rng(nq * 31 + len(semiring))
    sets, senders = 3, 4
    ids, n_local = _tile_rows_case(rng, 2 * tile_rows_for(nq) + 3, sets, senders)
    shape = ids.shape + (nq,)
    x = (rng.integers(-50, 50, shape) if dtype == np.int32 else rng.random(shape)).astype(dtype)
    x[np.broadcast_to((ids >= n_local)[..., None], shape)] = _common.identity(
        semiring, torch.float32 if dtype == np.float32 else torch.int32)
    val = torch.from_numpy(x)
    if kernel == "scatter_combine_multi":
        want = sc_ref.scatter_combine_multi_ref(torch.from_numpy(ids.astype(np.int32)), val,
                                                n_local, semiring=semiring)
        got = tile_fold(ids, val, n_sets=sets, n_local=n_local, seg_w=n_local,
                        n_out=sets * n_local, semiring=semiring)
        assert torch.equal(got, want.reshape(-1, nq))
        return
    width = codec.device_width(n_local)
    words = torch.from_numpy(codec.pack_uniform(ids, width).reshape(-1))
    full = sets * (n_local + 1)
    for n_out in (full, full - (n_local + 1) - n_local // 2, full + 700):
        want = sc_ref.packed_scatter_combine_multi_ref(
            words, val.reshape(-1, nq), n_out, set_slots=senders * ids.shape[-1],
            n_local=n_local, width=width, semiring=semiring)
        got = tile_fold(ids, val, n_sets=sets, n_local=n_local, seg_w=n_local + 1,
                        n_out=n_out, semiring=semiring)
        assert torch.equal(got, want)


def test_tile_fold_covers_every_output_tile():
    """The emulation's tile rows are the kernels' (128 at Q >= 64 float
    columns, 8192 / Q below, at most 4096), and its rows cross them."""
    assert [tile_rows_for(q) for q in (1, 4, 5, 64, 67, 130)] == [4096, 2048, 1638, 128,
                                                                  128, 128]
    ids, n_local = _tile_rows_case(np.random.default_rng(0), 2 * tile_rows_for(64) + 3, 2, 4)
    assert n_local == 259 and (ids == n_local - 1).any() and (ids[..., 0] == 0).any()


@pytest.mark.parametrize("semiring,dtype", SWEEP, ids=[f"{s}-{np.dtype(d).name}"
                                                       for s, d in SWEEP])
@pytest.mark.parametrize("senders", [4, 9])
@pytest.mark.parametrize("tiles,extra", [(1, -1), (1, 0), (1, 1), (2, 1)],
                         ids=["R-1", "R", "R+1", "2R+1"])
@pytest.mark.parametrize("kernel", ["scatter_combine", "packed_scatter_combine"])
def test_scalar_tile_fold_equals_plain_versions(kernel, tiles, extra, senders, semiring, dtype):
    """Kernels 3 and 7: the Q = 1 fold with its own tile rows R at n_local
    around R's edges, 4 and 9 senders; kernel 3's rows also start below 0."""
    rng = np.random.default_rng(tiles * 1000 + extra * 10 + senders + len(semiring))
    sets = 3
    sparse = kernel == "scatter_combine"
    ids, n_local = _tile_rows_case(rng, tiles * SCALAR_ROWS + extra, sets, senders,
                                   negative=sparse)
    x = (rng.integers(-50, 50, ids.shape) if dtype == np.int32 else rng.random(ids.shape))
    x = x.astype(dtype)
    x[ids >= n_local] = _common.identity(
        semiring, torch.float32 if dtype == np.float32 else torch.int32)
    val = torch.from_numpy(x)
    fold = dict(n_sets=sets, n_local=n_local, semiring=semiring, rows=SCALAR_ROWS)
    if sparse:
        assert (ids < 0).any()
        want = sc_ref.scatter_combine_ref(torch.from_numpy(ids.astype(np.int32)), val, n_local,
                                          semiring=semiring)
        got = tile_fold(ids, val[..., None], seg_w=n_local, n_out=sets * n_local, **fold)
        assert torch.equal(got[:, 0], want.reshape(-1))
        return
    width = codec.device_width(n_local)
    words = torch.from_numpy(codec.pack_uniform(ids, width).reshape(-1))
    full = sets * (n_local + 1)
    for n_out in (full, full - (n_local + 1) - n_local // 2, full + 700):
        want = sc_ref.packed_scatter_combine_ref(
            words, val.reshape(-1), n_out, set_slots=senders * ids.shape[-1], n_local=n_local,
            width=width, semiring=semiring)
        got = tile_fold(ids, val[..., None], seg_w=n_local + 1, n_out=n_out, **fold)
        assert torch.equal(got[:, 0], want)
