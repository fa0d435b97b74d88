"""The layout the ELL kernels (``csrc/ell_gimv.cu``, ``csrc/ell_gimv_multi.cu``)
rely on, held on every producer of the port's ELL tables.

Both kernels stop reading a row after its first 32-slot chunk that holds a
pad (col < 0).  That is exact only when every row is left-packed: once a
slot is a pad, every later slot of the row is a pad.  This file checks that
on ``ell_from_edges`` (random edge lists with duplicates, empty rows and a
forced ``d_cap``), ``pack_bucketed_ell`` and ``stack_planned``,
``flatten_planned`` in both layouts, the tables ``PMVEngine.prepare`` builds
for horizontal, vertical, hybrid and packed runs on the fuzz topologies of
``test_fuzz_parity`` and a small RMAT graph, and a ``PMVServer`` family.
It also emulates the kernels' read pattern (a warp or a half-warp a row, and a row
split over warps) to show that it folds every valid slot of a left-packed row and
misses the valid slots after a pad chunk in a row that is not, and holds the
smoke's per-bucket timing to refusing such a bucket.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_fuzz_parity import TOPOLOGIES, _fuzz_edges

import repro_torch.core as T
from repro_torch.core import blocks, placement, planner
from repro_torch.graph import rmat
from repro_torch.kernels.ell_spmv import check_left_packed, ell_from_edges, ell_gimv_ref
from repro_torch.serving import PMVServer, Query

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_left_packed(cols, what: str) -> None:
    """cols [..., D]: no valid slot after a pad, and every pad is -1."""
    cols = _np(cols)
    valid = cols >= 0
    assert not np.any(valid[..., 1:] & ~valid[..., :-1]), f"{what}: a valid slot after a pad"
    assert np.all(cols[~valid] == -1), f"{what}: a pad other than -1"


def _read_slots(cols: np.ndarray, warps: int = 1, unroll: int = 1, chunk: int = 32) -> np.ndarray:
    """The slots the kernels read.  Warp k of a row walks chunks k, k +
    warps, ... in groups of ``unroll`` and stops after a group whose last
    chunk holds a pad or reaches the width (its lanes past the width read
    -1): warps=1, unroll=1 is the one-warp path (chunk=16 the Q-wide
    kernel's half-warp path), warps=32 the split path (unroll 4
    single-vector, 1 Q-wide), where one warp first reads chunk 0 and a row
    whose chunk 0 holds a pad is read no further."""
    rows, width = cols.shape
    chunks = -(-width // chunk)
    read = np.zeros(cols.shape, bool)
    for r in range(rows):
        if warps > 1 and bool((cols[r, :chunk] < 0).any()):
            read[r, :chunk] = True
            continue
        for k in range(warps):
            for g in range(k, chunks, warps * unroll):
                group = [g + u * warps for u in range(unroll)]
                for c in group:
                    if c < chunks:
                        read[r, c * chunk:(c + 1) * chunk] = True
                last = group[-1]
                if (last + 1) * chunk >= width or bool(
                        (cols[r, last * chunk:(last + 1) * chunk] < 0).any()):
                    break
    return read


def _random_edges(rng, n_rows: int, n_src: int, n_edges: int):
    """Edges into the first half of the rows only (the rest stay empty), with
    repeated (dst, src) pairs."""
    dst = rng.integers(0, max(1, n_rows // 2), n_edges)
    src = rng.integers(0, n_src, n_edges)
    rep = rng.integers(0, n_edges, n_edges // 4) if n_edges else np.zeros(0, np.int64)
    return np.concatenate([dst, dst[rep]]), np.concatenate([src, src[rep]])


# ---------------------------------------------------------------------------
# The producers, one by one.
# ---------------------------------------------------------------------------


@given(data=st.data())
@settings(max_examples=25, deadline=None)
def test_ell_from_edges_rows_are_left_packed(data):
    """Every row of degree d fills slots 0..d-1 in submission order, its
    weights beside them, and pads the rest, with or without d_cap."""
    n_rows = data.draw(st.integers(1, 90), label="n_rows")
    n_edges = data.draw(st.integers(0, 400), label="n_edges")
    extra = data.draw(st.sampled_from([None, 0, 1, 31, 70]), label="d_cap_extra")
    rng = np.random.default_rng(data.draw(st.integers(0, 10_000), label="seed"))
    dst, src = _random_edges(rng, n_rows, 50, n_edges)
    w = rng.random(len(dst)).astype(np.float32)
    deg = np.bincount(dst, minlength=n_rows)
    d_cap = None if extra is None else max(int(deg.max(initial=0)), 1) + extra
    cols, ww = ell_from_edges(dst, src, w, n_rows, d_cap=d_cap)
    _assert_left_packed(cols, "ell_from_edges")
    np.testing.assert_array_equal((cols >= 0).sum(axis=1), deg)
    for r in range(n_rows):
        np.testing.assert_array_equal(cols[r, :deg[r]], src[dst == r])
        np.testing.assert_array_equal(ww[r, :deg[r]], w[dst == r])


@pytest.mark.parametrize("n_workers", [1, 3])
def test_pack_bucketed_ell_and_stack_planned_are_left_packed(n_workers):
    """Each worker's buckets from pack_bucketed_ell, then the stack that pads
    their row counts with whole all-pad rows."""
    rng = np.random.default_rng(5)
    n_local = 64
    stripes = []
    for wk in range(n_workers):
        deg = rng.zipf(1.6, n_local).clip(max=300) * (rng.random(n_local) < 0.7)
        out_rows = np.repeat(np.arange(n_local), deg)
        cols = rng.integers(0, n_local * 4, len(out_rows))
        w = rng.random(len(out_rows)).astype(np.float32)
        bks = blocks.pack_bucketed_ell(out_rows, cols, w, planner.bucket_boundaries(300))
        for i, bk in enumerate(bks):
            _assert_left_packed(bk.cols, f"worker {wk} bucket {i}")
            np.testing.assert_array_equal((bk.cols >= 0).sum(axis=1), deg[bk.rows])
        stripes.append(blocks.PlannedStripe(buckets=bks, dense=None, rows_out=n_local,
                                            layout="merged"))
    stacked = blocks.stack_planned(stripes, "plus_times")
    assert stacked.buckets
    for i, bk in enumerate(stacked.buckets):
        _assert_left_packed(bk.cols, f"stacked bucket {i}")
        assert np.all(bk.cols[bk.rows < 0] == -1)     # stacking pads are whole pad rows


@pytest.mark.parametrize("layout", ["vertical", "merged"])
def test_flatten_planned_keeps_rows_left_packed(layout):
    """flatten_planned remaps cols in place: each worker's offset on the
    valid slots of 'vertical' tables, -1 kept on the pads."""
    rng = np.random.default_rng(9)
    n_local, n_workers = 40, 4
    stripes = []
    for _ in range(n_workers):
        deg = rng.integers(0, 70, n_local) * (rng.random(n_local) < 0.8)
        out_rows = np.repeat(np.arange(n_local), deg)
        cols = rng.integers(0, n_local, len(out_rows))
        bks = blocks.pack_bucketed_ell(out_rows, cols, None, planner.bucket_boundaries(70))
        stripes.append(blocks.PlannedStripe(buckets=bks, dense=None, rows_out=n_local,
                                            layout=layout))
    stacked = blocks.stack_planned(stripes, "min_plus")
    fp = placement.flatten_planned(stacked, n_local, n_workers, torch.device("cpu"))
    assert len(fp.buckets) == len(stacked.buckets)
    for i, (bk, sb) in enumerate(zip(fp.buckets, stacked.buckets)):
        _assert_left_packed(bk.cols, f"{layout} flat bucket {i}")
        np.testing.assert_array_equal(_np(bk.cols >= 0),
                                      (sb.cols >= 0).reshape(-1, sb.cols.shape[-1]))


BROKEN_ROWS = {
    "valid slot after a pad in the first chunk": [5, -1, 7],
    "valid slot in a later chunk after a pad chunk": [5] * 3 + [-1] * 40 + [9],
    "only the last slot valid": [-1] * 69 + [2],
}


@pytest.mark.parametrize("case", sorted(BROKEN_ROWS))
def test_check_left_packed_refuses_a_broken_row(case):
    """check_left_packed passes left-packed tables (empty, all-pad, full
    rows; no rows; width 1) and refuses one broken row among them."""
    rng = np.random.default_rng(2)
    good = _left_packed_table(rng, [0, 1, 31, 32, 33, 70, 70, 5], 70)
    check_left_packed(torch.from_numpy(good))
    check_left_packed(torch.full((0, 70), -1, dtype=torch.int32))
    check_left_packed(torch.tensor([[3], [-1]], dtype=torch.int32))
    bad = np.full(70, -1, np.int32)
    bad[:len(BROKEN_ROWS[case])] = BROKEN_ROWS[case]
    broken = good.copy()
    broken[4] = bad
    with pytest.raises(ValueError, match="left-packed"):
        check_left_packed(torch.from_numpy(broken))


@pytest.mark.parametrize("layout", ["vertical", "merged"])
def test_flatten_planned_refuses_a_row_that_is_not_left_packed(layout):
    """The engine's tables are checked once where they are built: a stacked
    bucket with a hole in one row is refused by flatten_planned."""
    rng = np.random.default_rng(4)
    n_local, n_workers = 40, 2
    stripes = []
    for _ in range(n_workers):
        deg = rng.integers(1, 70, n_local)
        out_rows = np.repeat(np.arange(n_local), deg)
        cols = rng.integers(0, n_local, len(out_rows))
        bks = blocks.pack_bucketed_ell(out_rows, cols, None, planner.bucket_boundaries(70))
        stripes.append(blocks.PlannedStripe(buckets=bks, dense=None, rows_out=n_local,
                                            layout=layout))
    stacked = blocks.stack_planned(stripes, "min_plus")
    placement.flatten_planned(stacked, n_local, n_workers, torch.device("cpu"))
    bk = max(stacked.buckets, key=lambda x: x.cols.shape[-1])
    wk, r = np.argwhere((bk.cols >= 0).sum(axis=-1) >= 2)[0]
    bk.cols[wk, r, 0] = -1                       # a pad before the row's other valid slots
    with pytest.raises(ValueError, match="left-packed"):
        placement.flatten_planned(stacked, n_local, n_workers, torch.device("cpu"))


# ---------------------------------------------------------------------------
# What the engine and the server hand the kernels.
# ---------------------------------------------------------------------------

RUNS = {
    "horizontal": dict(strategy="horizontal"),
    "vertical": dict(strategy="vertical", scatter="kernel", stream="off"),
    "hybrid": dict(strategy="hybrid", theta=3.0, stream="off"),
    "packed": dict(strategy="vertical", exchange="packed", scatter="kernel", stream="off"),
}


def _engine_buckets(edges, n, b, run):
    eng = PMVEngine(edges, n, b=b, backend="auto", device="cpu", **RUNS[run])
    matrix, _, _, _, meta = eng.prepare(T.pagerank(n))
    assert meta["backend"] == "planned"
    key = "planned_sparse" if meta["strategy"] == "hybrid" else "planned"
    return matrix[key].buckets


PMVEngine = T.PMVEngine


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_tables_are_left_packed_on_fuzz_topologies(run, topology, b):
    n = b * 11
    edges = _fuzz_edges(topology, n, b, np.random.default_rng(len(topology) * 10 + b))
    for i, bk in enumerate(_engine_buckets(edges, n, b, run)):
        _assert_left_packed(bk.cols, f"{run} {topology} b={b} bucket {i}")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_tables_are_left_packed_on_rmat(run):
    bks = _engine_buckets(rmat(8, 8 << 8, seed=4), 1 << 8, 4, run)
    assert bks
    for i, bk in enumerate(bks):
        _assert_left_packed(bk.cols, f"{run} rmat bucket {i}")
        assert bool((bk.cols >= 0).any())


@pytest.mark.parametrize("kind", ["rwr", "sssp"])
def test_server_family_tables_are_left_packed(kind):
    n = 1 << 8
    srv = PMVServer(rmat(8, 8 << 8, seed=4), n, b=4, strategy="hybrid", theta=20.0,
                    backend="auto", scatter="kernel", stream="off", device="cpu")
    eng, fspec = srv.engine_for(Query(kind, source=3))
    matrix, _, _, _, meta = eng.prepare(fspec)
    assert meta["backend"] == "planned" and matrix["planned_sparse"].buckets
    for i, bk in enumerate(matrix["planned_sparse"].buckets):
        _assert_left_packed(bk.cols, f"server {kind} bucket {i}")
    srv.close()


# ---------------------------------------------------------------------------
# The kernels' read pattern, emulated.
# ---------------------------------------------------------------------------

PATHS = {"one warp a row": (1, 1, 32), "half-warp a row, Q-wide": (1, 1, 16),
         "split, single-vector": (32, 4, 32), "split, Q-wide": (32, 1, 32)}


def _left_packed_table(rng, degrees, width):
    deg = np.asarray(degrees)
    cols = np.where(np.arange(width)[None, :] < deg[:, None],
                    rng.integers(0, 500, (len(deg), width)), -1).astype(np.int32)
    return cols


@pytest.mark.parametrize("path", sorted(PATHS))
def test_read_pattern_folds_every_slot_of_left_packed_rows(path):
    """Degrees at the chunk edges (0, 31, 32, 33, 64), a full row and the
    widths of the smoke's widest buckets: every valid slot is read, and the
    fold over the slots read equals the plain version over the whole row."""
    warps, unroll, chunk = PATHS[path]
    rng = np.random.default_rng(3)
    for width in (70, 1025, 4100):
        degrees = [0, 1, 31, 32, 33, 64, width - 1, width] + list(rng.integers(0, width, 6))
        cols = _left_packed_table(rng, degrees, width)
        read = _read_slots(cols, warps, unroll, chunk)
        assert np.all(read[cols >= 0]), (path, width)
        w = rng.random(cols.shape).astype(np.float32)
        v = torch.from_numpy(rng.random(500).astype(np.float32))
        seen = torch.from_numpy(np.where(read, cols, -1).astype(np.int32))
        for semiring in ("min_plus", "max_plus"):
            np.testing.assert_array_equal(
                ell_gimv_ref(seen, torch.from_numpy(w), v, semiring=semiring),
                ell_gimv_ref(torch.from_numpy(cols), torch.from_numpy(w), v, semiring=semiring))
        # a row stops within one group of warps x unroll chunks past its end,
        # and a row shorter than one chunk costs that chunk alone
        for r, d in enumerate(degrees):
            assert read[r].sum() <= max(chunk * -(-int(d) // chunk), chunk) + chunk * warps * unroll
            if d < chunk:
                assert read[r].sum() == chunk


@pytest.mark.parametrize("path", sorted(PATHS))
def test_read_pattern_misses_slots_after_a_pad_chunk(path):
    """The precondition matters: a valid slot after a chunk that holds a pad
    is not read (the header's "loses the slots after its first chunk that
    holds a pad"); a pad inside a chunk with later valid slots is harmless."""
    warps, unroll, chunk = PATHS[path]
    width = 4100
    cols = np.full((2, width), -1, np.int32)
    cols[0, [0, 2, 3]] = 7                       # a hole inside the first chunk
    cols[1, [0, 1]] = 7
    cols[1, width - 3] = 9      # past one round of every warp's first group
    read = _read_slots(cols, warps, unroll, chunk)
    assert np.all(read[0][cols[0] >= 0])
    assert not read[1, width - 3]


def test_smoke_bucket_timing_refuses_a_row_that_is_not_left_packed(monkeypatch):
    """chip_smoke.ell_bucket_times asserts the precondition on every bucket it
    times; on a left-packed one it counts slots, sectors of cols and the
    longest row."""
    monkeypatch.setattr(smoke, "time_ms", lambda torch_, fn, reps, warmup=2: (fn(), 1.0)[1])
    rng = np.random.default_rng(1)
    cols = torch.from_numpy(_left_packed_table(rng, [0, 5, 33, 64], 64))
    bk = placement.FlatBucket(rows=torch.arange(4), cols=cols, w=torch.rand(cols.shape))
    row = {}
    per = smoke.ell_bucket_times(torch, "test", [bk], torch.rand(500), row)
    assert per[0]["nnz"] == 102 and per[0]["longest_row"] == 64
    # each row's cols up to its first pad (min(width, deg + 1) slots) in
    # 32-byte sectors of 8 cols: 1, 6, 34 and 64 slots
    assert per[0]["col_sectors"] == 1 + 1 + 5 + 8
    assert row["iteration_ms"] == 1.0 and row["shape"] == [4, 64]
    assert row["bound_ms"] == per[0]["valid_bound_ms"] < per[0]["layout_bound_ms"]
    smoke.ell_bucket_times(torch, "test", [bk], torch.rand(500, 5), row)
    assert row["shape"] == [4, 64, 5]
    broken = cols.clone()
    broken[0, 40] = 3
    with pytest.raises(smoke.SmokeError, match="left-packed"):
        smoke.ell_bucket_times(torch, "test", [placement.FlatBucket(
            rows=torch.arange(4), cols=broken, w=bk.w)], torch.rand(500), {})
