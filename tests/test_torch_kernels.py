"""Kernel parity of the PyTorch port: each plain version (what a kernel
wrapper runs on a CPU tensor) against the JAX package's Pallas kernel in
interpret mode, for the four semirings x float32 / int32, on the same numpy
inputs.  Exact for the selection semirings and for int32; plus_times float
sums are allclose (rtol 1e-5, atol 1e-6) because the summation order
differs.  test_torch_cuda.py holds the Hopper kernels against the plain
versions on a GPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_gimv import dense_gimv as jax_dense_gimv
from repro.kernels.ell_spmv import ell_from_edges as jax_ell_from_edges
from repro.kernels.ell_spmv import ell_gimv as jax_ell_gimv
from repro.kernels.scatter_combine import scatter_combine_gimv as jax_scatter
from repro_torch import kernels
from repro_torch.kernels import block_gimv, ell_spmv, scatter_combine

SEMIRINGS = ["plus_times", "min_plus", "max_plus", "min_src"]
DTYPES = [np.float32, np.int32]


def _assert_match(got, want, semiring, dtype):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if semiring == "plus_times" and dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _ell_inputs(rng, rows, width, n_src, dtype, with_w):
    deg = rng.integers(0, width + 1, rows)
    cols = np.full((rows, width), -1, np.int32)
    for r in range(rows):
        cols[r, :deg[r]] = rng.integers(0, n_src, deg[r])
    # weights are small integers for int32 values so float->int32 is exact
    w = None
    if with_w:
        w = (rng.integers(1, 4, (rows, width)) if dtype == np.int32
             else rng.random((rows, width))).astype(np.float32)
    v = (rng.integers(-50, 50, n_src) if dtype == np.int32 else rng.random(n_src)).astype(dtype)
    return cols, w, v


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("shape", [(37, 5, 50), (130, 33, 200), (1, 1, 1)])
def test_ell_plain_matches_jax_kernel(semiring, dtype, shape):
    rows, width, n_src = shape
    rng = np.random.default_rng(hash((semiring, shape, np.dtype(dtype).name)) % 2**31)
    cols, w, v = _ell_inputs(rng, rows, width, n_src, dtype, semiring != "min_src")
    want = jax_ell_gimv(jnp.asarray(cols), None if w is None else jnp.asarray(w),
                        jnp.asarray(v), semiring=semiring, interpret=True)
    got = ell_spmv.ell_gimv(torch.from_numpy(cols), None if w is None else torch.from_numpy(w),
                            torch.from_numpy(v), semiring=semiring)
    _assert_match(got.numpy(), want, semiring, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_ell_plain_without_weights_matches_jax_kernel(semiring, dtype):
    rng = np.random.default_rng(7)
    cols, _, v = _ell_inputs(rng, 64, 9, 80, dtype, False)
    want = jax_ell_gimv(jnp.asarray(cols), None, jnp.asarray(v), semiring=semiring,
                        interpret=True)
    got = ell_spmv.ell_gimv(torch.from_numpy(cols), None, torch.from_numpy(v), semiring=semiring)
    _assert_match(got.numpy(), want, semiring, dtype)


def _dense_inputs(rng, semiring, shape, dtype):
    m_rows, k = shape
    if semiring == "min_src":
        m = (rng.random((m_rows, k)) > 0.7).astype(np.float32)
    elif dtype == np.int32:
        m = rng.integers(-3, 4, (m_rows, k)).astype(np.float32)
    else:
        m = rng.random((m_rows, k)).astype(np.float32)
    v = (rng.integers(-50, 50, k) if dtype == np.int32 else rng.random(k)).astype(dtype)
    return m, v


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("shape", [(128, 128), (100, 200), (1, 1), (129, 257)])
def test_dense_plain_matches_jax_kernel(semiring, dtype, shape):
    rng = np.random.default_rng(hash(("dense", semiring, shape)) % 2**31)
    m, v = _dense_inputs(rng, semiring, shape, dtype)
    want = jax_dense_gimv(jnp.asarray(m), jnp.asarray(v), semiring=semiring, interpret=True)
    got = block_gimv.dense_gimv(torch.from_numpy(m), torch.from_numpy(v), semiring=semiring)
    _assert_match(got.numpy(), want, semiring, dtype)


def _compacted(rng, sets, senders, cap, n_local):
    """Receive buffers in the compact-exchange layout: each (s, k) row holds
    strictly ascending unique indices padded with n_local."""
    idx = np.full((sets, senders, cap), n_local, np.int32)
    for s in range(sets):
        for k in range(senders):
            cnt = int(rng.integers(0, min(cap, n_local) + 1))
            idx[s, k, :cnt] = np.sort(rng.choice(n_local, cnt, replace=False))
    return idx


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("shape", [(4, 4, 7, 20), (2, 3, 16, 16), (1, 1, 1, 1)])
def test_scatter_plain_matches_jax_kernel(semiring, dtype, shape):
    """The JAX kernel takes the flat (n_local + 1)-per-set layout that
    sparse_exchange.scatter_partials builds; the port takes [S, B, cap]."""
    sets, senders, cap, n_local = shape
    rng = np.random.default_rng(hash(("scatter", semiring, shape)) % 2**31)
    idx = _compacted(rng, sets, senders, cap, n_local)
    val = (rng.integers(-50, 50, idx.shape) if dtype == np.int32
           else rng.random(idx.shape)).astype(dtype)
    flat = (idx.reshape(sets, -1) + np.arange(sets)[:, None] * (n_local + 1)).reshape(-1)
    want = jax_scatter(jnp.asarray(flat), jnp.asarray(val.reshape(-1)), sets * (n_local + 1),
                       semiring=semiring, interpret=True)
    want = np.asarray(want).reshape(sets, n_local + 1)[:, :n_local]
    got = scatter_combine.scatter_combine_gimv(torch.from_numpy(idx), torch.from_numpy(val),
                                               n_local, semiring=semiring)
    _assert_match(got.numpy(), want, semiring, dtype)


def test_scatter_plain_accepts_any_index():
    """The plain version drops any index outside [0, n_local), unsorted or not."""
    idx = torch.tensor([[[3, -1, 3, 9, 0]]], dtype=torch.int32)
    val = torch.tensor([[[1.0, 5.0, 2.0, 7.0, 4.0]]])
    got = scatter_combine.scatter_combine_ref(idx, val, 4, semiring="plus_times")
    np.testing.assert_array_equal(got.numpy(), [[4.0, 0.0, 0.0, 3.0]])


def test_ell_from_edges_matches_jax_package():
    rng = np.random.default_rng(3)
    dst = rng.integers(0, 30, 200)
    src = rng.integers(0, 50, 200)
    w = rng.random(200).astype(np.float32)
    for d_cap in (None, 40):
        c1, w1 = jax_ell_from_edges(dst, src, w, 30, d_cap=d_cap)
        c2, w2 = ell_spmv.ell_from_edges(dst, src, w, 30, d_cap=d_cap)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(w1, w2)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    kernels.reset_launch_counts()
    cols = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    v = torch.tensor([2.0, 3.0])
    assert ell_spmv.ell_gimv(cols, None, v, semiring="plus_times").tolist() == [5.0]
    m = torch.ones(2, 2)
    assert block_gimv.dense_gimv(m, v, semiring="plus_times").tolist() == [5.0, 5.0]
    idx = torch.tensor([[[0, 2]]], dtype=torch.int32)
    assert scatter_combine.scatter_combine_gimv(
        idx, torch.tensor([[[1.0, 9.0]]]), 2, semiring="min_plus").tolist() == [[1.0, float("inf")]]
    words = torch.tensor([0x22012210], dtype=torch.uint32)  # ids 0,1,2,2 | 1,0,2,2 at width 4
    assert scatter_combine.packed_scatter_combine_gimv(
        words, torch.tensor([1.0, 2, 4, 8, 16, 32, 64, 128]), 3, set_slots=8, n_local=2,
        width=4, semiring="plus_times", senders=2).tolist() == [33.0, 18.0, 0.0]
    assert kernels.launch_counts() == {"ell_gimv": 0, "dense_gimv": 0, "scatter_combine": 0,
                                       "ell_gimv_multi": 0, "dense_gimv_multi": 0,
                                       "scatter_combine_multi": 0, "packed_scatter_combine": 0,
                                       "packed_scatter_combine_multi": 0}


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "semiring", "contiguous"])
def test_wrappers_check_arguments(case):
    cols = torch.zeros((4, 3), dtype=torch.int32)
    v = torch.zeros(5)
    w = torch.zeros((4, 3))
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            ell_spmv.ell_gimv(cols.long(), w, v, semiring="plus_times")
        elif case == "shape":
            ell_spmv.ell_gimv(cols, torch.zeros((4, 2)), v, semiring="plus_times")
        elif case == "device":
            ell_spmv.ell_gimv(cols.to("meta"), w, v, semiring="plus_times")
        elif case == "semiring":
            block_gimv.dense_gimv(torch.zeros((2, 5)), v, semiring="tropical")
        else:
            scatter_combine.scatter_combine_gimv(
                torch.zeros((2, 3, 4), dtype=torch.int32).transpose(0, 1),
                torch.zeros((3, 2, 4)), 4, semiring="plus_times")
