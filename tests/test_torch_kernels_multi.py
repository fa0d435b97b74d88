"""Multi-query kernel parity of the PyTorch port: the plain version of each
Q-wide kernel (what its wrapper runs on a CPU tensor) against the JAX
package's ``_multi`` op with its Pallas kernel in interpret mode, for the
four semirings x float32 / int32 and Q in {1, 3, 8, 64} (3 fits no TPU
tile), on shapes with tails past the TPU tiles and on the same numpy inputs.
Column 0 of every vector block is all identity (a padded or retired serving
column) and the selection semirings also see +-inf entries.  Exact for the
selection semirings and for int32; plus_times float sums are allclose (rtol
1e-5, atol 1e-6) because the summation order differs.  test_torch_cuda.py
holds the Hopper kernels against the plain versions on a GPU."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_gimv import dense_gimv_multi as jax_dense_multi
from repro.kernels.ell_spmv import ell_gimv_multi as jax_ell_multi
from repro.kernels.scatter_combine import scatter_combine_gimv_multi as jax_scatter_multi
from repro_torch import kernels
from repro_torch.kernels import block_gimv, ell_spmv, scatter_combine

SEMIRINGS = ["plus_times", "min_plus", "max_plus", "min_src"]
DTYPES = [np.float32, np.int32]
QS = [1, 3, 8, 64]
_IDENT = {"plus_times": 0, "min_plus": "max", "max_plus": "min", "min_src": "max"}


def _rng(*parts):
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def _identity(semiring, dtype):
    kind = _IDENT[semiring]
    if kind == 0:
        return dtype(0)
    if np.dtype(dtype) == np.float32:
        return np.float32(np.inf if kind == "max" else -np.inf)
    info = np.iinfo(np.int32)
    return np.int32(info.max if kind == "max" else info.min)


def _block(rng, shape, semiring, dtype):
    """[rows, Q] values: column 0 all identity; +-inf entries (float32) for
    the selection semirings, as unreached SSSP vertices are."""
    x = (rng.integers(-50, 50, shape) if dtype == np.int32 else rng.random(shape)).astype(dtype)
    x[:, 0] = _identity(semiring, dtype)
    if dtype == np.float32 and semiring != "plus_times":
        x[rng.random(shape) < 0.2] = _identity(semiring, dtype)
    return x


def _assert_match(got, want, semiring, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    if semiring == "plus_times" and dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _ell_inputs(rng, rows, width, n_src, nq, semiring, dtype, with_w):
    deg = rng.integers(0, width + 1, rows)
    cols = np.where(np.arange(width)[None, :] < deg[:, None],
                    rng.integers(0, n_src, (rows, width)), -1).astype(np.int32)
    w = None
    if with_w:   # small integers for int32 values so float -> int32 is exact
        w = (rng.integers(1, 4, (rows, width)) if dtype == np.int32
             else rng.random((rows, width))).astype(np.float32)
    return cols, w, _block(rng, (n_src, nq), semiring, dtype)


@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_ell_multi_plain_matches_jax_kernel(semiring, dtype, nq):
    rng = _rng("ell", semiring, nq)
    cols, w, v = _ell_inputs(rng, 131, 9, 70, nq, semiring, dtype, semiring != "min_src")
    want = jax_ell_multi(jnp.asarray(cols), None if w is None else jnp.asarray(w),
                         jnp.asarray(v), semiring=semiring, interpret=True)
    got = ell_spmv.ell_gimv_multi(torch.from_numpy(cols),
                                  None if w is None else torch.from_numpy(w),
                                  torch.from_numpy(v), semiring=semiring)
    _assert_match(got.numpy(), want, semiring, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_ell_multi_plain_without_weights_matches_jax_kernel(semiring, dtype):
    rng = np.random.default_rng(5)
    cols, _, v = _ell_inputs(rng, 40, 130, 60, 3, semiring, dtype, False)
    want = jax_ell_multi(jnp.asarray(cols), None, jnp.asarray(v), semiring=semiring,
                         interpret=True)
    got = ell_spmv.ell_gimv_multi(torch.from_numpy(cols), None, torch.from_numpy(v),
                                  semiring=semiring)
    _assert_match(got.numpy(), want, semiring, dtype)


def test_ell_multi_plain_equals_single_per_column():
    """Each column of the Q-wide plain version is the single-vector one, also
    when the rows run in several chunks (min_plus: exact, whatever the
    reduction order)."""
    rng = np.random.default_rng(9)
    cols, w, v = _ell_inputs(rng, 50, 7, 30, 5, "min_plus", np.float32, True)
    cols_t, w_t, v_t = (torch.from_numpy(a) for a in (cols, w, v))
    chunk = ell_spmv.ref._CHUNK_ELEMS
    try:
        ell_spmv.ref._CHUNK_ELEMS = 7 * 5 * 3         # 3 rows per chunk
        got = ell_spmv.ell_gimv_multi_ref(cols_t, w_t, v_t, semiring="min_plus")
    finally:
        ell_spmv.ref._CHUNK_ELEMS = chunk
    for q in range(5):
        want = ell_spmv.ell_gimv_ref(cols_t, w_t, v_t[:, q].contiguous(), semiring="min_plus")
        assert torch.equal(got[:, q], want)


def _dense_inputs(rng, semiring, shape, nq, dtype):
    m_rows, k = shape
    if semiring == "min_src":
        m = (rng.random((m_rows, k)) > 0.7).astype(np.float32)
    elif dtype == np.int32:
        m = rng.integers(-3, 4, (m_rows, k)).astype(np.float32)
    else:
        m = rng.random((m_rows, k)).astype(np.float32)
    if semiring in ("min_plus", "max_plus"):
        # the materialized dense region's fill for absent edges
        m[rng.random((m_rows, k)) < 0.5] = np.inf if semiring == "min_plus" else -np.inf
    return m, _block(rng, (k, nq), semiring, dtype)


@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_dense_multi_plain_matches_jax_kernel(semiring, dtype, nq):
    rng = _rng("dense", semiring, nq)
    m, v = _dense_inputs(rng, semiring, (131, 140), nq, dtype)
    want = jax_dense_multi(jnp.asarray(m), jnp.asarray(v), semiring=semiring, interpret=True)
    got = block_gimv.dense_gimv_multi(torch.from_numpy(m), torch.from_numpy(v),
                                      semiring=semiring)
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


@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_scatter_multi_plain_matches_jax_kernel(semiring, dtype, nq):
    """The JAX kernel takes the flat (n_local + 1)-per-set layout that
    sparse_exchange.scatter_partials builds; the port takes [S, B, cap]."""
    sets, senders, cap, n_local = 3, 4, 11, 30
    rng = _rng("scatter", semiring, nq)
    idx = _compacted(rng, sets, senders, cap, n_local)
    val = _block(rng, (sets * senders * cap, nq), semiring, dtype)
    flat = (idx.reshape(sets, -1) + np.arange(sets)[:, None] * (n_local + 1)).reshape(-1)
    want = jax_scatter_multi(jnp.asarray(flat), jnp.asarray(val), sets * (n_local + 1),
                             semiring=semiring, interpret=True)
    want = np.asarray(want).reshape(sets, n_local + 1, nq)[:, :n_local]
    got = scatter_combine.scatter_combine_gimv_multi(
        torch.from_numpy(idx), torch.from_numpy(val.reshape(idx.shape + (nq,))), n_local,
        semiring=semiring)
    _assert_match(got.numpy(), want, semiring, dtype)


def test_cpu_multi_wrappers_run_plain_versions_and_count_nothing():
    kernels.reset_launch_counts()
    cols = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    v = torch.tensor([[2.0, 1.0], [3.0, 5.0]])
    assert ell_spmv.ell_gimv_multi(cols, None, v, semiring="plus_times").tolist() == [[5.0, 6.0]]
    assert block_gimv.dense_gimv_multi(torch.ones(1, 2), v, semiring="min_plus").tolist() == \
        [[3.0, 2.0]]
    idx = torch.tensor([[[0, 2]]], dtype=torch.int32)
    val = torch.tensor([[[[1.0, 4.0], [9.0, 9.0]]]])
    assert scatter_combine.scatter_combine_gimv_multi(idx, val, 2, semiring="min_plus").tolist() \
        == [[[1.0, 4.0], [float("inf"), float("inf")]]]
    assert all(c == 0 for c in kernels.launch_counts().values())


@pytest.mark.parametrize("case", ["v_ndim", "w_shape", "dense_k", "scatter_shape", "contiguous"])
def test_multi_wrappers_check_arguments(case):
    cols = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if case == "v_ndim":
            ell_spmv.ell_gimv_multi(cols, None, torch.zeros(5), semiring="plus_times")
        elif case == "w_shape":
            ell_spmv.ell_gimv_multi(cols, torch.zeros((4, 2)), torch.zeros((5, 2)),
                                    semiring="plus_times")
        elif case == "dense_k":
            block_gimv.dense_gimv_multi(torch.zeros((2, 5)), torch.zeros((4, 3)),
                                        semiring="min_plus")
        elif case == "scatter_shape":
            scatter_combine.scatter_combine_gimv_multi(
                torch.zeros((2, 3, 4), dtype=torch.int32), torch.zeros((2, 3, 5, 2)), 4,
                semiring="plus_times")
        else:
            ell_spmv.ell_gimv_multi(cols, None, torch.zeros((2, 5)).t(), semiring="plus_times")


# ---------------------------------------------------------------------------
# The 3xTF32 method of the Hopper kernel's plus_times path
# (csrc/dense_gimv_multi.cu), emulated in plain torch here only: each operand
# splits into big = rna(x) and small = rna(x - big), rna rounding float32 to
# TF32 (10 mantissa bits) to nearest with ties away from zero, and the
# product sums small_a*big_v + big_a*small_v + big_a*big_v (small*small left
# out) in float32, one fresh partial per 32 k added in k order, as the
# kernel adds its per-tile partials.  Products of TF32 parts are exact in
# float32, so what differs from a float32 dot is the dropped small*small
# term (~2^-22 of a product) and the summation order.  Not modelled: the
# tensor cores truncate as they accumulate inside a 32-k tile, where each
# partial here is a torch float32 matmul that rounds to nearest.  So these
# tests hold the split, the dropped term and the per-tile partials, not the
# card's in-tile rounding: that is held on the card only (test_torch_cuda.py
# and the chip smoke, at the same tolerance).

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _dense_3xtf32(m: np.ndarray, v: np.ndarray, tile: int = 32) -> np.ndarray:
    a, b = torch.from_numpy(m), torch.from_numpy(v)
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], tile):
        ks = slice(k0, k0 + tile)
        acc += (a_small[:, ks] @ b_big[ks] + a_big[:, ks] @ b_small[ks]) + a_big[:, ks] @ b_big[ks]
    return acc.numpy()


def _rwr_like(rng, rows, k, nq, signed):
    """A dense region's row-stochastic weights (90% zero) times RWR-scale
    columns (each sums to 1 in absolute value); ``signed`` flips a random
    half of both."""
    m = rng.random((rows, k))
    m[rng.random((rows, k)) < 0.9] = 0
    m /= np.maximum(m.sum(axis=1, keepdims=True), 1e-30)
    v = rng.random((k, nq)) ** 4
    v /= v.sum(axis=0, keepdims=True)
    if signed:
        m *= np.where(rng.random(m.shape) < 0.5, -1.0, 1.0)
        v *= np.where(rng.random(v.shape) < 0.5, -1.0, 1.0)
    return m.astype(np.float32), v.astype(np.float32)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10   # a TF32 ulp at 1.0
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2.0 ** -23, -(1.0 + one_ulp / 2),
                      1.0 + 1.5 * one_ulp, 3.0e-39, float("inf")], dtype=torch.float32)
    want = [1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 1.0 + 2 * one_ulp]
    got = _tf32_rna(x)
    assert got[:5].tolist() == want
    assert got[6] == float("inf")
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("nq", [5, 64, 67])
@pytest.mark.parametrize("signed", [False, True], ids=["nonneg", "signed"])
def test_dense_multi_3xtf32_method_matches_jax_kernel(signed, nq):
    """The emulated method against the Pallas kernel in interpret mode at 256
    rows and k = 1232, within the chip smoke's plus_times tolerance (rtol
    1e-5, atol 1e-6 * min(1, max|want|)): the method's split, dropped term
    and per-tile partials leave room for the card's check.  The card's
    truncating in-tile accumulation is not emulated, so this does not show
    that the card's result holds."""
    rng = _rng("3xtf32", signed, nq)
    m, v = _rwr_like(rng, 256, 1232, nq, signed)
    want = np.asarray(jax_dense_multi(jnp.asarray(m), jnp.asarray(v), semiring="plus_times",
                                      interpret=True))
    got = _dense_3xtf32(m, v)
    scale = min(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("nq", [5, 64, 67])
def test_dense_multi_3xtf32_method_as_accurate_as_a_float32_dot(nq):
    """Signed unit-scale data (M and V uniform in [-1, 1], outputs up to ~45
    with heavy cancellation): here no float32 sum meets an absolute 1e-6 --
    the Pallas kernel's own result sits ~1.2e-5 from the float64 product.
    So the method is held to that: its largest error against float64 is at
    most twice the Pallas kernel's, and its mean error at most 1.5 times."""
    rng = _rng("3xtf32-unit", nq)
    m = rng.uniform(-1, 1, (256, 1232)).astype(np.float32)
    v = rng.uniform(-1, 1, (1232, nq)).astype(np.float32)
    exact = m.astype(np.float64) @ v.astype(np.float64)
    ref_err = np.abs(np.asarray(jax_dense_multi(jnp.asarray(m), jnp.asarray(v),
                                                semiring="plus_times", interpret=True)) - exact)
    err = np.abs(_dense_3xtf32(m, v) - exact)
    assert err.max() <= 2.0 * ref_err.max(), (err.max(), ref_err.max())
    assert err.mean() <= 1.5 * ref_err.mean(), (err.mean(), ref_err.mean())
