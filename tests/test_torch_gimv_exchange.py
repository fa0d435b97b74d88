"""GIM-V ops and the compact sparse exchange of the PyTorch port against the
JAX package, on the same numpy inputs.  Compaction and scatter must be equal
element for element, with and without a trailing query axis."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gimv as jgimv
from repro.core import sparse_exchange as jx
from repro.core.algorithms import connected_components as j_cc
from repro.core.algorithms import pagerank as j_pr
from repro.core.algorithms import sssp as j_sssp
from repro_torch.core import gimv as tgimv
from repro_torch.core import sparse_exchange as tx
from repro_torch.core.algorithms import connected_components as t_cc
from repro_torch.core.algorithms import pagerank as t_pr
from repro_torch.core.algorithms import sssp as t_sssp


def _max_spec(mod):
    return mod.GimvSpec(name="maxplus", combine2="add", combine_all="max", dtype=np.float32,
                        assign=None, init=None)


# (JAX spec, port spec) per semiring
SPECS = {
    "plus_times": (j_pr(50), t_pr(50)),
    "min_plus": (j_sssp(0), t_sssp(0)),
    "max_plus": (_max_spec(jgimv), _max_spec(tgimv)),
    "min_src": (j_cc(), t_cc()),
}


def _values(rng, spec, shape, *, sparsity=0.0):
    if np.dtype(spec.dtype) == np.int32:
        x = rng.integers(0, 1000, shape).astype(np.int32)
    else:
        x = rng.random(shape).astype(np.float32)
    if sparsity:
        x = np.where(rng.random(shape) < sparsity, np.asarray(spec.identity, x.dtype), x)
    return x


def _eq(got, want, exact=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("semiring", list(SPECS))
def test_gimv_ops_match_jax(semiring):
    jspec, tspec = SPECS[semiring]
    exact = semiring != "plus_times"
    rng = np.random.default_rng(1)
    assert jspec.identity == tspec.identity
    m = rng.random(40).astype(np.float32)
    vj = _values(rng, jspec, 40)
    _eq(tgimv.combine2(tspec, torch.from_numpy(m), torch.from_numpy(vj)),
        jgimv.combine2(jspec, jnp.asarray(m), jnp.asarray(vj)))
    seg = rng.integers(0, 9, 40).astype(np.int32)
    _eq(tgimv.segment_combine(tspec, torch.from_numpy(vj), torch.from_numpy(seg), 12),
        jgimv.segment_combine(jspec, jnp.asarray(vj), jnp.asarray(seg), 12), exact)
    base = _values(rng, jspec, 10)
    idx = rng.integers(-13, 14, 40).astype(np.int32)     # negatives wrap, out of range drops
    _eq(tgimv.scatter_combine(tspec, torch.from_numpy(base), torch.from_numpy(idx),
                              torch.from_numpy(vj)),
        jgimv.scatter_combine(jspec, jnp.asarray(base), jnp.asarray(idx), jnp.asarray(vj)), exact)
    parts = [_values(rng, jspec, 17) for _ in range(7)]
    for k in range(1, 8):
        # the same pairwise association order: bitwise equal even for sums
        _eq(tgimv.tree_combine(tspec, [torch.from_numpy(p) for p in parts[:k]]),
            jgimv.tree_combine(jspec, [jnp.asarray(p) for p in parts[:k]]))
    a, b = (_values(rng, jspec, (3, 5)) for _ in range(2))
    _eq(tgimv.combine_elementwise(tspec, torch.from_numpy(a), torch.from_numpy(b)),
        jgimv.combine_elementwise(jspec, jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("semiring", list(SPECS))
def test_default_delta_matches_jax(semiring):
    jspec, tspec = SPECS[semiring]
    rng = np.random.default_rng(2)
    v, w = _values(rng, jspec, (4, 30)), _values(rng, jspec, (4, 30))
    w[:, ::3] = v[:, ::3]
    got = float(tspec.default_delta(torch.from_numpy(v), torch.from_numpy(w)))
    want = float(jspec.default_delta(jnp.asarray(v), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("semiring", list(SPECS))
@pytest.mark.parametrize("shape,capacity", [((4, 4, 30), 30), ((2, 2, 50), 9),
                                            ((3, 3, 1), 1), ((2, 4, 64), 64)])
def test_compaction_and_scatter_equal_jax(semiring, shape, capacity):
    jspec, tspec = SPECS[semiring]
    rng = np.random.default_rng(hash((semiring, shape)) % 2**31)
    partials = _values(rng, jspec, shape, sparsity=0.6)
    n_local = shape[-1]
    j_idx, j_val, j_over, j_log = jx.compact_partials(jspec, jnp.asarray(partials), capacity, None)
    t_idx, t_val, t_over, t_log = tx.compact_partials(tspec, torch.from_numpy(partials), capacity)
    _eq(t_idx, j_idx)
    _eq(t_val, j_val)
    assert float(t_over) == float(j_over) and float(t_log) == float(j_log)
    assert float(tx.count_non_identity(tspec, torch.from_numpy(partials))) == float(
        jx.count_non_identity(jspec, jnp.asarray(partials)))
    # receive side: the exchanged buffers [receiver, sender, cap]
    j_rx = (jnp.swapaxes(j_idx, 0, 1), jnp.swapaxes(j_val, 0, 1))
    t_rx = (t_idx.transpose(0, 1).contiguous(), t_val.transpose(0, 1).contiguous())
    want = jx.scatter_partials(jspec, *j_rx, n_local, method="segment")
    for method in ("segment", "kernel"):
        _eq(tx.scatter_partials(tspec, *t_rx, n_local, method=method), want)
    chunk = tx.compact_chunk(tspec, torch.from_numpy(partials[0, 0]), capacity)
    _eq(chunk[0], j_idx[0, 0])


def test_wire_bytes_match_jax():
    for b, cap, item in ((8, 100, 4), (2, 1, 4), (4, 33, 2)):
        assert tx.exchange_wire_bytes(b, cap, None, item) == jx.exchange_wire_bytes(b, cap, None, item)
        assert tx.exchange_wire_split(b, cap, None, item) == jx.exchange_wire_split(b, cap, None, item)


@pytest.mark.parametrize("semiring", list(SPECS))
@pytest.mark.parametrize("shape,capacity", [((4, 4, 30, 3), 30), ((2, 2, 50, 8), 9),
                                            ((3, 3, 1, 1), 1), ((2, 4, 64, 5), 64)])
def test_batched_compaction_and_scatter_equal_jax(semiring, shape, capacity):
    """A trailing query axis: one index set per partial row (any column not
    the identity), Q values per kept index.  idx, val and both counters equal
    the JAX package's; column 0 is all identity (a padded serving column) and
    rows where every column is the identity compact to nothing."""
    jspec, tspec = SPECS[semiring]
    rng = np.random.default_rng(zlib.crc32(repr((semiring, shape)).encode()))
    partials = _values(rng, jspec, shape, sparsity=0.7)
    partials[..., 0] = np.asarray(jspec.identity, partials.dtype)
    partials[:, :, ::4, :] = np.asarray(jspec.identity, partials.dtype)
    n_local = shape[-2]
    j_idx, j_val, j_over, j_log = jx.compact_partials(jspec, jnp.asarray(partials), capacity,
                                                      None, batched=True)
    t_idx, t_val, t_over, t_log = tx.compact_partials(tspec, torch.from_numpy(partials),
                                                      capacity, batched=True)
    _eq(t_idx, j_idx)
    _eq(t_val, j_val)
    assert float(t_over) == float(j_over) and float(t_log) == float(j_log)
    j_rx = (jnp.swapaxes(j_idx, 0, 1), jnp.swapaxes(j_val, 0, 1))
    t_rx = (t_idx.transpose(0, 1).contiguous(), t_val.transpose(0, 1).contiguous())
    for method in ("segment", "kernel"):
        want = jx.scatter_partials(jspec, *j_rx, n_local, method=method, interpret=True)
        _eq(tx.scatter_partials(tspec, *t_rx, n_local, method=method), want,
            exact=semiring != "plus_times")


def test_batched_compaction_overflow_counts_rows():
    """overflow counts partial rows past the capacity, not row x query pairs."""
    jspec, tspec = SPECS["min_plus"]
    partials = np.zeros((2, 6, 4), np.float32)
    partials[1, :, 2] = np.inf                       # row 1 keeps 5 of 6 entries
    j = jx.compact_partials(jspec, jnp.asarray(partials), 3, None, batched=True)
    t = tx.compact_partials(tspec, torch.from_numpy(partials), 3, batched=True)
    assert float(t[2]) == float(j[2]) == 2.0
    assert float(t[3]) == float(j[3]) == float((partials != np.inf).sum())
    _eq(t[0], j[0])


def test_batched_wire_bytes_match_jax():
    for b, cap, nq, item in ((8, 100, 64, 4), (2, 1, 3, 4), (4, 33, 16, 2)):
        assert tx.exchange_wire_bytes(b, cap, nq, item) == jx.exchange_wire_bytes(b, cap, nq, item)
        assert tx.exchange_wire_split(b, cap, nq, item) == jx.exchange_wire_split(b, cap, nq, item)


@pytest.mark.parametrize("semiring", list(SPECS))
def test_gimv_ops_with_query_axis_match_jax(semiring):
    """segment_combine, combine_elementwise and tree_combine on [..., Q]
    operands, as the batched placements call them."""
    jspec, tspec = SPECS[semiring]
    exact = semiring != "plus_times"
    rng = np.random.default_rng(zlib.crc32(semiring.encode()))
    x = _values(rng, jspec, (40, 3))
    seg = rng.integers(0, 9, 40).astype(np.int32)
    _eq(tgimv.segment_combine(tspec, torch.from_numpy(x), torch.from_numpy(seg), 12),
        jgimv.segment_combine(jspec, jnp.asarray(x), jnp.asarray(seg), 12), exact)
    parts = [_values(rng, jspec, (2, 17, 3)) for _ in range(5)]
    for k in (1, 2, 5):
        _eq(tgimv.tree_combine(tspec, [torch.from_numpy(p) for p in parts[:k]]),
            jgimv.tree_combine(jspec, [jnp.asarray(p) for p in parts[:k]]))
    _eq(tgimv.combine_elementwise(tspec, torch.from_numpy(parts[0]), torch.from_numpy(parts[1])),
        jgimv.combine_elementwise(jspec, jnp.asarray(parts[0]), jnp.asarray(parts[1])))
