"""Packed-id scatter-combine parity of the PyTorch port: the plain versions
of the two packed kernels (what their wrappers run on a CPU tensor) against
the JAX package's ``packed_scatter_combine_gimv`` / ``_multi`` with their
Pallas kernels in interpret mode, on the same numpy inputs.

Inputs are laid out as the packed exchange lays them out: S receiving sets
of B sender rows of p slots, each row a sorted unique id set from
[0, n_local) padded with the sentinel n_local, bit-packed at the uniform
width (4, 8, 16 or 32 bits), and the payload carries the identity on the
sentinel slots (as ``exchange.gather_payload`` makes it).  Every width runs
the four semirings plus int32 min_src, single-vector and Q in {5, 8}.
Exact for the selection semirings and int32; plus_times allclose (rtol 1e-5,
atol 1e-6): the Pallas kernel sums a one-hot product, the plain version in
slot order.  A sentinel slot with a value other than the identity lands in
the Pallas kernel's drop slot and nowhere in the port's (its drop slot keeps
the identity); the rows the exchange keeps are equal either way.  Last, the
plain packed fold equals the plain sparse fold on the compacted form of the
same partials, bitwise for every semiring.  test_torch_cuda.py holds the
Hopper kernels against these plain versions on a GPU."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.scatter_combine import (packed_scatter_combine_gimv as jax_packed,
                                           packed_scatter_combine_gimv_multi as jax_packed_multi)
from repro_torch import kernels
from repro_torch.core import GimvSpec, sparse_exchange
from repro_torch.exchange import codec, gather_payload, plan, scatter_payload
from repro_torch.kernels import scatter_combine

CASES = [("plus_times", np.float32), ("min_plus", np.float32), ("max_plus", np.float32),
         ("min_src", np.float32), ("min_src", np.int32)]
# width -> n_local: the largest id domain of the width for 4 and 8 (so the
# sentinel uses the top code), small domains for 16 and 32 (the width holds
# any id; the chip smoke runs their real domains)
WIDTHS = {4: 15, 8: 255, 16: 300, 32: 40}
S, B = 2, 3


def _rng(*parts):
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def _identity(semiring, dtype):
    if semiring == "plus_times":
        return dtype(0)
    if dtype == np.float32:
        return np.float32(-np.inf if semiring == "max_plus" else np.inf)
    info = np.iinfo(np.int32)
    return np.int32(info.min if semiring == "max_plus" else info.max)


def _sets(rng, n_local, width, p_cap=60):
    """rows [S, B, p] int64: sorted unique ids padded with n_local, p a
    multiple of the ids per word."""
    k = 32 // width
    p = -(-p_cap // k) * k
    rows = np.full((S, B, p), n_local, np.int64)
    for s in range(S):
        for j in range(B):
            c = int(rng.integers(0, min(p_cap, n_local) + 1))
            rows[s, j, :c] = np.sort(rng.choice(n_local, c, replace=False))
    return rows


def _payload(rng, rows, n_local, semiring, dtype, nq=None):
    shape = rows.shape + (() if nq is None else (nq,))
    x = (rng.integers(-50, 50, shape) if dtype == np.int32 else rng.random(shape)).astype(dtype)
    if dtype == np.float32 and semiring != "plus_times":
        x[rng.random(shape) < 0.1] = _identity(semiring, dtype)
    pad = rows >= n_local
    x[pad if nq is None else np.broadcast_to(pad[..., None], shape)] = _identity(semiring, dtype)
    return x


def _assert_match(got, want, semiring, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    if semiring == "plus_times" and dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("semiring,dtype", CASES, ids=[f"{s}-{np.dtype(d).name}" for s, d in CASES])
def test_packed_plain_matches_jax_kernel(width, semiring, dtype):
    n_local = WIDTHS[width]
    rng = _rng("packed", width, semiring, np.dtype(dtype).name)
    rows = _sets(rng, n_local, width)
    set_slots = B * rows.shape[-1]
    words = codec.pack_uniform(rows, width).reshape(-1)
    n_out = S * (n_local + 1)
    kw = dict(set_slots=set_slots, n_local=n_local, width=width, semiring=semiring)
    for nq in (None, 5, 8):
        val = _payload(rng, rows, n_local, semiring, dtype, nq)
        if nq is None:
            flat = val.reshape(-1)
            want = jax_packed(jnp.asarray(words), jnp.asarray(flat), n_out, interpret=True, **kw)
            got = scatter_combine.packed_scatter_combine_gimv(
                torch.from_numpy(words), torch.from_numpy(flat), n_out, senders=B, **kw)
        else:
            flat = val.reshape(-1, nq)
            want = jax_packed_multi(jnp.asarray(words), jnp.asarray(flat), n_out,
                                    interpret=True, **kw)
            got = scatter_combine.packed_scatter_combine_gimv_multi(
                torch.from_numpy(words), torch.from_numpy(flat), n_out, senders=B, **kw)
        _assert_match(got.numpy(), want, semiring, dtype)


def test_packed_plain_drops_sentinel_values():
    """Values on sentinel slots reach no output in the port (the drop slots
    keep the identity); the Pallas kernel folds them into its drop slots.
    The n_local rows of every set are equal."""
    width, n_local, semiring = 8, 255, "min_plus"
    rng = _rng("sentinel")
    rows = _sets(rng, n_local, width)
    words = codec.pack_uniform(rows, width).reshape(-1)
    val = rng.random(rows.shape).astype(np.float32).reshape(-1)   # no identity anywhere
    n_out = S * (n_local + 1)
    kw = dict(set_slots=B * rows.shape[-1], n_local=n_local, width=width, semiring=semiring)
    want = np.asarray(jax_packed(jnp.asarray(words), jnp.asarray(val), n_out, interpret=True,
                                 **kw)).reshape(S, n_local + 1)
    got = scatter_combine.packed_scatter_combine_gimv(
        torch.from_numpy(words), torch.from_numpy(val), n_out, senders=B, **kw).numpy()
    got = got.reshape(S, n_local + 1)
    np.testing.assert_array_equal(got[:, :n_local], want[:, :n_local])
    assert np.isinf(got[:, n_local]).all() and np.isfinite(want[:, n_local]).all()


def test_packed_plain_counts_no_launches_and_checks_arguments():
    kernels.reset_launch_counts()
    words = torch.zeros(4, dtype=torch.uint32)
    val = torch.zeros(16)
    kw = dict(set_slots=8, n_local=5, width=8, semiring="plus_times", senders=2)
    assert scatter_combine.packed_scatter_combine_gimv(words, val, 12, **kw).shape == (12,)
    assert kernels.launch_counts()["packed_scatter_combine"] == 0
    for bad in (dict(kw, width=12), dict(kw, senders=3), dict(kw, set_slots=6),
                dict(kw, semiring="tropical")):
        with pytest.raises(ValueError):
            scatter_combine.packed_scatter_combine_gimv(words, val, 12, **bad)
    with pytest.raises(ValueError):     # 16 slots at width 8 need 4 words
        scatter_combine.packed_scatter_combine_gimv(torch.zeros(3, dtype=torch.uint32), val,
                                                    12, **kw)
    with pytest.raises(TypeError):
        scatter_combine.packed_scatter_combine_gimv(words.to(torch.int32), val, 12, **kw)
    with pytest.raises(ValueError):
        scatter_combine.packed_scatter_combine_gimv_multi(words, val, 12, **kw)


SPECS = {
    "plus_times": ("mul", "sum", np.float32),
    "min_plus": ("add", "min", np.float32),
    "max_plus": ("add", "max", np.float32),
    "min_src": ("src", "min", np.int32),
}


@pytest.mark.parametrize("nq", [None, 4])
def test_packed_fold_equals_sparse_fold(nq):
    """Partials [b, b, n_local(, Q)] that are the identity off a random
    structural support: gathered at the packed send order and folded by the
    packed plain version (and by the segment path), they give the bits of
    the compacted sparse exchange's fold, for every semiring."""
    b, n_local = 4, 37
    rng = _rng("fold", nq)
    support = rng.random((b, b, n_local)) < 0.3           # [src j, dst i, row]
    row_sets = [[np.flatnonzero(support[j, i]) for j in range(b)] for i in range(b)]
    for scatter in ("segment", "kernel"):
        xp, arrays = plan.build_exchange(row_sets, n_local, scatter=scatter)
        for name, (c2, call, dtype) in SPECS.items():
            spec = GimvSpec(name=name, combine2=c2, combine_all=call, dtype=dtype,
                            assign=lambda v, r, ctx: r, init=lambda ids, ctx: ids)
            shape = (b, b, n_local) + (() if nq is None else (nq,))
            x = (rng.integers(-9, 9, shape) if dtype == np.int32
                 else rng.random(shape)).astype(dtype)
            live = support if nq is None else support[..., None]
            # a structural row may still carry the identity (it is shipped)
            live = live & (rng.random(shape) < 0.8)
            partials = torch.from_numpy(np.where(live, x, spec.identity).astype(dtype))
            cap = int(support.sum(-1).max())
            idx, val, over, _ = sparse_exchange.compact_partials(spec, partials, cap,
                                                                 batched=nq is not None)
            assert float(over) == 0.0
            want = sparse_exchange.scatter_partials(
                spec, idx.transpose(0, 1).contiguous(), val.transpose(0, 1).contiguous(),
                n_local, method="segment")
            payload = gather_payload(spec, partials, torch.from_numpy(arrays["send_rows"]))
            got = scatter_payload(
                spec, payload.transpose(0, 1).contiguous(), n_local,
                recv_rows=torch.from_numpy(arrays["recv_rows"]),
                recv_words=(torch.from_numpy(arrays["recv_words"]) if scatter == "kernel"
                            else None),
                p_dev=xp.p_dev, width=xp.width_dev, method=scatter)
            assert torch.equal(got, want), (scatter, name)
