"""One batched placement step of the PyTorch port against the JAX package's
``repro.core.engine.placement_call`` on the same [b, n_local, Q] batch: every
placement (horizontal, vertical, hybrid) x backend (the port's 'torch' vs
the JAX package's 'xla', 'auto' vs 'auto') x PR / RWR / SSSP / CC, on RMAT
2^9 and on two of the fuzz topologies.  Column 0 of every batch is the
serving server's empty column (a padded or retired slot).  SSSP and CC are
exactly equal; PageRank and RWR allclose (rtol 1e-5, atol 1e-7) because the
float summation order differs.  The per-step stats (gathered / exchanged
elements and bytes, which count the Q columns, logical elements and
overflow) are equal."""
import itertools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import ALGOS, B, GRAPH, N
from test_fuzz_parity import _fuzz_edges

import repro.core as J
import repro_torch.core as T
from repro.core.engine import placement_call as j_placement_call

REFERENCE_BACKEND = {"torch": "xla", "auto": "auto"}
NQ = 5


def _batch(rng, algo, part, nq):
    """Blocked [b, n_local, Q] values and ctx for ``algo``; column 0 empty."""
    shape = (part.b, part.n_local, nq)
    if algo == "cc":
        v = rng.integers(0, part.n, shape).astype(np.int32)
        v[..., 0] = part.to_blocked(np.arange(part.n, dtype=np.int32))
    elif algo == "sssp":
        v = (rng.random(shape) * 5).astype(np.float32)
        v[rng.random(shape) < 0.4] = np.inf
        v[..., 0] = np.inf
    else:
        v = (rng.random(shape) / part.n).astype(np.float32)
        v[..., 0] = 0.0
    ctx = {}
    if algo == "rwr":
        restart = np.zeros((part.n, nq), np.float32)
        restart[rng.integers(0, part.n, nq), np.arange(nq)] = 1.0
        restart[:, 0] = 0.0
        ctx["restart"] = part.to_blocked(restart)
    return v, ctx


def _check_step(edges, n, b, algo, strategy, backend, scatter, nq=NQ, theta=3.0,
                exchange="sparse"):
    mk, _ctx_mk, sym, exact, _ = ALGOS[algo]
    kw = dict(b=b, strategy=strategy, scatter=scatter, stream="off", symmetrize=sym,
              theta=theta, exchange=exchange)
    ref = J.PMVEngine(edges, n, backend=REFERENCE_BACKEND[backend], **kw)
    port = T.PMVEngine(edges, n, backend=backend, device="cpu", **kw)
    j_spec, t_spec = mk(J, n), mk(T, n)
    _, j_matrix, _, _, j_mask, j_meta = ref.prepare(j_spec)
    t_matrix, _, _, t_mask, t_meta = port.prepare(t_spec)
    assert t_meta["backend"] == ("planned" if backend == "auto" else "torch")
    rng = np.random.default_rng(zlib.crc32(repr((algo, strategy, backend, n)).encode()))
    v, ctx = _batch(rng, algo, t_meta["part"], nq)
    # one jit of the whole reference step compiles faster than its eager ops
    j_step = jax.jit(lambda m, vv, c, mask: j_placement_call(j_spec, j_meta["cfg"], m, vv, c,
                                                             mask, None))
    j_new, j_r, j_stats = j_step(j_matrix, jnp.asarray(v),
                                 {k: jnp.asarray(x) for k, x in ctx.items()}, j_mask)
    t_new, t_r, t_stats = T.placement_call(
        t_spec, t_meta["cfg"], t_matrix, torch.from_numpy(v),
        {k: torch.from_numpy(x) for k, x in ctx.items()}, t_mask)
    assert tuple(t_new.shape) == v.shape
    for got, want in ((t_new, j_new), (t_r, j_r)):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    keys = ["gathered_elems", "exchanged_elems", "gathered_bytes", "exchanged_bytes"]
    if strategy != "horizontal":
        keys += ["overflow"] + (["logical_elems"] if exact else [])
    for key in keys:
        assert float(t_stats[key]) == float(j_stats[key]), key


CASES = [(algo, strategy, backend, "kernel" if backend == "auto" else "segment")
         for algo in ALGOS for strategy in ("horizontal", "vertical", "hybrid")
         for backend in ("torch", "auto")]


@pytest.mark.parametrize("algo,strategy,backend,scatter", CASES,
                         ids=["-".join(c) for c in CASES])
def test_batched_step_matches_jax_rmat(algo, strategy, backend, scatter):
    _check_step(GRAPH, N, B, algo, strategy, backend, scatter, theta=12.0)


CONFIGS = list(itertools.product(("horizontal", "vertical", "hybrid"), ("torch", "auto"),
                                 ("segment", "kernel")))
TOPO_CASES = [(topology, algo, *CONFIGS[(t_i * len(ALGOS) + a_i) % len(CONFIGS)])
              for t_i, topology in enumerate(("star_hub", "multi_edge"))
              for a_i, algo in enumerate(ALGOS)]


@pytest.mark.parametrize("topology,algo,strategy,backend,scatter", TOPO_CASES,
                         ids=["-".join(c) for c in TOPO_CASES])
def test_batched_step_matches_jax_on_topology(topology, algo, strategy, backend, scatter):
    b = 4
    n = b * 9
    edges = _fuzz_edges(topology, n, b, np.random.default_rng(len(topology)))
    _check_step(edges, n, b, algo, strategy, backend, scatter, nq=3)
