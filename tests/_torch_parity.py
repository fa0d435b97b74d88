"""Shared helper of the PyTorch-port engine parity tests: run one solve
through the JAX package's ``PMVEngine`` and the port's ``PMVEngine``
(device='cpu') and compare them."""
import numpy as np

import repro.core as J
import repro_torch.core as T
from _torch_graphs import tactic_mix_edges  # noqa: F401 -- re-exported
from repro.graph import rmat

# name -> (spec factory(module, n), ctx factory(module, n) | None, symmetrize,
#          exact, run kwargs)
ALGOS = {
    "pagerank": (lambda m, n: m.pagerank(n), None, False, False,
                 dict(max_iters=25, tol=1e-6)),
    "rwr": (lambda m, n: m.random_walk_with_restart(n, 1), lambda m, n: m.rwr_context(n, 1),
            False, False, dict(max_iters=25, tol=1e-6)),
    "sssp": (lambda m, n: m.sssp(0), None, False, True, dict(max_iters=60, tol=0.5)),
    "cc": (lambda m, n: m.connected_components(), None, True, True,
           dict(max_iters=60, tol=0.5)),
}

REFERENCE_BACKEND = {"torch": "xla", "auto": "auto"}


def run_both(edges, n, b, algo, *, strategy, backend, scatter, theta=None,
             reference_backend=None, **engine_kw):
    """Returns (reference PMVResult, port PMVResult, port meta).
    ``engine_kw`` (e.g. exchange=, delta_eps=) goes to both engines."""
    mk, ctx_mk, sym, _, run_kw = ALGOS[algo]
    kw = dict(b=b, strategy=strategy, scatter=scatter, stream="off", symmetrize=sym,
              **engine_kw)
    if theta is not None:
        kw["theta"] = theta
    ref = J.PMVEngine(edges, n, backend=reference_backend or REFERENCE_BACKEND[backend], **kw)
    port = T.PMVEngine(edges, n, backend=backend, device="cpu", **kw)
    r_ref = ref.run(mk(J, n), None if ctx_mk is None else ctx_mk(J, n), **run_kw)
    spec = mk(T, n)
    ctx = None if ctx_mk is None else ctx_mk(T, n)
    r_port = port.run(spec, ctx, **run_kw)
    meta = port.prepare(spec, ctx)[-1]
    return r_ref, r_port, meta


def assert_results_match(r_ref, r_port, algo):
    exact = ALGOS[algo][3]
    assert r_port.strategy == r_ref.strategy
    assert r_port.capacity == r_ref.capacity
    assert r_port.v.dtype == r_ref.v.dtype and r_port.v.shape == r_ref.v.shape
    if exact:
        assert r_port.iterations == r_ref.iterations
        assert r_port.converged == r_ref.converged
        np.testing.assert_array_equal(r_port.v, r_ref.v)
    else:
        np.testing.assert_allclose(r_port.v, r_ref.v, rtol=1e-5, atol=1e-7)
    last_ref, last_port = r_ref.per_iter[-1], r_port.per_iter[-1]
    for key in ("gathered_elems", "exchanged_elems", "gathered_bytes", "exchanged_bytes"):
        assert last_port[key] == last_ref[key], key
    if exact and "logical_elems" in last_ref:
        assert [r["logical_elems"] for r in r_port.per_iter] == \
            [r["logical_elems"] for r in r_ref.per_iter]


# the RMAT graph of the engine parity grid
GRAPH = rmat(9, 4 << 9, seed=21)
N, B, THETA = 512, 4, 12.0


def engine_cases(backend):
    """(algo, strategy, backend, scatter) grid; horizontal has no exchange."""
    return [(algo, strategy, backend, scatter)
            for algo in ALGOS
            for strategy in ("horizontal", "vertical", "hybrid")
            for scatter in ("segment", "kernel")
            if not (strategy == "horizontal" and scatter == "kernel")]


def check_engine_case(algo, strategy, backend, scatter):
    r_ref, r_port, meta = run_both(GRAPH, N, B, algo, strategy=strategy, backend=backend,
                                   scatter=scatter, theta=THETA)
    assert meta["backend"] == ("planned" if backend == "auto" else "torch")
    if strategy != "horizontal":
        assert meta["plan"].scatter == scatter
    assert_results_match(r_ref, r_port, algo)
