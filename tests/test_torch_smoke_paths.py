"""The solves of ``chip_smoke.py`` at a small scale on the CPU: the same
knobs (b=8, backend='auto', PageRank/selective, SSSP/vertical with the
scatter kernel, CC/hybrid on the symmetrized edges, PageRank/vertical over
the packed exchange with delta_eps=0) through the port's
``PMVEngine(device='cpu')``, held against the smoke's own scipy references
with its tolerances (PageRank rtol 1e-4; SSSP and CC exact)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse import csgraph

from repro_torch.core import PMVEngine, connected_components, pagerank, sssp
from repro_torch.graph import rmat, symmetrize_edges

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

SCALE = 10
N = 1 << SCALE
EDGES = rmat(SCALE, 16 << SCALE, seed=0)


def test_pagerank_selective():
    eng = PMVEngine(EDGES, N, b=8, strategy="selective", backend="auto", device="cpu")
    res = eng.run(pagerank(N), max_iters=100, tol=1e-6)
    assert eng.prepare(pagerank(N))[-1]["backend"] == "planned"
    assert res.converged
    want = smoke.pagerank_ref(np, sp, EDGES, N, res.iterations)
    np.testing.assert_allclose(res.v, want, rtol=1e-4, atol=1e-12)


def test_sssp_vertical_scatter_kernel():
    eng = PMVEngine(EDGES, N, b=8, strategy="vertical", backend="auto", scatter="kernel",
                    stream="off", device="cpu")
    res = eng.run(sssp(0), max_iters=100, tol=0.5)
    meta = eng.prepare(sssp(0))[-1]
    assert meta["backend"] == "planned" and meta["plan"].scatter == "kernel"
    assert res.converged
    want = smoke.sssp_ref(np, sp, csgraph, EDGES, N, 0)
    np.testing.assert_array_equal(res.v.astype(np.float64), want)


@pytest.mark.parametrize("theta", [60.0, 100.0])
def test_cc_hybrid(theta):
    sym = symmetrize_edges(EDGES)
    eng = PMVEngine(sym, N, b=8, strategy="hybrid", theta=theta, backend="auto",
                    stream="off", device="cpu")
    res = eng.run(connected_components(), max_iters=100, tol=0.5)
    meta = eng.prepare(connected_components())[-1]
    assert meta["backend"] == "planned" and meta["n_dense"] > 0
    assert res.converged
    np.testing.assert_array_equal(res.v, smoke.cc_ref(np, sp, csgraph, sym, N))


def test_pagerank_vertical_packed_delta():
    eng = PMVEngine(EDGES, N, b=8, strategy="vertical", backend="auto", scatter="kernel",
                    exchange="packed", delta_eps=0.0, device="cpu")
    res = eng.run(pagerank(N), max_iters=100, tol=1e-6)
    meta = eng.prepare(pagerank(N))[-1]
    assert meta["exchange"] == "packed" and meta["delta_reason"] == "active"
    assert meta["plan"].scatter == "kernel" and "recv_words" in eng.prepare(pagerank(N))[0]["xchg"]
    assert res.converged
    want = smoke.pagerank_ref(np, sp, EDGES, N, res.iterations)
    np.testing.assert_allclose(res.v, want, rtol=1e-4, atol=1e-12)
