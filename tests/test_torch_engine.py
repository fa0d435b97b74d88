"""PMVEngine.run of the PyTorch port (device='cpu') against the JAX
package's PMVEngine.run on RMAT graphs: PR/RWR/SSSP/CC x horizontal /
vertical / hybrid x backend torch / auto x scatter segment / kernel.  The
port's 'torch' backend is held against the JAX package's 'xla', 'auto'
against 'auto' (its Pallas kernels in interpret mode).  SSSP and CC are
exactly equal with equal iteration counts; PR and RWR allclose (rtol 1e-5,
atol 1e-7) because the float summation order differs."""
import numpy as np
import pytest
from _torch_parity import (B, GRAPH, N, assert_results_match, check_engine_case,
                           engine_cases, run_both)

from repro.graph import rmat

CASES = engine_cases("torch")   # backend 'auto': test_torch_engine_planned.py


@pytest.mark.parametrize("algo,strategy,backend,scatter", CASES,
                         ids=["-".join(c) for c in CASES])
def test_engine_matches_jax(algo, strategy, backend, scatter):
    check_engine_case(algo, strategy, backend, scatter)


@pytest.mark.parametrize("scale,b", [(8, 2), (10, 4)])
def test_selective_and_auto_theta_match_jax(scale, b):
    """strategy='selective' and theta='auto' resolve as in the JAX package."""
    edges = rmat(scale, 8 << scale, seed=scale)
    n = 1 << scale
    for strategy in ("selective", "hybrid"):
        r_ref, r_port, meta = run_both(edges, n, b, "sssp", strategy=strategy, backend="auto",
                                       scatter="auto")
        assert r_port.theta == r_ref.theta
        assert_results_match(r_ref, r_port, "sssp")


def test_dense_exchange_matches_jax():
    import repro.core as J
    import repro_torch.core as T

    for backend, ref_backend in (("torch", "xla"), ("auto", "auto")):
        ref = J.PMVEngine(GRAPH, N, b=B, strategy="vertical", exchange="dense",
                          backend=ref_backend, stream="off")
        port = T.PMVEngine(GRAPH, N, b=B, strategy="vertical", exchange="dense",
                           backend=backend, stream="off", device="cpu")
        r_ref = ref.run(J.sssp(3), max_iters=40, tol=0.5)
        r_port = port.run(T.sssp(3), max_iters=40, tol=0.5)
        assert_results_match(r_ref, r_port, "sssp")
        np.testing.assert_array_equal(r_port.deltas, r_ref.deltas)


@pytest.mark.parametrize("strategy", ["vertical", "hybrid"])
def test_range_partition_matches_jax(strategy):
    """psi='range' (contiguous blocks) through both engines."""
    import repro.core as J
    import repro_torch.core as T

    kw = dict(b=B, strategy=strategy, theta=12.0, psi="range", stream="off")
    r_ref = J.PMVEngine(GRAPH, N, backend="auto", **kw).run(J.sssp(5), max_iters=40, tol=0.5)
    r_port = T.PMVEngine(GRAPH, N, backend="auto", device="cpu", **kw).run(
        T.sssp(5), max_iters=40, tol=0.5)
    assert_results_match(r_ref, r_port, "sssp")
