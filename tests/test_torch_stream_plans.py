"""The port's ``stream`` resolution against the JAX package's: on a grid of
strategy x exchange x backend x stream x b, on the JAX package's memory
contract graph (``erdos_renyi(4096, 8192)``), the port's ``plan.stream`` and
``plan.memory_profile()`` equal the reference's, key for key, and the port
packs the layout the plan names (``matrix['streamed']`` /
``['streamed_sparse']`` exactly where it streams)."""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.graph import erdos_renyi

N = 4096
EDGES = erdos_renyi(N, 8192, seed=5)
REFERENCE_BACKEND = {"torch": "xla", "auto": "auto"}


@pytest.mark.parametrize("b", [4, 32])
@pytest.mark.parametrize("stream", ["auto", "on", "off"])
@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("exchange", ["sparse", "packed", "dense"])
@pytest.mark.parametrize("strategy", ["horizontal", "vertical", "hybrid"])
def test_plan_stream_and_memory_profile_equal_reference(strategy, exchange, backend, stream,
                                                        b):
    kw = dict(b=b, strategy=strategy, exchange=exchange, stream=stream)
    ref = J.PMVEngine(EDGES, N, backend=REFERENCE_BACKEND[backend], **kw).prepare(
        J.pagerank(N))
    want = ref[-1]["plan"]
    matrix, *_, meta = T.PMVEngine(EDGES, N, backend=backend, device="cpu", **kw).prepare(
        T.pagerank(N))
    got = meta["plan"]
    assert got.stream == want.stream
    assert got.capacity == want.capacity
    if want.capacity is not None:
        assert got.memory_profile() == want.memory_profile()
    streamed = {k for k in matrix if k.startswith("streamed")}
    assert streamed == {k for k in ref[1] if k.startswith("streamed")}
    assert bool(streamed) == (got.stream == "on")
    if got.stream == "on":
        fs = matrix["streamed" if strategy == "vertical" else "streamed_sparse"]
        assert fs.n_blocks == b and fs.n_workers == b
        assert np.isclose(got.memory_profile()["savings"],
                          b * got.n_local / (got.n_local + b * min(got.capacity,
                                                                   got.n_local)))
