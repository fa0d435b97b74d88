"""PMVEngine.run of the PyTorch port against the JAX package's on the
adversarial fuzz topologies (star hubs, chains, self-loops, empty stripes,
isolated vertices, multigraphs, a mix), b in {2, 4}.  Each topology runs
every algorithm; the port's configuration (strategy x backend x scatter)
rotates across cases so every combination is covered.  The JAX package runs
its 'xla' backend throughout (its 'auto' backend equals it, as its own fuzz
suite shows).  SSSP and CC are exactly equal with equal iteration counts;
PR and RWR allclose (rtol 1e-5, atol 1e-7)."""
import itertools

import numpy as np
import pytest
from _torch_parity import ALGOS, assert_results_match, run_both
from test_fuzz_parity import TOPOLOGIES, _fuzz_edges

CONFIGS = list(itertools.product(("horizontal", "vertical", "hybrid"), ("torch", "auto"),
                                 ("segment", "kernel")))
CASES = []
for t_i, topology in enumerate(TOPOLOGIES):
    for a_i, algo in enumerate(ALGOS):
        CASES.append((topology, algo, *CONFIGS[(t_i * len(ALGOS) + a_i) % len(CONFIGS)]))


@pytest.mark.parametrize("topology,algo,strategy,backend,scatter", CASES,
                         ids=["-".join(c) for c in CASES])
def test_engine_matches_jax_on_topology(topology, algo, strategy, backend, scatter):
    b = 4 if hash(topology) % 2 else 2
    n = b * 9
    edges = _fuzz_edges(topology, n, b, np.random.default_rng(len(topology)))
    r_ref, r_port, _ = run_both(edges, n, b, algo, strategy=strategy, backend=backend,
                                scatter=scatter, theta=3.0, reference_backend="xla")
    assert_results_match(r_ref, r_port, algo)
