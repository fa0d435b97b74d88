"""PMVEngine.run of the PyTorch port with backend='auto' (the planner and
the kernel wrappers, whose plain versions run on the CPU) against the JAX
package's backend='auto' (its Pallas kernels in interpret mode), on the RMAT
graph of _torch_parity.py: PR/RWR/SSSP/CC x horizontal / vertical /
hybrid x scatter segment / kernel."""
import pytest
from _torch_parity import check_engine_case, engine_cases

CASES = engine_cases("auto")


@pytest.mark.parametrize("algo,strategy,backend,scatter", CASES,
                         ids=["-".join(c) for c in CASES])
def test_planned_engine_matches_jax(algo, strategy, backend, scatter):
    check_engine_case(algo, strategy, backend, scatter)
