"""Hand-written Hopper kernels of the PMV main path, one package each:

- ``ell_spmv``: ELL GIM-V over the planner's bucketed ELL tables;
- ``block_gimv``: dense GIM-V over a materialized dense block;
- ``scatter_combine``: the receive-side fold of the compact sparse exchange.

Each has ``ops.py`` (the wrapper, which launches the CUDA kernel on a CUDA
tensor and runs the plain version on a CPU tensor, and counts launches),
``ref.py`` (the plain PyTorch version) and a source under ``csrc/``.
"""
from repro_torch.kernels.block_gimv import dense_gimv
from repro_torch.kernels.ell_spmv import ell_gimv
from repro_torch.kernels.scatter_combine import scatter_combine_gimv

__all__ = ["ell_gimv", "dense_gimv", "scatter_combine_gimv", "launch_counts",
           "reset_launch_counts", "WRAPPERS"]

WRAPPERS = {"ell_gimv": ell_gimv, "dense_gimv": dense_gimv,
            "scatter_combine": scatter_combine_gimv}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
