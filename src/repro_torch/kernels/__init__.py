"""Hand-written Hopper kernels of the PMV main path, of multi-query serving
and of the packed exchange, one package each, a single-vector and a Q-wide
kernel per function:

- ``ell_spmv``: ELL GIM-V over the planner's bucketed ELL tables
  (``ell_gimv``, v [N]; ``ell_gimv_multi``, v [N, Q]);
- ``block_gimv``: dense GIM-V over a materialized dense block
  (``dense_gimv``, v [K]; ``dense_gimv_multi``, v [K, Q]);
- ``scatter_combine``: the receive-side fold of the compact sparse exchange
  (``scatter_combine_gimv``, one value per slot;
  ``scatter_combine_gimv_multi``, Q values per slot) and of the packed
  exchange, whose ids arrive bit-packed and are decoded in the kernel
  (``packed_scatter_combine_gimv``, ``packed_scatter_combine_gimv_multi``).

Each has ``ops.py`` (the wrappers, which launch the CUDA kernels on CUDA
tensors, run the plain versions on CPU tensors, and count launches),
``ref.py`` (the plain PyTorch versions) and sources under ``csrc/``.
"""
from repro_torch.kernels.block_gimv import dense_gimv, dense_gimv_multi
from repro_torch.kernels.ell_spmv import ell_gimv, ell_gimv_multi
from repro_torch.kernels.scatter_combine import (packed_scatter_combine_gimv,
                                                 packed_scatter_combine_gimv_multi,
                                                 scatter_combine_gimv,
                                                 scatter_combine_gimv_multi)

__all__ = ["ell_gimv", "dense_gimv", "scatter_combine_gimv", "ell_gimv_multi",
           "dense_gimv_multi", "scatter_combine_gimv_multi", "packed_scatter_combine_gimv",
           "packed_scatter_combine_gimv_multi", "launch_counts", "reset_launch_counts",
           "WRAPPERS"]

WRAPPERS = {"ell_gimv": ell_gimv, "dense_gimv": dense_gimv,
            "scatter_combine": scatter_combine_gimv,
            "ell_gimv_multi": ell_gimv_multi, "dense_gimv_multi": dense_gimv_multi,
            "scatter_combine_multi": scatter_combine_gimv_multi,
            "packed_scatter_combine": packed_scatter_combine_gimv,
            "packed_scatter_combine_multi": packed_scatter_combine_gimv_multi}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
