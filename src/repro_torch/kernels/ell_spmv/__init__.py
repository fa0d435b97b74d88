from repro_torch.kernels.ell_spmv.ops import ell_from_edges, ell_gimv
from repro_torch.kernels.ell_spmv.ref import ell_gimv_ref

__all__ = ["ell_gimv", "ell_gimv_ref", "ell_from_edges"]
