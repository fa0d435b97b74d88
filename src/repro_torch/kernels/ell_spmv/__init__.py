from repro_torch.kernels.ell_spmv.ops import (check_left_packed, ell_from_edges, ell_gimv,
                                              ell_gimv_multi)
from repro_torch.kernels.ell_spmv.ref import ell_gimv_multi_ref, ell_gimv_ref

__all__ = ["ell_gimv", "ell_gimv_ref", "ell_gimv_multi", "ell_gimv_multi_ref", "ell_from_edges",
           "check_left_packed"]
