from repro_torch.kernels.scatter_combine.ops import (scatter_combine_gimv,
                                                     scatter_combine_gimv_multi)
from repro_torch.kernels.scatter_combine.ref import (scatter_combine_multi_ref,
                                                     scatter_combine_ref)

__all__ = ["scatter_combine_gimv", "scatter_combine_ref", "scatter_combine_gimv_multi",
           "scatter_combine_multi_ref"]
