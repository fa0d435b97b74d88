from repro_torch.kernels.scatter_combine.ops import (packed_scatter_combine_gimv,
                                                     packed_scatter_combine_gimv_multi,
                                                     scatter_combine_gimv,
                                                     scatter_combine_gimv_multi)
from repro_torch.kernels.scatter_combine.ref import (packed_scatter_combine_multi_ref,
                                                     packed_scatter_combine_ref,
                                                     scatter_combine_multi_ref,
                                                     scatter_combine_ref)

__all__ = ["scatter_combine_gimv", "scatter_combine_ref", "scatter_combine_gimv_multi",
           "scatter_combine_multi_ref", "packed_scatter_combine_gimv",
           "packed_scatter_combine_ref", "packed_scatter_combine_gimv_multi",
           "packed_scatter_combine_multi_ref"]
