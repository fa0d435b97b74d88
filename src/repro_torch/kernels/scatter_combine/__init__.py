from repro_torch.kernels.scatter_combine.ops import scatter_combine_gimv
from repro_torch.kernels.scatter_combine.ref import scatter_combine_ref

__all__ = ["scatter_combine_gimv", "scatter_combine_ref"]
