from repro_torch.kernels.block_gimv.ops import (dense_gimv, dense_gimv_multi, has_semiring,
                                                semiring_of)
from repro_torch.kernels.block_gimv.ref import dense_gimv_multi_ref, dense_gimv_ref

__all__ = ["dense_gimv", "dense_gimv_ref", "dense_gimv_multi", "dense_gimv_multi_ref",
           "has_semiring", "semiring_of"]
