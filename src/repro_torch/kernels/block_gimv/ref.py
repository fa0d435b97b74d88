"""Plain PyTorch version of the dense GIM-V kernel (csrc/dense_gimv.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels._common import from_float, identity


def dense_gimv_ref(m: torch.Tensor, v: torch.Tensor, *, semiring: str) -> torch.Tensor:
    """r = M (x) v over a dense block.  m: float32 [M, K] (for min_src a 0/1
    presence matrix); v: float32 or int32 [K] -> r: [M] in v's dtype."""
    vf = v.to(torch.float32)[None, :]
    if semiring == "plus_times":
        return from_float(m * vf, v.dtype).sum(dim=1, dtype=v.dtype)
    if semiring == "min_plus":
        return from_float(m + vf, v.dtype).amin(dim=1)
    if semiring == "max_plus":
        return from_float(m + vf, v.dtype).amax(dim=1)
    if semiring == "min_src":
        ident = torch.full((), identity(semiring, v.dtype), dtype=v.dtype, device=v.device)
        return torch.where(m > 0, v[None, :], ident).amin(dim=1)
    raise ValueError(semiring)
