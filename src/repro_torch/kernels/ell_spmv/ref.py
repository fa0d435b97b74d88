"""Plain PyTorch version of the ELL GIM-V kernel (csrc/ell_gimv.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels._common import REDUCE, from_float, identity


def ell_gimv_ref(cols: torch.Tensor, w: torch.Tensor | None, v: torch.Tensor, *,
                 semiring: str) -> torch.Tensor:
    """r[i] = combineAll_d combine2(w[i,d], v[cols[i,d]]); cols < 0 skipped.
    cols/w: [R, D]; v: [N] float32 or int32 -> r: [R] in v's dtype."""
    valid = cols >= 0
    vals = torch.index_select(v, 0, cols.clamp_min(0).reshape(-1)).reshape(cols.shape)
    if semiring == "min_src" or w is None:
        x = vals
    elif semiring == "plus_times":
        x = from_float(w * vals.to(torch.float32), v.dtype)
    else:
        x = from_float(w + vals.to(torch.float32), v.dtype)
    x = torch.where(valid, x, torch.full((), identity(semiring, v.dtype), dtype=v.dtype,
                                         device=v.device))
    if REDUCE[semiring] == "sum":
        return x.sum(dim=1, dtype=v.dtype)
    return x.amin(dim=1) if REDUCE[semiring] == "amin" else x.amax(dim=1)
