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


# elements of the [rows, K, Q] broadcast the multi-query plain version builds
# at once; larger matrices run in row chunks (the result does not depend on it)
_CHUNK_ELEMS = 1 << 26


def dense_gimv_multi_ref(m: torch.Tensor, v: torch.Tensor, *, semiring: str) -> torch.Tensor:
    """R = M (x) V over a dense block.  m: float32 [M, K] (for min_src a 0/1
    presence matrix); v: float32 or int32 [K, Q] -> R: [M, Q] in v's dtype."""
    rows, k = m.shape
    nq = v.shape[1]
    vf = v.to(torch.float32)[None, :, :]
    ident = torch.full((), identity(semiring, v.dtype), dtype=v.dtype, device=v.device)
    out = torch.empty((rows, nq), dtype=v.dtype, device=v.device)
    step = max(1, _CHUNK_ELEMS // max(1, k * nq))
    for r0 in range(0, rows, step):
        mc = m[r0:r0 + step, :, None]
        if semiring == "plus_times":
            out[r0:r0 + step] = from_float(mc * vf, v.dtype).sum(dim=1, dtype=v.dtype)
        elif semiring == "min_plus":
            out[r0:r0 + step] = from_float(mc + vf, v.dtype).amin(dim=1)
        elif semiring == "max_plus":
            out[r0:r0 + step] = from_float(mc + vf, v.dtype).amax(dim=1)
        elif semiring == "min_src":
            out[r0:r0 + step] = torch.where(mc > 0, v[None, :, :], ident).amin(dim=1)
        else:
            raise ValueError(semiring)
    return out
