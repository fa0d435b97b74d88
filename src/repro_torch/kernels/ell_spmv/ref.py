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


# elements of the [rows, D, Q] broadcast the multi-query plain version builds
# at once; larger tables run in row chunks (the result does not depend on it)
_CHUNK_ELEMS = 1 << 26


def ell_gimv_multi_ref(cols: torch.Tensor, w: torch.Tensor | None, v: torch.Tensor, *,
                       semiring: str) -> torch.Tensor:
    """r[i, q] = combineAll_d combine2(w[i,d], v[cols[i,d], q]); cols < 0
    skipped.  cols/w: [R, D]; v: [N, Q] float32 or int32 -> r: [R, Q] in
    v's dtype."""
    rows, width = cols.shape
    nq = v.shape[1]
    ident = torch.full((), identity(semiring, v.dtype), dtype=v.dtype, device=v.device)
    out = torch.empty((rows, nq), dtype=v.dtype, device=v.device)
    step = max(1, _CHUNK_ELEMS // max(1, width * nq))
    for r0 in range(0, rows, step):
        c = cols[r0:r0 + step]
        vals = torch.index_select(v, 0, c.clamp_min(0).reshape(-1)).reshape(c.shape + (nq,))
        if semiring == "min_src" or w is None:
            x = vals
        else:
            wc = w[r0:r0 + step, :, None]
            f = wc * vals.to(torch.float32) if semiring == "plus_times" else wc + vals.to(torch.float32)
            x = from_float(f, v.dtype)
        x = torch.where((c >= 0)[:, :, None], x, ident)
        if REDUCE[semiring] == "sum":
            out[r0:r0 + step] = x.sum(dim=1, dtype=v.dtype)
        elif REDUCE[semiring] == "amin":
            out[r0:r0 + step] = x.amin(dim=1)
        else:
            out[r0:r0 + step] = x.amax(dim=1)
    return out
