"""Plain PyTorch version of the scatter-combine kernel
(csrc/scatter_combine.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels._common import REDUCE, identity


def scatter_combine_ref(idx: torch.Tensor, val: torch.Tensor, n_local: int, *,
                        semiring: str) -> torch.Tensor:
    """r[s, n] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t] on the flat
    layout: each set s gets its own (n_local + 1)-wide segment whose last
    slot catches every idx outside [0, n_local).  Accepts any idx.
    idx: int32 [S, B, cap]; val: [S, B, cap] -> r: [S, n_local]."""
    sets = idx.shape[0]
    seg_w = n_local + 1
    flat = idx.reshape(sets, -1).to(torch.int64)
    flat = torch.where((flat >= 0) & (flat < n_local), flat, n_local)
    flat = flat + torch.arange(sets, dtype=torch.int64, device=idx.device)[:, None] * seg_w
    out = torch.full((sets * seg_w,), identity(semiring, val.dtype), dtype=val.dtype,
                     device=val.device)
    out.scatter_reduce_(0, flat.reshape(-1), val.reshape(-1), reduce=REDUCE[semiring],
                        include_self=True)
    return out.reshape(sets, seg_w)[:, :n_local]


def scatter_combine_multi_ref(idx: torch.Tensor, val: torch.Tensor, n_local: int, *,
                              semiring: str) -> torch.Tensor:
    """r[s, n, q] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t,q] on the
    flat layout of :func:`scatter_combine_ref`, columnwise.  Accepts any idx.
    idx: int32 [S, B, cap]; val: [S, B, cap, Q] -> r: [S, n_local, Q]."""
    sets = idx.shape[0]
    nq = val.shape[-1]
    seg_w = n_local + 1
    flat = idx.reshape(sets, -1).to(torch.int64)
    flat = torch.where((flat >= 0) & (flat < n_local), flat, n_local)
    flat = flat + torch.arange(sets, dtype=torch.int64, device=idx.device)[:, None] * seg_w
    out = torch.full((sets * seg_w, nq), identity(semiring, val.dtype), dtype=val.dtype,
                     device=val.device)
    out.scatter_reduce_(0, flat.reshape(-1, 1).expand(-1, nq), val.reshape(-1, nq),
                        reduce=REDUCE[semiring], include_self=True)
    return out.reshape(sets, seg_w, nq)[:, :n_local]
