"""Wrappers of the scatter-combine kernels (csrc/scatter_combine.cu, one
value per slot; csrc/scatter_combine_multi.cu, Q values per slot), the
receive side of the compact sparse exchange.

``scatter_combine_gimv`` / ``scatter_combine_gimv_multi`` on a CUDA tensor
launch their Hopper kernel (or raise); on a CPU tensor they run the plain
version in ref.py.  Each wrapper's ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common
from repro_torch.kernels.scatter_combine.ref import (scatter_combine_multi_ref,
                                                     scatter_combine_ref)

__all__ = ["scatter_combine_gimv", "scatter_combine_gimv_multi"]


def scatter_combine_gimv(idx: torch.Tensor, val: torch.Tensor, n_local: int, *,
                         semiring: str) -> torch.Tensor:
    """r[s, n] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t]; idx outside
    [0, n_local) is dropped and an unreached n gets the identity.

    idx: int32 [S, B, cap] -- S receiving sets, B senders, each row (s, k) a
    compacted partial: strictly ascending unique indices padded with n_local
    (sparse_exchange.compact_partials).  The kernel folds the B rows of a set
    in sender order and relies on that layout; the plain version accepts any
    idx.  val: float32 or int32 [S, B, cap] -> r: [S, n_local].
    """
    _common.check_semiring(semiring)
    dev = val.device
    _common.check_tensor("val", val, dtypes=(torch.float32, torch.int32), ndim=3, device=dev)
    _common.check_tensor("idx", idx, dtypes=(torch.int32,), ndim=3, device=dev)
    if idx.shape != val.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and val {tuple(val.shape)} differ")
    if n_local <= 0:
        raise ValueError(f"n_local must be positive, got {n_local}")
    if _common.use_plain(dev):
        return scatter_combine_ref(idx, val, n_local, semiring=semiring)
    sets, senders, cap = idx.shape
    out = torch.empty((sets, n_local), dtype=val.dtype, device=dev)
    if sets == 0:
        return out
    if senders == 0:
        return out.fill_(_common.identity(semiring, val.dtype))
    from repro_torch.kernels.build import check_rc, load

    fn = load("scatter_combine")
    with torch.cuda.device(dev):
        rc = fn(idx.data_ptr(), val.data_ptr(), out.data_ptr(), sets, senders, cap, n_local,
                _common.SEMIRING_ID[semiring], _common.VALUE_TYPE_ID[val.dtype],
                _common.current_stream(dev))
    check_rc(rc, "scatter_combine")
    scatter_combine_gimv.launches += 1
    return out


scatter_combine_gimv.launches = 0


def scatter_combine_gimv_multi(idx: torch.Tensor, val: torch.Tensor, n_local: int, *,
                               semiring: str) -> torch.Tensor:
    """r[s, n, q] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t,q]; idx
    outside [0, n_local) is dropped and an unreached n gets the identity.

    idx: int32 [S, B, cap] in the layout of :func:`scatter_combine_gimv` (one
    index set shared by the Q columns; the kernel relies on it, the plain
    version accepts any idx); val: float32 or int32 [S, B, cap, Q] -> r:
    [S, n_local, Q].
    """
    _common.check_semiring(semiring)
    dev = val.device
    _common.check_tensor("val", val, dtypes=(torch.float32, torch.int32), ndim=4, device=dev)
    _common.check_tensor("idx", idx, dtypes=(torch.int32,), ndim=3, device=dev)
    if idx.shape != val.shape[:3]:
        raise ValueError(f"idx {tuple(idx.shape)} does not match val {tuple(val.shape)}")
    if n_local <= 0:
        raise ValueError(f"n_local must be positive, got {n_local}")
    if _common.use_plain(dev):
        return scatter_combine_multi_ref(idx, val, n_local, semiring=semiring)
    sets, senders, cap, nq = val.shape
    out = torch.empty((sets, n_local, nq), dtype=val.dtype, device=dev)
    if sets == 0 or nq == 0:
        return out
    if senders == 0:
        return out.fill_(_common.identity(semiring, val.dtype))
    from repro_torch.kernels.build import check_rc, load

    fn = load("scatter_combine_multi")
    with torch.cuda.device(dev):
        rc = fn(idx.data_ptr(), val.data_ptr(), out.data_ptr(), sets, senders, cap, n_local,
                nq, _common.SEMIRING_ID[semiring], _common.VALUE_TYPE_ID[val.dtype],
                _common.current_stream(dev))
    check_rc(rc, "scatter_combine_multi")
    scatter_combine_gimv_multi.launches += 1
    return out


scatter_combine_gimv_multi.launches = 0
