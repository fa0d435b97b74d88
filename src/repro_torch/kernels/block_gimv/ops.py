"""Wrappers of the dense GIM-V kernels (csrc/dense_gimv.cu, one vector;
csrc/dense_gimv_multi.cu, a [K, Q] block of query vectors) and the semiring
table that maps a GimvSpec to a kernel semiring.

``dense_gimv`` / ``dense_gimv_multi`` on a CUDA tensor launch their Hopper
kernel (or raise); on a CPU tensor they run the plain version in ref.py.
Each wrapper's ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common
from repro_torch.kernels.block_gimv.ref import dense_gimv_multi_ref, dense_gimv_ref

__all__ = ["dense_gimv", "dense_gimv_multi", "semiring_of", "has_semiring"]

_SEMIRING_TABLE = {
    ("mul", "sum"): "plus_times",
    ("add", "min"): "min_plus",
    ("add", "max"): "max_plus",
    ("src", "min"): "min_src",
}


def semiring_of(combine2: str, combine_all: str) -> str:
    """Map a GimvSpec's (combine2, combineAll) to a kernel semiring id."""
    key = (combine2, combine_all)
    if key not in _SEMIRING_TABLE:
        raise ValueError(f"no kernel semiring for {key}")
    return _SEMIRING_TABLE[key]


def has_semiring(combine2: str, combine_all: str) -> bool:
    """Whether the (combine2, combineAll) pair has a kernel semiring."""
    return (combine2, combine_all) in _SEMIRING_TABLE


def dense_gimv(m: torch.Tensor, v: torch.Tensor, *, semiring: str) -> torch.Tensor:
    """r = M (x) v.  m: float32 [M, K] (for min_src a 0/1 presence matrix);
    v: float32 or int32 [K] -> r: [M] in v's dtype."""
    _common.check_semiring(semiring)
    dev = v.device
    _common.check_tensor("v", v, dtypes=(torch.float32, torch.int32), ndim=1, device=dev)
    _common.check_tensor("m", m, dtypes=(torch.float32,), ndim=2, device=dev)
    if m.shape[1] != v.shape[0]:
        raise ValueError(f"m {tuple(m.shape)} does not match v {tuple(v.shape)}")
    if _common.use_plain(dev):
        return dense_gimv_ref(m, v, semiring=semiring)
    rows, k = m.shape
    out = torch.empty(rows, dtype=v.dtype, device=dev)
    if rows == 0:
        return out
    if k == 0:
        return out.fill_(_common.identity(semiring, v.dtype))
    from repro_torch.kernels.build import check_rc, load

    fn = load("dense_gimv")
    with torch.cuda.device(dev):
        rc = fn(m.data_ptr(), v.data_ptr(), out.data_ptr(), rows, k,
                _common.SEMIRING_ID[semiring], _common.VALUE_TYPE_ID[v.dtype],
                _common.current_stream(dev))
    check_rc(rc, "dense_gimv")
    dense_gimv.launches += 1
    return out


dense_gimv.launches = 0


def dense_gimv_multi(m: torch.Tensor, v: torch.Tensor, *, semiring: str) -> torch.Tensor:
    """R = M (x) V.  m: float32 [M, K] (for min_src a 0/1 presence matrix);
    v: float32 or int32 [K, Q] row-major (one query per column) -> R: [M, Q]
    in v's dtype.  On a CUDA tensor, plus_times over float32 runs on the
    tensor cores as three TF32 products (within ~1e-6 relative of a float32
    product, the same bits from call to call; its values must be finite:
    an infinite operand makes its whole output row, for one in m, or
    column, for one in v, NaN, where the plain version gives inf or NaN);
    every other case on the CUDA cores."""
    _common.check_semiring(semiring)
    dev = v.device
    _common.check_tensor("v", v, dtypes=(torch.float32, torch.int32), ndim=2, device=dev)
    _common.check_tensor("m", m, dtypes=(torch.float32,), ndim=2, device=dev)
    if m.shape[1] != v.shape[0]:
        raise ValueError(f"m {tuple(m.shape)} does not match v {tuple(v.shape)}")
    if _common.use_plain(dev):
        return dense_gimv_multi_ref(m, v, semiring=semiring)
    rows, k = m.shape
    nq = v.shape[1]
    out = torch.empty((rows, nq), dtype=v.dtype, device=dev)
    if rows == 0 or nq == 0:
        return out
    if k == 0:
        return out.fill_(_common.identity(semiring, v.dtype))
    from repro_torch.kernels.build import check_rc, load

    fn = load("dense_gimv_multi")
    with torch.cuda.device(dev):
        rc = fn(m.data_ptr(), v.data_ptr(), out.data_ptr(), rows, k, nq,
                _common.SEMIRING_ID[semiring], _common.VALUE_TYPE_ID[v.dtype],
                _common.current_stream(dev))
    check_rc(rc, "dense_gimv_multi")
    dense_gimv_multi.launches += 1
    return out


dense_gimv_multi.launches = 0
