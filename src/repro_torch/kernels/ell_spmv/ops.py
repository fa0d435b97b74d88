"""Wrappers of the ELL GIM-V kernels (csrc/ell_gimv.cu, one vector;
csrc/ell_gimv_multi.cu, a [N, Q] block of query vectors) and the ELL packer.

``ell_gimv`` / ``ell_gimv_multi`` on a CUDA tensor launch their Hopper
kernel (or raise); on a CPU tensor they run the plain version in ref.py.
Each wrapper's ``launches`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _common
from repro_torch.kernels.ell_spmv.ref import ell_gimv_multi_ref, ell_gimv_ref

__all__ = ["ell_gimv", "ell_gimv_multi", "ell_from_edges"]


def ell_from_edges(dst: np.ndarray, src: np.ndarray, w: np.ndarray | None, n_rows: int,
                   *, d_cap: int | None = None):
    """Edge list -> ELL (cols[r, D], w[r, D]); D = max in-degree, col < 0 pads.

    Vectorized (stable argsort + offset-from-row-start slots); slot order
    within a row is edge submission order.  ``d_cap`` forces a wider table.
    """
    dst = np.asarray(dst, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    deg = np.bincount(dst, minlength=n_rows)
    D = max(int(deg.max(initial=0)), 1)
    if d_cap is not None:
        assert d_cap >= D, (d_cap, D)
        D = d_cap
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    starts = np.concatenate([[0], np.cumsum(deg)])
    slots = np.arange(len(dst_s), dtype=np.int64) - starts[dst_s]
    cols = np.full((n_rows, D), -1, dtype=np.int32)
    cols[dst_s, slots] = src_s
    ww = None
    if w is not None:
        ww = np.zeros((n_rows, D), dtype=np.float32)
        ww[dst_s, slots] = np.asarray(w)[order]
    return cols, ww


def ell_gimv(cols: torch.Tensor, w: torch.Tensor | None, v: torch.Tensor, *,
             semiring: str) -> torch.Tensor:
    """r[i] = combineAll_d combine2(w[i,d], v[cols[i,d]]), pads (col < 0)
    skipped.  cols: int32 [R, D]; w: float32 [R, D] or None; v: float32 or
    int32 [N] -> r: [R] in v's dtype.  Every col must be < N."""
    _common.check_semiring(semiring)
    dev = v.device
    _common.check_tensor("v", v, dtypes=(torch.float32, torch.int32), ndim=1, device=dev)
    _common.check_tensor("cols", cols, dtypes=(torch.int32,), ndim=2, device=dev)
    if w is not None:
        _common.check_tensor("w", w, dtypes=(torch.float32,), ndim=2, device=dev)
        if w.shape != cols.shape:
            raise ValueError(f"w {tuple(w.shape)} and cols {tuple(cols.shape)} differ")
    if _common.use_plain(dev):
        return ell_gimv_ref(cols, w, v, semiring=semiring)
    rows, width = cols.shape
    out = torch.empty(rows, dtype=v.dtype, device=dev)
    if rows == 0:
        return out
    from repro_torch.kernels.build import check_rc, load

    fn = load("ell_gimv")
    with torch.cuda.device(dev):
        rc = fn(cols.data_ptr(), None if w is None else w.data_ptr(), v.data_ptr(),
                out.data_ptr(), rows, width, _common.SEMIRING_ID[semiring],
                _common.VALUE_TYPE_ID[v.dtype], _common.current_stream(dev))
    check_rc(rc, "ell_gimv")
    ell_gimv.launches += 1
    return out


ell_gimv.launches = 0


def ell_gimv_multi(cols: torch.Tensor, w: torch.Tensor | None, v: torch.Tensor, *,
                   semiring: str) -> torch.Tensor:
    """r[i, q] = combineAll_d combine2(w[i,d], v[cols[i,d], q]), pads
    (col < 0) skipped.  cols: int32 [R, D]; w: float32 [R, D] or None; v:
    float32 or int32 [N, Q] row-major (one query per column) -> r: [R, Q] in
    v's dtype.  Every col must be < N."""
    _common.check_semiring(semiring)
    dev = v.device
    _common.check_tensor("v", v, dtypes=(torch.float32, torch.int32), ndim=2, device=dev)
    _common.check_tensor("cols", cols, dtypes=(torch.int32,), ndim=2, device=dev)
    if w is not None:
        _common.check_tensor("w", w, dtypes=(torch.float32,), ndim=2, device=dev)
        if w.shape != cols.shape:
            raise ValueError(f"w {tuple(w.shape)} and cols {tuple(cols.shape)} differ")
    if _common.use_plain(dev):
        return ell_gimv_multi_ref(cols, w, v, semiring=semiring)
    rows, width = cols.shape
    nq = v.shape[1]
    out = torch.empty((rows, nq), dtype=v.dtype, device=dev)
    if rows == 0 or nq == 0:
        return out
    if width == 0:
        return out.fill_(_common.identity(semiring, v.dtype))
    from repro_torch.kernels.build import check_rc, load

    fn = load("ell_gimv_multi")
    with torch.cuda.device(dev):
        rc = fn(cols.data_ptr(), None if w is None else w.data_ptr(), v.data_ptr(),
                out.data_ptr(), rows, width, nq, _common.SEMIRING_ID[semiring],
                _common.VALUE_TYPE_ID[v.dtype], _common.current_stream(dev))
    check_rc(rc, "ell_gimv_multi")
    ell_gimv_multi.launches += 1
    return out


ell_gimv_multi.launches = 0
