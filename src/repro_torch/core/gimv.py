"""GIM-V: the generalized matrix-vector multiplication primitive (paper §2.3).

A graph algorithm is three operations over matrix elements m_{i,j} (edge
j -> i) and vector elements v_j:

    combine2(m_ij, v_j)       -> x_ij        (edge map)
    combineAll({x_ij}_j)      -> r_i         (per-row reduce)
    assign(v_i, r_i)          -> v'_i        (state update)

``combineAll`` is one of {sum, min, max} (commutative and associative, so
partial results can be streamed, Algorithm 2 line 8); ``combine2`` one of
{mul, add, src} (src: return v_j -- connected components).  ``assign`` and
the convergence metric are elementwise torch callables.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["GimvSpec", "combine2", "segment_combine", "scatter_combine",
           "identity_of", "combine_elementwise", "tree_combine", "torch_dtype"]

_COMBINE2 = ("mul", "add", "src")
_COMBINE_ALL = ("sum", "min", "max")
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype -> torch dtype (float32 / int32 are the spec dtypes)."""
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def identity_of(combine_all: str, dtype) -> Any:
    """Identity element of the combineAll monoid (a Python scalar)."""
    dtype = np.dtype(dtype)
    floating = np.issubdtype(dtype, np.floating)
    if combine_all == "sum":
        return np.zeros((), dtype=dtype).item()
    if combine_all == "min":
        return float("inf") if floating else int(np.iinfo(dtype).max)
    if combine_all == "max":
        return float("-inf") if floating else int(np.iinfo(dtype).min)
    raise ValueError(combine_all)


@dataclasses.dataclass(frozen=True)
class GimvSpec:
    """User-defined generalized matrix-vector multiplication M (x) v.

    Attributes:
      name: algorithm name.
      combine2: 'mul' | 'add' | 'src'.
      combine_all: 'sum' | 'min' | 'max'.
      dtype: numpy vector dtype (np.float32 for PR/RWR/SSSP, np.int32 for CC).
      assign: (v_local, r_local, ctx_local) -> v'_local, elementwise torch.
      init: (global_ids [m], ctx) -> v0 values [m] (numpy); padding ids >= n
        must be a fixed point of assign under identity input.
      edge_weight: (out_deg_src [E], base_w [E]) -> matrix values [E] (numpy,
        host-side at partition time).  None => use base_w as-is.
      delta: (v_local, v'_local) -> scalar convergence contribution; the
        engine stops when the total < tol.
      needs_weights: False for CC (weights never read, never stored).
    """

    name: str
    combine2: str
    combine_all: str
    dtype: Any
    assign: Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]
    init: Callable[[np.ndarray, dict], np.ndarray]
    edge_weight: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None
    delta: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    needs_weights: bool = True

    def __post_init__(self):
        if self.combine2 not in _COMBINE2:
            raise ValueError(f"combine2 must be one of {_COMBINE2}, got {self.combine2!r}")
        if self.combine_all not in _COMBINE_ALL:
            raise ValueError(f"combine_all must be one of {_COMBINE_ALL}, got {self.combine_all!r}")

    @property
    def identity(self):
        return identity_of(self.combine_all, self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def default_delta(self, v, v_new) -> torch.Tensor:
        if self.delta is not None:
            return self.delta(v, v_new)
        if np.issubdtype(np.dtype(self.dtype), np.floating):
            return torch.sum(torch.abs(v_new - v))
        return torch.sum((v_new != v).to(torch.float32))


def combine2(spec: GimvSpec, m, v_j: torch.Tensor) -> torch.Tensor:
    """x_ij = combine2(m_ij, v_j), vectorized over edges."""
    if spec.combine2 == "mul":
        return m * v_j
    if spec.combine2 == "add":
        return m + v_j
    if spec.combine2 == "src":
        return v_j
    raise ValueError(spec.combine2)


def segment_combine(spec: GimvSpec, x: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """combineAll over segments: r_i = combineAll({x_e : seg(e) == i}).

    ``seg_ids`` must lie in [0, num_segments).  Empty segments yield the
    monoid identity (the output is pre-filled with it), so assign sees the
    identity and keeps v_i.  A trailing axis on ``x`` ([E, Q]) reduces
    columnwise into [num_segments, Q].
    """
    out = torch.full((num_segments,) + tuple(x.shape[1:]), spec.identity,
                     dtype=x.dtype, device=x.device)
    index = seg_ids.to(torch.int64)
    if x.ndim > 1:
        index = index.reshape((-1,) + (1,) * (x.ndim - 1)).expand(x.shape)
    return out.scatter_reduce_(0, index, x, reduce=_REDUCE[spec.combine_all],
                               include_self=True)


def scatter_combine(spec: GimvSpec, base: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor) -> torch.Tensor:
    """base[idx] = combineAll(base[idx], val); a negative idx counts from the
    end (Python indexing), an idx still outside [0, len(base)) is dropped.
    Returns a new tensor (``base`` is not modified)."""
    n = base.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    ext = torch.cat([base, base.new_full((1,) + tuple(base.shape[1:]), spec.identity)])
    seg = torch.where(keep, idx.to(torch.int64), n)
    if val.ndim > 1:
        seg = seg.reshape((-1,) + (1,) * (val.ndim - 1)).expand(val.shape)
    ext.scatter_reduce_(0, seg, val.to(base.dtype), reduce=_REDUCE[spec.combine_all],
                        include_self=True)
    return ext[:n]


def combine_elementwise(spec: GimvSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """combineAll applied elementwise to two partial vectors."""
    if spec.combine_all == "sum":
        return a + b
    if spec.combine_all == "min":
        return torch.minimum(a, b)
    if spec.combine_all == "max":
        return torch.maximum(a, b)
    raise ValueError(spec.combine_all)


def tree_combine(spec: GimvSpec, parts: list) -> torch.Tensor:
    """combineAll over equal-shaped partial vectors via a pairwise tree fold:
    level k combines neighbors (0,1), (2,3), ... carrying an odd tail up
    unchanged.  The association order depends only on ``len(parts)``, the
    same order as the JAX package's ``tree_combine``, so float sums
    associate identically in both."""
    if not parts:
        raise ValueError("tree_combine needs at least one partial")
    level = list(parts)
    while len(level) > 1:
        nxt = [combine_elementwise(spec, level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]
