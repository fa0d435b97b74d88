"""Graph algorithms expressed on GIM-V (paper Table 2).

Each factory returns a :class:`GimvSpec`.  Conventions (identical to the JAX
package's, so both give the same answers):

- PageRank / RWR use the *normalized* formulation (v sums to 1, assign uses
  (1-d)/n resp. (1-c)*restart).
- The PageRank matrix is column-stochastic: m_{i,j} = 1/out(j) for each edge
  j -> i.  Dangling vertices (out-degree 0) leak mass, as PEGASUS does.
- SSSP/CC use min-combine; unreached vertices carry +inf / their own id.
- CC requires symmetric edges (engine option ``symmetrize=True``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gimv import GimvSpec

__all__ = ["pagerank", "random_walk_with_restart", "rwr_context", "sssp",
           "connected_components"]

_F32_INF = np.float32(np.inf)


def _changed(v, v_new):
    return torch.sum((v_new != v).to(torch.float32))


def pagerank(n: int, damping: float = 0.85) -> GimvSpec:
    """combine2 = m*v, combineAll = sum, assign = (1-d)/n + d*r."""
    base = float(np.float32((1.0 - damping) / n))
    d = float(np.float32(damping))

    def assign(v, r, ctx):
        del v, ctx
        return base + d * r

    def init(ids, ctx):
        del ctx
        return np.full(ids.shape, 1.0 / n, dtype=np.float32)

    def edge_weight(out_deg_src, base_w):
        del base_w
        return (1.0 / np.maximum(out_deg_src, 1)).astype(np.float32)

    return GimvSpec(name="pagerank", combine2="mul", combine_all="sum",
                    dtype=np.float32, assign=assign, init=init,
                    edge_weight=edge_weight)


def random_walk_with_restart(n: int, source: int, c: float = 0.85) -> GimvSpec:
    """RWR: assign = (1-c)*1[i==source] + c*r (normalized Table-2 form).

    ctx must contain 'restart' (see :func:`rwr_context`)."""
    keep = float(np.float32(1.0 - c))
    cc = float(np.float32(c))

    def assign(v, r, ctx):
        del v
        return keep * ctx["restart"] + cc * r

    def init(ids, ctx):
        del ctx
        return (ids == source).astype(np.float32)

    def edge_weight(out_deg_src, base_w):
        del base_w
        return (1.0 / np.maximum(out_deg_src, 1)).astype(np.float32)

    return GimvSpec(name="rwr", combine2="mul", combine_all="sum",
                    dtype=np.float32, assign=assign, init=init,
                    edge_weight=edge_weight)


def rwr_context(n: int, source: int) -> dict:
    """Global ctx arrays for RWR (the engine blocks them alongside v)."""
    restart = np.zeros(n, dtype=np.float32)
    restart[source] = 1.0
    return {"restart": restart}


def sssp(source: int, default_weight: float = 1.0) -> GimvSpec:
    """Single-source shortest path: combine2 = m+v, combineAll = min,
    assign = min(v, r)."""
    del default_weight

    def assign(v, r, ctx):
        del ctx
        return torch.minimum(v, r)

    def init(ids, ctx):
        del ctx
        return np.where(ids == source, np.float32(0.0), _F32_INF)

    def edge_weight(out_deg_src, base_w):
        del out_deg_src
        if base_w is None:
            return None  # engine fills default
        return base_w.astype(np.float32)

    return GimvSpec(name="sssp", combine2="add", combine_all="min",
                    dtype=np.float32, assign=assign, init=init,
                    edge_weight=edge_weight, delta=_changed)


def connected_components() -> GimvSpec:
    """Min-label propagation: combine2 = v_j, combineAll = min,
    assign = min(v, r).  int32 labels = vertex ids."""

    def assign(v, r, ctx):
        del ctx
        return torch.minimum(v, r)

    def init(ids, ctx):
        del ctx
        return ids.astype(np.int32)

    return GimvSpec(name="cc", combine2="src", combine_all="min",
                    dtype=np.int32, assign=assign, init=init,
                    edge_weight=None, delta=_changed, needs_weights=False)
