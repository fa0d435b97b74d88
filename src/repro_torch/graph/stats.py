"""Degree statistics used by the PMV cost model (Lemma 3.3 inputs).

The paper's hybrid cost model needs the empirical in-degree distribution
p_in(d) and the cumulative out-degree distribution P_out(theta) -- "the ratio
of vertices whose out-degree is less than theta".
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GraphStats", "compute_stats"]


@dataclasses.dataclass(frozen=True)
class GraphStats:
    n: int
    n_edges: int
    out_deg: np.ndarray          # [n] int64
    in_deg: np.ndarray           # [n] int64
    density: float               # |M| / |v|^2

    def p_out_below(self, theta: float) -> float:
        """P_out(theta): fraction of vertices with out-degree < theta."""
        if theta == np.inf:
            return 1.0
        return float(np.mean(self.out_deg < theta))

    def in_degree_hist(self) -> tuple[np.ndarray, np.ndarray]:
        """(degrees, p_in(d)) over observed in-degrees (sparse histogram)."""
        degs, counts = np.unique(self.in_deg, return_counts=True)
        return degs, counts / self.n

    def out_degree_values(self) -> np.ndarray:
        """Sorted distinct out-degrees: candidate thetas for the θ* search."""
        return np.unique(self.out_deg)


def compute_stats(edges: np.ndarray, n: int) -> GraphStats:
    out_deg = np.bincount(edges[:, 0], minlength=n).astype(np.int64)
    in_deg = np.bincount(edges[:, 1], minlength=n).astype(np.int64)
    return GraphStats(
        n=n,
        n_edges=int(edges.shape[0]),
        out_deg=out_deg,
        in_deg=in_deg,
        density=float(edges.shape[0]) / float(n) ** 2,
    )
