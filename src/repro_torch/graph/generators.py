"""Graph generators (host-side, numpy).

The paper evaluates on web-scale real graphs (ClueWeb12/09, YahooWeb, Twitter)
and an RMAT synthetic graph (a=0.57, b=0.19, c=0.19, d=0.05, via TegViz).  We
provide an RMAT generator with the same parameterization plus small
deterministic fixtures used by tests and examples.

Edges are (src, dst) int64 arrays of shape [E, 2]; the GIM-V matrix element
m_{i,j} corresponds to the edge j -> i (dst = row, src = column), matching the
message-passing reading of Figure 2 in the paper.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "rmat",
    "erdos_renyi",
    "chain_graph",
    "star_graph",
    "complete_graph",
    "paper_example_graph",
    "dedup_edges",
    "symmetrize_edges",
]


def dedup_edges(edges: np.ndarray) -> np.ndarray:
    """Remove duplicate (src, dst) pairs, keeping edge order canonical."""
    if edges.size == 0:
        return edges.reshape(0, 2)
    key = edges[:, 0].astype(np.int64) * (edges.max() + 1) + edges[:, 1]
    _, idx = np.unique(key, return_index=True)
    return edges[np.sort(idx)]


def symmetrize_edges(edges: np.ndarray) -> np.ndarray:
    """Add reverse edges (required by connected components on directed input)."""
    rev = edges[:, ::-1]
    return dedup_edges(np.concatenate([edges, rev], axis=0))


def rmat(
    log2_n: int,
    n_edges: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    d: float = 0.05,
    seed: int = 0,
    remove_self_loops: bool = True,
    dedup: bool = False,
) -> np.ndarray:
    """RMAT generator with the paper's TegViz parameters (Section 4.1).

    Fully vectorized: for each of ``log2_n`` recursion levels, draw the
    quadrant for all edges at once.  Quadrants: 0->(0,0) w.p. a, 1->(0,1) w.p.
    b, 2->(1,0) w.p. c, 3->(1,1) w.p. d, where the first bit extends the row
    (dst) and the second the column (src).
    """
    assert abs(a + b + c + d - 1.0) < 1e-9
    rng = np.random.default_rng(seed)
    n = 1 << log2_n
    probs = np.array([a, b, c, d])
    dst = np.zeros(n_edges, dtype=np.int64)
    src = np.zeros(n_edges, dtype=np.int64)
    for _ in range(log2_n):
        quad = rng.choice(4, size=n_edges, p=probs)
        dst = (dst << 1) | (quad >> 1)
        src = (src << 1) | (quad & 1)
    edges = np.stack([src, dst], axis=1)
    if remove_self_loops:
        edges = edges[edges[:, 0] != edges[:, 1]]
    if dedup:
        edges = dedup_edges(edges)
    assert edges[:, 0].max(initial=0) < n and edges[:, 1].max(initial=0) < n
    return edges


def erdos_renyi(n: int, n_edges: int, *, seed: int = 0, dedup: bool = True) -> np.ndarray:
    """Uniform random directed graph with ~n_edges edges (no self loops)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=n_edges, dtype=np.int64)
    dst = rng.integers(0, n, size=n_edges, dtype=np.int64)
    edges = np.stack([src, dst], axis=1)
    edges = edges[src != dst]
    if dedup:
        edges = dedup_edges(edges)
    return edges


def chain_graph(n: int) -> np.ndarray:
    """0 -> 1 -> ... -> n-1."""
    src = np.arange(n - 1, dtype=np.int64)
    return np.stack([src, src + 1], axis=1)


def star_graph(n: int) -> np.ndarray:
    """Hub 0 -> {1..n-1}: one max-out-degree vertex (hybrid dense region)."""
    dst = np.arange(1, n, dtype=np.int64)
    return np.stack([np.zeros(n - 1, dtype=np.int64), dst], axis=1)


def complete_graph(n: int) -> np.ndarray:
    """All ordered pairs (i != j): the fully dense matrix."""
    src, dst = np.meshgrid(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64), indexing="ij")
    mask = src != dst
    return np.stack([src[mask], dst[mask]], axis=1)


def paper_example_graph() -> np.ndarray:
    """A 6-vertex, 9-edge graph consistent with Figure 2 of the paper.

    Vertex 4 receives messages from {1, 3, 6} and sends to {2, 5} (1-indexed
    in the paper; 0-indexed here: 3 receives from {0, 2, 5}, sends to {1, 4}).
    """
    edges_1idx = [
        (1, 4), (3, 4), (6, 4),   # in-neighbors of 4
        (4, 2), (4, 5),           # out-neighbors of 4
        (1, 2), (2, 3), (5, 6), (6, 1),
    ]
    return np.array([(s - 1, t - 1) for s, t in edges_1idx], dtype=np.int64)
