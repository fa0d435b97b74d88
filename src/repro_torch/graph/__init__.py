"""Host-side graph generators and degree statistics (numpy; shared shapes
with the JAX package's ``repro.graph``, kept as this package's own copy)."""
from repro_torch.graph.generators import (
    chain_graph,
    complete_graph,
    erdos_renyi,
    paper_example_graph,
    rmat,
    star_graph,
    symmetrize_edges,
)
from repro_torch.graph.stats import GraphStats, compute_stats

__all__ = [
    "rmat",
    "erdos_renyi",
    "chain_graph",
    "star_graph",
    "complete_graph",
    "paper_example_graph",
    "symmetrize_edges",
    "GraphStats",
    "compute_stats",
]
