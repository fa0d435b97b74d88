"""PMV core on PyTorch: specs, pre-partitioning, planner, placements, engine.

``__all__`` is the JAX package's ``repro.core.__all__``; ``placement_call``
(the one placement step that ``make_step`` wraps) and ``from_reference``
(the JAX package's partition outputs carried into this package) are
importable here too."""
from repro_torch.core import cost_model, planner
from repro_torch.core.algorithms import (
    connected_components,
    pagerank,
    random_walk_with_restart,
    rwr_context,
    sssp,
)
from repro_torch.core.convert import from_reference
from repro_torch.core.engine import PMVEngine, PMVResult, StepConfig, make_step, placement_call
from repro_torch.core.gimv import GimvSpec
from repro_torch.core.partition import Partition, partition_graph
from repro_torch.core.planner import BlockPlan, ExecutionPlan

__all__ = [
    "GimvSpec",
    "PMVEngine",
    "PMVResult",
    "StepConfig",
    "make_step",
    "Partition",
    "partition_graph",
    "planner",
    "BlockPlan",
    "ExecutionPlan",
    "pagerank",
    "random_walk_with_restart",
    "rwr_context",
    "sssp",
    "connected_components",
    "cost_model",
]
