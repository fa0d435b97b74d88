"""Carry the JAX package's pre-partitioned matrix into this package.

PMV has no learned weights; its parameters are the pre-partitioned matrix.
:func:`from_reference` rebuilds the JAX package's partition outputs
(``Partition``, ``GraphStats``, ``BlockEdges``, ``DenseRegion``,
``EllBucket``, ``DenseGroup``, ``PlannedStripe``, ``PartitionedMatrix``,
``HybridMatrix``, and lists / tuples / dicts of them) as this package's
dataclasses of numpy arrays.  It matches them by class and field name and
reads every array through ``np.asarray``, so it never imports the JAX
package, and one partition can feed both packages' steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.blocks import (BlockEdges, DenseGroup, DenseRegion, EllBucket,
                                     PlannedStripe)
from repro_torch.core.partition import HybridMatrix, Partition, PartitionedMatrix
from repro_torch.graph.stats import GraphStats

__all__ = ["from_reference"]

_CLASSES = {cls.__name__: cls for cls in (
    Partition, GraphStats, BlockEdges, DenseRegion, EllBucket, DenseGroup,
    PlannedStripe, PartitionedMatrix, HybridMatrix)}


def from_reference(obj):
    """Convert one of the JAX package's partition outputs (see module doc)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_reference(x) for x in obj)
    if isinstance(obj, dict):
        return {k: from_reference(x) for k, x in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        cls = _CLASSES.get(name)
        if cls is None:
            raise TypeError(f"no repro_torch counterpart for {name}")
        return cls(**{f.name: from_reference(getattr(obj, f.name))
                      for f in dataclasses.fields(cls)})
    if hasattr(obj, "__array__"):
        return np.asarray(obj)
    raise TypeError(f"cannot convert {type(obj).__name__}")
