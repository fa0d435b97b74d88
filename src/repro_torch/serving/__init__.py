"""repro_torch.serving: batched multi-query GIM-V serving (continuous batching).

Pre-partition once, answer many concurrent queries against the resident
matrix on the card -- see server.py for the design notes.
"""
from repro_torch.serving.batcher import (DEFAULT_BUCKETS, RETIREMENT_REASONS, Query,
                                         QueryBatcher, QueryResult)
from repro_torch.serving.server import (FAMILIES, PMVServer, QueryFamily, make_batched_step,
                                        per_query_delta)

__all__ = [
    "DEFAULT_BUCKETS",
    "FAMILIES",
    "PMVServer",
    "Query",
    "QueryBatcher",
    "QueryFamily",
    "QueryResult",
    "RETIREMENT_REASONS",
    "make_batched_step",
    "per_query_delta",
]
