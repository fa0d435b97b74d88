"""Query model + batching policy for the PMV serving subsystem.

A copy of the JAX package's pure-Python batcher (repro.serving.batcher), so
that the port imports nothing of that package.

Queries are grouped by *family key* — the (algorithm kind, algorithm
parameters) tuple that determines the GIM-V semiring, the edge weights and
therefore the batched step they can share.  Within a family, waiting queries
are packed into fixed Q-bucket batches (a small set of batch widths keeps
the shapes the kernels see few), and the server admits waiting queries into
retired columns mid-loop (continuous batching, server.py).

Fairness across families is arrival-order: ``next_batch`` always serves the
family whose *oldest* waiting query arrived first.
"""
from __future__ import annotations

import dataclasses
from collections import deque

__all__ = ["Query", "QueryResult", "QueryBatcher", "DEFAULT_BUCKETS",
           "RETIREMENT_REASONS"]

DEFAULT_BUCKETS = (8, 16, 32, 64)

# Why a query's column left the batch (QueryResult.reason / the server's
# stats()["retirement_reasons"] ledger):
#   completed          converged or hit its iteration cap — vector is valid
#   deadline_exceeded  per-query deadline fired mid-solve — vector is the
#                      PARTIAL iterate at retirement (converged=False)
#   shed               admission control refused it (queue over max_queue) —
#                      never iterated, vector is None
#   failed             the batch died on an I/O error — vector is None,
#                      error says why
RETIREMENT_REASONS = ("completed", "deadline_exceeded", "shed", "failed")

_KINDS = ("pagerank", "rwr", "sssp", "cc")


@dataclasses.dataclass
class Query:
    """One GIM-V query against the resident pre-partitioned matrix.

    spec_kind: 'pagerank' | 'rwr' | 'sssp' | 'cc'.
    source: personalization / source vertex (ignored by pagerank and cc).
    tol: per-query convergence tolerance (the engine's delta metric, applied
      to this query's column only).
    c: restart probability (rwr) / damping (pagerank); part of the family
      key because it is baked into the spec's assign closure.
    max_iters: per-query iteration cap (None -> server default).
    """

    spec_kind: str
    source: int = 0
    tol: float = 1e-6
    c: float = 0.85
    max_iters: int | None = None
    # wall-clock budget from submit(); None = no deadline.  An expired query
    # retires with reason='deadline_exceeded' and its partial iterate.
    deadline_s: float | None = None

    # filled in by the server at submit() time
    qid: int | None = None
    t_submit: float | None = None

    def __post_init__(self):
        if self.spec_kind not in _KINDS:
            raise ValueError(f"unknown spec_kind {self.spec_kind!r}; one of {_KINDS}")

    @property
    def family_key(self) -> tuple:
        if self.spec_kind in ("rwr", "pagerank"):
            return (self.spec_kind, round(float(self.c), 9))
        return (self.spec_kind,)


@dataclasses.dataclass
class QueryResult:
    """Answer to one query: the converged (or capped) per-query vector."""

    qid: int
    query: Query
    vector: object            # np.ndarray [n]; None when shed / failed
    iterations: int
    converged: bool
    latency_s: float          # submit -> retire wall clock
    reason: str = "completed"  # one of RETIREMENT_REASONS
    error: str | None = None   # diagnosis when reason == 'failed'


class QueryBatcher:
    """FIFO queues per family + fixed Q-bucket padding policy."""

    def __init__(self, buckets: tuple[int, ...] = DEFAULT_BUCKETS):
        assert buckets and all(q > 0 for q in buckets)
        self.buckets = tuple(sorted(set(int(q) for q in buckets)))
        self._queues: dict[tuple, deque[tuple[int, Query]]] = {}  # (arrival seq, query)
        self._seq = 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def add(self, query: Query) -> None:
        self._queues.setdefault(query.family_key, deque()).append((self._seq, query))
        self._seq += 1

    def bucket_for(self, n_queries: int) -> int:
        """Smallest configured bucket >= n_queries (max bucket if none fit)."""
        for q in self.buckets:
            if n_queries <= q:
                return q
        return self.buckets[-1]

    def next_batch(self) -> tuple[tuple, list[Query]] | None:
        """Pop up to max-bucket queries of the family with the oldest head."""
        live = [(q[0][0], key) for key, q in self._queues.items() if q]
        if not live:
            return None
        _, key = min(live)
        queue = self._queues[key]
        batch = [queue.popleft()[1] for _ in range(min(len(queue), self.buckets[-1]))]
        return key, batch

    def pop_waiting(self, family_key: tuple) -> Query | None:
        """Next waiting query of the family (for mid-loop admission)."""
        queue = self._queues.get(family_key)
        if queue:
            return queue.popleft()[1]
        return None
