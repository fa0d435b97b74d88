"""repro_torch.faults: deterministic fault injection and the recovery
machinery (this package's counterpart of the JAX package's ``repro.faults``).

- :mod:`repro_torch.faults.plan` -- FaultPlan (a seeded schedule of shard
  corruption, transient IOError, slow fetch, broken prefetch and
  kill-at-iteration events), the FaultInjector runtime, and the ``faults=``
  knob normalizer (``as_injector``) shared by PMVEngine / PMVServer /
  DiskBlockStore.
- :mod:`repro_torch.faults.retry` -- RetryPolicy (bounded attempts,
  exponential backoff with seeded jitter, per-call deadline) around every
  disk fetch.

The recovery contract: a run under a *recoverable* FaultPlan (every
corruption transient, every IOError within the retry budget, a kill only
after a checkpoint) gives results bitwise equal to the fault-free run, with
every injected fault visible in the obs metrics.
"""
from repro_torch.faults.plan import (
    FAULT_KINDS,
    BreakPrefetch,
    CorruptFetch,
    FaultInjector,
    FaultPlan,
    InjectedIOError,
    InjectedKill,
    KillAtIteration,
    SlowFetch,
    TransientIO,
    as_injector,
)
from repro_torch.faults.retry import DEFAULT_RETRY, FetchDeadlineError, RetryPolicy

__all__ = [
    "FAULT_KINDS",
    "FaultPlan",
    "FaultInjector",
    "CorruptFetch",
    "TransientIO",
    "SlowFetch",
    "BreakPrefetch",
    "KillAtIteration",
    "InjectedIOError",
    "InjectedKill",
    "as_injector",
    "RetryPolicy",
    "DEFAULT_RETRY",
    "FetchDeadlineError",
]
