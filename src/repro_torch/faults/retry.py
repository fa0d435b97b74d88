"""Bounded retry with exponential backoff and seeded jitter (this package's
own copy of the JAX package's ``repro.faults.retry``).

One :class:`RetryPolicy` instance governs every fetch of one executor run:
``policy.call(fn)`` retries ``fn`` on *retryable* errors — transient
``OSError`` and :class:`~repro_torch.store.manifest.ShardCorruptError` (a
re-read of a transiently corrupted slice is the recovery path) — up to
``max_attempts`` total attempts and a per-call ``deadline_s`` wall budget,
whichever bites first.  Permanent errors (``FileNotFoundError`` — a missing
shard won't reappear) fail fast, as does anything non-I/O.

Backoff is ``base_delay_s * 2**(attempt-1)`` capped at ``max_delay_s``, with
multiplicative jitter drawn from a seeded RNG so a run's retry timing is
reproducible.  Every re-attempt counts ``fault.retry`` (and
``fault.retry.<label>``) on the caller's recorder, every call that succeeds
after one counts ``fault.recovered``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

__all__ = ["RetryPolicy", "FetchDeadlineError", "DEFAULT_RETRY"]


class FetchDeadlineError(RuntimeError):
    """The per-call retry deadline elapsed before a successful attempt; the
    last underlying error is chained as ``__cause__``."""


def _is_retryable(exc: BaseException) -> bool:
    from repro_torch.store.manifest import ShardCorruptError

    if isinstance(exc, FileNotFoundError):
        return False                       # a missing shard is permanent
    return isinstance(exc, (OSError, ShardCorruptError))


@dataclasses.dataclass
class RetryPolicy:
    """Retry budget for I/O calls (see module docstring).

    ``max_attempts`` counts the first try: 3 means one try + two retries.
    ``deadline_s`` is per ``call()`` (one block fetch), not per run.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.005
    max_delay_s: float = 0.25
    jitter: float = 0.25
    deadline_s: float | None = 30.0
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        self._rng = np.random.default_rng(self.seed)

    @property
    def retry_budget(self) -> int:
        """Re-attempts the policy can add to one call."""
        return self.max_attempts - 1

    def _backoff(self, attempt: int) -> float:
        d = min(self.max_delay_s, self.base_delay_s * (2.0 ** (attempt - 1)))
        return d * (1.0 + self.jitter * float(self._rng.random()))

    def call(self, fn, *, obs=None, label: str = ""):
        """Run ``fn()`` under this policy; returns its value or raises the
        last error (typed, diagnosis preserved) once the budget is spent.
        ``obs`` (a recorder, or None) receives the retry counters."""
        from repro_torch.obs.recorder import as_recorder

        rec = as_recorder(obs)
        t0 = time.perf_counter()
        last: BaseException | None = None
        for attempt in range(1, self.max_attempts + 1):
            if attempt > 1:
                rec.counter("fault.retry").add(1)
                if label:
                    rec.counter(f"fault.retry.{label}").add(1)
                time.sleep(self._backoff(attempt - 1))
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — classified right below
                if not _is_retryable(e):
                    raise
                last = e
                if self.deadline_s is not None and time.perf_counter() - t0 > self.deadline_s:
                    raise FetchDeadlineError(
                        f"retry deadline {self.deadline_s}s exceeded after "
                        f"{attempt} attempt(s){' on ' + label if label else ''}: "
                        f"{e}") from e
                continue
            if attempt > 1:
                rec.counter("fault.recovered").add(1)
            return out
        assert last is not None
        raise last


DEFAULT_RETRY = RetryPolicy()
