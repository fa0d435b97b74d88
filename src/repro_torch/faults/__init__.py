"""repro_torch.faults: the retry policy that bounds every disk fetch of the
out-of-core store.  The JAX package's fault injector (``FaultPlan``,
``faults=``) is not ported: ``PMVEngine(faults=...)`` raises."""
from repro_torch.faults.retry import DEFAULT_RETRY, FetchDeadlineError, RetryPolicy

__all__ = ["RetryPolicy", "DEFAULT_RETRY", "FetchDeadlineError"]
