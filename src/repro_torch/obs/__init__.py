"""repro_torch.obs: zero-overhead-when-disabled tracing + metrics for the
PMV pipeline (this package's counterpart of the JAX package's ``repro.obs``).

- :mod:`repro_torch.obs.recorder` -- Recorder (spans + metrics registry),
  the NULL_RECORDER no-op singleton, and ``as_recorder`` (the ``obs=`` knob
  normalizer shared by PMVEngine / PMVServer / DiskBlockStore).
  ``Recorder.fence`` synchronizes the CUDA devices a value lives on.
- :mod:`repro_torch.obs.trace` -- Chrome trace-event JSON export (Perfetto /
  ``chrome://tracing``) plus schema + span-nesting validators.
- :mod:`repro_torch.obs.report` -- predicted-vs-measured cost calibration
  and the ``explain(live=True)`` report section.

Not ported yet: the JAX package's ``profiler`` (``profile_block_launches``),
``fleet`` and ``live`` (``PMVServer(telemetry=)``).
"""
from repro_torch.obs.recorder import (
    NULL_RECORDER,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRecorder,
    Recorder,
    Series,
    as_recorder,
)
from repro_torch.obs.report import (
    bench_obs_doc,
    calibration_summary,
    collect_launches,
    format_calibration,
    format_live_report,
    write_bench_obs,
)
from repro_torch.obs.trace import (
    TraceSchemaError,
    check_span_nesting,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "Recorder",
    "NullRecorder",
    "NULL_RECORDER",
    "as_recorder",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "Series",
    "to_chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "check_span_nesting",
    "TraceSchemaError",
    "collect_launches",
    "calibration_summary",
    "bench_obs_doc",
    "write_bench_obs",
    "format_live_report",
    "format_calibration",
]
