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
- :mod:`repro_torch.obs.profiler` -- standalone per-block kernel launch
  timing (``launch.ell`` / ``launch.dense`` spans with plan predictions).
- :mod:`repro_torch.obs.fleet` -- trace merging (one pid lane per
  ``Recorder.child`` shard or per exported document) and the
  ``fleet_report`` straggler / skew / overlap attribution over disk runs.
- :mod:`repro_torch.obs.live` -- rolling-window instruments, the SLO
  burn-rate tracker, and the OpenMetrics exporter behind
  ``PMVServer(telemetry=)``.

Not ported yet: the JAX package's SPMD per-worker ``pmv.io_*.w{k}``
series (this package runs no multi-worker mesh).
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
from repro_torch.obs.fleet import (
    FleetReport,
    fleet_report,
    merge_trace_docs,
    merge_traces,
    write_fleet_report,
)
from repro_torch.obs.live import (
    LiveTelemetry,
    SloTracker,
    TelemetryConfig,
    WindowedHistogram,
    WindowedRate,
    as_telemetry,
    format_top,
    openmetrics_text,
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
    "profile_block_launches",
    "merge_traces",
    "merge_trace_docs",
    "fleet_report",
    "FleetReport",
    "write_fleet_report",
    "LiveTelemetry",
    "TelemetryConfig",
    "SloTracker",
    "WindowedHistogram",
    "WindowedRate",
    "as_telemetry",
    "openmetrics_text",
    "format_top",
]


def profile_block_launches(*args, **kwargs):
    """Lazy forwarder: obs.profiler imports placement and the kernels, which
    the recorder-only consumers (engine, store) must not pay for at import."""
    from repro_torch.obs.profiler import profile_block_launches as fn

    return fn(*args, **kwargs)
