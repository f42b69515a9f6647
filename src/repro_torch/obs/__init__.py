"""Observability: the typed per-query telemetry
(:mod:`repro_torch.obs.telemetry`), the pluggable metric trackers
(:mod:`repro_torch.obs.tracker`) that the stores and the oracle service
count on, and the OpenMetrics exposition of any ``snapshot()`` dict with a
stdlib HTTP ``/metrics`` exporter (:mod:`repro_torch.obs.prometheus`)."""
from .prometheus import MetricsExporter, render_openmetrics  # noqa: F401
from .telemetry import (  # noqa: F401
    CascadeTelemetry,
    DispatchTelemetry,
    IndexTelemetry,
    OracleTelemetry,
    QueryTelemetry,
    StoreTelemetry,
    StratifyTelemetry,
    TelemetryView,
)
from .tracker import (  # noqa: F401
    NULL_TRACKER,
    InMemoryTracker,
    JsonlTracker,
    NoopTracker,
    StreamingHistogram,
    Tracker,
    make_tracker,
    merge_snapshots,
)
