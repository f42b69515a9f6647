"""Observability: the typed per-query telemetry
(:mod:`repro_torch.obs.telemetry`) and the pluggable metric trackers
(:mod:`repro_torch.obs.tracker`) that the index store counts on."""
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
