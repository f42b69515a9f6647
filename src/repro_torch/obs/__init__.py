"""Typed per-query telemetry (:mod:`repro_torch.obs.telemetry`)."""
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
