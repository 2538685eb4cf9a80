"""Serving observability (the part of ``esac_tpu/obs`` the dispatcher and
the registry import): metric instruments, the metrics registry, span
chains and causal traces.  Pure host code."""

from esac_tpu_torch.obs.metrics import (
    OBS_SCHEMA,
    CounterVec,
    GaugeVec,
    HistogramVec,
    MetricsRegistry,
    StreamingHistogram,
    jsonable,
)
from esac_tpu_torch.obs.trace import (
    STAGES,
    Span,
    SpanChain,
    TERMINAL_STAGES,
    Trace,
    TraceStore,
    active_traces,
    current_issuer,
    issuer_scope,
    new_trace_id,
    trace_scope,
)

__all__ = [
    "OBS_SCHEMA",
    "CounterVec",
    "GaugeVec",
    "HistogramVec",
    "MetricsRegistry",
    "Span",
    "SpanChain",
    "STAGES",
    "StreamingHistogram",
    "TERMINAL_STAGES",
    "Trace",
    "TraceStore",
    "active_traces",
    "current_issuer",
    "issuer_scope",
    "jsonable",
    "new_trace_id",
    "trace_scope",
]
