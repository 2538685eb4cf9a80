"""Serving observability (counterpart of ``esac_tpu/obs``): metric
instruments and the metrics registry, span chains and causal traces, the
windowed :class:`Timeline`, the health :class:`RuleEngine` over it, and
the export surface (Prometheus text, ``jsonable``, ``provenance``, the
``python -m esac_tpu_torch.obs`` dump).  Pure host code."""

from esac_tpu_torch.obs.export import provenance, render_prometheus, render_traces
from esac_tpu_torch.obs.metrics import (
    OBS_SCHEMA,
    CounterVec,
    GaugeVec,
    HistogramVec,
    MetricsRegistry,
    StreamingHistogram,
    jsonable,
)
from esac_tpu_torch.obs.rules import Alert, RuleEngine, default_rules
from esac_tpu_torch.obs.timeline import Timeline
from esac_tpu_torch.obs.trace import (
    SERVE_STAGES,
    STAGES,
    Span,
    SpanChain,
    StageClock,
    TERMINAL_STAGES,
    Trace,
    TraceStore,
    active_traces,
    close_range,
    current_issuer,
    host_range,
    issuer_scope,
    new_trace_id,
    open_range,
    serve_stage,
    stage_scope,
    top_level,
    trace_scope,
)

__all__ = [
    "OBS_SCHEMA",
    "Alert",
    "CounterVec",
    "GaugeVec",
    "HistogramVec",
    "MetricsRegistry",
    "RuleEngine",
    "SERVE_STAGES",
    "Span",
    "SpanChain",
    "STAGES",
    "StageClock",
    "StreamingHistogram",
    "TERMINAL_STAGES",
    "Timeline",
    "Trace",
    "TraceStore",
    "active_traces",
    "current_issuer",
    "close_range",
    "default_rules",
    "host_range",
    "issuer_scope",
    "jsonable",
    "new_trace_id",
    "open_range",
    "provenance",
    "render_prometheus",
    "render_traces",
    "serve_stage",
    "stage_scope",
    "top_level",
    "trace_scope",
]
