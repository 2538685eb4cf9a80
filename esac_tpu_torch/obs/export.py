"""Export surface: Prometheus text, trace rendering and artifact
provenance (counterpart of ``esac_tpu/obs/export.py``).

:func:`render_prometheus` turns a :meth:`MetricsRegistry.snapshot` into
the text exposition format scrapers expect (the same lines the JAX
package renders); :func:`render_traces` draws the slowest sampled traces;
:func:`provenance` is the block a results file embeds to record which obs
schema produced it (and, where a fleet ran, its snapshot).  ``jsonable``
(``obs/metrics.py``) is re-exported here, where the JAX package keeps it.

Pure host code: no torch import.
"""

from __future__ import annotations

import math

from esac_tpu_torch.obs.metrics import OBS_SCHEMA, jsonable

# Every collector the serving stack registers, with the key fields its
# rendered block carries (the JAX package's table, lock and outcome
# witnesses included): a new collector is added here with its fields,
# and the renderer below flattens every collector's numeric leaves into
# Prometheus samples either way.
KNOWN_COLLECTORS = {
    # dispatcher
    "serve_slo_totals": ("offered", "served", "pending"),
    "serve_dispatch_totals": (),          # lane -> count (dynamic keys)
    "serve_quarantined_lanes": (),        # lane -> reason (non-numeric)
    # scene registry / health
    "scene_health": (),                   # scenes/canaries/events
    "weight_cache": ("hits", "misses", "host_hits", "disk_loads",
                     "demotions", "resident", "bytes_in_use"),
    # host tier + prefetcher
    "host_tier": ("hits", "misses", "admissions", "resident",
                  "bytes_in_use"),
    "prefetch": ("issued_device", "issued_host", "hits", "wasted",
                 "failures", "posterior_feeds", "cycles"),
    # replica fleet
    "fleet": (),                          # per-replica merge (dynamic)
    # retrieval front end: image-tier accounting, recall proxies,
    # posterior evidence
    "retrieval": ("offered", "served", "shed", "expired", "failed",
                  "pending", "decided", "missed_low_confidence",
                  "missed_no_candidate", "missed_tripped",
                  "tripped_skipped", "posterior_entropy_mean",
                  "candidate_fanout_mean", "winners_noted", "top1_hits",
                  "winner_in_topk", "recall_proxy_top1",
                  "prefetch_feeds", "enrolled"),
    # tracked sessions
    "session": ("sessions", "opened", "closed", "evicted", "frames",
                "tracked_frames", "full_frames", "tracked_frac",
                "track_losses", "track_entries", "budget_saved_hyps",
                "dispatch_errors"),
    # runtime witnesses (attached by tests only)
    "lock_witness": (),
    "fault_taxonomy": ("committed_errors", "committed_edges"),
    # causal traces, time axis, health rules
    "traces": ("added", "retained"),
    "timeline": ("ticks", "windows_retained", "window_s"),
    "health_alerts": (),
}


def _prom_escape(v) -> str:
    s = str(v)
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_prom_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _prom_value(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, float) and not math.isfinite(v):
        return "NaN" if math.isnan(v) else ("+Inf" if v > 0 else "-Inf")
    return repr(float(v))


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition of a :meth:`MetricsRegistry.snapshot`
    dict.  Counters and gauges render directly; histograms as summaries
    (quantile-labeled samples, ``_count`` and ``_sum``); every collector
    block's numeric leaves as ``esac_collector_value{collector=...,
    path=...}`` samples, so the next collector renders by construction; a
    collector with no numeric leaf still appears as a comment, so the page
    names every surface.  The header line is the JAX package's, so one
    scraper reads both."""
    lines = [f"# esac_tpu obs schema {snapshot.get('obs_schema')}"]
    for name, m in sorted(snapshot.get("metrics", {}).items()):
        kind = m.get("kind", "untyped")
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(
            f"# TYPE {name} {'summary' if kind == 'histogram' else kind}"
        )
        for s in m.get("samples", []):
            labels = s.get("labels", {})
            if kind == "histogram":
                for k, v in s.items():
                    if k.startswith("p") and k[1:].isdigit():
                        q = int(k[1:]) / 100.0
                        lines.append(
                            f"{name}{_prom_labels({**labels, 'quantile': q})}"
                            f" {_prom_value(v)}"
                        )
                lines.append(
                    f"{name}_count{_prom_labels(labels)} "
                    f"{_prom_value(s.get('count', 0))}"
                )
                lines.append(
                    f"{name}_sum{_prom_labels(labels)} "
                    f"{_prom_value(s.get('sum', 0.0))}"
                )
            else:
                lines.append(
                    f"{name}{_prom_labels(labels)} "
                    f"{_prom_value(s.get('value'))}"
                )
    collectors = snapshot.get("collectors", {})
    if collectors:
        from esac_tpu_torch.obs.timeline import flatten_numeric

        lines.append("# TYPE esac_collector_value untyped")
    for cname in sorted(collectors):
        flat = flatten_numeric(collectors[cname]) \
            if isinstance(collectors[cname], dict) else {}
        lines.append(
            f"# COLLECTOR {cname} ({len(flat)} numeric leaves; full "
            "structure in the JSON snapshot)"
        )
        for path in sorted(flat):
            labels = _prom_labels({"collector": cname, "path": path})
            lines.append(f"esac_collector_value{labels} "
                         f"{_prom_value(flat[path])}")
    return "\n".join(lines) + "\n"


def render_traces(snapshot: dict, k: int = 5) -> str:
    """Human rendering of the K slowest sampled traces carried by a
    snapshot's ``traces`` collector (``python -m esac_tpu_torch.obs
    --traces``): per trace the root stage walk (the fleet telescoping
    partition), each dispatch's nested bucket-call stages under
    ``dispatched`` (host, and the card's time beside them), and the child
    span tree with per-stage durations."""
    block = snapshot.get("collectors", {}).get("traces")
    if not isinstance(block, dict) or not block.get("slowest"):
        return ("no sampled traces in this snapshot (enable "
                "FleetPolicy.trace_sample / MicroBatchDispatcher("
                "trace=True) and re-capture)\n")
    out = [f"{min(k, len(block['slowest']))} slowest sampled traces "
           f"({block.get('retained', '?')} retained, "
           f"{block.get('added', '?')} recorded):"]

    def ms(v):
        return f"{v * 1e3:.2f}ms" if isinstance(v, (int, float)) else "?"

    for t in block["slowest"][:k]:
        out.append(
            f"\ntrace {t.get('trace_id')}  scene={t.get('scene')} "
            f"outcome={t.get('outcome')}  total={ms(t.get('total_s'))}  "
            f"(1-in-{t.get('sampled_1_in', 1)} sampled, "
            f"residual {t.get('residual_s', 0):.2e}s)"
        )
        nested = dict(t.get("nested_stages", []))
        for stage, dt in t.get("root_stages", []):
            out.append(f"  |- {stage:<18} {ms(dt)}")
            for key in [k for k in nested if k.startswith(stage + ".")]:
                sub = key[len(stage) + 1:]
                gpu = nested.get("gpu." + sub)
                out.append(f"  |    .  {sub:<13} {ms(nested.pop(key))}"
                           + (f"  (gpu {ms(gpu)})" if gpu is not None else ""))
        spans = t.get("spans", [])
        by_parent: dict = {}
        for s in spans:
            by_parent.setdefault(s.get("parent_id"), []).append(s)

        def walk(parent, depth):
            for s in by_parent.get(parent, []):
                ann = s.get("annotations", {})
                ann_s = " ".join(f"{a}={ann[a]}" for a in sorted(ann))
                dur = (ms(s.get("duration_s"))
                       if s.get("kind") != "event" else "event")
                out.append(f"  {'   ' * depth}+- [{s.get('kind')}] "
                           f"{s.get('name')}  {dur}  {ann_s}".rstrip())
                for stage, dt in s.get("stages", []) or []:
                    out.append(f"  {'   ' * (depth + 1)}.  "
                               f"{stage:<16} {ms(dt)}")
                walk(s.get("span_id"), depth + 1)

        walk(None, 0)
    return "\n".join(out) + "\n"


def provenance(fleet_snapshot: dict | None = None) -> dict:
    """The obs provenance block a results file embeds: the schema version
    that produced it plus, when a fleet ran, its full ``obs.snapshot()``."""
    out = {
        "obs_schema": OBS_SCHEMA,
        "has_fleet_snapshot": fleet_snapshot is not None,
    }
    if fleet_snapshot is not None:
        out["fleet"] = jsonable(fleet_snapshot)
    return out
