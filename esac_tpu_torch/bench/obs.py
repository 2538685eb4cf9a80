"""``obs`` mode (counterpart of ``bench.py``'s ``_measure_obs`` and
``_measure_obs_fleet``): the observability overhead gate (DESIGN.md §14).
The SAME serve function driven through the request path with tracing OFF vs
ON in interleaved passes; the verdict is the median of per-pair wall ratios
(tracing-on throughput within 3% of off) and NO new batch signature
(tracing is host bookkeeping).  Two evidence legs ride along: span integrity
(every traced request's stage durations fsum to its end-to-end latency) and
export (the snapshot round-trips ``json.dumps``).

The fleet leg lifts the same protocol through a FleetRouter over 2 replicas
sharing ONE serve function, with 1-in-1 trace sampling, the windowed
timeline and the health rules on in the traced leg, plus a forced
watchdog-failover drill whose trace must still telescope exactly."""

from __future__ import annotations

import gc
import json
import math
import threading
import time

from esac_tpu_torch.bench.constants import C, OBS_FRAMES, OBS_HYPS, OBS_REPEATS
from esac_tpu_torch.bench.fixtures import join_threads_started_since, med
from esac_tpu_torch.bench.serve import correspondence_requests
from esac_tpu_torch.fleet.router import FleetPolicy, FleetRouter, Replica
from esac_tpu_torch.obs import STAGES, top_level
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher, make_dsac_serve_fn
from esac_tpu_torch.serve.slo import FaultInjector, SLOPolicy
from esac_tpu_torch.utils.precision import resolve_device


def measure_obs(n_frames: int = OBS_FRAMES, n_hyps: int = OBS_HYPS,
                repeats: int = OBS_REPEATS, device=None) -> dict:
    dev = resolve_device(device)
    cfg = RansacConfig(n_hyps=n_hyps, frame_buckets=(1,))
    fn = make_dsac_serve_fn(C, cfg, device=dev)
    frames = correspondence_requests(n_frames)

    # One shared serve function: warm once, then count batch signatures
    # around the whole traced sweep.
    warm = MicroBatchDispatcher(fn, cfg, start_worker=False, device=dev)
    warm.infer_one(frames[0])
    compiled_before = warm.cache_size()
    warm.close()

    def timed_pass(trace):
        disp = MicroBatchDispatcher(fn, cfg, start_worker=False, trace=trace, device=dev)
        t0 = time.perf_counter()
        for fr in frames:
            disp.infer_one(fr)
        dt = time.perf_counter() - t0
        q = disp.latency_quantiles()
        disp.close()
        return dt, q

    offs, ons, q_offs, q_ons = [], [], [], []
    for _ in range(repeats):
        # A gen-2 GC pause mid-pass reads as overhead on whichever leg it
        # lands; pay it between passes.
        gc.collect()
        dt, q = timed_pass(False)
        offs.append(dt)
        q_offs.append(q)
        gc.collect()
        dt, q = timed_pass(True)
        ons.append(dt)
        q_ons.append(q)

    med_off, med_on = med(offs), med(ons)
    # Per-leg p50/p99 are medians across passes, as the walls are.
    q_off = {p: med([q[p] for q in q_offs]) for p in (0.5, 0.99)}
    q_on = {p: med([q[p] for q in q_ons]) for p in (0.5, 0.99)}
    # The gate statistic is the MEDIAN OF PER-PAIR RATIOS: each interleaved
    # (off, on) pair shares the host's weather, so one contended pass skews
    # one pair and the median discards it.
    pair_ratios = sorted(on / off for off, on in zip(offs, ons))

    def leg(dt_med, spread, q):
        return {
            "wall_s_median": round(dt_med, 4),
            "wall_s_spread": [round(x, 4) for x in sorted(spread)],
            "requests_per_s": round(n_frames / dt_med, 1),
            "hyps_per_s": round(n_frames * n_hyps / dt_med, 1),
            "p50_ms": round(q[0.5] * 1e3, 2),
            "p99_ms": round(q[0.99] * 1e3, 2),
        }

    # Span integrity + the unified snapshot: a traced WORKER dispatcher (the
    # queued path, so coalesced/queue time is real) serving every frame once.
    dispw = MicroBatchDispatcher(fn, cfg, trace=True, device=dev)
    reqs = [dispw.submit(fr) for fr in frames]
    for r in reqs:
        r.get(300.0)
    residuals = [abs(math.fsum(top_level(r.spans.durations()).values())
                     - (r.t_done - r.t_submit)) for r in reqs]
    stage_hist = dispw.obs.get("serve_stage_seconds")
    stage_p50_ms = {stage: round(stage_hist.quantile(0.5, stage=stage) * 1e3, 3)
                    for stage in list(STAGES[1:]) + ["served"]
                    if stage_hist.count(stage=stage)}
    snapshot = dispw.obs.snapshot()
    try:
        json.dumps(snapshot)
        snapshot_json_ok = True
    except (TypeError, ValueError):
        snapshot_json_ok = False
    compiled_after = dispw.cache_size()
    dispw.close()

    fleet = measure_obs_fleet(fn, cfg, frames, repeats, dev)

    ratio_wall = med(pair_ratios)      # on-wall / off-wall, pair median
    ratio = 1.0 / ratio_wall           # on-throughput / off-throughput
    return {
        "n_frames": n_frames,
        "n_hyps_per_frame": n_hyps,
        "repeats": repeats,
        "tracing_off": leg(med_off, offs, q_off),
        "tracing_on": leg(med_on, ons, q_on),
        "overhead_pct": round((ratio_wall - 1.0) * 100.0, 2),
        "pair_wall_ratios": [round(r, 4) for r in pair_ratios],
        "throughput_ratio_on_over_off": round(ratio, 4),
        "within_3pct": bool(ratio >= 0.97),
        "compiled_programs": {
            "before": compiled_before,
            "after_traced_sweep": compiled_after,
            "jit_cache_misses_added": compiled_after - compiled_before,
        },
        "span_integrity": {
            "requests_checked": len(reqs),
            "max_abs_residual_s": max(residuals),
            "sums_match_e2e": bool(max(residuals) < 1e-6),
        },
        "stage_p50_ms": stage_p50_ms,
        "snapshot_json_ok": snapshot_json_ok,
        "fleet": fleet,
        "obs_snapshot": snapshot,
        "note": (
            "same serve function for every leg (jit_cache_misses_added counts new "
            "batch signatures); off/on passes interleaved and the overhead verdict "
            "is the MEDIAN OF PER-PAIR wall ratios (raw spreads recorded); per-leg "
            "p50/p99 are medians across all passes, same protocol; stage_p50_ms "
            "durations are attributed to the stage REACHED (the 'served' row is "
            "the sliced->finish fan-out gap); span residual is the telescoping-sum "
            "check over every traced request"
        ),
    }


def measure_obs_fleet(fn, cfg, frames, repeats: int, dev) -> dict:
    """The gate's FLEET leg: the same pair-median protocol through a
    FleetRouter over 2 replicas sharing ``fn``, with sampling, the timeline
    and the health rules on in the traced leg; the fleet telescoping sum
    over every sampled trace, across a forced watchdog failover too."""

    # The replicas share fn; scenes ride as pure routing labels.
    def scene_blind(tree, scene=None, route_k=None):
        return fn(tree)

    scene_blind._cache_size = fn._cache_size
    compiled_before = fn._cache_size()
    slo = SLOPolicy(deadline_ms=120_000.0)
    dispatchers = [MicroBatchDispatcher(scene_blind, cfg, slo=slo, device=dev)
                   for _ in range(2)]
    replicas = [Replica(f"r{i}", d) for i, d in enumerate(dispatchers)]
    scenes = [f"s{i}" for i in range(4)]

    def fleet_pass(traced: bool):
        router = FleetRouter(replicas, FleetPolicy(poll_ms=2.0, trace_sample=1 if traced else 0),
                             start=True)
        if traced:
            router.obs.attach_timeline(window_s=0.05, max_windows=240)
            router.obs.attach_health_rules()
        t0 = time.perf_counter()
        reqs = [router.submit(frames[i % len(frames)], scene=scenes[i % len(scenes)],
                              deadline_ms=120_000.0)
                for i in range(len(frames))]
        for r in reqs:
            r.get(300.0)
        return time.perf_counter() - t0, router

    offs, ons = [], []
    last_on_router = None
    for _ in range(repeats):
        gc.collect()
        dt, router = fleet_pass(False)
        router.close(close_replicas=False)
        offs.append(dt)
        gc.collect()
        dt, router = fleet_pass(True)
        ons.append(dt)
        if last_on_router is not None:
            last_on_router.close(close_replicas=False)
        last_on_router = router  # kept open: telescoping/timeline evidence

    # Telescoping + timeline + alert evidence from the LAST traced pass.
    store = last_on_router.obs.get_trace_store()
    traces = [t for t in store.traces() if t.done]
    residuals = [t.residual() for t in traces]
    tl = last_on_router.obs.timeline()
    tl.tick()  # close the trailing partial window
    eng = last_on_router.obs.health_rules()
    eng.evaluate()
    tl_snap = tl.snapshot()
    alerts = eng.snapshot()
    exemplars = store.slowest(3)
    last_on_router.close(close_replicas=True)

    # Failover drill: wedge replica f0 through a tag-matched injector; the
    # watchdog types the stall and the failed-over traced request must
    # STILL telescope exactly, failover siblings included.
    threads_before = set(threading.enumerate())
    drill_slo = SLOPolicy(deadline_ms=120_000.0, watchdog_ms=250.0, watchdog_poll_ms=10.0)
    injectors = [FaultInjector(scene_blind, tag=f"f{i}") for i in range(2)]
    drill_reps = [Replica(f"f{i}", MicroBatchDispatcher(inj, cfg, slo=drill_slo, device=dev))
                  for i, inj in enumerate(injectors)]
    drill_router = FleetRouter(drill_reps, FleetPolicy(poll_ms=2.0, trace_sample=1),
                               start=True)
    # Seed the scene's home (cold placement prefers the name-tie winner on
    # an idle fleet), then wedge exactly that replica.
    drill_router.infer_one(frames[0], scene="drill", deadline_ms=60_000.0)
    home = drill_router.scene_homes()["drill"][0]
    release = threading.Event()
    for inj in injectors:
        inj.stall_once(release, match=lambda ctx, t=home: ctx["tag"] == t)
    fo_result = drill_router.infer_one(frames[1], scene="drill", deadline_ms=60_000.0)
    release.set()
    fo_traces = [t for t in drill_router.obs.get_trace_store().traces()
                 if t.done and len([s for s in t.spans if s.kind == "dispatch"]) > 1]
    drill_router.close(close_replicas=True)
    join_threads_started_since(threads_before)
    fo = None
    if fo_traces:
        t = fo_traces[-1]
        dsp = [s for s in t.spans if s.kind == "dispatch"]
        fo = {
            "checked": True,
            "served": fo_result is not None,
            "residual_s": t.residual(),
            "sums_match_e2e": bool(t.residual() < 1e-6),
            "root_stages": [s for s, _ in t.root.segments()],
            "dispatch_spans": len(dsp),
            "retry_linked": bool(dsp[-1].annotations.get("retry_of") == dsp[0].span_id),
            "wedged_replica": home,
        }

    compiled_after = fn._cache_size()
    pair_ratios = sorted(on / off for off, on in zip(offs, ons))
    ratio_wall = med(pair_ratios)
    n_frames = len(frames)

    def leg(walls):
        m = med(walls)
        return {"wall_s_median": round(m, 4),
                "wall_s_spread": [round(x, 4) for x in sorted(walls)],
                "requests_per_s": round(n_frames / m, 1)}

    return {
        "replicas": 2,
        "n_frames": n_frames,
        "repeats": repeats,
        "tracing_off": leg(offs),
        "tracing_on": leg(ons),
        "overhead_pct": round((ratio_wall - 1.0) * 100.0, 2),
        "pair_wall_ratios": [round(r, 4) for r in pair_ratios],
        "throughput_ratio_on_over_off": round(1.0 / ratio_wall, 4),
        "within_3pct": bool(1.0 / ratio_wall >= 0.97),
        "jit_cache_misses_added": compiled_after - compiled_before,
        "telescoping": {
            "traces_checked": len(traces),
            "max_abs_residual_s": max(residuals) if residuals else None,
            "sums_match_e2e": bool(residuals and max(residuals) < 1e-6),
            "failover": fo,
        },
        "timeline": {
            "ticks": tl_snap["ticks"],
            "windows_retained": tl_snap["windows_retained"],
            "ring_bounded": bool(tl_snap["windows_retained"] <= tl_snap["max_windows"]),
        },
        "alerts": {
            "rules": alerts["rules"],
            "events": len(alerts["events"]),
            "quiet": not alerts["active"],
        },
        "exemplar_slow_traces": exemplars,
        "note": (
            "2 in-process replicas over ONE shared serve function; traced leg = "
            "1-in-1 trace sampling + 50ms timeline windows + the default rule "
            "catalog driven from the router loop; pair-median protocol as the "
            "single-dispatcher legs; telescoping = every sampled trace's root "
            "segments (router overhead + replica spans + failover siblings) fsum "
            "to its end-to-end latency; the failover drill wedges the scene's home "
            "replica via tag-matched injectors and the watchdog, and the "
            "failed-over trace must telescope with its two dispatch spans linked "
            "retry_of"
        ),
    }


def obs_headline(obs: dict) -> dict:
    fleet = obs.get("fleet") or {}
    fo = (fleet.get("telescoping") or {}).get("failover") or {}
    return {
        "metric": "obs_tracing_overhead_pct",
        "value": obs["overhead_pct"],
        "unit": "%",
        "vs_baseline": None,
        "within_3pct": obs["within_3pct"],
        "jit_cache_misses_added": obs["compiled_programs"]["jit_cache_misses_added"],
        "span_sums_match_e2e": obs["span_integrity"]["sums_match_e2e"],
        "snapshot_json_ok": obs["snapshot_json_ok"],
        "fleet_overhead_pct": fleet.get("overhead_pct"),
        "fleet_within_3pct": fleet.get("within_3pct"),
        "fleet_jit_cache_misses_added": fleet.get("jit_cache_misses_added"),
        "fleet_telescoping_ok": ((fleet.get("telescoping") or {}).get("sums_match_e2e")
                                 and fo.get("sums_match_e2e")),
    }
