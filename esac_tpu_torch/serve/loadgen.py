"""Open-loop load generation over the micro-batching dispatcher (a copy of
``esac_tpu/serve/loadgen.py``).

Closed-loop timing sends the next request only after the last answer.  Real
traffic does not wait: requests arrive on the *arrival process's* clock,
pile up when the server falls behind, and the interesting numbers
(sustained goodput, p50/p99 against offered load, where the knee is) only
exist under that regime.  This module is the open-loop driver:

- :func:`poisson_arrivals` / :func:`uniform_arrivals` build an arrival
  schedule (cumulative seconds) for a target offered rate -- Poisson for
  memoryless traffic, uniform for a deterministic trace.
- :func:`run_open_loop` replays a schedule against a dispatcher:
  ``submit`` fires at each arrival time regardless of completions (the
  open-loop property -- admission control, not caller blocking, is what
  bounds the queue, so the dispatcher should carry an
  :class:`~esac_tpu_torch.serve.slo.SLOPolicy`), outcomes are collected
  from the requests themselves, and the summary reports achieved offered
  rate, the outcome accounting (which sums to offered), served-latency
  quantiles and sustained throughput.

Pure host code.  Requests can mix scenes, ``route_k`` values and frame
shapes -- lanes are the dispatcher's problem -- via the ``make_request``
callback, which maps an arrival index to ``(frame, scene, route_k)``.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from esac_tpu_torch.serve.slo import ConfigError, DeadlineExceededError, ShedError

# Outcome classes a request can end in (the accounting invariant's terms).
OUTCOMES = ("served", "degraded", "shed", "expired", "failed")


def poisson_arrivals(rate_rps: float, n: int, seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of ``n`` Poisson arrivals at
    ``rate_rps``: i.i.d. exponential gaps, deterministic per seed."""
    if rate_rps <= 0:
        raise ConfigError(f"rate_rps {rate_rps} <= 0")
    gaps = np.random.RandomState(seed).exponential(1.0 / rate_rps, size=n)
    return np.cumsum(gaps)


def uniform_arrivals(rate_rps: float, n: int) -> np.ndarray:
    """Cumulative arrival times of a deterministic constant-rate trace."""
    if rate_rps <= 0:
        raise ConfigError(f"rate_rps {rate_rps} <= 0")
    return (np.arange(n, dtype=np.float64) + 1.0) / rate_rps


def run_open_loop(
    disp,
    make_request,
    arrivals,
    deadline_ms: float | None = None,
    hyps_per_request: int = 1,
    settle_s: float = 30.0,
    freeze_gc: bool = True,
) -> dict:
    """Replay an open-loop arrival schedule against ``disp``.

    Unless ``freeze_gc=False``, the run executes with the garbage
    collector's existing heap FROZEN (``gc.collect()`` then
    ``gc.freeze()``, unfrozen after): a gen-2 collection pause shows up
    as a "server stall" in the latency tail, and every long-lived object
    at run start -- modules, weight caches, the dispatcher itself -- is
    prewarm state that a
    mid-run gen-2 pass can only waste time re-scanning.  The summary's
    ``gc`` block records the provenance (frozen flag + per-generation
    collection counts during the run) so an artifact states the regime
    its tail was measured under.

    ``make_request(i) -> (frame, scene, route_k)`` builds request ``i``;
    ``arrivals`` is the cumulative schedule (seconds from start).  Submits
    never block on completions: a shed (typed
    :class:`~esac_tpu_torch.serve.slo.ShedError`) is recorded and the generator
    moves on — exactly the admission-control contract.  After the last
    arrival, every admitted request is awaited for its remaining deadline
    plus ``settle_s`` grace (the dispatcher wakes waiters on watchdog
    abandonment, worker death and close, so the grace is slack for
    scheduling, not a correctness crutch).

    Returns a summary dict: achieved offered rate, per-outcome counts
    (summing to ``offered``), served+degraded latency quantiles,
    sustained goodput in requests/s and hyps/s over the span from first
    arrival to last completion, and the raw per-request outcome list.
    When the dispatcher carries an obs metrics registry (every
    ``MicroBatchDispatcher`` does), the summary also breaks
    latency down ``per_scene`` and ``per_route_k``, sourced from the
    registry's streaming ``serve_lane_latency_seconds`` histogram:
    fleet-wide percentiles hide a single degraded scene inside healthy
    aggregate numbers, and the per-lane view is what surfaces it.  That
    lane histogram is RESET at run start, so the blocks cover exactly
    the run this summary describes — warmup traffic or a previous run
    on the same dispatcher cannot contaminate them (the fleet
    ``serve_request_latency_seconds`` instrument and the accounting
    counters are untouched; note that on a SHARED obs registry the lane
    histogram is shared too, so driving the load harness against one
    dispatcher restarts the lane-latency window for its peers — one
    more reason the aggregation mode is opt-in).  Those quantiles are sketch estimates
    within the histogram's pinned tolerance and cover every COMPLETED
    request of the run; the fleet-wide ``p50_ms``/``p99_ms`` stay exact
    over the served+degraded latencies, unchanged.
    """
    arrivals = np.asarray(arrivals, np.float64)
    if len(arrivals) == 0:
        raise ConfigError("empty arrival schedule")
    frozen = False
    if freeze_gc:
        gc.collect()
        gc.freeze()
        frozen = True
    gc_before = gc.get_stats()
    try:
        out = _run_paced(disp, make_request, arrivals, deadline_ms,
                         hyps_per_request, settle_s)
    finally:
        if frozen:
            gc.unfreeze()
    out["gc"] = {
        "frozen": frozen,
        "collections_during_run": [
            int(a["collections"] - b["collections"])
            for a, b in zip(gc.get_stats(), gc_before)
        ],
    }
    return out


def _run_paced(disp, make_request, arrivals, deadline_ms,
               hyps_per_request, settle_s) -> dict:
    """The paced replay itself (see :func:`run_open_loop`)."""
    n = len(arrivals)
    lane_hist = _lane_hist(disp)
    if lane_hist is not None:
        # Run-local lane views (see docstring): the per-lane histogram
        # restarts with the run; nothing else is reset.
        lane_hist.reset()
    admitted = []          # (index, request)
    outcomes = [None] * n  # per-request outcome string
    # Typed-error class name per request (None for clean serves): the
    # chaos drill's per-fault accounting keys on WHICH typed fault ended
    # a request, not just its outcome class.
    err_types = [None] * n
    # Pacing runs on the harness clock; every latency/deadline quantity
    # below comes from the REQUESTS' own timestamps (the dispatcher's
    # clock domain) — mixing the two would corrupt wait budgets the
    # moment either side used a non-default clock.
    t0 = time.perf_counter()
    for i in range(n):
        target = t0 + float(arrivals[i])
        while True:
            # Sleep-until with a cap so coarse schedulers cannot overshoot
            # a whole burst of arrivals.
            now = time.perf_counter()
            if now >= target:
                break
            time.sleep(min(target - now, 0.01))
        frame, scene, route_k = make_request(i)
        try:
            req = disp.submit(frame, scene=scene, route_k=route_k,
                              deadline_ms=deadline_ms)
        except ShedError as e:
            outcomes[i] = "shed"
            err_types[i] = type(e).__name__
            continue
        except DeadlineExceededError:
            # A no-SLO dispatcher's bounded space wait expires instead of
            # shedding; the request's fate is recorded, never a harness
            # crash that loses the whole point's outcomes.
            outcomes[i] = "expired"
            err_types[i] = "DeadlineExceededError"
            continue
        admitted.append((i, req, time.perf_counter()))
    t_last_arrival = time.perf_counter()

    latencies = []
    t_end = t_last_arrival
    for i, req, t_sub_h in admitted:
        # The request's FULL deadline window (its own clock domain) plus
        # grace; the event is guaranteed to fire eventually, the bound
        # keeps a broken dispatcher from hanging the harness.
        budget = settle_s
        if req.deadline is not None:
            budget += max(0.0, req.deadline - req.t_submit)
        if not req.event.wait(budget):
            outcomes[i] = "lost"  # should be impossible; surfaced, not hidden
            continue
        outcomes[i] = req.outcome
        if req.error is not None:
            err_types[i] = type(req.error).__name__
        if req.outcome in ("served", "degraded"):
            # Latency in the dispatcher's clock domain; the completion
            # instant anchored on the ACTUAL submit time (a generator
            # running behind schedule must not shrink the span and
            # inflate sustained throughput).
            latencies.append(req.t_done - req.t_submit)
            t_end = max(t_end, t_sub_h + (req.t_done - req.t_submit))

    counts = {o: outcomes.count(o) for o in OUTCOMES}
    counts["lost"] = outcomes.count("lost")
    good = counts["served"] + counts["degraded"]
    span = max(t_end - t0, 1e-9)
    lat = np.sort(np.asarray(latencies)) if latencies else None

    def q(p):
        if lat is None:
            return float("nan")
        return float(lat[min(len(lat) - 1, round(p * (len(lat) - 1)))])

    # Per-request trace ids: when the dispatcher/router
    # samples causal traces, every admitted request's id rides the
    # summary so an artifact's slow points can be joined back to their
    # exemplar traces (None for unsampled/shed requests).
    trace_ids: list = [None] * n
    for i, req, _t in admitted:
        tr = getattr(req, "trace", None)
        if tr is not None:
            trace_ids[i] = tr.trace_id

    out = {
        "offered": n,
        "offered_rps_target": round(n / float(arrivals[-1]), 2),
        "offered_rps_achieved": round(n / max(t_last_arrival - t0, 1e-9), 2),
        "outcomes": counts,
        "goodput_ratio": round(good / n, 4),
        "served_rps": round(good / span, 2),
        "sustained_hyps_per_s": round(good * hyps_per_request / span, 1),
        "p50_ms": round(q(0.5) * 1e3, 2),
        "p99_ms": round(q(0.99) * 1e3, 2),
        "span_s": round(span, 3),
        "per_request_outcomes": outcomes,
        "per_request_error_types": err_types,
        "per_request_trace_ids": trace_ids,
    }
    obs = getattr(disp, "obs", None)
    store = obs.get_trace_store() if obs is not None \
        and hasattr(obs, "get_trace_store") else None
    if store is not None:
        # Exemplar slow traces for the artifact (the loadtest/fleet
        # artifacts' "where did the tail go" evidence).
        out["exemplar_slow_traces"] = store.slowest(3)
    per_scene, per_route = _lane_latency_views(disp)
    if per_scene is not None:
        out["per_scene"] = per_scene
        out["per_route_k"] = per_route
    return out


def _lane_hist(disp):
    """The dispatcher's per-lane latency histogram, or None when the
    dispatcher carries no obs registry (a foreign/minimal dispatcher)."""
    obs = getattr(disp, "obs", None)
    return obs.get("serve_lane_latency_seconds") if obs is not None \
        else None


def _lane_latency_views(disp):
    """(per_scene, per_route_k) latency breakdowns from the dispatcher's
    obs registry, or (None, None) for a dispatcher without one.  Each
    entry merges the streaming histogram's children over the OTHER label
    (a scene's number spans its route_k lanes and vice versa); keys are
    stringified so the blocks ride json artifacts as-is."""
    hist = _lane_hist(disp)
    if hist is None:
        return None, None

    def view(label: str) -> dict:
        values = sorted(
            {c.get(label) for c in hist.labelsets()},
            key=lambda v: (v is None, str(v)),
        )
        out = {}
        for v in values:
            s = hist.summary(quantiles=(0.5, 0.99), **{label: v})
            if not s["count"]:
                continue  # a lane from BEFORE the run (reset keeps the
                # child object); a count-0 NaN row is noise, not data
            out[str(v)] = {
                "count": s["count"],
                "p50_ms": round(s["p50"] * 1e3, 2),
                "p99_ms": round(s["p99"] * 1e3, 2),
            }
        return out

    return view("scene"), view("route_k")
