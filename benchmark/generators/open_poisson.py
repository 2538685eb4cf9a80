"""Open loop: single-frame requests through ``MicroBatchDispatcher.submit``
on a Poisson schedule at the cell's fixed rate.

Every seed gets the same inter-arrival gaps (drawn once from the mix's
``schedule_seed``) in an order drawn from the seed, so two seeds offer the
same amount of work.  Each request is timed on this process's clock, from
the moment it was due to the moment the generator sees its result on the
host (its event set; the generator waits on the oldest open request
between arrivals), so a late generator or a stall counts against every
request it delays; how late the generator ran is reported beside the
metrics.  Nothing of the timing is read from the program."""

from __future__ import annotations

import collections
import time

import numpy as np

from benchmark import reduce

# How long past the window's close a request due inside it may take.
SETTLE_S = 60.0


def poisson_arrivals(rate_rps: float, n: int, seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of ``n`` Poisson arrivals at
    ``rate_rps``: i.i.d. exponential gaps, deterministic per seed.  (A
    frozen copy of the program's ``serve.loadgen.poisson_arrivals``.)"""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps {rate_rps} <= 0")
    gaps = np.random.RandomState(seed).exponential(1.0 / rate_rps, size=n)
    return np.cumsum(gaps)


def schedule(rate: float, seconds: float, schedule_seed: int, order: np.random.Generator):
    """Due times (s from the window's opening) inside ``seconds``."""
    n = int(rate * seconds * 1.5) + 16
    gaps = np.diff(poisson_arrivals(rate, n, schedule_seed), prepend=0.0)
    due = np.cumsum(order.permutation(gaps))
    return due[due < seconds]


def _dispatches(disp) -> int:
    return sum(disp.dispatch_totals().values())


def collect(pending: collections.deque, stamps: dict, until: float) -> None:
    """Stamp (perf clock) each request at the head of ``pending``, (index,
    request) pairs in submission order, as its event fires, waiting for the
    head until ``until`` at most.  The dispatcher answers in order, so a
    later request is never stamped for long after its answer."""
    while pending:
        j, r = pending[0]
        if not r.event.wait(max(0.0, until - time.perf_counter())):
            return
        stamps[j] = time.perf_counter()
        pending.popleft()


def run(ctx) -> dict:
    wl, scene_id = ctx.wl, ctx.system.scene_id
    rate = float(wl.cell["rate_per_s"])
    seeds = ctx.rng(1).integers(0, 2 ** 62, size=int(rate * ctx.seconds * 2) + 4096)
    due = schedule(rate, ctx.seconds, wl.mix["schedule_seed"], ctx.rng(2))
    warm = wl.mix["warm_bursts"]
    disp = ctx.system.dispatcher(ctx.trace, warm_frame=ctx.frame(0, 0))
    try:
        k = 0
        for burst in warm:  # the real path at every bucket, counted as set-up
            reqs = [disp.submit(ctx.frame(k + j, seeds[k + j]), scene=scene_id)
                    for j in range(burst)]
            for r in reqs:
                r.get(timeout=SETTLE_S)
            k += burst
        n0 = _dispatches(disp)
        prof_from = ctx.seconds - wl.cell.get("profile_s", 0.0)
        t_open = ctx.open_window()
        recs, pending, stamps = [], collections.deque(), {}
        for i, a in enumerate(due):
            if ctx.trace and a >= prof_from:
                ctx.profile_start()
            collect(pending, stamps, t_open + a)
            wait = t_open + a - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            t_sub = time.perf_counter()
            j = k + i
            r = disp.submit(ctx.frame(j, seeds[j]), scene=scene_id)
            recs.append((t_open + a, t_sub, j, r))
            pending.append((j, r))
        collect(pending, stamps, t_open + ctx.seconds + SETTLE_S)
        ctx.profile_stop(t_end=max(stamps.values()) if stamps else None)
        dispatches = _dispatches(disp) - n0
        # (bucket, frames) of the window's dispatches, the newest last.
        rode = list(disp.dispatch_log)[-dispatches:] if dispatches else []
    finally:
        disp.close()

    lat, served, failed, spans = [], [], 0, []
    for t_due, _, j, r in recs:
        if j in stamps and r.error is None:
            lat.append(stamps[j] - t_due)
            served.append((j % len(ctx.images), int(seeds[j]), r.result))
        else:
            failed += 1
            lat.append(float("inf"))
        if r.spans is not None:
            spans.append(r.spans.durations())
    late = [t_sub - t_due for t_due, t_sub, _, _ in recs]
    prof = ctx.profile
    in_prof = ([j for j, t in stamps.items() if prof["t0"] <= t <= prof["t1"]]
               if prof else [])
    return {
        "end_to_end": {"latency_p50_ms": 1e3 * reduce.percentile(lat, 50),
                       "latency_p95_ms": 1e3 * reduce.percentile(lat, 95)},
        "attempted": len(recs), "failed": failed, "served": served, "latencies": lat,
        "served_frames": len(served), "dispatches": dispatches, "spans": spans,
        "bucket_lanes": sum(b for b, _ in rode), "bucket_frames": sum(n for _, n in rode),
        "window_s": ctx.seconds, "profile_frames": len(in_prof), "profile_lanes": None,
        "generator": {"requests": len(recs), "rate_per_s": rate,
                      "late_p50_ms": 1e3 * reduce.percentile(late, 50),
                      "late_p99_ms": 1e3 * reduce.percentile(late, 99),
                      "late_max_ms": 1e3 * max(late)},
    }
