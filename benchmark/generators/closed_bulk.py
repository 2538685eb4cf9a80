"""Closed loop: one client calls ``MicroBatchDispatcher.infer_many`` on
``frames_per_call`` frames, again and again, each call's frames with fresh
request seeds.  ``frames_per_s`` is every frame served over the whole
window: from its opening to the return of the last call started inside
it."""

from __future__ import annotations

import time

from benchmark import reduce


def run(ctx) -> dict:
    wl, scene_id = ctx.wl, ctx.system.scene_id
    n = wl.mix["frames_per_call"]
    rng = ctx.rng(1)
    disp = ctx.system.dispatcher(ctx.trace, warm_frame=ctx.frame(0, 0))

    def call():
        seeds = rng.integers(0, 2 ** 62, size=n)
        out = disp.infer_many([ctx.frame(j, seeds[j]) for j in range(n)], scene=scene_id)
        return seeds, out

    try:
        for _ in range(wl.mix["warm_calls"]):  # the real path, counted as set-up
            t = time.perf_counter()
            call()
        call_s = time.perf_counter() - t
        n0 = sum(disp.dispatch_totals().values())
        t_open = ctx.open_window()
        served, calls, prof_calls, call_ms = [], 0, 0, []
        prof_from = ctx.seconds - wl.cell.get("profile_calls", 0) * call_s
        while time.perf_counter() - t_open < ctx.seconds:
            if ctx.trace and time.perf_counter() - t_open >= prof_from:
                ctx.profile_start()
                prof_calls += 1
            t = time.perf_counter()
            seeds, out = call()
            call_ms.append(round(1e3 * (time.perf_counter() - t), 3))
            served += [(j, int(seeds[j]), row) for j, row in enumerate(out)]
            calls += 1
        t_close = time.perf_counter()
        dispatches = sum(disp.dispatch_totals().values()) - n0
        if ctx.trace and not prof_calls:
            # A call ran long over the profiled stretch: trace one more,
            # after the window, so the per-layer metrics have their calls.
            ctx.profile_start()
            prof_calls = 1
            call()
        ctx.profile_stop()
    finally:
        disp.close()
    lanes = max(ctx.system.buckets)
    return {
        "end_to_end": {"frames_per_s": reduce.rate(len(served), t_close - t_open)},
        "attempted": calls * n, "failed": calls * n - len(served), "served": served,
        "served_frames": len(served), "dispatches": dispatches, "spans": [],
        "window_s": t_close - t_open, "profile_frames": prof_calls * n,
        "profile_lanes": prof_calls * -(-n // lanes) * lanes,
        "generator": {"calls": calls, "frames_per_call": n, "warm_call_s": call_s,
                      "call_ms": call_ms},
    }
