"""``loadtest`` mode (counterpart of ``bench.py``'s ``_loadtest_knee`` and
``_measure_loadtest``): the open-loop SLO sweep (DESIGN.md §12).  Mixed
scenes, {dense, K = 2} routed bucket functions and two frame buckets under
Poisson arrivals swept PAST the knee; per point the achieved offered rate
beside the requested one, the outcome accounting (served + shed + expired +
degraded + failed == offered), p50/p99 and sustained hyps/s.

Offered rates are multiples of each leg's closed-loop capacity measured in
the same run, so they scale with the device.  Tiny scenes on purpose: the
knee's position in multiples of capacity is the measurement, not absolute
throughput."""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from esac_tpu_torch.bench.constants import (
    LOADTEST_BUCKETS,
    LOADTEST_HW,
    LOADTEST_HYPS,
    LOADTEST_M,
    LOADTEST_MULTS,
    LOADTEST_SECONDS,
)
from esac_tpu_torch.bench.fixtures import image_frame, tiny_preset
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.serving import (
    init_scene_params,
    make_routed_scene_bucket_fn,
    make_scene_bucket_fn,
)
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
from esac_tpu_torch.serve.loadgen import poisson_arrivals, run_open_loop
from esac_tpu_torch.serve.slo import SLOPolicy
from esac_tpu_torch.utils.precision import resolve_device


def loadtest_knee(points: list) -> dict | None:
    """The knee of one leg: the LAST point of the longest goodput >= 0.99
    prefix of the (ascending-load) sweep -- a load above a point the server
    already failed is not sustainable, however a noisy higher point
    scored."""
    knee = None
    for p in points:
        if p["goodput_ratio"] >= 0.99:
            knee = p
        else:
            break
    return knee


def scene_params(preset, seed: int, dev) -> dict:
    """A random-init scene at f = 40 (the drills' camera)."""
    params = init_scene_params(preset, seed=seed, device=dev)
    params["f"] = torch.tensor(40.0, device=dev)
    return params


def measure_loadtest(buckets: tuple = LOADTEST_BUCKETS, mults: tuple = LOADTEST_MULTS,
                     seconds: float = LOADTEST_SECONDS, device=None) -> dict:
    dev = resolve_device(device)
    H = LOADTEST_HW
    M = LOADTEST_M
    preset = tiny_preset(H, M)
    base = RansacConfig(n_hyps=LOADTEST_HYPS, refine_iters=2, polish_iters=1)
    hyps_per_request = M * LOADTEST_HYPS  # routed reallocates: K-invariant
    params = {"s0": scene_params(preset, 0, dev), "s1": scene_params(preset, 1, dev)}
    scenes = sorted(params)
    pool = [image_frame(i, H) for i in range(16)]

    legs = []
    for route_k in (None, 2):
        for bucket in sorted(buckets):
            cfg = dataclasses.replace(base, frame_buckets=(bucket,), serve_max_wait_ms=2.0,
                                      serve_queue_depth=max(8 * bucket, 32))
            fn = (make_scene_bucket_fn(preset, cfg, device=dev) if route_k is None
                  else make_routed_scene_bucket_fn(preset, cfg, route_k, device=dev))

            def serve(tree, scene, rk=None, _fn=fn):
                return _fn(params[scene], tree)

            serve._cache_size = fn._cache_size
            # Warm: both scenes share the bucket function; then the
            # closed-loop dispatch time that anchors the sweep.
            warmer = MicroBatchDispatcher(serve, cfg, start_worker=False, device=dev)
            for s in scenes:
                warmer.infer_many(pool[:bucket], scene=s, route_k=route_k)
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                warmer.infer_many(pool[:bucket], scene=scenes[0], route_k=route_k)
                walls.append(time.perf_counter() - t0)
            dispatch_s = sorted(walls)[len(walls) // 2]
            capacity_rps = bucket / dispatch_s
            deadline_ms = max(300.0, 6 * dispatch_s * 1e3)
            slo = SLOPolicy(deadline_ms=deadline_ms,
                            watchdog_ms=max(10_000.0, 50 * dispatch_s * 1e3))
            points = []
            for j, mult in enumerate(sorted(mults)):
                # A gen-2 GC pause over the previous point's request objects
                # mid-window reads as a server stall; pay it between points.
                # Frozen from here, the heap is out of the collector's sight
                # through the point's warm-up too (run_open_loop unfreezes
                # it after the window): an automatic full collection over a
                # large heap (chip_smoke.py's phase 12: 214-241 ms on the
                # H100's host) pushed a warm-up past its 300 ms deadline.
                gc.collect()
                gc.freeze()
                rate = capacity_rps * mult
                n = int(min(max(24, rate * seconds), 400))
                disp = MicroBatchDispatcher(serve, cfg, slo=slo, device=dev)
                try:
                    for w in range(3):
                        # Per-point warmup through the measuring dispatcher:
                        # the worker's first dispatches are cold-start cost
                        # (they also seed the admission EMA).
                        disp.infer_one(pool[w], scene=scenes[w % 2], route_k=route_k)
                    disp.reset_stats()
                    res = run_open_loop(
                        disp,
                        lambda i: (pool[i % len(pool)], scenes[i % 2], route_k),
                        poisson_arrivals(rate, n, seed=17 + j),
                        deadline_ms=deadline_ms,
                        hyps_per_request=hyps_per_request,
                    )
                finally:
                    # A failed point stops its worker: a process that exits
                    # while the worker is inside a torch call aborts.
                    disp.close()
                    gc.unfreeze()
                res.pop("per_request_outcomes")
                res.pop("per_request_error_types", None)
                points.append({"offered_x_capacity": mult, "offered_rps": round(rate, 2),
                               **res})
            warmer.close()
            knee = loadtest_knee(points)
            legs.append({
                "program": "dense" if route_k is None else f"routed_k{route_k}",
                "route_k": route_k,
                "frame_bucket": bucket,
                "closed_loop_dispatch_ms": round(dispatch_s * 1e3, 2),
                "closed_loop_capacity_rps": round(capacity_rps, 2),
                "deadline_ms": round(deadline_ms, 1),
                "compiled_programs": warmer.cache_size(),
                "points": points,
                "knee_offered_rps": knee["offered_rps"] if knee else None,
                "knee_sustained_hyps_per_s": knee["sustained_hyps_per_s"] if knee else None,
            })
    return {
        "num_experts": M,
        "hw": [H, H],
        "hyps_per_request": hyps_per_request,
        "offered_mults": list(sorted(mults)),
        "open_loop_seconds_per_point": seconds,
        "legs": legs,
        "note": (
            "offered load in multiples of each leg's measured closed-loop "
            "capacity (offered_rps requested, offered_rps_achieved by the "
            "paced generator); knee = highest offered point with goodput >= "
            "0.99; mixed s0/s1 scene traffic per leg (two lanes); outcome "
            "accounting per point sums to offered; tiny scenes -- queueing "
            "behavior, not absolute throughput, is the measurement"
        ),
    }


def loadtest_headline(loadtest: dict) -> dict:
    # Headline: the dense, largest-bucket leg's knee (fall back to the
    # best-measured knee if that leg never reached goodput >= 0.99).
    legs = loadtest["legs"]
    dense_big = max((leg for leg in legs if leg["route_k"] is None),
                    key=lambda leg: leg["frame_bucket"])
    knees = [leg["knee_sustained_hyps_per_s"] for leg in legs
             if leg["knee_sustained_hyps_per_s"] is not None]
    value = dense_big["knee_sustained_hyps_per_s"]
    if value is None:
        value = max(knees) if knees else None
    return {
        "metric": "serve_loadtest_knee_sustained_hyps_per_s",
        "value": value,
        "unit": "hyps/s",
        "vs_baseline": None,
        "knee_offered_rps_dense_big_bucket": dense_big["knee_offered_rps"],
    }
