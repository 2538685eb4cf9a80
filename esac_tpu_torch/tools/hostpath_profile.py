#!/usr/bin/env python3
"""Stage-attributed host-path profile of the serving hot path (the port's
copy of ``tools/hostpath_profile.py``).

At the fleet bench's toy shapes the device does a fraction of a dispatch's
work: the Python host path (stack/pad staging, result slicing, obs
publishes, lock traffic) sets the knee.  This tool names where each
request's wall goes, riding the span stamps the dispatcher already records
(no new instrumentation):

  admitted -> coalesced -> staged -> dispatched -> device -> sliced ->
  outcome

Each consecutive-stamp diff is attributed to the LATER stage, so the table
reads as "time spent reaching this stage":

  coalesced   queue wait until the worker popped the request
  staged      host staging: row copies into pooled buffers, one copy each
              to the device
  dispatched  issuing the call (PyTorch enqueues on the card)
  device      the card's work, up to the synchronized CUDA event
  sliced      one ``.cpu()`` per leaf + per-request result slicing
  <outcome>   fan-out: accounting, obs publishes, event set

Two measurements, on the card unless ``--cpu`` (``device="cpu"``):

- **stage table**: N traced closed-loop requests through the worker at
  ``serve_max_wait_ms=0`` (coalescing off: per-dispatch host cost, no hold
  window); per-stage mean/p50/p99 and share of the end-to-end wall;
- **closed-loop capacity**: the fleet bench's protocol -- median of 5
  ``infer_many(pool[:FRAME_BUCKET])`` walls at its operating point ->
  requests/s per replica.

``python esac_tpu_torch/tools/hostpath_profile.py [--requests N] [--out FILE]
[--cpu]`` prints one indented JSON document.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import pathlib
import sys
import time

from esac_tpu_torch.obs.trace import top_level

ROOT = pathlib.Path(__file__).resolve().parents[2]

# The fleet bench's toy operating point (bench constants FLEET_*).
HW = 24
M = 2
N_HYPS = 4
FRAME_BUCKET = 2
SCENES = 2
CAPACITY_REPS = 5


def stage_table(per_request_durations: list[dict]) -> dict:
    """Aggregate per-request ``SpanChain.durations()`` dicts into the
    per-stage table: count, mean/p50/p99 ms, and share of the summed
    end-to-end wall (the top-level stages'; a nested stage's row shares
    that wall).  Pure function."""
    stages: dict[str, list[float]] = {}
    totals = []
    for durs in per_request_durations:
        totals.append(math.fsum(top_level(durs).values()))
        for stage, dt in durs.items():
            stages.setdefault(stage, []).append(dt)
    wall = math.fsum(totals)

    def q(sorted_xs, p):
        return sorted_xs[min(len(sorted_xs) - 1, round(p * (len(sorted_xs) - 1)))]

    out = {}
    for stage, xs in stages.items():
        xs_sorted = sorted(xs)
        s = math.fsum(xs)
        out[stage] = {
            "count": len(xs),
            "mean_ms": round(s / len(xs) * 1e3, 4),
            "p50_ms": round(q(xs_sorted, 0.5) * 1e3, 4),
            "p99_ms": round(q(xs_sorted, 0.99) * 1e3, 4),
            "share": round(s / wall, 4) if wall > 0 else None,
        }
    return out


def host_overhead_summary(per_request_durations: list[dict]) -> dict:
    """Host vs device split per request: everything that is not the
    ``device`` stage is host-path cost."""
    host, device = [], []
    for durs in per_request_durations:
        d = durs.get("device", 0.0)
        device.append(d)
        host.append(math.fsum(top_level(durs).values()) - d)
    n = max(len(host), 1)
    return {
        "host_ms_per_request_mean": round(math.fsum(host) / n * 1e3, 4),
        "device_ms_per_request_mean": round(math.fsum(device) / n * 1e3, 4),
        "host_share": round(math.fsum(host) / max(math.fsum(host) + math.fsum(device), 1e-12),
                            4),
    }


def _build_fixture(root: pathlib.Path, dev):
    """One fleet-bench replica: a SceneRegistry over tiny written scenes
    (worker-less dispatchers are the callers' choice)."""
    from esac_tpu_torch.bench.fixtures import image_frame, tiny_preset, write_scene
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.manifest import SceneManifest
    from esac_tpu_torch.registry.serving import SceneRegistry

    preset = tiny_preset(HW, M)
    cfg = RansacConfig(n_hyps=N_HYPS, refine_iters=2, polish_iters=1,
                       frame_buckets=(FRAME_BUCKET,), serve_max_wait_ms=0.0,
                       serve_queue_depth=256)
    manifest = SceneManifest()
    scenes = [f"s{i}" for i in range(SCENES)]
    for seed, name in enumerate(scenes):
        manifest.add(write_scene(root, name, preset, cfg, seed=seed, checksums=True))
    pool = [image_frame(i, HW) for i in range(8)]
    return SceneRegistry(manifest, device=dev), cfg, scenes, pool


def profile(n_requests: int = 300, device=None) -> dict:
    """Run both measurements on ``device`` (None = the card); returns the
    artifact dict."""
    from esac_tpu_torch.bench.fixtures import scratch_dir
    from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
    from esac_tpu_torch.utils.precision import resolve_device

    dev = resolve_device(device)
    frozen = False
    with scratch_dir("esac_hostpath_") as root:
        try:
            registry, cfg, scenes, pool = _build_fixture(root, dev)

            # ---- closed-loop capacity (the fleet bench's protocol) ----
            disp = MicroBatchDispatcher(registry.infer_fn(), cfg, start_worker=False,
                                        device=dev)
            registry.bind_obs(disp.obs)
            for j, s in enumerate(scenes):  # prewarm: weights staged, first calls
                disp.infer_one(pool[j % len(pool)], scene=s)
            compiled_before = registry.compile_cache_size()
            # The prewarm built the long-lived heap (weights, dispatcher):
            # freeze it so a mid-window gen-2 pass cannot stall either loop.
            gc.collect()
            gc.freeze()
            frozen = True
            gc_before = gc.get_stats()
            walls = []
            for _ in range(CAPACITY_REPS):
                t0 = time.perf_counter()
                disp.infer_many(pool[:FRAME_BUCKET], scene=scenes[0])
                walls.append(time.perf_counter() - t0)
            dispatch_s = sorted(walls)[len(walls) // 2]
            capacity = {
                "closed_loop_dispatch_ms": round(dispatch_s * 1e3, 3),
                "per_replica_capacity_rps": round(FRAME_BUCKET / dispatch_s, 2),
                "reps": CAPACITY_REPS,
            }

            # ---- stage table: traced closed-loop requests via the worker ----
            traced = MicroBatchDispatcher(registry.infer_fn(), cfg, start_worker=True,
                                          trace=True, device=dev)
            registry.bind_obs(traced.obs)
            traced.infer_one(pool[0], scene=scenes[0])  # worker-path warmup
            durations = []
            t0 = time.perf_counter()
            for i in range(n_requests):
                req = traced.submit(pool[i % len(pool)], scene=scenes[i % len(scenes)])
                req.get(timeout=30.0)
                durations.append(req.spans.durations())
            span = time.perf_counter() - t0
            totals = traced.slo_totals()
            traced.close()
            compiled_after = registry.compile_cache_size()
            disp.close()

            return {
                "operating_point": {
                    "hw": [HW, HW], "num_experts": M, "n_hyps": N_HYPS,
                    "frame_bucket": FRAME_BUCKET, "scenes": SCENES,
                    "serve_max_wait_ms": 0.0,
                },
                "requests": n_requests,
                "closed_loop_rps_traced_path": round(n_requests / span, 2),
                "stage_table": stage_table(durations),
                "host_overhead": host_overhead_summary(durations),
                "capacity": capacity,
                "accounting": totals,
                "compiled_programs": {
                    "before": compiled_before, "after": compiled_after,
                    "hot_path_recompiles": compiled_after - compiled_before,
                },
                "gc": {
                    "frozen": frozen,
                    "collections_during_run": [int(a["collections"] - b["collections"])
                                               for a, b in zip(gc.get_stats(), gc_before)],
                },
                "platform": "gpu" if dev.type == "cuda" else "cpu",
            }
        finally:
            if frozen:
                gc.unfreeze()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--out", type=str, default=None, help="also write the JSON document here")
    ap.add_argument("--cpu", action="store_true", help="profile on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = profile(n_requests=args.requests, device="cpu" if args.cpu else None)
    doc = json.dumps(out, indent=1)
    if args.out:
        pathlib.Path(args.out).write_text(doc + "\n")
    print(doc)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
