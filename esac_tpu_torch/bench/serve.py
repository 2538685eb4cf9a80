"""``serve`` mode (counterpart of ``bench.py``'s ``_measure_serve``): the
frame-axis amortization curve (DESIGN.md §9).  ``n_frames`` single-frame
requests through ``serve.dispatcher.MicroBatchDispatcher`` at every frame
bucket in ``buckets``, n_hyps per request fixed, so total hypotheses are the
same across the sweep and the only variable is how many frames ride a
dispatch."""

from __future__ import annotations

import time

import numpy as np
import torch

from esac_tpu_torch.bench.constants import (
    C,
    SERVE_BUCKETS,
    SERVE_FRAMES,
    SERVE_HYPS,
    SERVE_REPEATS,
)
from esac_tpu_torch.bench.fixtures import REQUEST_SEED
from esac_tpu_torch.data.synthetic import CAMERA_F, make_correspondence_frame
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.serve.batching import MIN_LANES
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher, make_dsac_serve_fn
from esac_tpu_torch.utils.precision import resolve_device


def correspondence_requests(n_frames: int) -> list[dict]:
    """Coords-level requests from synthetic frames (1 cm noise, 30%
    outliers), host numpy, each with its own seed."""
    out = []
    for i in range(n_frames):
        fr = make_correspondence_frame(torch.Generator().manual_seed(i), noise=0.01,
                                       outlier_frac=0.3, device="cpu")
        out.append({"seed": np.int64(REQUEST_SEED + i), "coords": fr["coords"].numpy(),
                    "pixels": fr["pixels"].numpy(), "f": np.float32(CAMERA_F)})
    return out


def measure_serve(n_frames: int = SERVE_FRAMES, n_hyps: int = SERVE_HYPS,
                  buckets: tuple = SERVE_BUCKETS, repeats: int = SERVE_REPEATS,
                  device=None) -> dict:
    """Per leg: median wall time of ``repeats`` bulk passes after a warm
    pass, request p50/p99 of the median pass; ``physical_lanes`` records
    the serve path's >= 2-lane floor (``MIN_LANES``)."""
    dev = resolve_device(device)
    frames = correspondence_requests(n_frames)
    curve = []
    for B in sorted(buckets):
        cfg = RansacConfig(n_hyps=n_hyps, frame_buckets=(B,))
        disp = MicroBatchDispatcher(make_dsac_serve_fn(C, cfg, device=dev), cfg,
                                    start_worker=False, device=dev)
        disp.infer_many(frames)  # warm the bucket
        passes = []
        for _ in range(repeats):
            disp.reset_stats()
            t0 = time.perf_counter()
            disp.infer_many(frames)
            passes.append((time.perf_counter() - t0, disp.latency_quantiles()))
        disp.close()
        passes.sort(key=lambda p: p[0])
        dt, q = passes[len(passes) // 2]  # median pass
        curve.append({
            "frame_batch": B,
            "physical_lanes": max(B, MIN_LANES),
            "dispatches": -(-n_frames // B),
            "hyps_per_s": round(n_frames * n_hyps / dt, 1),
            "wall_s_spread": [round(p[0], 4) for p in passes],
            "p50_ms": round(q[0.5] * 1e3, 2),
            "p99_ms": round(q[0.99] * 1e3, 2),
        })
    by_b = {e["frame_batch"]: e for e in curve}
    lo, hi = min(by_b), max(by_b)
    return {
        "curve": curve,
        "n_frames": n_frames,
        "n_hyps_per_frame": n_hyps,
        "total_hyps": n_frames * n_hyps,
        "amortization_x": round(by_b[hi]["hyps_per_s"] / by_b[lo]["hyps_per_s"], 2),
        "note": (
            "fixed total hypotheses across the sweep; request latency is "
            "burst-load (all frames submitted at t=0, latency includes "
            "queue drain); frame_batch 1 runs at 2 physical lanes "
            "(MIN_LANES bit-identity floor), recorded in physical_lanes"
        ),
    }


def serve_headline(serve: dict) -> dict:
    by_b = {e["frame_batch"]: e for e in serve["curve"]}
    return {
        "metric": f"serve_hyps_per_sec_frame_batch_{max(by_b)}",
        "value": by_b[max(by_b)]["hyps_per_s"],
        "unit": "hyps/s",
        "vs_baseline": None,
        "vs_frame_batch_1": serve["amortization_x"],
    }
