"""``routed`` mode (counterpart of ``bench.py``'s ``_measure_routed``): the
dense-vs-routed serve sweep (DESIGN.md §11).  One synthetic gated scene
(M = 8 experts, 96 x 96 frames); the full bucket functions (gating CNN +
expert CNNs + frames-major RANSAC) timed at K in {1, M/4, M/2, M} against the
dense function at FIXED total hypotheses (the routed entry gives each
evaluated expert ``n_hyps * M / K``).  Per-expert frame capacity is the
balanced load ``ceil(B*K/M)``; drops under the random-init gating's
concentrated routing are recorded.

Two honesty legs ride along: ``k_eq_m_bitwise`` (the K = M routed function
against the dense one, bit for bit) and ``accuracy`` (coords-level winner
accuracy on planted-expert frames with informative, load-balanced gating:
dense consensus vs routed at every K, same capacity rule)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from esac_tpu_torch.bench.constants import (
    ROUTED_FRAMES,
    ROUTED_HW,
    ROUTED_HYPS,
    ROUTED_M,
    ROUTED_REPEATS,
)
from esac_tpu_torch.bench.fixtures import REQUEST_SEED, fence
from esac_tpu_torch.data.synthetic import make_correspondence_frame
from esac_tpu_torch.parallel.esac_sharded import route_frames_to_experts
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import (
    esac_infer_frames,
    esac_infer_routed_frames,
    select_topk_experts,
)
from esac_tpu_torch.ransac.kernel import frame_generators
from esac_tpu_torch.registry.manifest import ScenePreset
from esac_tpu_torch.registry.serving import (
    init_scene_params,
    make_routed_scene_bucket_fn,
    make_scene_bucket_fn,
)
from esac_tpu_torch.utils.precision import resolve_device


def measure_routed(n_frames: int = ROUTED_FRAMES, n_hyps: int = ROUTED_HYPS,
                   repeats: int = ROUTED_REPEATS, device=None) -> dict:
    dev = resolve_device(device)
    H = W = ROUTED_HW
    M, B = ROUTED_M, n_frames
    preset = ScenePreset(height=H, width=W, num_experts=M, stem_channels=(8, 16, 32),
                         head_channels=64, head_depth=3, gating_channels=(4, 8),
                         compute_dtype="float32", gated=True)
    cfg = RansacConfig(n_hyps=n_hyps, refine_iters=4, polish_iters=2, frame_buckets=(B,))
    total_hyps = B * M * n_hyps  # per dispatch, fixed across the sweep
    params = init_scene_params(preset, seed=0, device=dev)
    params["f"] = torch.tensor(60.0, device=dev)
    host_images = np.random.default_rng(3).random((B, H, W, 3), dtype=np.float32)
    seeds = np.arange(REQUEST_SEED, REQUEST_SEED + B, dtype=np.int64)

    def make_batch():
        # A fresh device copy per call: per-dispatch staging is the honest
        # serving cost.
        return {"seed": seeds, "image": torch.from_numpy(host_images).to(dev)}

    def timed(fn):
        out = fn(params, make_batch())  # warm
        fence(dev)
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn(params, make_batch())
            fence(dev)
            walls.append(time.perf_counter() - t0)
        walls.sort()
        return walls[len(walls) // 2], walls, out

    dense_dt, dense_spread, dense_out = timed(make_scene_bucket_fn(preset, cfg, device=dev))
    ks = sorted({1, M // 4, M // 2, M})
    curve = []
    k_eq_m_bitwise = None
    for k in ks:
        cap = max(2, -(-B * k // M))  # balanced per-expert load, slack 1.0
        cfg_k = dataclasses.replace(cfg, serve_capacity=cap)
        dt, spread, out = timed(make_routed_scene_bucket_fn(preset, cfg_k, k, device=dev))
        ev = out["experts_evaluated"].cpu().numpy()
        if k == M:
            k_eq_m_bitwise = all(torch.equal(out[key], dense_out[key])
                                 for key in ("rvec", "tvec", "scores", "expert"))
        curve.append({
            "k": k,
            "capacity": cap,
            "expert_forwards": (M * cap) if k < M else (B * M),
            "dispatch_ms": round(dt * 1e3, 2),
            "wall_s_spread": [round(x, 4) for x in spread],
            "hyps_per_s": round(total_hyps / dt, 1),
            "speedup_x": round(dense_dt / dt, 2),
            "dropped_slots": int((ev == M).sum()),
            "slots": int(ev.size),
        })

    # ---- accuracy leg: coords-level, informative load-balanced gating ----
    frames = [make_correspondence_frame(torch.Generator().manual_seed(100 + i), noise=0.01,
                                        outlier_frac=0.3, height=120, width=160, f=131.25,
                                        c=(80.0, 60.0), device=dev) for i in range(B)]
    n_cells = frames[0]["coords"].shape[0]
    planted = np.arange(B) % M
    junk = torch.Generator().manual_seed(4)
    coords_all = torch.stack([
        torch.stack([frames[i]["coords"] if m == planted[i]
                     else (5.0 * torch.rand((n_cells, 3), generator=junk)).to(dev)
                     for m in range(M)])
        for i in range(B)])  # (B, M, N, 3)
    # Ring gating: frame i's preference order is planted, planted+1, ... mod
    # M -- informative AND balanced, so the capacity rule never drops a
    # planted expert (per-expert claimants = exactly ceil(B*K/M)).
    logits = torch.as_tensor(np.stack([np.roll(5.0 - np.arange(M, dtype=np.float32), int(p))
                                       for p in planted]), device=dev)
    pixels_b = torch.stack([f["pixels"] for f in frames])
    f_b = torch.full((B,), 131.25, device=dev)
    c_pt = torch.tensor([80.0, 60.0], device=dev)

    def gens():
        return frame_generators(range(5_000, 5_000 + B), dev)

    acfg = RansacConfig(n_hyps=n_hyps, refine_iters=4, polish_iters=2, frame_buckets=(B,))
    with torch.inference_mode():
        dense_acc_out = esac_infer_frames(gens(), logits, coords_all, pixels_b, f_b, c_pt,
                                          acfg, device=dev)
    dense_expert = dense_acc_out["expert"].cpu().numpy()
    accuracy = {"dense_winner_acc": float(np.mean(dense_expert == planted)), "per_k": []}
    for k in ks:
        cap = max(2, -(-B * k // M))
        selected = select_topk_experts(logits, k)
        kept, _, _, _ = route_frames_to_experts(selected, M, cap)
        with torch.inference_mode():
            out = esac_infer_routed_frames(
                gens(), logits, coords_all[torch.arange(B, device=dev)[:, None], selected],
                selected, kept, pixels_b, f_b, c_pt, acfg, device=dev)
        got = out["expert"].cpu().numpy()
        evaluated = out["experts_evaluated"].cpu().numpy()
        accuracy["per_k"].append({
            "k": k,
            "capacity": cap,
            "winner_acc": float(np.mean(got == planted)),
            "agrees_with_dense": float(np.mean(got == dense_expert)),
            "planted_dropped": int(((evaluated == planted[:, None]).sum(1) == 0).sum()),
        })

    by_k = {e["k"]: e for e in curve}
    return {
        "n_frames": B,
        "num_experts": M,
        "n_hyps_per_expert_dense": n_hyps,
        "total_hyps_per_dispatch": total_hyps,
        "preset": {"hw": [H, W], "stem": list(preset.stem_channels),
                   "head": [preset.head_channels, preset.head_depth]},
        "dense_dispatch_ms": round(dense_dt * 1e3, 2),
        "dense_wall_s_spread": [round(x, 4) for x in dense_spread],
        "dense_hyps_per_s": round(total_hyps / dense_dt, 1),
        "curve": curve,
        "k_eq_m_bitwise": bool(k_eq_m_bitwise),
        "speedup_at_k_m4": by_k[max(1, M // 4)]["speedup_x"],
        "accuracy": accuracy,
        "note": (
            "fixed total hypotheses across the sweep (routed reallocates "
            "the per-expert budget); throughput legs run the full bucket "
            "functions with random-init weights -- their gating routes "
            "concentratedly, so drops are heavy but compute (and thus "
            "throughput) is capacity-static; the accuracy leg is "
            "coords-level with informative balanced gating so the same "
            "capacity rule drops nothing planted"
        ),
    }


def routed_headline(routed: dict) -> dict:
    return {
        "metric": "routed_serve_speedup_x_at_k_m4",
        "value": routed["speedup_at_k_m4"],
        "unit": "x",
        "vs_baseline": None,
        "k_eq_m_bitwise": routed["k_eq_m_bitwise"],
    }
