"""``prefetch`` mode (counterpart of ``bench.py``'s ``_measure_prefetch``):
the tiered weight hierarchy sweep (DESIGN.md §17).  One Zipf
scene-popularity trace over a fleet whose device budget holds
1/PREFETCH_OVERSUB_X of the scenes, served three ways, a fresh registry per
leg:

- ``on_demand``          -- device cache only: every re-admission of an
  evicted scene pays the DISK cold-load class;
- ``host_tier``          -- + the compressed bf16 host tier: eviction
  demotes, re-admission promotes without a disk read;
- ``host_tier_prefetch`` -- + the predictive prefetcher admitting scenes
  from the dispatcher's arrival stream ahead of their faults.

Per leg: served p50/p99, exact outcome accounting, per-tier fault classes,
prefetch decisions and the batch-signature count (no new signature across
any tier transition).  The headline is the p99 cut of the full hierarchy
against on-demand."""

from __future__ import annotations

import time

import numpy as np

from esac_tpu_torch.bench.constants import (
    PREFETCH_HW,
    PREFETCH_HYPS,
    PREFETCH_M,
    PREFETCH_OVERSUB_X,
    PREFETCH_REQUESTS,
    PREFETCH_SCENES,
    PREFETCH_ZIPF_A,
)
from esac_tpu_torch.bench.fixtures import (
    accounting_exact,
    image_frame,
    pct,
    scratch_dir,
    tiny_preset,
    write_scene,
)
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.cache import tree_nbytes
from esac_tpu_torch.registry.hosttier import HostWeightTier
from esac_tpu_torch.registry.manifest import SceneManifest
from esac_tpu_torch.registry.prefetch import PrefetchPolicy
from esac_tpu_torch.registry.serving import SceneRegistry, load_scene_params
from esac_tpu_torch.utils.precision import resolve_device


def measure_prefetch(n_scenes: int = PREFETCH_SCENES, n_requests: int = PREFETCH_REQUESTS,
                     device=None) -> dict:
    dev = resolve_device(device)
    with scratch_dir("esac_prefetch_bench_") as root:
        return _measure_prefetch_at(root, n_scenes, n_requests, dev)


def _measure_prefetch_at(root, n_scenes: int, n_requests: int, dev) -> dict:
    H = PREFETCH_HW
    M = PREFETCH_M
    preset = tiny_preset(H, M)
    # serve_max_wait_ms=0: one request per dispatch -- the sweep measures
    # per-request weight-locality classes, not coalescing.
    cfg = RansacConfig(n_hyps=PREFETCH_HYPS, refine_iters=2, polish_iters=1,
                       frame_buckets=(1,), serve_max_wait_ms=0.0, serve_queue_depth=512)
    manifest = SceneManifest()
    entries = [manifest.add(write_scene(root, f"scene{i}", preset, cfg, seed=i,
                                        center_offset=i * 0.01))
               for i in range(n_scenes)]
    sids = [e.scene_id for e in entries]
    # Prime the OS page cache over every checkpoint ONCE, before any leg:
    # leg order must compare tier policy, not disk-cache temperature.
    for e in entries:
        load_scene_params(e)
    scene_nbytes = tree_nbytes(load_scene_params(entries[0]))
    budget_scenes = max(1, n_scenes // PREFETCH_OVERSUB_X)
    device_budget = scene_nbytes * budget_scenes + 1

    # One Zipf trace shared by every leg: rank r served with p ~ 1/(r+1)^a.
    rng = np.random.default_rng(13)
    p = 1.0 / (np.arange(n_scenes) + 1.0) ** PREFETCH_ZIPF_A
    p /= p.sum()
    trace = rng.choice(n_scenes, size=n_requests, p=p)
    pool = [image_frame(i, H) for i in range(8)]

    def run_leg(tier, prefetch):
        reg = SceneRegistry(manifest, budget_bytes=device_budget, host_tier=tier, device=dev)
        pf = None
        if prefetch:
            # device_scenes leaves ONE budget slot as demand-fault headroom.
            pf = reg.attach_prefetcher(PrefetchPolicy(
                interval_ms=3.0, halflife_s=2.0, device_scenes=max(1, budget_scenes - 1),
                max_device_per_cycle=2, max_host_per_cycle=4))
        disp = reg.dispatcher(cfg)
        try:
            # Off the trace: the first call of the shared bucket function,
            # then one warm pass over every scene -- identical in every leg.
            for s in sids:
                disp.infer_one(pool[0], scene=s, deadline_ms=300_000.0)
            compiled = reg.compile_cache_size()
            disp.reset_stats()
            lat = []
            for i, s in enumerate(trace):
                t0 = time.perf_counter()
                disp.infer_one(pool[i % len(pool)], scene=sids[int(s)], deadline_ms=300_000.0)
                lat.append((time.perf_counter() - t0) * 1e3)
            totals = disp.slo_totals()
            snap = disp.obs.snapshot() if prefetch else None
        finally:
            if pf is not None:
                pf.close()
            disp.close()
        cache = reg.cache.stats()
        leg = {
            "served_p50_ms": round(pct(lat, 0.50), 2),
            "served_p99_ms": round(pct(lat, 0.99), 2),
            "served_mean_ms": round(sum(lat) / len(lat), 2),
            "wall_s": round(sum(lat) / 1e3, 3),
            "outcomes": totals,
            "sums_to_offered": accounting_exact(totals),
            "fault_classes": {
                "device_hits": cache["hits"],
                "host_hits": cache["host_hits"],
                "disk_loads": cache["disk_loads"],
                "demotions": cache["demotions"],
            },
            "cache_stats": cache,
            "tier_stats": tier.stats() if tier is not None else None,
            "prefetch_stats": pf.stats() if pf is not None else None,
            "compiled_programs": reg.compile_cache_size(),
            "recompiles_during_trace": reg.compile_cache_size() - compiled,
        }
        return leg, snap

    on_demand, _ = run_leg(tier=None, prefetch=False)
    host_tier, _ = run_leg(tier=HostWeightTier(compression="bf16"), prefetch=False)
    full, fleet_snap = run_leg(tier=HostWeightTier(compression="bf16"), prefetch=True)

    def cut(a, b):
        return round(a / max(b, 1e-9), 2)

    return {
        "scenes": {"n": n_scenes, "hw": [H, H], "num_experts": M, "n_hyps": PREFETCH_HYPS,
                   "scene_nbytes": scene_nbytes},
        "device_budget_bytes": device_budget,
        "device_budget_scenes": budget_scenes,
        "hbm_oversubscription_x": round(n_scenes / budget_scenes, 2),
        "zipf_alpha": PREFETCH_ZIPF_A,
        "requests_per_leg": n_requests,
        "compression": "bf16",
        "legs": {"on_demand": on_demand, "host_tier": host_tier, "host_tier_prefetch": full},
        "p99_cut_x_host_tier": cut(on_demand["served_p99_ms"], host_tier["served_p99_ms"]),
        "p99_cut_x_prefetch": cut(on_demand["served_p99_ms"], full["served_p99_ms"]),
        "p50_cut_x_prefetch": cut(on_demand["served_p50_ms"], full["served_p50_ms"]),
        "obs_snapshot": fleet_snap,
        "note": (
            "same Zipf trace over the same scenes, fresh registry per leg, one "
            f"warm pass per leg off the trace; the device budget holds "
            f"{budget_scenes}/{n_scenes} scenes so the on-demand leg re-pays the "
            "disk cold-load class on every tail fault; the host tier converts those "
            "to decompress+stage promotions; the prefetcher converts hot-scene "
            "faults into pre-staged warm hits ahead of arrival; outcome classes sum "
            "exactly to offered and the batch-signature count pins no new signature "
            "across all tier transitions in every leg"
        ),
    }


def prefetch_headline(prefetch: dict) -> dict:
    legs = prefetch["legs"]
    return {
        "metric": "weight_tier_served_p99_cut_x",
        "value": prefetch["p99_cut_x_prefetch"],
        "unit": "x",
        "vs_baseline": None,
        "p99_cut_x_host_tier": prefetch["p99_cut_x_host_tier"],
        "hbm_oversubscription_x": prefetch["hbm_oversubscription_x"],
        "on_demand_p99_ms": legs["on_demand"]["served_p99_ms"],
        "prefetch_p99_ms": legs["host_tier_prefetch"]["served_p99_ms"],
        "accounting_exact": all(leg["sums_to_offered"] for leg in legs.values()),
        "recompiles": sum(leg["recompiles_during_trace"] for leg in legs.values()),
    }
