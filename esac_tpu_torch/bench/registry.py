"""``registry`` mode (counterpart of ``bench.py``'s ``_measure_registry``):
multi-scene hot-swap latency classes (DESIGN.md §10).  A synthetic fleet of
``n_scenes`` scenes sharing one preset is served through one scene-aware
dispatcher, and each request-latency class is sampled ``repeats`` times:

- ``compile_first_ms``  -- the very first request (checkpoint load, staging
  to the device, the first call of the bucket function: CUDA context and
  cuDNN's algorithm choice on the card);
- ``cold_load_ms``      -- the first request of each LATER scene (load +
  staging, no new batch signature);
- ``warm_hit_ms``       -- a repeat request, weights cached on the device;
- ``hot_swap_ms``       -- round-robin across all scenes, all cached;
- ``evicted_reload_ms`` -- cycling a fleet one scene larger than the cache
  budget (every request re-stages its evicted weights);
- ``host_tier_hit_ms``  -- demoted to the bf16 host tier and re-served
  (decompress + stage, no disk read).

The batch-signature count is recorded so the artifact itself shows the swap
legs never added one."""

from __future__ import annotations

import time

from esac_tpu_torch.bench.constants import REGISTRY_REPEATS, REGISTRY_SCENES, SERVE_HYPS
from esac_tpu_torch.bench.fixtures import image_frame, med, scratch_dir, write_scene
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.cache import tree_nbytes
from esac_tpu_torch.registry.hosttier import HostWeightTier
from esac_tpu_torch.registry.manifest import SceneManifest, ScenePreset
from esac_tpu_torch.registry.serving import SceneRegistry, load_scene_params
from esac_tpu_torch.utils.precision import resolve_device


def measure_registry(n_scenes: int = REGISTRY_SCENES, repeats: int = REGISTRY_REPEATS,
                     device=None) -> dict:
    dev = resolve_device(device)
    with scratch_dir("esac_registry_bench_") as root:
        return _measure_registry_at(root, n_scenes, repeats, dev)


def _measure_registry_at(root, n_scenes: int, repeats: int, dev) -> dict:
    H = W = 32
    M = 4
    preset = ScenePreset(height=H, width=W, num_experts=M, stem_channels=(4, 8, 16),
                         head_channels=16, head_depth=1, gating_channels=(4,),
                         compute_dtype="float32", gated=True)
    cfg = RansacConfig(n_hyps=SERVE_HYPS, refine_iters=4, polish_iters=2, frame_buckets=(1,))
    manifest = SceneManifest()
    entries = [manifest.add(write_scene(root, f"scene{i}", preset, cfg, seed=i,
                                        center_offset=i * 0.01))
               for i in range(n_scenes)]
    scene_nbytes = tree_nbytes(load_scene_params(entries[0]))
    frames = [image_frame(i, H) for i in range(repeats)]

    def timed(disp, fr, scene):
        t0 = time.perf_counter()
        disp.infer_one(fr, scene=scene)
        return (time.perf_counter() - t0) * 1e3

    registry = SceneRegistry(manifest, device=dev)
    disp = registry.dispatcher(cfg, start_worker=False)
    sids = [e.scene_id for e in entries]

    compile_first_ms = timed(disp, frames[0], sids[0])
    cold_load = [timed(disp, frames[0], s) for s in sids[1:]]
    # warm_hit PINS one scene (the params argument never changes); hot_swap
    # cycles scenes every request -- the delta is the cost of swapping.
    warm_hit = [timed(disp, frames[i], sids[0]) for i in range(repeats)]
    hot_swap = [timed(disp, frames[i], sids[(i + 1) % len(sids)]) for i in range(repeats)]
    compiles_after_swaps = disp.cache_size()
    stats_shared = registry.cache.stats()
    disp.close()

    # Thrash floor: a fresh registry whose budget holds all but one scene,
    # cycled round-robin so EVERY request re-stages evicted weights.
    thrash = SceneRegistry(manifest, budget_bytes=scene_nbytes * (n_scenes - 1) + 1,
                           device=dev)
    disp_t = thrash.dispatcher(cfg, start_worker=False)
    for s in sids:
        disp_t.infer_one(frames[0], scene=s)  # fill + first evictions
    evicted_reload = [timed(disp_t, frames[i], sids[i % len(sids)]) for i in range(repeats)]
    disp_t.close()

    # Host-tier hit: each sample demotes the scene out of device memory and
    # re-serves it (decompress + staging, no disk read, no checksum re-read).
    tiered = SceneRegistry(manifest, host_tier=HostWeightTier(compression="bf16"),
                           device=dev)
    disp_h = tiered.dispatcher(cfg, start_worker=False)
    disp_h.infer_one(frames[0], scene=sids[0])  # load + this registry's first call
    host_hit = []
    for i in range(repeats):
        tiered.cache.demote((sids[0], 1))
        host_hit.append(timed(disp_h, frames[i], sids[0]))
    disp_h.close()

    return {
        "n_scenes": n_scenes,
        "scene_nbytes": scene_nbytes,
        "preset": {"hw": [H, W], "num_experts": M, "n_hyps": cfg.n_hyps,
                   "frame_buckets": list(cfg.frame_buckets)},
        "compile_first_ms": round(compile_first_ms, 2),
        "cold_load_ms": round(med(cold_load), 2),
        "cold_load_spread_ms": [round(x, 2) for x in sorted(cold_load)],
        "warm_hit_ms": round(med(warm_hit), 2),
        "warm_hit_spread_ms": [round(x, 2) for x in sorted(warm_hit)],
        "hot_swap_ms": round(med(hot_swap), 2),
        "hot_swap_spread_ms": [round(x, 2) for x in sorted(hot_swap)],
        "evicted_reload_ms": round(med(evicted_reload), 2),
        "evicted_reload_spread_ms": [round(x, 2) for x in sorted(evicted_reload)],
        "host_tier_hit_ms": round(med(host_hit), 2),
        "host_tier_hit_spread_ms": [round(x, 2) for x in sorted(host_hit)],
        "host_tier_compression": "bf16",
        "compiled_programs_after_all_swaps": compiles_after_swaps,
        "cache_stats_shared_registry": stats_shared,
        "cold_over_warm_x": round(med(cold_load) / max(med(warm_hit), 1e-9), 2),
        "swap_over_warm_x": round(med(hot_swap) / max(med(warm_hit), 1e-9), 2),
        "host_over_warm_x": round(med(host_hit) / max(med(warm_hit), 1e-9), 2),
        "cold_over_host_x": round(med(cold_load) / max(med(host_hit), 1e-9), 2),
        "note": (
            "one preset shared by all scenes: compiled_programs_after_all_swaps "
            "(batch signatures) == len(frame_buckets) shows hot-swapping adds no "
            "signature; hot_swap vs warm_hit isolates the cost of changing the "
            "params argument; evicted_reload cycles a budget one scene too small "
            "(worst-case thrash); host_tier_hit demotes out of device memory then "
            "re-serves through the bf16 host tier (decompress + stage, no disk "
            "read) -- the class a demoted scene pays instead of the cold class"
        ),
    }


def registry_headline(registry: dict) -> dict:
    return {
        "metric": "registry_hot_swap_p50_ms",
        "value": registry["hot_swap_ms"],
        "unit": "ms",
        "vs_baseline": None,
        "vs_warm_hit": registry["swap_over_warm_x"],
        "cold_over_warm_x": registry["cold_over_warm_x"],
    }
