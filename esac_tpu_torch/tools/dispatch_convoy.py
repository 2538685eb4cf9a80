#!/usr/bin/env python3
"""How much a second busy Python thread slows a serving dispatch.

A port dispatch is a stream of a few hundred eager ops, each releasing and
re-taking the GIL, so a concurrent Python-bound thread takes the GIL at
every op boundary.  Two measurements, on the card unless ``--cpu``:

- ``loader``: one scene's warm dispatch (the bench drills' toy preset,
  16 x 16, 2 experts, 4 hypotheses) timed 15 times while 0, 1 and 2
  background threads keep loading and staging another scene's weights
  (``load_scene_params`` + ``stage_scene_params``, what a prefetch does,
  outside the dispatch gate), and while a real ``WeightPrefetcher`` cycles
  the other scene (evicted before each cycle, so every cycle loads it),
  through the dispatch gate (``prefetcher``) and with the gate's wait cut
  to 0 (``prefetcher_ungated``);
- ``city``: every registry serve call of the bench's city drill
  (``esac_tpu_torch.bench.city``, 100 retriever steps), timed with a
  synchronize, with the prefetchers running, without them, and with a
  0.1 ms GIL switch interval; the drill's watchdog is lifted to 60 s so a
  stretched dispatch is timed, not quarantined.

``python3 esac_tpu_torch/tools/dispatch_convoy.py [--cpu] [--skip-city]
[--out FILE]`` prints one JSON document.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _quantiles(times_s: list[float]) -> dict:
    ts = sorted(times_s)

    def q(p):
        return round(1e3 * ts[min(len(ts) - 1, int(p * len(ts)))], 1)

    return {"n": len(ts), "p50_ms": q(0.5), "p90_ms": q(0.9), "p99_ms": q(0.99),
            "max_ms": q(1.0)}


def loader_convoy(dev, repeats: int = 15) -> dict:
    """Warm dispatch times with 0, 1 and 2 weight-loading threads, and
    with a prefetcher cycling through the gate and past it."""
    from esac_tpu_torch.bench.fixtures import (
        fence,
        image_frame,
        scratch_dir,
        tiny_preset,
        write_scene,
    )
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.manifest import SceneManifest
    from esac_tpu_torch.registry.prefetch import PrefetchPolicy
    from esac_tpu_torch.registry.serving import (
        SceneRegistry,
        load_scene_params,
        stage_scene_params,
    )
    from esac_tpu_torch.serve import gate

    out = {}
    with scratch_dir("esac_convoy_") as root:
        preset = tiny_preset(16, 2)
        cfg = RansacConfig(n_hyps=4, refine_iters=2, polish_iters=1, frame_buckets=(1,),
                           serve_max_wait_ms=0.0)
        manifest = SceneManifest()
        for i in range(2):
            manifest.add(write_scene(root, f"s{i}", preset, cfg, seed=i, checksums=True))
        disp = SceneRegistry(manifest, device=dev).dispatcher(cfg, start_worker=False)
        disp.infer_one(image_frame(0, 16), scene="s0")
        entry = manifest.resolve("s1")
        stop = threading.Event()

        def load_forever():
            while not stop.is_set():
                stage_scene_params(load_scene_params(entry), preset, dev)

        reg = SceneRegistry(manifest, device=dev)
        disp2 = reg.dispatcher(cfg, start_worker=False)
        pf = reg.attach_prefetcher(PrefetchPolicy(interval_ms=1.0, device_scenes=2,
                                                  repromote_cooldown_s=0.0), start=False)
        disp2.infer_one(image_frame(0, 16), scene="s0")
        cycles = {"n": 0}

        def prefetch_forever():
            while not stop.is_set():
                reg.cache.evict(entry.key)
                pf.observe("s1")
                pf.run_cycle()
                cycles["n"] += 1

        def timed(target, copies, d):
            threads = [threading.Thread(target=target, daemon=True) for _ in range(copies)]
            stop.clear()
            for t in threads:
                t.start()
            times = []
            for k in range(repeats):
                t0 = time.perf_counter()
                d.infer_one(image_frame(k, 16), scene="s0")
                fence(dev)
                times.append(time.perf_counter() - t0)
            stop.set()
            for t in threads:
                t.join(60.0)
            return _quantiles(times)

        for loaders in (0, 1, 2):
            out[f"loaders_{loaders}"] = timed(load_forever, loaders, disp)
        for name, wait_s in (("prefetcher", gate.MAX_YIELD_S), ("prefetcher_ungated", 0.0)):
            saved, gate.MAX_YIELD_S = gate.MAX_YIELD_S, wait_s
            cycles["n"] = 0
            try:
                out[name] = {**timed(prefetch_forever, 1, disp2), "cycles": cycles["n"]}
            finally:
                gate.MAX_YIELD_S = saved
        pf.close()
        disp2.close()
        disp.close()
    return out


def city_convoy(dev, train_steps: int = 100) -> dict:
    """The city drill's serve calls with and without its prefetchers."""
    import torch

    from esac_tpu_torch.bench import city
    from esac_tpu_torch.registry import prefetch, serving
    from esac_tpu_torch.serve.slo import SLOPolicy

    times: list[float] = []
    infer_fn, start = serving.SceneRegistry.infer_fn, prefetch.WeightPrefetcher.start
    slo_policy, interval = city.SLOPolicy, sys.getswitchinterval()

    def timed_infer_fn(self):
        fn = infer_fn(self)

        def serve(batch, scene, route_k=None, n_hyps=None):
            t0 = time.perf_counter()
            out = fn(batch, scene, route_k, n_hyps)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            return out

        serve._cache_size = fn._cache_size
        return serve

    out = {}
    serving.SceneRegistry.infer_fn = timed_infer_fn
    city.SLOPolicy = lambda **kw: SLOPolicy(**{**kw, "watchdog_ms": 60_000.0})
    try:
        for name, with_prefetch, switch_s in (("prefetch", True, interval),
                                              ("no_prefetch", False, interval),
                                              ("prefetch_switch_0.1ms", True, 1e-4)):
            prefetch.WeightPrefetcher.start = start if with_prefetch else (lambda self: self)
            sys.setswitchinterval(switch_s)
            times.clear()
            t0 = time.perf_counter()
            payload = city.measure_city(train_steps=train_steps, device=dev)
            out[name] = {**_quantiles(times), "wall_s": round(time.perf_counter() - t0, 1),
                         "closed_loop_dispatch_ms": payload["closed_loop_dispatch_ms"],
                         "recall_at_k": {leg["top_k"]: leg["recall_at_k"]
                                         for leg in payload["legs"]}}
            print(name, json.dumps(out[name]), flush=True)
    finally:
        serving.SceneRegistry.infer_fn, prefetch.WeightPrefetcher.start = infer_fn, start
        city.SLOPolicy = slo_policy
        sys.setswitchinterval(interval)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="measure on the CPU")
    ap.add_argument("--skip-city", action="store_true", help="only the loader measurement")
    ap.add_argument("--out", default=None, help="also write the JSON document here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from esac_tpu_torch.bench.scaffold import device_block
    from esac_tpu_torch.utils.precision import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    doc = {"device": device_block(dev), "loader": loader_convoy(dev)}
    if not args.skip_city:
        doc["city"] = city_convoy(dev)
    text = json.dumps(doc, indent=1)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
