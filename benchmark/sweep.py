"""Find an open-loop cell's knee: one set-up, then the cell's traffic at
each offered rate for a short window, in one process.

    python3 benchmark/sweep.py --workload NAME --seed N --seconds S --rates R1,R2,...

Prints one JSON line a rate: offered and served rate, p50 / p95 / p99 of
all requests (from their due times), the p95 of the window's first and
second halves (a backlog that grows shows as a second half far above the
first) and how late the generator ran.  Not part of a benchmark run.
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import torch

    from benchmark import harness, reduce, scene, spec
    from benchmark import system as system_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    wl = spec.load(args.workload)
    with tempfile.TemporaryDirectory(prefix="esac_sweep_") as tmp:
        system = system_mod.build(wl.cfg, wl.mix, args.seed, dev, pathlib.Path(tmp))
        images = list(scene.make_frames(wl.cfg, args.seed, wl.mix["image_pool"], dev)
                      ["images"].cpu().numpy())
        gen = spec.generator(wl.mix["generator"])
        for rate in (float(r) for r in args.rates.split(",")):
            wl.cell = dict(wl.cell, rate_per_s=rate)
            ctx = harness.Context(wl=wl, system=system, images=images, seed=args.seed,
                                  seconds=args.seconds, trace=False, device=dev)
            t = time.perf_counter()
            w = gen.run(ctx)
            lat = [1e3 * x for x in w["latencies"]]
            half = len(lat) // 2
            print(json.dumps({
                "rate_per_s": rate, "served_per_s": w["served_frames"] / args.seconds,
                "requests": len(lat), "failed": w["failed"],
                "p50_ms": reduce.percentile(lat, 50), "p95_ms": reduce.percentile(lat, 95),
                "p99_ms": reduce.percentile(lat, 99),
                "p95_first_half_ms": reduce.percentile(lat[:half], 95),
                "p95_second_half_ms": reduce.percentile(lat[half:], 95),
                "frames_per_dispatch": w["served_frames"] / max(1, w["dispatches"]),
                "late_max_ms": w["generator"]["late_max_ms"],
                "wall_s": time.perf_counter() - t}), flush=True)
        system_mod.release(system, dev)
    print(json.dumps({"device": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
