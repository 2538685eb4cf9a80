"""``python -m esac_tpu_torch.obs`` -- dump a fleet snapshot (counterpart of
``python -m esac_tpu.obs``).

Reads an obs snapshot and renders it as Prometheus text (default, every
collector's numeric leaves included as samples), pretty JSON, or -- with
``--traces [K]`` -- the K slowest sampled traces.  Sources:

- ``--file PATH``: a JSON file holding a bare ``snapshot()`` dict (it has
  ``metrics`` and ``obs_schema``), or a results file that carries one under
  ``obs_provenance.fleet`` or ``obs.obs_snapshot``;
- ``--demo``: a tiny in-process fleet on the CPU -- two echo replicas (a
  dispatcher each, no model) behind a ``FleetRouter`` with a timeline and
  the default health rules attached and tracing on -- driven by a few
  mixed-scene requests, then its live snapshot.

The port has no committed snapshot to default to (the JAX package reads
its ``.obs_overhead.json``): without ``--file`` or ``--demo`` it says so
and exits 2, as it does when a file holds no snapshot.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def _extract_snapshot(doc: dict) -> dict | None:
    """Find a snapshot dict inside a bare snapshot or a results file."""
    if not isinstance(doc, dict):
        return None
    if "metrics" in doc and "obs_schema" in doc:
        return doc
    prov = doc.get("obs_provenance")
    if isinstance(prov, dict) and isinstance(prov.get("fleet"), dict):
        return prov["fleet"]
    obs = doc.get("obs")
    if isinstance(obs, dict) and isinstance(obs.get("obs_snapshot"), dict):
        return obs["obs_snapshot"]
    return None


def _demo_snapshot() -> dict:
    """Two echo replicas behind a FleetRouter (timeline, rules, tracing),
    a few mixed-scene requests, its snapshot once two windows ticked."""
    import numpy as np

    from esac_tpu_torch.fleet.router import FleetPolicy, FleetRouter, Replica
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher

    def echo(tree, scene=None, route_k=None, n_hyps=None):
        return {"echo": tree["x"]}

    cfg = RansacConfig(frame_buckets=(1, 4), serve_max_wait_ms=1.0)
    reps = [Replica(f"r{i}", MicroBatchDispatcher(echo, cfg, trace=True, device="cpu"))
            for i in range(2)]
    router = FleetRouter(reps, FleetPolicy(poll_ms=2.0, trace_sample=1))
    tl = router.obs.attach_timeline(window_s=0.05)
    router.obs.attach_health_rules()
    try:
        for i in range(8):
            router.infer_one({"x": np.full(2, i, np.float32)}, scene=f"s{i % 2}",
                             deadline_ms=5_000)
        t_end = time.perf_counter() + 5.0
        while tl.ticks < 3 and time.perf_counter() < t_end:
            time.sleep(0.01)
    finally:
        router.close()
    return router.obs.snapshot()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m esac_tpu_torch.obs",
        description="dump an esac_tpu_torch fleet observability snapshot",
    )
    ap.add_argument("--file", type=pathlib.Path, default=None,
                    help="snapshot JSON, or a results file carrying one")
    ap.add_argument("--format", choices=("prom", "json"), default="prom")
    ap.add_argument("--demo", action="store_true",
                    help="run a tiny in-process CPU fleet and dump it")
    ap.add_argument("--traces", type=int, nargs="?", const=5, default=None, metavar="K",
                    help="render the K slowest sampled traces (default 5) "
                         "instead of the metrics page")
    args = ap.parse_args(argv)

    if args.demo:
        snap = _demo_snapshot()
    elif args.file is None:
        print("no snapshot to read: pass --file PATH (a snapshot JSON, or a results "
              "file carrying one) or --demo", file=sys.stderr)
        return 2
    else:
        try:
            doc = json.loads(args.file.read_text())
        except (OSError, ValueError) as e:
            print(f"no readable snapshot at {args.file}: {e}", file=sys.stderr)
            return 2
        snap = _extract_snapshot(doc)
        if snap is None:
            print(f"{args.file} carries no obs snapshot (expected a snapshot dict, "
                  "obs_provenance.fleet, or obs.obs_snapshot)", file=sys.stderr)
            return 2

    from esac_tpu_torch.obs.export import render_prometheus, render_traces

    if args.traces is not None:
        sys.stdout.write(render_traces(snap, args.traces))
    elif args.format == "json":
        print(json.dumps(snap, indent=1, sort_keys=True))
    else:
        sys.stdout.write(render_prometheus(snap))
    return 0


if __name__ == "__main__":
    sys.exit(main())
