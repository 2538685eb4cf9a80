"""The port's bench (counterpart of the root ``bench.py``, which stays as it
is): the same measurements, run in process on the card through the port's
own modules.

    python -m esac_tpu_torch.bench [MODE] [--cpu]

No MODE: the headline, ``pose_hypotheses_per_sec_per_chip`` (config #1's
pipeline against the C++ host loop); ``streaming``: config #5's one-chip
shard; the named modes as in ``bench.py``: serve, registry, routed, loadtest,
scoring, chaos, obs, prefetch, fleet, hostpath, city, sessions.  Each run
prints exactly one JSON line with ``bench.py``'s ``metric``, ``unit`` and
headline keys, and writes ``chiprun_out/bench/<mode>.json``
(``scaffold.ARTIFACT_DIR``).  It runs on the card unless ``--cpu`` asks for
the CPU, and raises where there is no card: there is no CPU fallback.
``python -m esac_tpu_torch.bench.accuracy`` is ``bench_accuracy.py``'s
counterpart.

What has no counterpart here, because it exists only for the TPU
container: the relay probe, the detached never-killed measurement child, the
busy sentinel, the pause of co-tenant pipelines and its breadcrumb, and the
committed-hardware block read from ``BENCH_TPU.json``.
"""

from __future__ import annotations

import argparse
import sys

from esac_tpu_torch.bench import (
    chaos,
    city,
    fleet,
    hostpath,
    loadtest,
    obs,
    pipeline,
    prefetch,
    registry,
    routed,
    scoring,
    serve,
    sessions,
)
from esac_tpu_torch.bench.scaffold import run_mode
from esac_tpu_torch.utils.precision import resolve_device

# mode -> (measure, headline): ``bench.py``'s ``_main_measured`` table.
MODES = {
    "serve": (serve.measure_serve, serve.serve_headline),
    "registry": (registry.measure_registry, registry.registry_headline),
    "routed": (routed.measure_routed, routed.routed_headline),
    "loadtest": (loadtest.measure_loadtest, loadtest.loadtest_headline),
    "scoring": (scoring.measure_scoring, scoring.scoring_headline),
    "chaos": (chaos.measure_chaos, chaos.chaos_headline),
    "obs": (obs.measure_obs, obs.obs_headline),
    "prefetch": (prefetch.measure_prefetch, prefetch.prefetch_headline),
    "fleet": (fleet.measure_fleet, fleet.fleet_headline),
    "hostpath": (hostpath.measure_hostpath, hostpath.hostpath_headline),
    "city": (city.measure_city, city.city_headline),
    "sessions": (sessions.measure_sessions, sessions.sessions_headline),
}


def run(mode: str | None, dev, **kwargs) -> dict:
    """One bench run on ``dev``: the mode's line (printed) and artifact;
    ``kwargs`` reach the measure function (the tests' small counts)."""
    if mode in MODES:
        measure, headline = MODES[mode]
        if mode == "scoring":
            # The winner disagreements ride the artifact, not the payload.
            kwargs.setdefault("disagreements", [])
            return run_mode(mode, measure, headline, dev,
                            artifact_extra={"winner_disagreements": kwargs["disagreements"]},
                            **kwargs)
        return run_mode(mode, measure, headline, dev, **kwargs)
    return pipeline.main_measured(mode == "streaming", dev, **kwargs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m esac_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default=None, choices=sorted(MODES) + ["streaming"],
                   help="the measurement (none: the headline pipeline)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the kernels)")
    args = p.parse_args(argv)
    try:
        dev = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"esac_tpu_torch.bench: {e}", file=sys.stderr)
        return 2
    run(args.mode, dev)
    return 0
