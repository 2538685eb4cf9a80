"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Exits 1 without a result when there is no CUDA device, or fewer than the
cell asks for, when the program cannot be imported, or when a forbidden
package (JAX, Flax, orbax, the JAX package) was loaded.  The last line of
standard output is the result's JSON object; the compared numbers, each
beside its limit, are also the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

RUNS_DIR = pathlib.Path(__file__).resolve().parent.parent / "chiprun_out" / "benchmark"


def _finite(obj):
    """JSON has no infinities: a non-finite reading prints as +-1e300."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300 if obj > 0 or math.isnan(obj) else -1e300
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    from benchmark import harness, spec

    t0 = T0 - harness.process_age()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    wl = spec.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl.chips:
        print(f"needs {wl.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        import esac_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program does not import: {e}", file=sys.stderr)
        return 1
    result = harness.run_cell(wl, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t0)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    result = _finite(result)
    gen = result.pop("generator")
    print(json.dumps({"generator": gen}))
    kinds = result.pop("kinds", None)
    try:
        RUNS_DIR.mkdir(parents=True, exist_ok=True)
        (RUNS_DIR / f"{args.workload}.{args.seed}.{args.trace}.json").write_text(
            json.dumps(dict(result, generator=gen, kinds=kinds), indent=1))
    except OSError as e:
        print(f"run file not written: {e}", file=sys.stderr)
    for name, v in result["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
