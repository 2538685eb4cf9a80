"""The readings that set the limits of ``compare``: sound runs of the
program on many seeds, and the control -- the reference computed one step
below the configuration's precision in the program's place -- on a few,
all in one process on the card.

    python3 benchmark/control.py --workload NAME --seconds S \\
        --seeds 1,2,...  --control-seeds 101,102,103

Prints one JSON line a run, then a summary: per compared number the
largest reading of the sound runs (the lower reading) and, per control,
the smallest (the upper reading).  The benchmark's own runs never run
this.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CONTROLS = ("cnn_fp8", "head3_fp8", "head3_skip", "score_bf16")


def control_numbers(wl, seed: int, device, precision: str) -> dict:
    """The control's numbers on one seed: the reference at ``precision``
    judged against the float32 reference, on as many frames as a run
    samples (the same images and request seeds on both sides)."""
    import numpy as np

    from benchmark import compare, harness

    n = wl.cell["correct_sample"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    picks = [(i % wl.mix["image_pool"], int(s))
             for i, s in enumerate(rng.integers(0, 2 ** 62, size=n))]
    block = wl.cell["reference_block"]
    pool = wl.mix["image_pool"]
    ref = harness.reference_answers(wl.cfg, seed, pool, picks, device, "float32", block)
    low = harness.reference_answers(wl.cfg, seed, pool, picks, device, precision, block)
    return compare.numbers(low, ref)


def main(argv=None) -> int:
    import torch

    from benchmark import compare, harness, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    wl = spec.load(args.workload)
    sound, controls = [], {p: [] for p in CONTROLS}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(wl, seed, args.seconds, False, dev, time.perf_counter())
        nums = {k: v["value"] for k, v in res["compared"].items()}
        sound.append(nums)
        print(json.dumps({"run": "program", "seed": seed, "correct": res["correct"], **nums}),
              flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",")):
        for p in CONTROLS:
            nums = control_numbers(wl, seed, dev, p)
            controls[p].append(nums)
            print(json.dumps({"run": p, "seed": seed, **nums}), flush=True)
    summary = {"workload": args.workload, "device": str(dev), "lower": {}, "upper": {}}
    for k in compare.NUMBERS:
        summary["lower"][k] = max(r[k] for r in sound)
        summary["upper"][k] = {p: min(r[k] for r in rs) for p, rs in controls.items()}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
