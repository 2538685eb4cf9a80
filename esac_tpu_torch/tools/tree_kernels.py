#!/usr/bin/env python3
"""Phase 3 of a checkout's own chip_smoke.py, at shapes of one's choice.

    python3 esac_tpu_torch/tools/tree_kernels.py TREE \
        [--shape LABEL=FRAMES,MAPS,HYPOTHESES,HEIGHT,WIDTH ...] [--seed 0]

Imports TREE's ``chip_smoke.py`` and TREE's port package (not this
checkout's), builds TREE's kernels, sets its ``KERNEL_SHAPES`` to the shapes
given (by default the 1-frame serving bucket, 7 experts x 256 hypotheses at
640x480) and runs its ``phase_kernels``: every check that tree's phase 3
makes, and the times it logs.  A "before" leg at a shape that an older
tree's chip_smoke.py does not hold, with that tree's own kernels, wrappers
and checks.  Needs one CUDA GPU.  Prints the card's nvidia-smi name and
power limit, then one JSON object of the phase's results.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _shape(text: str) -> tuple[str, tuple[int, ...]]:
    label, dims = text.split("=")
    return label, tuple(int(d) for d in dims.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=pathlib.Path)
    ap.add_argument("--shape", type=_shape, action="append", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    import chip_smoke as cs

    dev, _, smi = cs.phase_device()
    cs.phase_build()
    cs.KERNEL_SHAPES = dict(args.shape or [("frames1", (1, 7, 256, 480, 640))])
    results = cs.phase_kernels(dev, args.seed)
    print(smi)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
