#!/usr/bin/env python3
"""What bounds the scoring kernels on the card.

    python3 esac_tpu_torch/tools/kernel_bound.py [--seed 0]

Needs one CUDA GPU and nvcc.  Builds ``csrc/soft_inlier.cu`` several ways
into ``esac_tpu_torch/build/kernel_bound/`` (gitignored), all ``nvcc``
processes started together:

- ``ieee``: the served build (the flags of ``_build.py``);
- ``blocks8`` / ``blocks12``: the same with ``-DPARTIAL_BLOCKS_PER_SM`` at 8
  and 12 (the register cap the launch bounds ask of ptxas, hence occupancy);
- ``fast_math``: ``--use_fast_math`` (approximate sqrt, exp and division).
  A diagnostic of what the IEEE sequences cost; it is never served.

For each build it prints the registers and spills (ptxas) of the partial
pass, which both entries launch, and of each entry's final pass (the score
entry's sum pass, the select entry's first-max pass), the partial pass's
resident blocks per SM, and the CUDA-event times of each entry's launch
alone (operands packed once) at the 4- and 16-frame serving shapes (4 or 16
frames x 7 experts, H = 256, N = 4800) for fixed chunks of 16, 32, 64 and
128 cells (the served rule, ``fused_scoring.cell_chunks``, takes
``CHUNK_CELLS``), each checked against the plain version.  From the served build's SASS (``cuobjdump
-sass``) it counts the instructions of one (hypothesis, cell) pair of the
partial pass -- the one kernel both entries run, so one count covers both:
the distance between consecutive shared-memory cell loads (LDS.128) of the
unrolled inner loop, and the slow-path calls and special-function
instructions inside it.  Prints one JSON object, after the card's
nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BUILDS = {
    "ieee": [],
    "blocks8": ["-DPARTIAL_BLOCKS_PER_SM=8"],
    "blocks12": ["-DPARTIAL_BLOCKS_PER_SM=12"],
    "fast_math": ["--use_fast_math"],
}
CHUNKS = (16, 32, 64, 128)  # cells per chunk of the partial pass
FRAMES = (4, 16)
KERNELS = ("partial_kernel", "sum_kernel", "select_final_kernel")


def build(out_dir: pathlib.Path) -> dict[str, tuple[pathlib.Path, str]]:
    from esac_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "soft_inlier.cu"
    procs = {}
    for name, flags in BUILDS.items():
        lib = out_dir / f"soft_inlier_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, log)
    return built


def ptxas(log: str, kernel: str) -> dict:
    """Registers and spill stores of ``kernel`` from ptxas -v."""
    part = log.split(kernel, 1)[1]
    return dict(registers=int(re.search(r"Used (\d+) registers", part).group(1)),
                spill_store_bytes=int(re.search(r"(\d+) bytes spill stores", part).group(1)))


def sass_per_pair(lib: pathlib.Path) -> dict:
    from esac_tpu_torch import _build

    cuobjdump = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    fn = next(f for f in re.split(r"\n\s*Function : ", sass)
              if "partial_kernel" in f.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn)
    loads = [i for i, op in enumerate(ops) if op == "LDS.128"]
    gaps = [b - a for a, b in zip(loads, loads[1:])]
    pair = collections.Counter(ops[loads[0]:loads[1]])
    return dict(kernel="partial_kernel (both entries)",
                instructions_per_pair=statistics.median(gaps), gaps=gaps,
                slow_path_calls_per_pair=pair["CALL.REL.NOINC"],
                branches_per_pair=pair["BRA"],
                mufu_per_pair=sum(v for k, v in pair.items() if k.startswith("MUFU")))


def time_builds(built, seed: int) -> dict:
    import torch

    import chip_smoke as cs
    from esac_tpu_torch.ransac import fused_scoring as fs

    dev = torch.device("cuda", 0)
    stream = fs._stream(dev)
    shapes = {}
    for frames in FRAMES:
        Rs, ts, coords, pixels, f, c = cs._scoring_inputs(dev, seed, frames, 7, 256, 480, 640)
        op = fs._kernel_operands(Rs, ts, coords, pixels, f, c)
        args = (Rs, ts, coords, pixels, f, c, 10.0, 0.5)
        shapes[frames] = (op, fs._scores_plain(*args).reshape(op["P"], op["H"]),
                          fs._select_plain(*args))
    out = {}
    for name, (path, log) in built.items():
        lib = fs._typed(ctypes.CDLL(str(path)))
        row = {k: ptxas(log, k) for k in KERNELS}
        row["partial_blocks_per_sm"] = lib.esac_partial_blocks_per_sm()
        for frames, (op, want_scores, (want_i, want_s, _)) in shapes.items():
            for cells in CHUNKS:
                split = (-(-op["N"] // cells), cells)
                sel, sc = fs._select_buffers(op, dev, split), fs._score_buffers(op, dev, split)
                fs._check(fs._launch_select(op, sel, 10.0, 0.5, stream, lib), name)
                fs._check(fs._launch_scores(op, sc, 10.0, 0.5, stream, lib), name)
                select_ok = torch.equal(sel["best_idx"].long(), want_i.reshape(-1)) and \
                    torch.allclose(sel["best_score"], want_s.reshape(-1), **cs.SCORE_TOL)
                scores_ok = torch.allclose(sc["out"], want_scores, **cs.SCORE_TOL)
                row[f"P{op['P']}_cells{cells}"] = dict(
                    S=sel["S"], cells=cells, served=split == fs.cell_chunks(op["N"]),
                    select_kernel_ms=cs.time_ms(
                        lambda: fs._launch_select(op, sel, 10.0, 0.5, stream, lib), dev,
                        reps=50),
                    score_kernel_ms=cs.time_ms(
                        lambda: fs._launch_scores(op, sc, 10.0, 0.5, stream, lib), dev,
                        reps=50),
                    select_agrees_with_plain=select_ok, scores_agree_with_plain=scores_ok)
        out[name] = row
        print(name, json.dumps(row), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():  # torch-lint: disable=R6(exits 1: no fallback)
        print("kernel_bound: no CUDA GPU", file=sys.stderr)
        return 1
    built = build(ROOT / "esac_tpu_torch" / "build" / "kernel_bound")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = dict(device=smi, sass=sass_per_pair(built["ieee"][0]),
                  builds=time_builds(built, args.seed))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
