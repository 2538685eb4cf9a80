"""Per-stage timing of the hypothesis pipeline (the counterpart of
``experiments/profile_stages.py``).

Is the minimal solve worth a kernel, or does scoring dominate?  Each stage
runs on its own at BASELINE.md config #1 shapes (16 frames x 256
hypotheses x 4800 cells, frames from ``make_correspondence_frame`` with
1 cm noise and 30% outliers), fenced with a synchronize: one warm call,
then the mean of 20.  Plain eager PyTorch, no ``torch.compile`` and no CUDA
graphs: the point is where eager time goes.

- ``sample_solve_ms``: sampling + P3P + polish (``generate_hypotheses``);
- ``score_ms_<impl>``: ``_score_hypotheses`` under "errmap", "fused" and,
  on the card only, "pallas" (the CUDA scoring kernel; on the CPU its plain
  version would time nothing of the kernel);
- ``refine_ms``: ``refine_soft_inliers`` of the winners;
- ``full_ms``: the whole ``dsac_infer_frames``;
- ``score_ms``: the default scoring_impl's time.

``python -m esac_tpu_torch.experiments.profile_stages [--cpu] [--batch B]
[--n-hyps H] [--repeats R] [--out FILE]`` prints one JSON line with the JAX
script's keys, ``platform`` and the ``device`` block; ``--out`` also writes
it to FILE.  Without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from esac_tpu_torch.bench.fixtures import fence
from esac_tpu_torch.bench.scaffold import device_block
from esac_tpu_torch.data.synthetic import CAMERA_F, make_correspondence_frame
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import (
    _score_hypotheses,
    _take,
    dsac_infer_frames,
    frame_generators,
    generate_hypotheses,
)
from esac_tpu_torch.ransac.refine import refine_soft_inliers
from esac_tpu_torch.ransac.sampling import sample_correspondence_sets
from esac_tpu_torch.utils.precision import resolve_device

BATCH, N_HYPS, REPEATS = 16, 256, 20
FRAME_SEED, RANSAC_SEED = 0, 1_000


def _ms(fn, dev, repeats: int) -> float:
    fn()
    fence(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    fence(dev)
    return (time.perf_counter() - t0) / repeats * 1e3


def frames(batch: int, dev) -> dict:
    """Config #1's frames: ``make_correspondence_frame(noise=0.01,
    outlier_frac=0.3)`` from seeds FRAME_SEED + b."""
    fr = [make_correspondence_frame(g, noise=0.01, outlier_frac=0.3, device=dev)
          for g in frame_generators(range(FRAME_SEED, FRAME_SEED + batch), dev)]
    return {"coords": torch.stack([x["coords"] for x in fr]), "pixels": fr[0]["pixels"],
            "f": torch.full((batch,), CAMERA_F, device=dev),
            "c": torch.tensor([320.0, 240.0], device=dev)}


def impls_for(dev) -> tuple[str, ...]:
    return ("errmap", "fused", "pallas") if dev.type == "cuda" else ("errmap", "fused")


def stages(inp: dict, cfg: RansacConfig, impls, dev, idx=None) -> tuple[dict, dict]:
    """``(callables, outputs)``: each stage as a callable on ``inp`` and
    what one call of it gives.  ``idx`` (B, n_hyps, 4) injects the
    correspondence sets (the callables then sample nothing)."""
    coords, pixels, f, c = inp["coords"], inp["pixels"], inp["f"], inp["c"]
    B, N = coords.shape[:2]

    def gens():
        return frame_generators(range(RANSAC_SEED, RANSAC_SEED + B), dev)

    def sets(generators):
        if idx is not None:
            return torch.as_tensor(idx, device=dev)
        return torch.stack([sample_correspondence_sets(g, cfg.n_hyps, N) for g in generators])

    def sample_solve():
        return generate_hypotheses(None, coords, pixels, f, c, cfg, idx=sets(gens()))

    rvecs, tvecs = sample_solve()
    fns = {"sample_solve": sample_solve}
    out = {"rvecs": rvecs, "tvecs": tvecs}
    for impl in impls:
        icfg = RansacConfig(n_hyps=cfg.n_hyps, scoring_impl=impl)
        fns[f"score_{impl}"] = (lambda icfg=icfg: _score_hypotheses(
            gens(), rvecs, tvecs, coords, pixels, f, c, icfg))
        out[f"scores_{impl}"] = fns[f"score_{impl}"]()
    best = torch.argmax(out[f"scores_{cfg.scoring_impl}"], dim=-1)
    rb, tb = _take(rvecs, best), _take(tvecs, best)
    fns["refine"] = lambda: refine_soft_inliers(rb, tb, coords, pixels, f, c, cfg.tau,
                                                cfg.beta, iters=cfg.refine_iters)
    fns["full"] = lambda: dsac_infer_frames(gens(), coords, pixels, f, c, cfg,
                                            idx=None if idx is None else sets(None),
                                            device=dev)
    out.update(best=best, refined=fns["refine"](), full=fns["full"]())
    return fns, out


def profile(dev, batch: int = BATCH, n_hyps: int = N_HYPS, repeats: int = REPEATS,
            inp: dict | None = None, idx=None) -> tuple[dict, dict]:
    """``(line, outputs)``: the stage times (the JAX script's keys) and
    the stages' outputs on ``inp`` (config #1's frames by default)."""
    cfg = RansacConfig(n_hyps=n_hyps)
    impls = impls_for(dev)
    with torch.inference_mode():
        inp = frames(batch, dev) if inp is None else inp
        fns, out = stages(inp, cfg, impls, dev, idx=idx)
        line = {"sample_solve_ms": _ms(fns["sample_solve"], dev, repeats),
                **{f"score_ms_{impl}": _ms(fns[f"score_{impl}"], dev, repeats)
                   for impl in impls},
                "refine_ms": _ms(fns["refine"], dev, repeats),
                "full_ms": _ms(fns["full"], dev, repeats)}
    line.update(batch=int(inp["coords"].shape[0]), n_hyps=n_hyps,
                device_kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                platform="gpu" if dev.type == "cuda" else "cpu", device=device_block(dev))
    # The configured default impl's time (as the JAX script's legacy key).
    line["score_ms"] = line.get(f"score_ms_{cfg.scoring_impl}", line["score_ms_errmap"])
    return line, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--n-hyps", type=int, default=N_HYPS)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    line, _ = profile(dev, args.batch, args.n_hyps, args.repeats)
    text = json.dumps(line)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
