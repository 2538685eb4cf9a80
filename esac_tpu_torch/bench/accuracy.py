"""Accuracy benchmark: novel-view 5cm/5deg on the synthetic scene, one JSON
line (counterpart of ``bench_accuracy.py``, same flags and presets).

Trains an expert from scratch on the procedural room, evaluates
localization on NOVEL views through the full pipeline, and prints

  {"metric": "synthetic_novel_view_5cm5deg", "value": <fraction>,
   "unit": "fraction", "vs_baseline": null, ...}

plus the run's ``platform`` and ``device`` block, and writes
``chiprun_out/bench/accuracy.json``.  Runs on the card unless ``--cpu``.

Presets (the names are ``bench_accuracy.py``'s, so the flags match):

  python -m esac_tpu_torch.bench.accuracy                # 1024 frames,
      8000 iterations, the test-size net at 96x128 (CNN in the preset's
      dtype on the card, float32 with --cpu)
  python -m esac_tpu_torch.bench.accuracy --preset tpu   # 4096 frames,
      20000 iterations, the ref-size net at 192x256
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from esac_tpu_torch.bench.scaffold import finish
from esac_tpu_torch.cli import cosine_schedule, make_expert
from esac_tpu_torch.data.synthetic import output_pixel_grid, random_poses_in_box, render_box_scene
from esac_tpu_torch.geometry.camera import pose_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import dsac_infer
from esac_tpu_torch.train.expert import make_expert_train_step
from esac_tpu_torch.utils.precision import resolve_device

PRESETS = {
    # (frames, iters, net size, H, W)
    "cpu": dict(frames=1024, iters=8000, size="test", height=96, width=128),
    "tpu": dict(frames=4096, iters=20000, size="ref", height=192, width=256),
}


def render(rv, tv, H, W, focal, center):
    """Images and GT coordinates of the poses, rendered 64 frames at a time."""
    imgs, crds = [], []
    for i in range(0, rv.shape[0], 64):
        out = render_box_scene(rv[i:i + 64], tv[i:i + 64], H, W, focal, center, 8)
        imgs.append(out["image"])
        crds.append(out["coords_gt"])
    return torch.cat(imgs), torch.cat(crds)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=tuple(PRESETS), default="cpu")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--eval-frames", type=int, default=32)
    p.add_argument("--iterations", type=int, default=0,
                   help="override the preset's training iterations (dev)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    try:
        dev = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"esac_tpu_torch.bench.accuracy: {e}", file=sys.stderr)
        return 2

    cfgp = dict(PRESETS[args.preset])
    if args.iterations:
        cfgp["iters"] = args.iterations
    H, W = cfgp["height"], cfgp["width"]
    focal = 525.0 * W / 640.0
    center = (W / 2.0, H / 2.0)
    n_frames = cfgp["frames"]
    load_before = [round(x, 2) for x in os.getloadavg()]

    t_start = time.time()
    rv, tv = random_poses_in_box(torch.Generator().manual_seed(args.seed), n_frames, device=dev)
    images, coords = render(rv, tv, H, W, focal, center)
    coords = coords.reshape(n_frames, H // 8, W // 8, 3)
    pixels = output_pixel_grid(H, W, 8, device=dev)

    net = make_expert(cfgp["size"], (3.0, 2.0, 1.5),
                      dtype=torch.float32 if args.cpu else None, seed=args.seed + 1,
                      device=dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    sched = cosine_schedule(opt, cfgp["iters"])
    step = make_expert_train_step(net, opt, device=dev)
    rng = np.random.default_rng(args.seed + 2)
    masks = torch.ones((8, H // 8, W // 8), device=dev)
    loss = None
    for _ in range(cfgp["iters"]):
        idx = torch.as_tensor(rng.integers(0, n_frames, 8), device=dev)
        loss = step(images[idx], coords[idx], masks)
        sched.step()

    rv2, tv2 = random_poses_in_box(torch.Generator().manual_seed(args.seed + 100),
                                   args.eval_frames, device=dev)
    eval_imgs, _ = render(rv2, tv2, H, W, focal, center)
    net.eval()
    with torch.no_grad():
        pred = net(eval_imgs).reshape(args.eval_frames, -1, 3).float()
    cfg = RansacConfig(n_hyps=256)
    ok, rot_errs, tr_errs = 0, [], []
    for i in range(args.eval_frames):
        gen = torch.Generator(device=dev).manual_seed(args.seed + 200 + i)
        out = dsac_infer(gen, pred[i], pixels, focal, center, cfg, device=dev)
        r, t = pose_errors(rodrigues(out["rvec"]), out["tvec"], rodrigues(rv2[i]), tv2[i])
        r, t = float(r), float(t)
        ok += int(r < 5.0 and t < 0.05)
        rot_errs.append(r)
        tr_errs.append(t)

    finish("accuracy", {
        "metric": "synthetic_novel_view_5cm5deg",
        "value": round(ok / args.eval_frames, 4),
        "unit": "fraction",
        "vs_baseline": None,
        "median_rot_deg": round(float(np.median(rot_errs)), 3),
        "median_trans_cm": round(100 * float(np.median(tr_errs)), 2),
        "train_loss": round(float(loss), 4) if loss is not None else None,
        "preset": args.preset,
        "wall_s": round(time.time() - t_start, 1),
    }, dev, load_before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
