"""Novel-view accuracy against the training budget (the counterpart of
``experiments/generalization.py``).

Trains the test-size expert (stem 16/32/64, head 64 x 2, float32) at
96 x 128 on ``N_FRAMES`` renders of the box room (``render_box_scene``),
with or without ``augment_frame``, for ``ITERS`` Adam steps of 8 frames
under the cosine decay of the JAX script (1e-3 to 5e-5); then renders 16
novel views, predicts their coordinates and runs ``dsac_infer`` (64
hypotheses, 6 refinement rounds) on each.

``python -m esac_tpu_torch.experiments.generalization N_FRAMES aug|noaug
ITERS [--cpu] [--out FILE]`` prints one JSON line: the JAX script's
numbers (``train_loss``, the median coordinate error, the median pose
error, ``5cm5deg`` as k/16, seconds), its text line under ``line``,
``platform`` and the ``device`` block.  Without a card and without
``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from esac_tpu_torch.bench.scaffold import device_block
from esac_tpu_torch.cli import cosine_schedule
from esac_tpu_torch.data.augment import augment_frame
from esac_tpu_torch.data.synthetic import random_poses_in_box, render_box_scene
from esac_tpu_torch.geometry.camera import pose_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import dsac_infer
from esac_tpu_torch.train.expert import make_expert_train_step
from esac_tpu_torch.utils.precision import resolve_device

H, W = 96, 128
FOCAL, CENTER = 105.0, (64.0, 48.0)
NET = dict(scene_center=(3.0, 2.0, 1.5), stem_channels=(16, 32, 64), head_channels=64,
           head_depth=2, compute_dtype=torch.float32)
BATCH, N_VIEWS = 8, 16
EVAL_CFG = RansacConfig(n_hyps=64, refine_iters=6)
# Seeds, as the JAX script's keys: training poses, the net's init, batch
# indices (numpy), augmentation, novel-view poses, each view's RANSAC.
POSE_SEED, INIT_SEED, BATCH_SEED, AUG_SEED, VIEW_SEED, RANSAC_SEED = 0, 1, 2, 3, 100, 200


def _generator(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def render(rv: torch.Tensor, tv: torch.Tensor) -> dict:
    """Renders of poses (n, 3) in chunks of 64: 'image' (n, H, W, 3),
    'coords' (n, H/8, W/8, 3), 'pixels' (cells, 2)."""
    imgs, crds = [], []
    for i in range(0, rv.shape[0], 64):
        o = render_box_scene(rv[i:i + 64], tv[i:i + 64], H, W, FOCAL, CENTER, 8)
        imgs.append(o["image"])
        crds.append(o["coords_gt"])
    return {"image": torch.cat(imgs), "coords": torch.cat(crds).reshape(-1, H // 8, W // 8, 3),
            "pixels": o["pixels"]}


def train(n_frames: int, augment: bool, iters: int, dev) -> tuple[ExpertNet, float]:
    """The expert after ``iters`` steps, and the last step's loss."""
    rv, tv = random_poses_in_box(_generator(POSE_SEED, dev), n_frames)
    data = render(rv, tv)
    torch.manual_seed(INIT_SEED)
    net = ExpertNet(**NET).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    sched = cosine_schedule(opt, iters)
    step = make_expert_train_step(net, opt, device=dev)
    rng, aug = np.random.default_rng(BATCH_SEED), _generator(AUG_SEED, dev)
    masks = torch.ones((BATCH, H // 8, W // 8), device=dev)
    loss = torch.tensor(float("nan"))
    for _ in range(iters):
        idx = torch.as_tensor(rng.integers(0, n_frames, BATCH), device=dev)
        im, co = data["image"][idx], data["coords"][idx]
        if augment:
            out = augment_frame(aug, im, co, rv[idx], tv[idx], FOCAL)
            im, co = out["image"], out["coords_gt"]
        loss = step(im, co, masks)
        sched.step()
    return net, float(loss)


def evaluate(net: ExpertNet, dev, idx=None) -> dict:
    """The 16 novel views: median coordinate error (m), each view's pose
    errors (deg, m) and the count within 5 cm / 5 deg.  ``idx`` (16,
    n_hyps, 4) injects each view's correspondence sets."""
    rv, tv = random_poses_in_box(_generator(VIEW_SEED, dev), N_VIEWS)
    views = render(rv, tv)
    with torch.inference_mode():
        pred = net(views["image"]).reshape(N_VIEWS, -1, 3)
        gtc = views["coords"].reshape(N_VIEWS, -1, 3)
        coord_err = float(torch.median(torch.linalg.norm(pred - gtc, dim=-1)))
        rot, trans = [], []
        for i in range(N_VIEWS):
            out = dsac_infer(_generator(RANSAC_SEED + i, dev), pred[i], views["pixels"],
                             torch.tensor(FOCAL, device=dev), torch.tensor(CENTER, device=dev),
                             EVAL_CFG, idx=None if idx is None else idx[i], device=dev)
            r, t = pose_errors(rodrigues(out["rvec"]), out["tvec"], rodrigues(rv[i]), tv[i])
            rot.append(float(r))
            trans.append(float(t))
    ok = sum(int(r < 5 and t < 0.05) for r, t in zip(rot, trans))
    return {"coord_err_m": coord_err, "rot_deg": rot, "trans_m": trans, "ok": ok,
            "rvec": rv, "tvec": tv}


def run(n_frames: int, augment: bool, iters: int, dev) -> dict:
    t0 = time.perf_counter()
    net, loss = train(n_frames, augment, iters, dev)
    ev = evaluate(net, dev)
    secs = time.perf_counter() - t0
    rot_med, trans_med = float(np.median(ev["rot_deg"])), float(np.median(ev["trans_m"]))
    line = (f"frames={n_frames} aug={augment} iters={iters}: train_loss={loss:.3f} "
            f"novel coord med={ev['coord_err_m'] * 100:.1f}cm pose med={rot_med:.2f}deg/"
            f"{trans_med * 100:.1f}cm 5cm5deg={ev['ok']}/{N_VIEWS} ({secs:.0f}s)")
    return {"frames": n_frames, "aug": augment, "iters": iters, "train_loss": loss,
            "coord_med_cm": ev["coord_err_m"] * 100, "pose_med_deg": rot_med,
            "pose_med_cm": trans_med * 100, "5cm5deg": f"{ev['ok']}/{N_VIEWS}",
            "seconds": secs, "line": line,
            "platform": "gpu" if dev.type == "cuda" else "cpu", "device": device_block(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", type=int)
    ap.add_argument("augment", choices=("aug", "noaug"))
    ap.add_argument("iters", type=int)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    text = json.dumps(run(args.n_frames, args.augment == "aug", args.iters, dev))
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
