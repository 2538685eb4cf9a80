"""Stage 1: train one expert's scene-coordinate regression network (the
port's counterpart of the root ``train_expert.py``); run once per scene.

    python -m esac_tpu_torch.scripts.train_expert synth0 --size test --iterations 500
    python -m esac_tpu_torch.scripts.train_expert chess --root datasets/7scenes

Writes a resume-capable checkpoint directory (--output, default
``ckpts/ckpt_expert_<scene>``).  The whole scene is staged on the device
once; each step gathers its batch there.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from esac_tpu_torch.cli import (
    batch_frames, common_parser, cosine_schedule, device_of, make_expert, open_scene,
    resume_train_state, scene_center_of, scene_kwargs, train_loop,
)
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.geometry.camera import backproject_at_depth, transform_points
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.train import make_expert_reproj_train_step, make_expert_train_step
from esac_tpu_torch.utils.checkpoint import load_checkpoint
from esac_tpu_torch.utils.precision import hmm


def iteration_generator(seed: int, it: int) -> torch.Generator:
    """The augmentation draws of iteration ``it``: a CPU generator keyed by
    (seed, it) alone, so a resumed run draws what an uninterrupted one does."""
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, it]).generate_state(1)[0]))


def main(argv=None, timer=None) -> int:
    """``timer``, a ``utils.profiling.StageTimer``, times every iteration,
    the resume's load and the final save, each fenced by a synchronize
    (for callers that measure; None adds none)."""
    p = common_parser(__doc__)
    p.add_argument("scene", help="scene name (or synthN for the synthetic room)")
    p.add_argument("--output", default=None, help="checkpoint directory")
    p.add_argument("--augment", action="store_true",
                   help="rotation/scale/brightness augmentation (see data/augment.py)")
    p.add_argument("--loss", choices=("auto", "coords", "reproj"), default="auto",
                   help="stage-1 loss: masked-L1 to GT coordinates, or "
                        "clamped reprojection error for scenes without "
                        "depth GT (the outdoor/Aachen recipe); auto picks "
                        "by whether the scene provides GT coordinates")
    p.add_argument("--init-depth", type=float, default=5.0,
                   help="reproj mode: constant depth (m) of the heuristic "
                        "back-projected init targets")
    p.add_argument("--init-iters", type=int, default=None,
                   help="reproj mode: iterations of L1-to-heuristic-target "
                        "bootstrap before switching to reprojection error "
                        "(default: iterations // 4; 0 disables the bootstrap)")
    p.add_argument("--reproj-clamp", type=float, default=100.0,
                   help="reproj mode: per-cell pixel-error clamp")
    p.add_argument("--init-from", default=None, metavar="CKPT",
                   help="initialize params from this checkpoint (fresh "
                        "optimizer and schedule -- a fine-tune, unlike "
                        "--resume which continues the original run)")
    p.add_argument("--depth-scale", type=float, default=1.0,
                   help="coords mode: simulate a miscalibrated depth sensor "
                        "by scaling the camera-space depth of every "
                        "supervision target (X' = R^T(s(RX+t)-t))")
    p.add_argument("--map-scale", type=float, default=1.0,
                   help="coords mode: simulate a map/reconstruction scale "
                        "error: supervision targets scaled about the scene "
                        "center, X' = c + s(X - c)")
    args = p.parse_args(argv)
    dev = device_of(args)

    ds = open_scene(args.root, args.scene, "training", device=dev, **scene_kwargs(args))
    center = scene_center_of(ds)
    net = make_expert(args.size, center, seed=args.seed, device=dev)
    has_coords = ds[0].coords_gt is not None
    mode = args.loss if args.loss != "auto" else ("coords" if has_coords else "reproj")
    if mode == "coords" and not has_coords:
        p.error(f"scene {args.scene} has no GT coordinates; use --loss reproj")
    if mode == "reproj" and args.augment:
        p.error("--augment requires GT coordinates (coords mode)")
    if mode == "reproj" and (args.depth_scale != 1.0 or args.map_scale != 1.0):
        p.error("--depth-scale/--map-scale corrupt GT coordinates and are "
                "coords-mode only (reproj mode has no coordinate targets "
                "to corrupt -- the flag would be recorded but never applied)")

    if args.init_from:
        init_params, init_cfg = load_checkpoint(args.init_from)
        if init_cfg.get("size") != args.size:
            p.error(f"--init-from size {init_cfg.get('size')!r} != --size {args.size!r}")
        init_params["scene_center"] = net.scene_center  # the center stays this scene's
        net.load_state_dict(init_params)
        print(f"initialized params from {args.init_from}")
    n_params = sum(x.numel() for x in net.parameters())
    print(f"scene={args.scene} frames={len(ds)} params={n_params/1e6:.2f}M "
          f"center={np.round(center, 2).tolist()}")

    opt = torch.optim.Adam(net.parameters(), lr=args.learningrate)
    step = make_expert_train_step(net, opt, device=dev)
    H, W = ds[0].image.shape[:2]
    h, w = H // 8, W // 8
    if mode == "reproj":
        pixels = output_pixel_grid(H, W, 8, device=dev)
        cvec = torch.tensor([W / 2.0, H / 2.0], device=dev)
        reproj_step = make_expert_reproj_train_step(net, opt, pixels, cvec,
                                                    clamp_px=args.reproj_clamp, device=dev)
        init_iters = args.init_iters if args.init_iters is not None else args.iterations // 4

    out = args.output or f"ckpts/ckpt_expert_{args.scene}"
    start_it = resume_train_state(args, out, net, opt, dev, timer)
    sched = cosine_schedule(opt, args.iterations, start_it)

    # The whole scene on the device once; a step indexes it there.
    all_b = batch_frames(ds, np.arange(len(ds)), device=dev)
    images_d = all_b["images"]
    if mode == "coords":
        coords_d = all_b["coords_gt"]
        masks_d = (coords_d.abs().sum(-1) > 1e-9).float()
        if args.depth_scale != 1.0:
            # A sensor reading s * depth moves each camera-space point
            # Y = R X + t to s Y: the target becomes X' = R^T (s Y - t).
            # Masked (invalid) cells stay exactly zero.
            R, t = rodrigues(all_b["rvecs"]), all_b["tvecs"]
            cam = transform_points(R, t, coords_d.reshape(len(ds), -1, 3))
            coords_d = hmm(args.depth_scale * cam - t[:, None], R).reshape(coords_d.shape) \
                * masks_d[..., None]
        if args.map_scale != 1.0:
            c_arr = torch.as_tensor(center, dtype=torch.float32, device=dev)
            coords_d = (c_arr + args.map_scale * (coords_d - c_arr)) * masks_d[..., None]
    else:
        rvecs_d, tvecs_d = all_b["rvecs"], all_b["tvecs"]
        focals_d = all_b["focals"]  # (B,): outdoor scenes mix cameras
        heur_d = None
        if init_iters > start_it:
            # Constant-depth targets of the bootstrap, held only while it runs.
            heur_d = backproject_at_depth(rodrigues(rvecs_d), tvecs_d, pixels, focals_d, cvec,
                                          args.init_depth).reshape(len(ds), h, w, 3)
        ones_mask = torch.ones((args.batch, h, w), device=dev)

    if args.augment:
        from esac_tpu_torch.data.augment import augment_frame

        rvecs_d, tvecs_d, focal = all_b["rvecs"], all_b["tvecs"], all_b["focal"]

    def train_step(it, idx):
        nonlocal heur_d
        if mode == "reproj":
            if it < init_iters:  # L1 bootstrap to the heuristic targets
                loss = step(images_d[idx], heur_d[idx], ones_mask)
            else:
                heur_d = None  # bootstrap done: free the targets
                loss = reproj_step(images_d[idx], rvecs_d[idx], tvecs_d[idx], focals_d[idx])
        elif args.augment:
            aug = augment_frame(iteration_generator(args.seed + 1, it), images_d[idx],
                                coords_d[idx], rvecs_d[idx], tvecs_d[idx], focal)
            masks_b = (aug["coords_gt"].abs().sum(-1) > 1e-9).float()
            loss = step(aug["image"], aug["coords_gt"], masks_b)
        else:
            loss = step(images_d[idx], coords_d[idx], masks_d[idx])
        sched.step()
        return loss

    def describe(it, loss):
        label = "coord L1" if mode == "coords" else (
            "init L1" if it < init_iters else "reproj px")
        return f"{label} {float(loss):.4f}"

    loss = train_loop(args, out, net, opt, lambda loss: _ck_config(args, center, loss, mode),
                      len(ds), train_step, describe, dev, start_it, timer)
    if loss is not None:
        unit = "coord L1" if mode == "coords" else "reproj px"
        print(f"saved {out}  final {unit} {float(loss):.4f}")
    return 0


def _ck_config(args, center, loss, mode="coords") -> dict:
    return {
        "kind": "expert",
        "size": args.size,
        "scene": args.scene,
        "scene_center": [float(x) for x in center],
        "loss_mode": mode,
        "final_loss": float(loss),
        "depth_scale": args.depth_scale,
        "map_scale": args.map_scale,
    }


if __name__ == "__main__":
    sys.exit(main())
