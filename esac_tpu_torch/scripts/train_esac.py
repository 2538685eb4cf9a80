"""Stage 3: end-to-end ESAC training through the hypothesis loop (the
port's counterpart of the root ``train_esac.py``): loads the stage-1
expert checkpoints and the stage-2 gating checkpoint, then minimizes the
expected pose loss through sampling / P3P / scoring / selection /
refinement with ``train.make_esac_train_step``.

    python -m esac_tpu_torch.scripts.train_esac synth0 synth1 --size test --iterations 50 \\
        --experts ckpt_expert_synth0 ckpt_expert_synth1 --gating ckpt_gating

``--estimator dense`` (default) weighs every expert's expected loss by its
gating probability; ``sampled`` is the reference-parity REINFORCE
estimator.  Under ``--scoring-impl pallas`` each step launches the CUDA
scoring kernel once.  Fine-tune recipe from a strong stage-1/2 baseline:
``--clip-norm 1.0 --learningrate 3e-6 --alpha-start 0.1``.

Writes ``<output>_state`` (resume-capable: experts, gating, Adam) and, at
the end, ``<output>_expert{m}`` / ``<output>_gating``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from esac_tpu_torch.cli import (
    add_scoring_impl_arg, batch_frames, common_parser, device_of, load_esac_scene,
    open_scene, resume_train_state, scene_kwargs, train_loop,
)
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.train import make_esac_train_step
from esac_tpu_torch.utils.checkpoint import save_checkpoint


def main(argv=None, timer=None) -> int:
    """``timer``: as ``train_expert.main``'s."""
    p = common_parser(__doc__)
    add_scoring_impl_arg(p)
    p.add_argument("scenes", nargs="+")
    p.add_argument("--experts", nargs="+", required=True,
                   help="stage-1 expert checkpoint dirs, one per scene")
    p.add_argument("--gating", required=True, help="stage-2 gating checkpoint")
    p.add_argument("--hypotheses", type=int, default=256)
    p.add_argument("--estimator", choices=("dense", "sampled"), default="dense")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="softmax selection temperature over hypothesis scores")
    p.add_argument("--alpha-start", type=float, default=None,
                   help="two-phase selection-sharpness anneal: use this alpha "
                        "for the first half of training, then switch to --alpha")
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off); the pose-loss "
                        "gradient through IRLS refinement can spike on "
                        "near-degenerate hypotheses")
    p.add_argument("--loss-clamp", type=float, default=100.0,
                   help="per-hypothesis pose-loss clamp (deg-equivalent)")
    p.add_argument("--output", default="ckpts/ckpt_esac")
    args = p.parse_args(argv)
    if len(args.experts) != len(args.scenes):
        p.error("need one --experts checkpoint per scene")
    dev = device_of(args)

    datasets = [open_scene(args.root, s, "training", expert=i, device=dev, **scene_kwargs(args))
                for i, s in enumerate(args.scenes)]
    f0 = datasets[0][0]
    H, W = f0.image.shape[:2]
    scene, e_cfgs, g_cfg = load_esac_scene(args.experts, args.gating, f0.focal,
                                           (W / 2.0, H / 2.0), dev)
    scene["expert"].train()
    scene["gating"].train()
    pixels = output_pixel_grid(H, W, 8, device=dev)
    cfg = RansacConfig(n_hyps=args.hypotheses, train_refine_iters=1, alpha=args.alpha,
                       loss_clamp=args.loss_clamp, scoring_impl=args.scoring_impl)
    opt = torch.optim.Adam(list(scene["expert"].parameters())
                           + list(scene["gating"].parameters()), lr=args.learningrate)

    nets = {"expert": scene["expert"], "gating": scene["gating"]}
    state = f"{args.output}_state"
    start_it = resume_train_state(args, state, nets, opt, dev, timer)

    clip = args.clip_norm if args.clip_norm > 0 else float("inf")

    def make_step(step_cfg):
        return make_esac_train_step(scene, opt, step_cfg, pixels, mode=args.estimator,
                                    clip_norm=clip, device=dev)

    esac_step = make_step(cfg)
    # Two-phase selection-sharpness anneal: a soft first half spreads the
    # selection gradient over more hypotheses, then --alpha takes over.
    alpha_switch_it = args.iterations // 2
    esac_step_early = (None if args.alpha_start is None
                       else make_step(dataclasses.replace(cfg, alpha=args.alpha_start)))

    # Every scene on the device once (see train_expert.py).
    staged = [batch_frames(d, np.arange(len(d)), device=dev) for d in datasets]
    images_d = torch.cat([b["images"] for b in staged])
    R_gts_d = rodrigues(torch.cat([b["rvecs"] for b in staged]))
    tvecs_d = torch.cat([b["tvecs"] for b in staged])

    def train_step(it, idx):
        step_fn = (esac_step_early
                   if esac_step_early is not None and it < alpha_switch_it else esac_step)
        # The step's seed depends on the iteration alone: resume-exact.
        return step_fn(args.seed * 7919 + it, images_d[idx], R_gts_d[idx], tvecs_d[idx])

    def finish():
        for m, cfg_d in enumerate(e_cfgs):
            save_checkpoint(f"{args.output}_expert{m}", scene["expert"][m].state_dict(),
                            {**cfg_d, "e2e": True})
        save_checkpoint(f"{args.output}_gating", scene["gating"].state_dict(),
                        {**g_cfg, "e2e": True})

    loss = train_loop(args, state, nets, opt, lambda loss: _state_config(args),
                      images_d.shape[0], train_step,
                      lambda it, loss: f"E[pose loss] {float(loss):.3f}", dev, start_it, timer,
                      finish, width=6)
    if loss is not None:
        print(f"saved {args.output}_expert*/{args.output}_gating  "
              f"final E[pose loss] {float(loss):.3f}")
    return 0


def _state_config(args) -> dict:
    return {"kind": "esac_state", "scenes": args.scenes}


if __name__ == "__main__":
    sys.exit(main())
