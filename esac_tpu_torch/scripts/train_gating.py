"""Stage 2: train the gating network to classify scenes / experts (the
port's counterpart of the root ``train_gating.py``).

    python -m esac_tpu_torch.scripts.train_gating synth0 synth1 synth2 --size test --iterations 300
    python -m esac_tpu_torch.scripts.train_gating chess fire heads --root datasets/7scenes
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from esac_tpu_torch.cli import (
    batch_frames, common_parser, cosine_schedule, device_of, make_gating, open_scene,
    resume_train_state, scene_kwargs, train_loop,
)
from esac_tpu_torch.train import make_gating_train_step


def main(argv=None, timer=None) -> int:
    """``timer``: as ``train_expert.main``'s."""
    p = common_parser(__doc__)
    p.add_argument("scenes", nargs="+", help="scene names in expert order")
    p.add_argument("--output", default="ckpts/ckpt_gating")
    args = p.parse_args(argv)
    dev = device_of(args)

    datasets = [open_scene(args.root, s, "training", expert=i, device=dev, **scene_kwargs(args))
                for i, s in enumerate(args.scenes)]
    net = make_gating(args.size, len(datasets), seed=args.seed, device=dev)
    opt = torch.optim.Adam(net.parameters(), lr=args.learningrate)
    step = make_gating_train_step(net, opt, device=dev)
    start_it = resume_train_state(args, args.output, net, opt, dev, timer)
    sched = cosine_schedule(opt, args.iterations, start_it)

    # Every scene on the device once (see train_expert.py).
    staged = [batch_frames(d, np.arange(len(d)), device=dev) for d in datasets]
    images_d = torch.cat([b["images"] for b in staged])
    labels_d = torch.cat([b["labels"] for b in staged])

    def train_step(it, idx):
        loss = step(images_d[idx], labels_d[idx])
        sched.step()
        return loss

    loss = train_loop(args, args.output, net, opt, lambda loss: _ck_config(args, loss),
                      images_d.shape[0], train_step, lambda it, loss: f"CE {float(loss):.4f}",
                      dev, start_it, timer)
    if loss is not None:
        print(f"saved {args.output}  final CE {float(loss):.4f}")
    return 0


def _ck_config(args, loss) -> dict:
    return {
        "kind": "gating",
        "size": args.size,
        "scenes": args.scenes,
        "final_loss": float(loss),
    }


if __name__ == "__main__":
    sys.exit(main())
