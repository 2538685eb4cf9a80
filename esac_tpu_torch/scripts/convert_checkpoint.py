"""Convert an original-ESAC torch checkpoint into a port checkpoint (the
port's counterpart of the root ``convert_checkpoint.py``).

    python -m esac_tpu_torch.scripts.convert_checkpoint expert chess.pth ckpt_expert_chess \\
        --size ref --scene-center 1.0 2.0 0.5
    python -m esac_tpu_torch.scripts.convert_checkpoint gating gating.pth ckpt_gating --experts 7

The reference stores ``torch.save(net.state_dict())``; layers are matched
by order (``models.convert.load_reference_expert`` / ``load_reference_gating``)
and a shape mismatch aborts.  The conversion is a host job: tensors are
read, copied and saved in host memory, and the checkpoint loads on any
device through ``utils.checkpoint.load_checkpoint``'s ``map_location``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from esac_tpu_torch.cli import make_expert, make_gating
from esac_tpu_torch.models.convert import load_reference_expert, load_reference_gating
from esac_tpu_torch.utils.checkpoint import save_checkpoint


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=("expert", "gating"))
    p.add_argument("torch_path")
    p.add_argument("output")
    p.add_argument("--size", default="ref")
    p.add_argument("--scene-center", nargs=3, type=float, default=(0.0, 0.0, 0.0))
    p.add_argument("--experts", type=int, default=7, help="gating only")
    args = p.parse_args(argv)

    state = torch.load(args.torch_path, map_location="cpu", weights_only=True)
    if args.kind == "expert":
        net = load_reference_expert(make_expert(args.size, args.scene_center, device="cpu"), state)
        config = {"kind": "expert", "size": args.size,
                  "scene_center": list(args.scene_center),
                  "converted_from": args.torch_path}
    else:
        net = load_reference_gating(make_gating(args.size, args.experts, device="cpu"), state)
        config = {"kind": "gating", "size": args.size, "num_experts": args.experts,
                  "converted_from": args.torch_path}
    save_checkpoint(args.output, net.state_dict(), config)
    n = sum(x.numel() for x in net.parameters())
    print(f"converted {args.torch_path} -> {args.output} ({n/1e6:.2f}M params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
