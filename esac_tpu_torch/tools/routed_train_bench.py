#!/usr/bin/env python3
"""Step-time comparison: dense vs gating-routed sharded TRAINING at M = 48
(the counterpart of ``tools/routed_train_bench.py``).

One optimizer-free loss + gradient step of
``parallel.train_sharded.make_sharded_esac_loss`` (forward, backward and
``reduce_grads``), two ways:

- dense: every local expert runs on every frame, and each frame's
  (M, cells, 3) coordinate stack is gathered over the expert group;
- routed: each rank runs only its top-``capacity`` local experts per
  frame, and the combine is a scalar all-reduce.

M = 48 experts (stem 8/16/32, head 32 x 1), gating (8, 16), B = 2 frames
at 48 x 64, 16 hypotheses, capacity 2, 3 timed steps after a warm one.
The gating net's last layer (``dense1``) is scaled by 4000 as in the JAX
script, so that capacity 2 covers the gate's mass and both policies
compute the same loss.  The CNNs run in float32 here, so the two losses
agree to float32 rounding.

The loss is the expected pose loss, clamped at ``loss_clamp`` (the
config's 100 by default, as in the JAX script).  With random weights the
hypotheses land metres from the ground truth and the default clamp
saturates: both losses read exactly the clamp, their equality says
nothing and the backward carries zero gradients.  The document says so
(``loss_saturated``); ``--loss-clamp 1e6`` keeps the same work (the clamp
is one elementwise minimum) under a loss that does not saturate.

The JAX script's 8-device virtual CPU mesh becomes torch.distributed
ranks, one process each: 8 gloo ranks with ``--cpu``, and on the card the
expert-parallel smoke's layout (2 gloo ranks sharing the one card);
``--ranks`` overrides the count.  ``python -m
esac_tpu_torch.tools.routed_train_bench [--cpu] [--ranks R] [--experts M]
[--loss-clamp C] [--out FILE]`` prints one JSON document: the JAX
script's keys (the structural counts by its formulas, with its 8 replaced
by the rank count), ``loss_clamp``, ``loss_saturated``, ``ranks``,
``platform`` and the ``device`` block.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]

H, W = 48, 64
M, CAP, B = 48, 2, 2
REPEATS = 3
CPU_RANKS, CARD_RANKS = 8, 2
GATE_SHARPEN = 4000.0
LOSS_CLAMP = 100.0  # RansacConfig's, as the JAX script runs it


def _rank(rank, out_path, experts, repeats, device, loss_clamp, inputs=None):
    """One rank: both policies' warm step and ``repeats`` timed steps;
    rank 0 writes the times and losses to ``out_path``.  ``inputs``: a
    ``torch.save`` file of {"experts": [state dict] * M, "gating": state
    dict} to start from instead of the seed-0 init, and optionally "idx"
    (B, M, n_hyps, 4) sets to inject; with it, each rank also writes each
    policy's last gradients of its local experts and the gate to
    ``out_path + ".grads<rank>"``."""
    import torch
    import torch.distributed as dist

    from esac_tpu_torch.data.synthetic import output_pixel_grid
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.models.expert import ExpertNet
    from esac_tpu_torch.models.gating import GatingNet
    from esac_tpu_torch.parallel.mesh import make_mesh
    from esac_tpu_torch.parallel.train_sharded import make_sharded_esac_loss
    from esac_tpu_torch.ransac.config import RansacConfig

    dev = torch.device(device)
    world = dist.get_world_size()
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_mesh(n_data=1, n_expert=world)
    torch.manual_seed(0)  # every rank builds the same M experts and gate
    nets = torch.nn.ModuleList(
        ExpertNet(stem_channels=(8, 16, 32), head_channels=32, head_depth=1,
                  compute_dtype=torch.float32) for _ in range(experts)).to(dev)
    gating = GatingNet(experts, (8, 16), compute_dtype=torch.float32).to(dev)
    state = {} if inputs is None else torch.load(inputs, map_location=dev)
    if state:
        for net, sd in zip(nets, state["experts"]):
            net.load_state_dict(sd)
        gating.load_state_dict(state["gating"])
    idx = state.get("idx")
    with torch.no_grad():
        gating.dense1.weight.mul_(GATE_SHARPEN)
        gating.dense1.bias.mul_(GATE_SHARPEN)
    cfg = RansacConfig(n_hyps=16, refine_iters=2, train_refine_iters=1, loss_clamp=loss_clamp)
    pixels = output_pixel_grid(H, W, 8, device=dev)
    f, c = torch.tensor(60.0, device=dev), torch.tensor([W / 2.0, H / 2.0], device=dev)
    images = torch.linspace(0.0, 1.0, B * H * W * 3, device=dev).reshape(B, H, W, 3)
    R_gts = rodrigues(torch.tensor([0.1, -0.05, 0.02], device=dev))[None].expand(B, 3, 3)
    t_gts = torch.tensor([-3.0, -2.0, 3.0], device=dev).expand(B, 3)
    params = list(nets.parameters()) + list(gating.parameters())

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    def timed(capacity):
        loss_fn = make_sharded_esac_loss(mesh, nets, gating, torch.zeros(experts, 3, device=dev),
                                         pixels, f, c, cfg, "dense", capacity, dev)

        def step(seed):
            for p in params:
                p.grad = None
            loss = loss_fn(images, R_gts, t_gts, seed, idx=idx)
            loss.backward()
            loss_fn.reduce_grads()
            return float(loss.detach())

        step(2)  # warm
        fence()
        t0 = time.perf_counter()
        for i in range(repeats):
            val = step(3 + i)
        fence()
        return (time.perf_counter() - t0) / repeats, val

    def grads(module):
        return {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().clone()
                for k, p in module.named_parameters()}

    def keep(policy):
        """This rank's last gradients (its local experts' and the gate's)."""
        if inputs is not None:
            m = experts // world
            kept[policy] = {"experts": {i: grads(nets[i]) for i in range(rank * m, (rank + 1) * m)},
                            "gating": grads(gating)}

    kept = {}
    dense_s, dense_loss = timed(None)
    keep("dense")
    routed_s, routed_loss = timed(CAP)
    keep("routed")
    if kept:
        torch.save(kept, f"{out_path}.grads{rank}")
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps(
            {"dense_s": dense_s, "routed_s": routed_s, "dense_loss": dense_loss,
             "routed_loss": routed_loss}))


def measure(dev, ranks: int | None = None, experts: int = M, repeats: int = REPEATS,
            loss_clamp: float = LOSS_CLAMP, inputs=None, grads_out=None) -> dict:
    """Spawn the ranks on ``dev`` and assemble the JAX script's document
    (``inputs`` as :func:`_rank` takes them; ``grads_out``: a file to
    ``torch.save`` each policy's last gradients to, every expert's and the
    gate's, which needs ``inputs``)."""
    from esac_tpu_torch.bench.scaffold import device_block
    from esac_tpu_torch.parallel import spawn_ranks

    on_card = dev.type == "cuda"
    ranks = ranks or (CARD_RANKS if on_card else CPU_RANKS)
    if experts % ranks:
        raise ValueError(f"{experts} experts do not divide over {ranks} ranks")
    device = "cuda:0" if on_card else "cpu"
    # The rank function by its module's own name: under ``python -m`` this
    # file is __main__, which the spawned ranks would not import.
    fn = importlib.import_module("esac_tpu_torch.tools.routed_train_bench")._rank
    with tempfile.TemporaryDirectory(prefix="esac_routed_train_") as tmp:
        out_path = str(pathlib.Path(tmp) / "rank0.json")
        spawn_ranks(fn, ranks, args=(out_path, experts, repeats, device, loss_clamp, inputs),
                    backend="gloo", device=device)
        r = json.loads(pathlib.Path(out_path).read_text())
        if grads_out is not None:
            import torch

            parts = [torch.load(f"{out_path}.grads{k}") for k in range(ranks)]
            torch.save({name: {"experts": {i: g for p in parts
                                           for i, g in p[name]["experts"].items()},
                               "gating": parts[0][name]["gating"]}
                        for name in parts[0]}, grads_out)
    losses = {"dense": r["dense_loss"], "routed": r["routed_loss"]}
    # A loss at the clamp (to float32 rounding) is every hypothesis's:
    # its value and gradients say nothing of the experts or the gate.
    saturated = {k: v >= loss_clamp * (1 - 1e-6) for k, v in losses.items()}
    cells = (H // 8) * (W // 8)
    where = (f"{ranks} gloo ranks sharing one card" if on_card
             else f"{ranks} gloo ranks on the host's CPU cores")
    return {
        "config": f"M={experts} experts over {ranks} ranks, capacity={CAP}, B={B} frames, "
                  f"{H}x{W} renders, n_hyps=16",
        "dense_step_ms": 1e3 * r["dense_s"],
        "routed_step_ms": 1e3 * r["routed_s"],
        "routed_over_dense": r["routed_s"] / r["dense_s"],
        "loss": losses,
        "structural": {
            "expert_forwards_per_frame": {"dense": experts, "routed": ranks * CAP},
            "ep_collective_bytes_per_frame": {
                "dense": experts * cells * 3 * 4,   # the (M, cells, 3) f32 gather
                "routed": 4,                        # the scalar loss all-reduce
            },
        },
        "note": f"{where}: no interconnect is measured (gloo stages every collective "
                "through host memory), so the milliseconds compare the two policies' "
                "work on this host, not an expert-parallel deployment; the structural "
                "counts are hardware-independent.  Dense batches each expert's conv over "
                "all frames while routed runs per-frame forwards of the selected experts.  "
                "The gate is sharpened so capacity covers its mass: 'loss' must show "
                "dense == routed (equal-loss programs) -- if they differ, the ratio "
                "compares different work and must not be quoted.  A loss at the clamp "
                "('loss_saturated') makes that equality vacuous and the backward "
                "all zeros: rerun with a larger --loss-clamp.",
        "loss_clamp": loss_clamp,
        "loss_saturated": saturated,
        "ranks": ranks,
        "platform": "gpu" if on_card else "cpu",
        "device": device_block(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--ranks", type=int, default=None,
                    help=f"rank count (default {CPU_RANKS} with --cpu, {CARD_RANKS} on the card)")
    ap.add_argument("--experts", type=int, default=M)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--loss-clamp", type=float, default=LOSS_CLAMP,
                    help="the pose loss's clamp (default the config's; 1e6 keeps it unsaturated)")
    ap.add_argument("--out", default=None, help="also write the JSON document here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from esac_tpu_torch.utils.precision import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    doc = measure(dev, args.ranks, args.experts, args.repeats, args.loss_clamp)
    text = json.dumps(doc, indent=2)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
