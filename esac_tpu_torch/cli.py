"""Shared plumbing of the port's entry scripts (counterpart of
``esac_tpu/cli.py``): ``esac_tpu_torch/scripts/{train_expert, train_gating,
train_esac, test_esac}.py``, run as ``python -m esac_tpu_torch.scripts.<name>``.

The flags are the JAX scripts', without the ones this package has no
counterpart for yet (``--backend``, ``--sharded``, ``--capacity``,
``--devices``).  Scripts run on the card; ``--cpu`` runs the plain PyTorch
versions on the CPU, and without it a machine with no CUDA raises.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import time

import numpy as np
import torch
from torch import nn

from esac_tpu_torch.data.datasets import batch_frames, open_scene
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.utils.checkpoint import load_checkpoint, load_train_state, save_train_state
from esac_tpu_torch.utils.precision import resolve_device


def common_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--root", default="datasets", help="dataset root directory")
    p.add_argument("--size", choices=tuple(EXPERT_PRESETS), default="ref",
                   help="network size preset")
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--learningrate", type=float, default=1e-4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the kernels' plain PyTorch versions "
                        "(default: the CUDA card; without one the script raises)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the output checkpoint (params, optimizer "
                        "state and iteration; data/RNG streams fast-forward so "
                        "the trajectory matches an uninterrupted run)")
    p.add_argument("--stop-after", type=int, default=0,
                   help="checkpoint and exit after this many iterations THIS "
                        "invocation (0 = run to --iterations); --iterations "
                        "still sets the LR schedule, so a stopped+resumed run "
                        "reproduces the uninterrupted trajectory")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save the resume-capable train state every N "
                        "iterations (0 = only at the end)")
    p.add_argument("--frames", type=int, default=0,
                   help="synthetic scenes only: frames rendered per scene "
                        "(0 = the SyntheticScene default; on-disk datasets "
                        "have fixed frame counts and ignore this)")
    p.add_argument("--res", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="synthetic scenes only: render resolution "
                        "(default 96 128; reference-scale runs use 192 256)")
    return p


def add_scoring_impl_arg(p: argparse.ArgumentParser) -> None:
    """--scoring-impl for the scripts that run the hypothesis loop."""
    p.add_argument("--scoring-impl", choices=("errmap", "fused", "pallas"),
                   default="errmap",
                   help="hypothesis scoring: errmap = reference-parity error "
                        "map, fused = the kernels' formula as plain PyTorch, "
                        "pallas = the hand-written CUDA scoring kernel (its "
                        "plain version on the CPU); all differentiable")


def device_of(args) -> torch.device:
    """The CPU for ``--cpu``, else the card (raises without CUDA)."""
    return resolve_device("cpu" if args.cpu else None)


def scene_kwargs(args) -> dict:
    """open_scene kwargs from the synthetic-scale flags (--frames/--res)."""
    kw = {}
    if getattr(args, "frames", 0):
        kw["n_frames"] = args.frames
    if getattr(args, "res", None):
        kw["height"], kw["width"] = args.res
    return kw


def _seeded(seed: int, build):
    """``build()`` under PyTorch's global RNG seeded with ``seed``, the
    caller's RNG state left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def make_expert(size: str, scene_center, dtype=None, seed: int = 0, device=None) -> ExpertNet:
    """An ``ExpertNet`` of preset ``size`` around ``scene_center``, with
    PyTorch's default init under ``seed``, on ``device`` (the card when
    None; raises without one)."""
    kw = dict(EXPERT_PRESETS[size], scene_center=tuple(float(x) for x in scene_center))
    if dtype is not None:
        kw["compute_dtype"] = dtype
    dev = resolve_device(device)
    return _seeded(seed, lambda: ExpertNet(**kw)).to(dev)


def make_gating(size: str, num_experts: int, dtype=None, seed: int = 0,
                device=None) -> GatingNet:
    """A ``GatingNet``, as :func:`make_expert` builds an expert."""
    kw = dict(GATING_PRESETS[size], num_experts=num_experts)
    if dtype is not None:
        kw["compute_dtype"] = dtype
    dev = resolve_device(device)
    return _seeded(seed, lambda: GatingNet(**kw)).to(dev)


def scene_center_of(ds, n_probe: int = 8) -> np.ndarray:
    """Mean GT scene coordinate over a few frames, the offset the expert
    regresses around; scenes without GT coordinates fall back to the mean
    camera center.  Returns (3,) float32 numpy."""
    cs, cams = [], []
    for i in np.linspace(0, len(ds) - 1, min(n_probe, len(ds))).astype(int):
        f = ds[int(i)]
        if f.coords_gt is not None:
            cs.append(f.coords_gt.reshape(-1, 3).mean(dim=0))
        else:
            cams.append(-rodrigues(f.rvec).T @ f.tvec)
    if cs:
        return torch.stack(cs).mean(dim=0).cpu().numpy()
    if cams:
        return torch.stack(cams).mean(dim=0).cpu().numpy().astype(np.float32)
    return np.zeros(3, dtype=np.float32)


def epoch_batches(rng: np.random.Generator, n: int, batch: int):
    """Yield random index batches forever."""
    while True:
        yield rng.integers(0, n, size=batch)


def cosine_decay(step: int, decay_steps: int, alpha: float = 0.05) -> float:
    """optax's ``cosine_decay_schedule`` factor at update ``step`` (from 0):
    (1 - alpha) * (1 + cos(pi * min(step, decay_steps) / decay_steps)) / 2
    + alpha."""
    frac = min(step, decay_steps) / decay_steps
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha


def cosine_schedule(optimizer: torch.optim.Optimizer, iterations: int, start_it: int = 0,
                    alpha: float = 0.05) -> torch.optim.lr_scheduler.LambdaLR:
    """The stage-1/2 learning-rate schedule: the optimizer's lr times
    :func:`cosine_decay`, stepped once after each ``optimizer.step()``, so
    iteration ``it`` trains at ``lr * cosine_decay(it)`` as optax does.  A
    resumed run passes its ``start_it`` and continues there."""
    for group in optimizer.param_groups:
        group.setdefault("initial_lr", group["lr"])
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda it: cosine_decay(it, iterations, alpha), last_epoch=start_it - 1)


def load_esac_scene(expert_ckpts, gating_ckpt, f: float, c, device) -> tuple:
    """The scene dict of ``registry.serving.init_scene_params`` (expert
    ModuleList, gating net, centers, f, c) from stage-1/2 (or stage-3)
    checkpoints, on ``device`` (read into host memory, copied by
    ``load_state_dict``).  Each expert carries its own scene center
    (its checkpoint's), so ``centers`` is zero.  Raises ``ValueError`` for
    experts of mixed size presets.  Returns (scene, expert configs, gating
    config)."""
    loaded = [load_checkpoint(ck) for ck in expert_ckpts]
    e_cfgs = [cfg for _, cfg in loaded]
    sizes = {cfg["size"] for cfg in e_cfgs}
    if len(sizes) != 1:
        raise ValueError(f"experts must share one size preset, got {sorted(sizes)}")
    size = sizes.pop()
    experts = nn.ModuleList()
    for params, cfg in loaded:
        net = make_expert(size, cfg["scene_center"], device=device)
        net.load_state_dict(params)
        experts.append(net)
    g_params, g_cfg = load_checkpoint(gating_ckpt)
    gating = make_gating(g_cfg["size"], len(experts), device=device)
    gating.load_state_dict(g_params)
    scene = {
        "expert": experts,
        "gating": gating,
        "centers": torch.zeros((len(experts), 3), device=device),
        "f": torch.tensor(float(f), device=device),
        "c": torch.as_tensor(c, dtype=torch.float32, device=device),
    }
    return scene, e_cfgs, g_cfg


def timed(timer, name: str, device):
    """``timer(name, fence=device)``, or nothing when ``timer`` is None."""
    return contextlib.nullcontext() if timer is None else timer(name, fence=device)


def _params(nets) -> dict:
    """A module's ``state_dict``, or a dict of them by name."""
    if isinstance(nets, nn.Module):
        return nets.state_dict()
    return {k: net.state_dict() for k, net in nets.items()}


def resume_train_state(args, path, nets, opt, device, timer=None) -> int:
    """The iteration a trainer starts at: 0, or under --resume the train
    state's at ``path``, its params loaded into ``nets`` (a module, or a
    dict of modules by name) and its optimizer state into ``opt``.  The
    state is read into host memory: ``load_state_dict`` puts each tensor
    beside its parameter, and Adam's step counts stay on the host, where a
    fresh Adam keeps them."""
    if not args.resume:
        return 0
    with timed(timer, "load", device):
        params, opt_state, _, start_it = load_train_state(path)
        if isinstance(nets, nn.Module):
            nets.load_state_dict(params)
        else:
            for k, net in nets.items():
                net.load_state_dict(params[k])
        opt.load_state_dict(opt_state)
    print(f"resumed {path} at iteration {start_it}")
    return start_it


def train_loop(args, path, nets, opt, config, n_frames, step, describe, device, start_it=0,
               timer=None, finish=None, width=7):
    """The three trainers' loop, from ``start_it`` to --iterations.

    Each iteration draws --batch frame indices below ``n_frames`` from the
    numpy stream seeded by --seed (a resumed run fast-forwards it) and
    calls ``step(it, idx)`` with them on ``device``; it returns the loss.
    Every ``iterations // 20`` iterations prints ``iter <it>  describe(it,
    loss)``.  The train state (``nets``' params, ``opt``'s state and
    ``config(loss)``) is saved at ``path`` every --checkpoint-every
    iterations and at the end, where ``finish()`` writes whatever the
    script adds.  --stop-after ends the run early.  ``timer`` times each
    iteration and the final save.  Returns the last loss, or None when a
    resumed run was already at --iterations."""

    def save(iteration, loss):
        save_train_state(path, _params(nets), config(loss), opt.state_dict(),
                         iteration=iteration)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    loss, last_it = None, start_it
    for it, idx in zip(range(args.iterations), epoch_batches(rng, n_frames, args.batch)):
        if it < start_it:  # fast-forward the data stream on resume
            continue
        with timed(timer, "iteration", device):
            loss = step(it, torch.as_tensor(idx, device=device))
        if it % max(1, args.iterations // 20) == 0:
            print(f"iter {it:{width}d}  {describe(it, loss)}  ({time.time() - t0:.0f}s)",
                  flush=True)
        last_it = it + 1
        if (args.checkpoint_every and last_it % args.checkpoint_every == 0
                and last_it < args.iterations):
            save(last_it, loss)
            print(f"checkpoint {path} @ iter {last_it}", flush=True)
        if args.stop_after and last_it - start_it >= args.stop_after:
            break

    if last_it == start_it:
        # A resume of a finished run: nothing ran, and re-saving would
        # overwrite the checkpoint's real final loss with NaN.
        print(f"{path} already at iteration {last_it}; nothing to do")
        return None
    with timed(timer, "save", device):
        save(last_it, loss)
        if finish is not None:
            finish()
    return loss


__all__ = [
    "add_scoring_impl_arg",
    "batch_frames",
    "common_parser",
    "load_esac_scene",
    "cosine_decay",
    "cosine_schedule",
    "device_of",
    "epoch_batches",
    "make_expert",
    "make_gating",
    "open_scene",
    "resume_train_state",
    "scene_center_of",
    "scene_kwargs",
    "timed",
    "train_loop",
]
