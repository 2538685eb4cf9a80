"""Stage-3 end-to-end training: the expected pose loss through the
hypothesis loop (counterpart of ``esac_tpu/train/e2e.py`` and of the dense
loss step of ``train_esac.py``).

image -> CNN(s) -> coordinates -> sample / solve / score / refine ->
expected pose loss -> autograd backward -> optimizer step.  Under
``scoring_impl="pallas"`` the forward launches the scoring kernel once per
step (every frame and expert in one launch); its backward is the plain
recompute of ``fused_scoring.SoftInlierScores``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import _no_stage, esac_train_loss_frames
from esac_tpu_torch.ransac.kernel import as_f32, dsac_train_loss_frames, frame_generators
from esac_tpu_torch.ransac.sampling import sample_correspondence_sets
from esac_tpu_torch.registry.serving import scene_forward
from esac_tpu_torch.utils.precision import resolve_device


def step_generators(seed: int, n_frames: int, device) -> list[torch.Generator]:
    """Per-frame generators of one training step, spawned from the step's
    ``seed`` (``np.random.SeedSequence``): the port's counterpart of
    ``jax.random.split(jax.random.key(seed), n_frames)``."""
    seeds = [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(n_frames)]
    return frame_generators(seeds, device)


def make_dsac_train_step(net: nn.Module, optimizer: torch.optim.Optimizer,
                         cfg: RansacConfig, f: float, c, device=None) -> Callable:
    """Single-expert end-to-end step (BASELINE config #1).

    Returns ``step(seed, images, pixels, R_gts, t_gts, idx=None)`` over a
    batch of frames -> (mean loss, aux of ``dsac_train_loss_frames``):
    images (B, H, W, 3), pixels (N, 2) or (B, N, 2), R_gts (B, 3, 3),
    t_gts (B, 3); ``idx`` (B, n_hyps, 4) injects the correspondence sets.
    """
    dev = resolve_device(device)
    c = as_f32(c, dev)

    def step(seed, images, pixels, R_gts, t_gts, idx=None):
        optimizer.zero_grad(set_to_none=True)
        coords = net(as_f32(images, dev))
        B = coords.shape[0]
        losses, aux = dsac_train_loss_frames(
            step_generators(seed, B, dev), coords.reshape(B, -1, 3), pixels, f, c,
            R_gts, t_gts, cfg, idx=idx, device=dev)
        loss = losses.mean()
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def make_esac_train_step(scene: dict, optimizer: torch.optim.Optimizer,
                         cfg: RansacConfig, pixels, mode: str = "dense",
                         clip_norm: float = 1.0, device=None,
                         expert_losses: Callable | None = None) -> Callable:
    """Gating + M experts end-to-end step (BASELINE config #2; the port's
    counterpart of ``train_esac.py``'s jax-backend loss step).

    ``scene`` is a dict of ``registry.serving.init_scene_params``: expert
    modules, gating module, centers (M, 3), f, c.  The optimizer updates
    whatever parameters it was given; their gradients are clipped to a
    global norm of ``clip_norm`` first (``torch.nn.utils.clip_grad_norm_``;
    inf leaves them as they are), as ``optax.chain(clip_by_global_norm,
    adam)`` does.  The default 1.0 is train_esac.py's fine-tune recipe
    value; its ``--clip-norm`` flag itself defaults to 0, which means no
    clip (a command line maps 0 to inf here).  Returns
    ``step(seed, images, R_gts, t_gts, idx=None, experts=None,
    on_stage=None)`` -> mean loss over the frames: images (B, H, W, 3),
    R_gts (B, 3, 3), t_gts (B, 3); ``idx`` / ``experts`` inject the draws
    as ``esac_train_loss_frames`` takes them.  ``on_stage(name)``, when
    given, is called as each stage of the step has been issued:
    "cnn_forward", those of ``esac_train_loss_frames``, "backward",
    "optimizer" (a timing hook; it must not touch the tensors).

    ``expert_losses`` (``train_esac --backend cpp``): a one-frame
    ``(coords_all (M, N, 3), R_gt, t_gt, idx (M, n_hyps, 4)) -> (M,)``
    differentiable in the coordinates,
    ``backends.train_bridge.make_cpp_expert_losses``, in place of the
    hypothesis loop.  Each frame's loss is then ``sum(softmax(logits) * E)``
    (the dense estimator), ``idx`` drawn from the frame's generator as
    ``cfg.n_hyps * M`` sets of ``sample_correspondence_sets`` (the stage
    "cpp_losses" follows "cnn_forward").
    """
    dev = resolve_device(device)
    pixels = as_f32(pixels, dev)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(seed, images, R_gts, t_gts, idx=None, experts=None, on_stage=None):
        stage = on_stage or _no_stage
        optimizer.zero_grad(set_to_none=True)
        imgs = as_f32(images, dev)
        B = imgs.shape[0]
        coords, logits = scene_forward(scene, imgs)
        stage("cnn_forward")
        gens = step_generators(seed, B, dev)
        if expert_losses is not None:
            losses = _dense_losses(expert_losses, gens, logits, coords, R_gts, t_gts, cfg)
            stage("cpp_losses")
        else:
            losses, _ = esac_train_loss_frames(
                gens, logits, coords, pixels, scene["f"].expand(B), scene["c"], R_gts, t_gts,
                cfg, mode, idx=idx, experts=experts, device=dev, on_stage=stage)
        loss = losses.mean()
        loss.backward()
        stage("backward")
        torch.nn.utils.clip_grad_norm_(params, clip_norm)
        optimizer.step()
        stage("optimizer")
        return loss.detach()

    return step


def _dense_losses(expert_losses, gens, logits, coords, R_gts, t_gts, cfg) -> torch.Tensor:
    """Each frame's ``sum(softmax(logits) * E)`` with ``E`` from
    ``expert_losses`` on that frame's coordinates (B, M, N, 3) and sets drawn
    from its generator (counterpart of train_esac.py's ``frame_loss``)."""
    M, N = coords.shape[1], coords.shape[2]
    losses = []
    for b, gen in enumerate(gens):
        idx = sample_correspondence_sets(gen, cfg.n_hyps * M, N).reshape(M, cfg.n_hyps, 4)
        E = expert_losses(coords[b], R_gts[b], t_gts[b], idx)
        losses.append(torch.sum(torch.softmax(logits[b].float(), dim=-1) * E))
    return torch.stack(losses)
