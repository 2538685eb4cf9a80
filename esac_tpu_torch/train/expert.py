"""Stage-1 expert training: scene-coordinate regression (counterpart of
``esac_tpu/train/expert.py``): masked L1 against GT coordinates or, for
scenes without depth GT, a log-clamped reprojection error under the GT
pose."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from esac_tpu_torch.geometry.camera import reprojection_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.models.expert import coordinate_loss
from esac_tpu_torch.ransac.kernel import as_f32
from esac_tpu_torch.utils.precision import resolve_device


def make_expert_train_step(net: nn.Module, optimizer: torch.optim.Optimizer,
                           device=None) -> Callable:
    """``step(images, targets, masks=None)`` -> loss: images (B, H, W, 3),
    targets (B, H/8, W/8, 3), masks (B, H/8, W/8) or None."""
    dev = resolve_device(device)

    def step(images, targets, masks=None):
        optimizer.zero_grad(set_to_none=True)
        loss = coordinate_loss(net(as_f32(images, dev)), as_f32(targets, dev),
                               None if masks is None else as_f32(masks, dev))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def reprojection_loss(pred, rvecs, tvecs, pixels, fs, c,
                      clamp_px: float = 100.0) -> torch.Tensor:
    """Mean log-clamped reprojection error of predicted scene coordinates
    under the GT poses (counterpart of ``train.expert.reprojection_loss``):
    ``clamp * log1p(err / clamp)`` tracks the error below ``clamp_px`` and
    damps larger ones with a slope that never reaches zero, so cells far
    from their pixels (behind-camera cells carry +1000 px) still drive
    gradients.  pred (B, h, w, 3) or (B, N, 3), rvecs/tvecs (B, 3), pixels
    (N, 2), fs scalar or (B,)."""
    B = pred.shape[0]
    coords = pred.reshape(B, -1, 3)
    fs = torch.as_tensor(fs, dtype=coords.dtype, device=coords.device).expand(B)
    errs = reprojection_errors(rodrigues(rvecs), tvecs, coords, pixels, fs, c)
    return torch.mean(clamp_px * torch.log1p(errs / clamp_px))


def make_expert_reproj_train_step(net: nn.Module, optimizer: torch.optim.Optimizer,
                                  pixels, c, clamp_px: float = 100.0,
                                  device=None) -> Callable:
    """``step(images, rvecs, tvecs, fs)`` -> loss minimizing
    :func:`reprojection_loss`, the stage-1 mode without depth GT; fs (B,)
    per-frame focal lengths."""
    dev = resolve_device(device)
    pixels, c = as_f32(pixels, dev), as_f32(c, dev)

    def step(images, rvecs, tvecs, fs):
        optimizer.zero_grad(set_to_none=True)
        loss = reprojection_loss(net(as_f32(images, dev)), as_f32(rvecs, dev),
                                 as_f32(tvecs, dev), pixels, as_f32(fs, dev), c, clamp_px)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
