"""Pinhole camera (counterpart of ``esac_tpu/geometry/camera.py``).

Conventions as in the JAX package: the pose (R, t) maps scene -> camera,
``Y = R X + t``; square pixels with focal ``f`` and principal point
``c = (cx, cy)``.  ``f`` is a tensor of the pose's batch shape (or a
scalar); ``c`` is shared, shape (2,).  Points at or behind the
``MIN_DEPTH`` plane keep a finite projection and get a +1000 px error
penalty, so they can never look like inliers.
"""

from __future__ import annotations

import torch

from esac_tpu_torch.geometry.rotations import rot_error_deg
from esac_tpu_torch.utils.num import safe_norm
from esac_tpu_torch.utils.precision import hmm

# Minimum camera-frame depth (meters) used to keep the perspective division
# finite for points at/behind the camera plane.
MIN_DEPTH = 0.1


def transform_points(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3), t (..., 3), X (..., N, 3) -> R X + t, (..., N, 3)."""
    return hmm(X, R.transpose(-1, -2)) + t[..., None, :]


def project(Y: torch.Tensor, f, c: torch.Tensor) -> torch.Tensor:
    """Camera-frame points to pixels, depth clamped. (..., N, 3) -> (..., N, 2)."""
    f = torch.as_tensor(f, dtype=Y.dtype, device=Y.device)
    z = torch.clamp(Y[..., 2:3], min=MIN_DEPTH)
    return Y[..., :2] / z * f[..., None, None] + c


def reprojection_errors(
    R: torch.Tensor,
    t: torch.Tensor,
    X: torch.Tensor,
    x2d: torch.Tensor,
    f,
    c: torch.Tensor,
) -> torch.Tensor:
    """Per-point pixel reprojection error. Returns (..., N) distances in px."""
    Y = transform_points(R, t, X)
    err = safe_norm(project(Y, f, c) - x2d)
    return torch.where(Y[..., 2] < MIN_DEPTH, err + 1000.0, err)


def pose_errors(
    R: torch.Tensor,
    t: torch.Tensor,
    R_gt: torch.Tensor,
    t_gt: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(rotation error deg, translation error m) for scene->camera poses;
    the translation error is the distance between camera centers -R^T t."""
    rot_err = rot_error_deg(R, R_gt)
    cam_center = -hmm(t[..., None, :], R)[..., 0, :]
    cam_center_gt = -hmm(t_gt[..., None, :], R_gt)[..., 0, :]
    return rot_err, safe_norm(cam_center - cam_center_gt)


def backproject_at_depth(R: torch.Tensor, t: torch.Tensor, pixels: torch.Tensor, f, c,
                         depth) -> torch.Tensor:
    """Scene points seen at a constant camera-frame ``depth`` (meters): the
    heuristic stage-1 targets for scenes without depth GT (counterpart of
    ``backproject_at_depth``).  R (..., 3, 3), t (..., 3) scene -> camera;
    pixels (N, 2); f scalar or of the pose's batch shape; c (2,).  Returns
    (..., N, 3): X = R^T (Y - t) with Y = depth * ray(pixel)."""
    f = torch.as_tensor(f, dtype=pixels.dtype, device=pixels.device)
    xy = (pixels - c) / f[..., None, None]
    Y = torch.cat([xy * depth, torch.full_like(xy[..., :1], depth)], dim=-1)
    return hmm(Y - t[..., None, :], R)  # row-vector form of R^T (Y - t)
