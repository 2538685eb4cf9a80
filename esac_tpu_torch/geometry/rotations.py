"""Rotation utilities (counterpart of ``esac_tpu/geometry/rotations.py``).

Branchless axis-angle <-> matrix conversions: the small-angle limit is a
Taylor blend and the near-pi logarithm an outer-product formula, both
selected with ``torch.where`` so every function is total over any batch.
All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

from esac_tpu_torch.utils.num import safe_norm
from esac_tpu_torch.utils.precision import hmm

# Below this angle (radians) the sin(x)/x style factors switch to their
# Taylor expansions to avoid 0/0.
_SMALL_ANGLE = 1e-6


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix. (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector -> rotation matrix. (..., 3) -> (..., 3, 3).

    R = I + a K + b K^2 with K = skew(rvec), a = sin(t)/t, b = (1-cos(t))/t^2;
    for t -> 0, a -> 1 - t^2/6 and b -> 1/2 - t^2/24.
    """
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta < _SMALL_ANGLE
    one = torch.ones_like(theta)
    safe_theta = torch.where(small, one, theta)
    safe_theta2 = torch.where(small, one, theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / safe_theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_theta2)
    K = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * hmm(K, K)


def _angle(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2(y, x), computed in float64 and rounded once to the inputs'
    dtype.  PyTorch's CPU atan2 rounds differently in a tensor's vectorized
    body than in its scalar tail, so in float32 one frame's angle could
    change by an ulp with the batch it rides; the once-rounded double is
    the same either way."""
    return torch.atan2(y.double(), x.double()).to(y.dtype)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector. (..., 3, 3) -> (..., 3).

    Skew-part formula away from 0 and pi; near pi the axis comes from the
    largest column of (R + R^T - 2 cos(t) I) / (2 (1 - cos(t))) = a a^T,
    its sign oriented by the skew part.  Every division is guarded so the
    untaken branch stays finite.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    two_sin = safe_norm(w)  # = 2 sin(t)
    theta = _angle(two_sin, trace - 1.0)
    near_pi = cos_t < -0.999
    axis_generic = w / two_sin[..., None]
    denom_pi = 2.0 * (1.0 - cos_t)
    safe_denom_pi = torch.where(near_pi, denom_pi, torch.ones_like(denom_pi))
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    M = (R + R.transpose(-1, -2) - 2.0 * cos_t[..., None, None] * eye) / (
        safe_denom_pi[..., None, None]
    )
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(M, -1, k[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
    axis_pi = col / safe_norm(col)[..., None]
    orient = torch.sum(w * axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi * torch.where(orient < 0, -1.0, 1.0)
    axis = torch.where(near_pi[..., None], axis_pi, axis_generic)
    small_total = theta < _SMALL_ANGLE
    return torch.where(small_total[..., None], w * 0.5, axis * theta[..., None])


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix, (..., 4) -> (..., 3, 3)
    (the SfM pose import of ``scripts/setup_aachen.py``); normalizes
    defensively."""
    q = q / safe_norm(q)[..., None]
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle of R in degrees. (..., 3, 3) -> (...)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    return _angle(safe_norm(w), trace - 1.0) * (180.0 / math.pi)


def rot_error_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Relative rotation angle between two rotations, in degrees."""
    return rotation_angle_deg(hmm(R1, R2.transpose(-1, -2)))
