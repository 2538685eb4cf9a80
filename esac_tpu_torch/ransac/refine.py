"""Soft-inlier IRLS pose refinement (counterpart of ``esac_tpu/ransac/refine.py``).

Recompute per-cell sigmoid weights, take one weighted Gauss-Newton step,
repeat a fixed number of rounds, carrying the rotation MATRIX through the
loop (no axis-angle round trip per round).  Weights are computed without
autograd (detached), the usual IRLS trick, as ``stop_weight_grad`` does in
the JAX package; gradients flow through the Gauss-Newton steps.
"""

from __future__ import annotations

import torch

from esac_tpu_torch.geometry.camera import reprojection_errors
from esac_tpu_torch.geometry.pnp import refine_pose_gn_R
from esac_tpu_torch.geometry.rotations import rodrigues, so3_log
from esac_tpu_torch.ransac.scoring import soft_inlier_weights


def refine_soft_inliers(
    rvec: torch.Tensor,
    tvec: torch.Tensor,
    coords: torch.Tensor,
    pixels: torch.Tensor,
    f,
    c: torch.Tensor,
    tau: float,
    beta: float,
    iters: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IRLS over leading batch dims: rvec/tvec (..., 3), coords (..., N, 3),
    pixels (..., N, 2) broadcastable, f (...) or scalar.  Returns the
    refined (rvec, tvec)."""
    f = torch.as_tensor(f, dtype=coords.dtype, device=coords.device)
    R = rodrigues(rvec)
    for _ in range(iters):
        with torch.no_grad():
            w = soft_inlier_weights(reprojection_errors(R, tvec, coords, pixels, f, c),
                                    tau, beta)
        R, tvec = refine_pose_gn_R(R, tvec, coords, pixels, f, c, weights=w, iters=1)
    return so3_log(R), tvec
