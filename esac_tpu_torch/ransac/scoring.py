"""Soft-inlier scoring (counterpart of ``esac_tpu/ransac/scoring.py``).

score_j = sum over cells of sigmoid(beta * (tau - r_jc)), with r_jc the
reprojection error of cell c under hypothesis j.
"""

from __future__ import annotations

import torch

from esac_tpu_torch.geometry.camera import reprojection_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.utils.precision import fixed_sum


def reprojection_error_map(
    rvecs: torch.Tensor,
    tvecs: torch.Tensor,
    coords: torch.Tensor,
    pixels: torch.Tensor,
    f,
    c: torch.Tensor,
) -> torch.Tensor:
    """Per-hypothesis, per-cell reprojection errors.

    rvecs/tvecs (..., H, 3); coords (..., N, 3); pixels (..., N, 2),
    broadcastable against coords; f (...) or scalar.  Returns (..., H, N).
    """
    f = torch.as_tensor(f, dtype=coords.dtype, device=coords.device)
    return reprojection_errors(
        rodrigues(rvecs), tvecs, coords[..., None, :, :], pixels[..., None, :, :],
        f[..., None], c,
    )


def soft_inlier_score(errors: torch.Tensor, tau: float, beta: float) -> torch.Tensor:
    """Soft inlier count per hypothesis. errors (..., N) -> (...), summed
    in a batch-independent order (:func:`fixed_sum`)."""
    return fixed_sum(torch.sigmoid(beta * (tau - errors)), dim=-1)


def soft_inlier_weights(errors: torch.Tensor, tau: float, beta: float) -> torch.Tensor:
    """Per-cell soft inlier weights in [0, 1] (same sigmoid as the score)."""
    return torch.sigmoid(beta * (tau - errors))


def draw_cells(generators: list[torch.Generator], n_cells: int, n_sub: int):
    """Each frame's random subset of ``n_sub`` of its ``n_cells`` cells for
    subsampled scoring (``RansacConfig.score_cells``): one ``randperm`` a
    generator, in frame order.  Returns (B, n_sub) int64 on the generators'
    device, or None when ``n_sub`` is 0 or >= ``n_cells`` (every cell
    scores)."""
    if not n_sub or n_sub >= n_cells:
        return None
    return torch.stack([
        torch.randperm(n_cells, generator=g, device=g.device)[:n_sub] for g in generators
    ])


def gather_cells(
    coords: torch.Tensor,
    pixels: torch.Tensor,
    sub: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, float]:
    """The cells ``sub`` (B, n_sub) of :func:`draw_cells`, frames-major.

    coords (B, ..., N, 3); pixels (N, 2) shared or (B, N, 2).  Every expert
    of a frame gets the same cells, so cross-expert scores stay comparable.
    Returns (coords (B, ..., n_sub, 3), pixels (B, n_sub, 2), scale =
    N / n_sub); with ``sub`` None the inputs come back unchanged with
    scale 1.
    """
    if sub is None:
        return coords, pixels, 1.0
    N = coords.shape[-2]
    sub = sub.to(coords.device)
    B = sub.shape[0]
    n_sub = sub.shape[1]
    mid = coords.dim() - 3  # expert axes between frame and cell axes
    sub_c = sub.view((B,) + (1,) * mid + (n_sub, 1)).expand(coords.shape[:-2] + (n_sub, 3))
    px = pixels.expand((B,) + pixels.shape[-2:]) if pixels.dim() == 2 else pixels
    return (
        torch.gather(coords, -2, sub_c),
        torch.gather(px, 1, sub[..., None].expand(B, n_sub, 2)),
        N / n_sub,
    )


def subsample_cells(
    generators: list[torch.Generator],
    coords: torch.Tensor,
    pixels: torch.Tensor,
    n_sub: int,
) -> tuple[torch.Tensor, torch.Tensor, float]:
    """Per-frame random cell subsets for subsampled scoring
    (``RansacConfig.score_cells``): :func:`draw_cells` from one generator
    per frame, then :func:`gather_cells`.  coords (B, ..., N, 3); pixels
    (N, 2) shared or (B, N, 2).  Returns (coords (B, ..., n_sub, 3),
    pixels (B, n_sub, 2), scale = N / n_sub); with ``n_sub`` 0 or >= N the
    inputs come back unchanged with scale 1.
    """
    return gather_cells(coords, pixels, draw_cells(generators, coords.shape[-2], n_sub))
