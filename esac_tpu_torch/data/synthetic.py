"""Camera constants and the expert's output-cell grid (the subset of
``esac_tpu/data/synthetic.py`` the serving path needs; the box-room
renderer waits for the data slice)."""

from __future__ import annotations

import torch

# Default pinhole intrinsics (7-Scenes-like: 640x480 @ f=525).
CAMERA_F = 525.0
CAMERA_C = (320.0, 240.0)


def output_pixel_grid(height: int = 480, width: int = 640, stride: int = 8,
                      device=None) -> torch.Tensor:
    """Centers of the expert's output cells in input-pixel coordinates,
    (stride * j + stride / 2).  Returns (n_cells, 2) float32 (x, y),
    row-major (y outer, x inner): 80 x 60 = 4800 cells at 640x480."""
    ys = torch.arange(height // stride, device=device) * stride + stride / 2.0
    xs = torch.arange(width // stride, device=device) * stride + stride / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1).float()
