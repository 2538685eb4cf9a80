"""Synthetic box-room scene (counterpart of ``esac_tpu/data/synthetic.py``):
exact geometry for kernel tests and a procedurally textured renderer for
end-to-end training without a dataset.

An axis-aligned room seen by a pinhole camera: ground-truth scene
coordinates, poses and images are all computable exactly.  Conventions
match ``esac_tpu_torch.geometry``: the pose (R, t) maps scene -> camera.
Everything is batched over leading frame dimensions and runs on the
device of its inputs; random draws come from an explicit
``torch.Generator`` (made on the generator's device, then moved to
``device``, so a CPU generator gives the same poses for every device).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from esac_tpu_torch.geometry.rotations import rodrigues

# Default pinhole intrinsics (7-Scenes-like: 640x480 @ f=525).
CAMERA_F = 525.0
CAMERA_C = (320.0, 240.0)

# The room: axis-aligned box [0, ROOM_SIZE]^3 (meters).
ROOM_SIZE = np.array([6.0, 4.0, 3.0], dtype=np.float32)


def output_pixel_grid(height: int = 480, width: int = 640, stride: int = 8,
                      device=None) -> torch.Tensor:
    """Centers of the expert's output cells in input-pixel coordinates,
    (stride * j + stride / 2).  Returns (n_cells, 2) float32 (x, y),
    row-major (y outer, x inner): 80 x 60 = 4800 cells at 640x480."""
    ys = torch.arange(height // stride, device=device) * stride + stride / 2.0
    xs = torch.arange(width // stride, device=device) * stride + stride / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1).float()


def _room(device) -> torch.Tensor:
    return torch.as_tensor(ROOM_SIZE, device=device)


def _uniform(generator: torch.Generator, shape, low: float, high: float, device):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (low + (high - low) * u).to(device)


def _translations(rvecs: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """t = -R @ center (camera center -> translation)."""
    return -torch.einsum("nij,nj->ni", rodrigues(rvecs), centers)


def random_poses_in_box(generator: torch.Generator, n: int, device=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plausible camera poses inside the room, looking inward: rotations
    within +-0.35 rad per axis, centers within ``ROOM_SIZE * (0.5 +- 0.2)``.
    Returns (rvecs (n, 3), tvecs (n, 3)) scene -> camera on ``device``
    (the generator's device when None)."""
    device = generator.device if device is None else device
    rvecs = _uniform(generator, (n, 3), -0.35, 0.35, device)
    centers = _room(device) * (0.5 + _uniform(generator, (n, 3), -0.2, 0.2, device))
    return rvecs, _translations(rvecs, centers)


def trajectory_poses_in_box(generator: torch.Generator, n: int, dt: float = 1.0 / 30.0,
                            device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A smooth camera path through the room: center and rotation each a
    sum of two low-frequency sinusoids (0.11 and 0.047 Hz) with random
    phases, sampled every ``dt`` seconds, so consecutive frames are a few
    cm / a fraction of a degree apart at 30 Hz.  Same ranges as
    :func:`random_poses_in_box`.  Returns (rvecs (n, 3), tvecs (n, 3))."""
    device = generator.device if device is None else device
    t = torch.arange(n, dtype=torch.float32, device=device)[:, None] * dt
    f1, f2 = 0.11, 0.047
    ph_c = _uniform(generator, (2, 3), 0.0, 2.0 * math.pi, device)
    ph_r = _uniform(generator, (2, 3), 0.0, 2.0 * math.pi, device)
    two_pi = 2.0 * math.pi
    # Amplitudes sum to the i.i.d. sampler's bounds: +-0.2 and +-0.35.
    wiggle_c = 0.13 * torch.sin(two_pi * f1 * t + ph_c[0]) \
        + 0.07 * torch.sin(two_pi * f2 * t + ph_c[1])
    centers = _room(device) * (0.5 + wiggle_c)
    rvecs = 0.23 * torch.sin(two_pi * f1 * t + ph_r[0]) \
        + 0.12 * torch.sin(two_pi * f2 * t + ph_r[1])
    return rvecs, _translations(rvecs, centers)


def _ray_box_depth(origin: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Ray parameter s of the first wall hit from inside the box:
    hit = origin + s * dirs.  origin (..., 1, 3), dirs (..., N, 3) ->
    (..., N).  Per axis the positive crossing is the exit; the min over
    axes is the first wall."""
    safe = torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    s_low = (0.0 - origin) / safe
    s_high = (_room(dirs.device) - origin) / safe
    return torch.amin(torch.maximum(s_low, s_high), dim=-1)


def _wall_texture(X: torch.Tensor, texture_phase: float = 0.0) -> torch.Tensor:
    """Procedural RGB of scene points (..., 3) -> (..., 3) in [0, 1]: a
    smooth, position-unique pattern; ``texture_phase`` makes scenes look
    different (the gating net must tell them apart)."""
    def dot(a, b, c):
        return X[..., 0] * a + X[..., 1] * b + X[..., 2] * c

    r = 0.5 + 0.5 * torch.sin(dot(1.7, 0.9, 2.3) * 1.3 + (0.0 + texture_phase))
    g = 0.5 + 0.5 * torch.sin(dot(0.6, 2.2, 1.1) * 2.9 + (1.1 + texture_phase))
    b = 0.5 + 0.5 * torch.sin(dot(2.9, 1.4, 0.5) * (0.7 + 0.13 * texture_phase)
                              + (2.3 + texture_phase))
    return torch.stack([r, g, b], dim=-1)


def _scene_points(R: torch.Tensor, center: torch.Tensor, px: torch.Tensor, f, c
                  ) -> torch.Tensor:
    """Where the rays through pixels ``px`` (N, 2) of cameras (R (..., 3, 3),
    center (..., 3)) hit the walls: (..., N, 3)."""
    xy = (px - torch.as_tensor(c, dtype=px.dtype, device=px.device)) / f
    x, y = xy[:, 0, None], xy[:, 1, None]  # (N, 1)
    # rays_cam @ R with rays_cam = (x, y, 1): R^T applied to each row.
    rays = x * R[..., None, 0, :] + y * R[..., None, 1, :] + R[..., None, 2, :]
    s = _ray_box_depth(center[..., None, :], rays)
    return center[..., None, :] + s[..., None] * rays


def render_box_scene(rvec: torch.Tensor, tvec: torch.Tensor, height: int = 480,
                     width: int = 640, f: float = CAMERA_F, c=CAMERA_C,
                     coord_stride: int = 8, texture_phase: float = 0.0) -> dict:
    """Render frames of the box room on the poses' device.  rvec, tvec
    (..., 3).  Returns 'image' (..., height, width, 3) RGB in [0, 1],
    'coords_gt' (..., n_cells, 3) scene coordinates at the output cell
    centers, 'pixels' (n_cells, 2) those centers, 'rvec', 'tvec'."""
    R = rodrigues(rvec)
    center = -torch.einsum("...ij,...i->...j", R, tvec)  # -R^T t
    dev = rvec.device
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px_full = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    img = _wall_texture(_scene_points(R, center, px_full, f, c), texture_phase)
    pixels = output_pixel_grid(height, width, coord_stride, device=dev)
    return {
        "image": img.reshape(rvec.shape[:-1] + (height, width, 3)),
        "coords_gt": _scene_points(R, center, pixels, f, c),
        "pixels": pixels,
        "rvec": rvec,
        "tvec": tvec,
    }


def make_correspondence_frame(generator: torch.Generator, height: int = 480,
                              width: int = 640, stride: int = 8, noise: float = 0.0,
                              outlier_frac: float = 0.0, f: float = CAMERA_F, c=CAMERA_C,
                              device=None) -> dict:
    """Geometry-only frame: a GT pose and the coordinates an imperfect
    expert would predict -- Gaussian noise of ``noise`` meters on every
    cell and an ``outlier_frac`` fraction replaced by uniform room points.
    Returns 'coords', 'coords_gt', 'pixels', 'rvec', 'tvec'."""
    device = generator.device if device is None else device
    rvecs, tvecs = random_poses_in_box(generator, 1, device)
    rvec, tvec = rvecs[0], tvecs[0]
    frame = render_box_scene(rvec, tvec, height, width, f, c, stride)
    coords = frame["coords_gt"]
    n = coords.shape[0]
    gen_dev = generator.device
    coords = coords + noise * torch.randn(coords.shape, generator=generator,
                                          device=gen_dev).to(device)
    if outlier_frac > 0:
        outliers = _room(device) * _uniform(generator, (n, 3), 0.0, 1.0, device)
        is_out = _uniform(generator, (n,), 0.0, 1.0, device) < outlier_frac
        coords = torch.where(is_out[:, None], outliers, coords)
    return {"coords": coords, "coords_gt": frame["coords_gt"], "pixels": frame["pixels"],
            "rvec": rvec, "tvec": tvec}
