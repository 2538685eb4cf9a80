"""Training-time augmentation (counterpart of ``esac_tpu/data/augment.py``):
in-plane rotation, scale and brightness, kept consistent with the
supervision.

- In-plane rotation by angle a: image and coordinate map are resampled by
  the same inverse warp about the principal point, and the scene -> camera
  pose picks up Rz(-a) on the left (projection commutes with in-plane
  rotation).
- Scale by s: zooming about the principal point equals focal *= s; pose
  and scene coordinates are unchanged.
- Brightness: photometric only.

The warp is bilinear with clamped edges, the formula of
``map_coordinates(order=1, mode="nearest")`` written out as four gathers
(pixel i at coordinate i), batched over leading frame dimensions on the
image's device.
"""

from __future__ import annotations

import torch

from esac_tpu_torch.geometry.rotations import rodrigues, so3_log
from esac_tpu_torch.utils.precision import hmm


def _warp_resample(img: torch.Tensor, angle, scale) -> torch.Tensor:
    """Rotate by ``angle`` (radians) and zoom by ``scale`` about the center
    of img (..., H, W, C); angle and scale are scalars or of img's leading
    shape.  Output pixel q samples the input at R(angle) q / scale."""
    H, W, C = img.shape[-3:]
    lead = img.shape[:-3]
    dev = img.device
    angle = torch.as_tensor(angle, dtype=torch.float32, device=dev)[..., None, None]
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)[..., None, None]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys = torch.arange(H, dtype=torch.float32, device=dev) - cy
    xs = torch.arange(W, dtype=torch.float32, device=dev) - cx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    ca, sa = torch.cos(angle) / scale, torch.sin(angle) / scale
    src_x = (ca * gx - sa * gy + cx).expand(lead + (H, W)).reshape(lead + (H * W,))
    src_y = (sa * gx + ca * gy + cy).expand(lead + (H, W)).reshape(lead + (H * W,))
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - y0, src_x - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy, ix = y0.long(), x0.long()
    flat = img.reshape(lead + (H * W, C))

    def tap(dy, dx):
        k = (iy + dy).clamp(0, H - 1) * W + (ix + dx).clamp(0, W - 1)
        return torch.gather(flat, -2, k[..., None].expand(lead + (H * W, C)))

    # map_coordinates' order: corners (y0, x0), (y0, x1), (y1, x0), (y1, x1),
    # each weighted by wy * wx, summed left to right.
    out = tap(0, 0) * (wy0 * wx0)[..., None] + tap(0, 1) * (wy0 * wx1)[..., None]
    out = out + tap(1, 0) * (wy1 * wx0)[..., None]
    out = out + tap(1, 1) * (wy1 * wx1)[..., None]
    return out.reshape(img.shape)


def augment_frame(generator: torch.Generator, image: torch.Tensor, coords_gt: torch.Tensor,
                  rvec: torch.Tensor, tvec: torch.Tensor, focal,
                  max_rotation_deg: float = 30.0, scale_range: tuple[float, float] = (0.8, 1.2),
                  brightness: float = 0.15) -> dict:
    """Jointly augment (image, GT coords, pose, focal) of one frame or a
    batch: image (..., H, W, 3), coords_gt (..., h, w, 3), rvec / tvec
    (..., 3).  One rotation, scale and gain per frame, drawn from
    ``generator`` in that order.  Reprojecting the returned coords through
    the returned pose and focal lands on the cell grid of the returned
    image.  Returns 'image', 'coords_gt', 'rvec', 'tvec', 'focal', 'scale'."""
    lead = image.shape[:-3]
    dev = image.device

    def draw(low, high):
        u = torch.rand(lead, generator=generator, device=generator.device).to(dev)
        return low + (high - low) * u

    angle = torch.deg2rad(draw(-max_rotation_deg, max_rotation_deg))
    scale = draw(*scale_range)
    gain = 1.0 + draw(-brightness, brightness)
    image_aug = _warp_resample(image, angle, scale)
    coords_aug = _warp_resample(coords_gt, angle, scale)
    z = torch.zeros_like(angle)
    Rz = rodrigues(torch.stack([z, z, -angle], dim=-1))
    R_new = hmm(Rz, rodrigues(rvec))
    t_new = hmm(Rz, tvec[..., None])[..., 0]
    return {
        "image": torch.clamp(image_aug * gain[..., None, None, None], 0.0, 1.0),
        "coords_gt": coords_aug,
        "rvec": so3_log(R_new),
        "tvec": t_new,
        "focal": focal * scale,
        "scale": scale,
    }
