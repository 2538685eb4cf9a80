"""Expert scene-coordinate regression network (counterpart of
``esac_tpu/models/expert.py``).

RGB (..., H, W, 3) NHWC in [0, 1] -> scene coordinates (..., H/8, W/8, 3),
NHWC like the JAX package; the module permutes to NCHW inside.  Convs and
activations run in ``compute_dtype`` with float32 parameters, as Flax's
``dtype=`` does (the parameters are cast per call); the coordinate head
runs in float32 so centimeter precision survives.  The convolutions stay
``nn.Conv2d`` -- the JAX package left them to XLA, so they are not kernels
to port.  :func:`conv_epilogue` runs each one with its bias, residual and
ReLU: on the card without autograd as one cuDNN fused convolution, which
applies them in its epilogue; everywhere else as the separate ops.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from esac_tpu_torch.geometry.camera import reprojection_errors
from esac_tpu_torch.obs.trace import convs_issued


# Half dtypes fuse (measured in bf16); float32 convolutions, the
# retriever's default, keep the separate ops.
_FUSED_DTYPES = (torch.bfloat16, torch.float16)


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` with its float32 parameters cast to ``x``'s dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride, conv.padding)


def fuses(x: torch.Tensor) -> bool:
    """Whether a convolution over ``x`` runs as one cuDNN fused convolution:
    on the card, without autograd (the fused ops have no backward), in a
    half dtype.  Any channel count fuses: cuDNN pads a 3-channel input to
    its vector width as it does for the separate convolution."""
    return x.is_cuda and not torch.is_grad_enabled() and x.dtype in _FUSED_DTYPES


def conv_epilogue(conv: nn.Conv2d, x: torch.Tensor, residual: torch.Tensor | None = None,
                  proj: nn.Conv2d | None = None) -> torch.Tensor:
    """``relu(conv(x))`` or, with ``residual``, ``relu(conv(x) + r)`` where
    ``r`` is ``residual`` or, with ``proj``, ``proj(residual)``; in ``x``'s
    dtype, float32 parameters cast per call (:func:`conv_in_dtype`).

    Where :func:`fuses` holds, cuDNN applies the bias,
    the residual and the ReLU in the convolution's epilogue, in float32, and
    rounds once; ``proj`` then runs without its bias, which joins
    ``conv``'s.  Otherwise every step is its own op, as the JAX package's
    modules compute them.  Each convolution is counted for a traced
    dispatch (:func:`~esac_tpu_torch.obs.trace.convs_issued`)."""
    n = 1 if proj is None else 2
    if fuses(x):
        convs_issued(n, n)
        w, bias = conv.weight.to(x.dtype), conv.bias
        args = (conv.stride, conv.padding, conv.dilation, conv.groups)
        if residual is None:
            return torch.cudnn_convolution_relu(x, w, bias.to(x.dtype), *args)
        if proj is not None:
            residual = F.conv2d(residual, proj.weight.to(x.dtype), None, proj.stride,
                                proj.padding)
            bias = bias + proj.bias
        return torch.cudnn_convolution_add_relu(x, w, residual, 1.0, bias.to(x.dtype), *args)
    convs_issued(n, 0)
    y = conv_in_dtype(conv, x)
    if residual is None:
        return F.relu(y)
    if proj is not None:
        residual = conv_in_dtype(proj, residual)
    return F.relu(residual + y)


class ExpertNet(nn.Module):
    """Fully-convolutional scene-coordinate regressor, stride-8 output.

    The layer list follows the Flax module's call order, which is also its
    ``Conv_k`` numbering: stem conv; per stem stage a stride-2 conv and a
    3x3 conv; per head block a 3x3 conv, a 1x1 conv and -- only where the
    channel count changes (head block 0) -- a 1x1 projection of the
    residual; then the 1x1 coordinate head.  Flax ``SAME`` on a 3x3 stride-1
    conv is ``padding=1``; the stride-2 convs use explicit (1, 1) padding.
    """

    def __init__(
        self,
        scene_center: Sequence[float] = (0.0, 0.0, 0.0),
        stem_channels: Sequence[int] = (64, 128, 256),
        head_channels: int = 512,
        head_depth: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.register_buffer("scene_center",
                             torch.tensor(scene_center, dtype=torch.float32))
        convs = [nn.Conv2d(3, stem_channels[0] // 2, 3, padding=1)]
        cin = stem_channels[0] // 2
        for ch in stem_channels:
            convs += [nn.Conv2d(cin, ch, 3, stride=2, padding=1),
                      nn.Conv2d(ch, ch, 3, padding=1)]
            cin = ch
        self.stem = nn.ModuleList(convs)
        self.head = nn.ModuleList()
        for _ in range(head_depth):
            block = nn.ModuleDict({
                "conv3": nn.Conv2d(cin, head_channels, 3, padding=1),
                "conv1": nn.Conv2d(head_channels, head_channels, 1),
            })
            if cin != head_channels:
                block["proj"] = nn.Conv2d(cin, head_channels, 1)
            self.head.append(block)
            cin = head_channels
        self.coord = nn.Conv2d(cin, 3, 1)

    def layers_in_flax_order(self) -> list[nn.Conv2d]:
        """Convs in Flax call order: index k is the Flax ``Conv_k``."""
        out = list(self.stem)
        for block in self.head:
            out += [block["conv3"], block["conv1"]]
            if "proj" in block:
                out.append(block["proj"])
        return out + [self.coord]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2).to(self.compute_dtype)
        for conv in self.stem:
            x = conv_epilogue(conv, x)
        for block in self.head:
            h = conv_epilogue(block["conv3"], x)
            x = conv_epilogue(block["conv1"], h, residual=x,
                              proj=block["proj"] if "proj" in block else None)
        convs_issued(1, 0)
        x = self.coord(x.float())
        x = x.permute(0, 2, 3, 1) + self.scene_center
        return x.reshape(lead + x.shape[1:])


def coordinate_loss(pred: torch.Tensor, target: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked mean L1 distance between predicted and GT scene coordinates
    (counterpart of ``coordinate_loss``).  pred/target (..., 3); mask (...)
    with 1 where the GT is valid."""
    dist = torch.sum(torch.abs(pred - target), dim=-1)
    if mask is None:
        return torch.mean(dist)
    return torch.sum(dist * mask) / (torch.sum(mask) + 1e-9)


def reprojection_loss(pred: torch.Tensor, pixels: torch.Tensor, R_gt: torch.Tensor,
                      t_gt: torch.Tensor, f, c: torch.Tensor,
                      clamp_px: float = 100.0) -> torch.Tensor:
    """Mean reprojection error under the GT pose, each cell's error clamped
    at ``clamp_px`` (counterpart of ``models.expert.reprojection_loss``).
    pred (N, 3), pixels (N, 2), R_gt (3, 3), t_gt (3,)."""
    errs = reprojection_errors(R_gt, t_gt, pred, pixels, f, c)
    return torch.mean(torch.clamp(errs, max=clamp_px))
