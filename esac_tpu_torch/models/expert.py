"""Expert scene-coordinate regression network (counterpart of
``esac_tpu/models/expert.py``).

RGB (..., H, W, 3) NHWC in [0, 1] -> scene coordinates (..., H/8, W/8, 3),
NHWC like the JAX package; the module permutes to NCHW inside.  Convs and
activations run in ``compute_dtype`` with float32 parameters, as Flax's
``dtype=`` does (the parameters are cast per call); the coordinate head
runs in float32 so centimeter precision survives.  The convolutions stay
``nn.Conv2d`` -- the JAX package left them to XLA, so they are not kernels
to port.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` with its float32 parameters cast to ``x``'s dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride, conv.padding)


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
            x = F.relu(conv_in_dtype(conv, x))
        for block in self.head:
            h = F.relu(conv_in_dtype(block["conv3"], x))
            h = conv_in_dtype(block["conv1"], h)
            if "proj" in block:
                x = conv_in_dtype(block["proj"], x)
            x = F.relu(x + h)
        x = self.coord(x.float())
        x = x.permute(0, 2, 3, 1) + self.scene_center
        return x.reshape(lead + x.shape[1:])
