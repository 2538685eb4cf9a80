"""Gating network (counterpart of ``esac_tpu/models/gating.py``).

RGB (..., H, W, 3) NHWC -> logits (..., M): strided convs in
``compute_dtype`` with float32 parameters, global average pool, then two
float32 dense layers.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from esac_tpu_torch.models.expert import conv_epilogue


class GatingNet(nn.Module):
    """CNN classifier over ``num_experts`` experts.  Layer order follows the
    Flax module's call order (``Conv_k`` then ``Dense_0``, ``Dense_1``)."""

    def __init__(
        self,
        num_experts: int,
        channels: Sequence[int] = (32, 64, 128, 256),
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        convs, cin = [], 3
        for ch in channels:
            convs += [nn.Conv2d(cin, ch, 3, stride=2, padding=1),
                      nn.Conv2d(ch, ch, 3, padding=1)]
            cin = ch
        self.convs = nn.ModuleList(convs)
        hidden = max(num_experts * 4, 64)
        self.dense0 = nn.Linear(cin, hidden)
        self.dense1 = nn.Linear(hidden, num_experts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2).to(self.compute_dtype)
        for conv in self.convs:
            x = conv_epilogue(conv, x)
        x = x.mean(dim=(2, 3)).float()  # global average pool
        x = self.dense1(F.relu(self.dense0(x)))
        return x.reshape(lead + x.shape[1:])


def gating_cross_entropy(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Stage-2 loss: mean cross-entropy of ``logits`` (..., M) against the
    GT expert ``label`` (...) (counterpart of ``gating_cross_entropy``)."""
    logp = torch.log_softmax(logits, dim=-1)
    label = torch.as_tensor(label, device=logits.device).long()
    return -torch.mean(torch.gather(logp, -1, label[..., None])[..., 0])
