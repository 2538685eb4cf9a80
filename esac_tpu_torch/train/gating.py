"""Stage-2 gating training: expert classification by cross-entropy against
the GT expert label (counterpart of ``esac_tpu/train/gating.py``)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from esac_tpu_torch.models.gating import gating_cross_entropy
from esac_tpu_torch.ransac.kernel import as_f32
from esac_tpu_torch.utils.precision import resolve_device


def make_gating_train_step(net: nn.Module, optimizer: torch.optim.Optimizer,
                           device=None) -> Callable:
    """``step(images, labels)`` -> loss: images (B, H, W, 3), labels (B,)."""
    dev = resolve_device(device)

    def step(images, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = gating_cross_entropy(net(as_f32(images, dev)),
                                    torch.as_tensor(labels, device=dev))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
