"""Gradient-safe numerical primitives (counterpart of ``esac_tpu/utils/num.py``).

The epsilon sits inside the sqrt so both the value and its gradient stay
finite at an exact zero; 1e-12 under a sqrt is a 1e-6 floor, far below any
physical pixel/meter/radian quantity here.
"""

from __future__ import annotations

import torch

DEFAULT_EPS = 1e-12


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = DEFAULT_EPS) -> torch.Tensor:
    """L2 norm with finite gradient at ``x = 0`` (eps inside the sqrt)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def safe_sqrt(x: torch.Tensor, eps: float = DEFAULT_EPS) -> torch.Tensor:
    """sqrt with finite gradient at 0 (real and complex inputs)."""
    return torch.sqrt(x + eps)
