"""Torch <-> C++ training bridge (counterpart of
``esac_tpu/backends/train_bridge.py``): the reference's
extension-inside-autograd architecture for ``train_esac --backend cpp``.

The reference calls its C++ extension once a frame inside the autograd
graph: forward returns the expected pose loss of every expert, backward
injects the extension's coordinate gradients into the network's backprop.
Here that is a ``torch.autograd.Function`` whose forward runs
``esac_train_cpp`` on host copies of one frame's coordinates and whose
backward returns ``grad_E[:, None, None] * grad_coords`` on the coordinates'
device.  A call that no backward can follow (grad mode off, or coordinates
that do not require grad) passes ``want_grad=False`` and skips the
finite-difference backward, the dominant cost.

Gating gradients need no bridge: in dense mode the loss is
``sum_m softmax(logits)_m * E_m`` with ``E`` from the extension, so the
logits gradient is exact with ``E`` held constant.
"""

from __future__ import annotations

import numpy as np
import torch

from esac_tpu_torch.backends.cpp import esac_train_cpp
from esac_tpu_torch.ransac.config import RansacConfig


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def make_cpp_expert_losses(pixels, f: float, c: tuple[float, float], cfg: RansacConfig):
    """Build ``expert_losses(coords_all, R_gt, t_gt, idx) -> (M,)`` float32,
    one frame, running the C++ training extension, differentiable with
    respect to ``coords_all``.

    pixels: (N, 2) cell centers (fixed for a run).  coords_all (M, N, 3) on
    any device; R_gt (3, 3), t_gt (3,) ground truth (no gradient); idx
    (M, n_hyps, 4) correspondence sets drawn by the caller (no gradient).
    The losses come back on ``coords_all``'s device.
    """
    px_host = np.asarray(_host(pixels), np.float32)
    f, c = float(f), (float(c[0]), float(c[1]))

    def call(coords_all, R_gt, t_gt, idx, want_grad):
        return esac_train_cpp(
            _host(coords_all), px_host, _host(idx), f, c, _host(R_gt), _host(t_gt),
            tau=cfg.tau, beta=cfg.beta, alpha=cfg.alpha,
            train_refine_iters=cfg.train_refine_iters, trans_scale=cfg.trans_scale,
            loss_clamp=cfg.loss_clamp, want_grad=want_grad)

    class CppExpertLosses(torch.autograd.Function):
        @staticmethod
        def forward(ctx, coords_all, R_gt, t_gt, idx, want_grad):
            out = call(coords_all, R_gt, t_gt, idx, want_grad)
            if want_grad:
                ctx.save_for_backward(torch.from_numpy(out["grad_coords"]).to(coords_all.device))
            return torch.from_numpy(out["expert_losses"].astype(np.float32)).to(
                coords_all.device)

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, grad_E):
            (grad,) = ctx.saved_tensors
            return grad_E[:, None, None] * grad, None, None, None, None

    def expert_losses(coords_all, R_gt, t_gt, idx):
        # Forward-only use skips the finite-difference backward entirely.
        want_grad = torch.is_grad_enabled() and coords_all.requires_grad
        return CppExpertLosses.apply(coords_all, R_gt, t_gt, idx, want_grad)

    return expert_losses
