"""Sharded end-to-end ESAC training: experts over the mesh's ``expert``
axis, frames over its ``data`` axis, gating replicated (counterpart of
``esac_tpu/parallel/train_sharded.py``).

Two expert-compute policies, as in the JAX package:

- **dense** (``capacity=None``): every local expert runs on every local
  frame, and each frame's (M, cells, 3) coordinate stack is assembled over
  the expert group by :class:`_GatherExperts` (a scatter and a SUM
  all-reduce; its backward sums the stack's gradient over the group and
  keeps this rank's rows -- the reduce-scatter).  Exact gating gradient.
- **routed** (``capacity=k``): per frame only the top-k local experts by
  gating mass run their CNN; each rank contributes its selected experts'
  ``g_m * L_m`` terms and the combine is a scalar SUM all-reduce, with no
  coordinate gather.  The loss is dense's ``sum_m g_m L_m`` truncated to
  the selected experts: when the selection covers all non-zero gating
  mass, value and gradients match dense (up to the order of the sum); a
  gate that spreads mass past capacity gets a loss biased low, the
  capacity-routing trade.  Routed training requires ``mode="dense"``: the
  sampled estimator draws experts from the full categorical.

Each expert's hypothesis sets are drawn by its global index from the
frame's generator (``ransac.esac._routed_sets``), so both policies draw
the single-device step's sets.

Gradients: the returned loss is the replicated global loss (a SUM
all-reduce of each rank's share, whose backward passes the gradient
through unchanged).  After ``loss.backward()``, :meth:`reduce_grads`
(``loss_fn.reduce_grads()``) sums the gating gradients over every rank and
the expert gradients over the data group, as the JAX package's shard_map
transposes do: then every rank's expert gradients are those of the
single-device loss for its local experts, and its gating gradients the
whole gating gradient.  Under "pallas" a step launches the scoring kernel
once per rank (its backward is the plain recompute).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from esac_tpu_torch.parallel.esac_sharded import _local_experts
from esac_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, batch_sharding
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import (
    _expected_losses_per_expert,
    _routed_sets,
    _top_experts,
    esac_train_loss_frames,
)
from esac_tpu_torch.ransac.kernel import _score_hypotheses, as_f32, generate_hypotheses
from esac_tpu_torch.utils.precision import resolve_device


class _GatherExperts(torch.autograd.Function):
    """local (B, m, ...) -> the group's (B, M, ...) stack, rows
    [lo, lo + m) from this rank.  Backward: the stack's gradient summed
    over the group, this rank's rows kept."""

    @staticmethod
    def forward(ctx, local, lo, M, group):
        ctx.lo, ctx.m, ctx.group = lo, local.shape[1], group
        full = local.new_zeros((local.shape[0], M) + local.shape[2:])
        full[:, lo:lo + local.shape[1]] = local
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g[:, ctx.lo:ctx.lo + ctx.m], None, None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the gradient passes through to each share."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _params(obj) -> list:
    """Parameters of a module or of a list of modules; anything else is an
    error (a trained net whose gradients no rank sums would drift)."""
    if isinstance(obj, nn.Module):
        return list(obj.parameters())
    if isinstance(obj, (list, tuple)):
        return [p for o in obj for p in _params(o)]
    raise TypeError(f"sharded training needs nn.Modules, got {type(obj).__name__} "
                    "(wrap a padded gating net in parallel.esac_sharded.PaddedGating)")


def _allreduce_grads(params, group) -> None:
    """SUM each parameter's gradient over ``group`` in one flat buffer; a
    missing gradient counts as zero (every rank issues the same call)."""
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).clone()
        off += n


def make_sharded_esac_loss(
    mesh,
    experts,
    gating,
    centers,
    pixels,
    f,
    c,
    cfg: RansacConfig,
    mode: str = "dense",
    capacity: int | None = None,
    device=None,
):
    """Build ``loss(images, R_gts, t_gts, seed, idx=None)`` over ``mesh``.

    ``experts``: modules images (n, H, W, 3) -> (n, h, w, 3), all M or this
    rank's M / n_expert; ``gating`` a module images -> logits (n, M)
    (``PaddedGating`` for padded experts); ``centers``
    (M, 3) added to the expert outputs.  The loss takes the whole batch
    (B divisible by the data axis) and uses this rank's frames; ``seed``
    spawns the per-frame generators as ``train.e2e.step_generators`` does,
    and ``idx`` (B, M, n_hyps, 4) injects the sets.  Returns the replicated
    mean loss over the batch, equal to the single-device
    ``esac_train_loss_frames`` mean.  ``loss.reduce_grads()`` after the
    backward completes the gradients (module docstring).
    """
    from esac_tpu_torch.train.e2e import step_generators

    if capacity and mode != "dense":
        raise ValueError("capacity routing requires mode='dense'")
    dev = resolve_device(device)
    centers = as_f32(centers, dev)
    M = centers.shape[0]
    lo, local = _local_experts(mesh, experts, M)
    m = len(local)
    cap = min(capacity, m) if capacity else None
    gating_params, expert_params = _params(gating), _params(local)
    D, E = axis_size(mesh, "data"), axis_size(mesh, "expert")
    d = axis_index(mesh, "data")
    expert_group, data_group = axis_group(mesh, "expert"), axis_group(mesh, "data")
    pixels, c = as_f32(pixels, dev), as_f32(c, dev)
    f = as_f32(f, dev)

    def local_forward(imgs, nets, lo_c):
        out = torch.stack([net(imgs) for net in nets], dim=1)
        return out.reshape(imgs.shape[0], len(nets), -1, 3) + lo_c[None, :, None, :]

    def dense_share(gens, logits, imgs, R, t, idx):
        coords = _GatherExperts.apply(local_forward(imgs, local, centers[lo:lo + m]), lo, M,
                                      expert_group)
        b = imgs.shape[0]
        losses, _ = esac_train_loss_frames(gens, logits, coords, pixels, f.expand(b), c, R, t,
                                           cfg, mode, idx=idx, device=dev)
        # Every rank of an expert group computes the same frames' losses.
        return losses.mean() / (D * E)

    def routed_share(gens, logits, imgs, R, t, idx):
        b = imgs.shape[0]
        g = torch.softmax(logits, dim=-1)
        top = torch.sort(_top_experts(g[:, lo:lo + m].detach(), cap), dim=-1).values
        gm = lo + top                                                  # (b, cap) global
        # Only the selected experts' CNNs run, each over its frames.
        coords = None
        for i, net in enumerate(local):
            hit = top == i
            frames = hit.any(1).nonzero()[:, 0]
            if frames.numel() == 0:
                continue
            out = net(imgs[frames]).reshape(len(frames), -1, 3) + centers[lo + i]
            if coords is None:
                coords = out.new_zeros((b, cap) + out.shape[1:])
            coords = coords.index_put((frames, hit[frames].int().argmax(1)), out)
        N = coords.shape[2]
        if idx is None:
            idx = _routed_sets(gens, cfg.n_hyps, N, M, gm)
        else:
            idx = torch.as_tensor(idx, device=dev)[torch.arange(b, device=dev)[:, None], gm]
        fBM = f.expand(b)[:, None].expand(b, cap)
        rvecs, tvecs = generate_hypotheses(None, coords, pixels, fBM, c, cfg, idx=idx)
        scores = _score_hypotheses(gens, rvecs, tvecs, coords, pixels, fBM, c, cfg)
        exp_losses, _ = _expected_losses_per_expert(rvecs, tvecs, scores, coords, pixels,
                                                    f.expand(b), c, R, t, cfg)
        return torch.sum(torch.gather(g, 1, gm) * exp_losses, dim=-1).mean() / D

    share_fn = routed_share if capacity else dense_share

    def loss(images, R_gts, t_gts, seed, idx=None):
        images = as_f32(images, dev)
        B = images.shape[0]
        if B % D:
            raise ValueError(f"batch {B} not divisible by the data axis {D}")
        b = B // D
        gens = step_generators(seed, B, dev)[d * b:(d + 1) * b]
        imgs = batch_sharding(mesh, images)
        if idx is not None:
            idx = batch_sharding(mesh, torch.as_tensor(idx, device=dev))
        share = share_fn(gens, gating(imgs), imgs, batch_sharding(mesh, as_f32(R_gts, dev)),
                         batch_sharding(mesh, as_f32(t_gts, dev)), idx)
        return _AllReduceSum.apply(share, None)

    def reduce_grads():
        """SUM the gating gradients over every rank and the local experts'
        over the data group (collective)."""
        _allreduce_grads(gating_params, None)
        if D > 1:
            _allreduce_grads(expert_params, data_group)

    def grad_sq_norm():
        """The squared global gradient norm over gating and every expert
        (collective over the expert group)."""
        e_sq = sum((p.grad.double() ** 2).sum() for p in expert_params if p.grad is not None)
        e_sq = torch.as_tensor(e_sq, dtype=torch.float64, device=dev).reshape(1)
        dist.all_reduce(e_sq, op=dist.ReduceOp.SUM, group=expert_group)
        g_sq = sum(float((p.grad.double() ** 2).sum()) for p in gating_params
                   if p.grad is not None)
        return float(e_sq) + g_sq

    loss.reduce_grads = reduce_grads
    loss.grad_sq_norm = grad_sq_norm
    loss.local_experts = local
    return loss


def make_sharded_esac_train_step(mesh, experts, gating, centers, optimizer, cfg, pixels, f, c,
                                 mode: str = "dense", capacity: int | None = None,
                                 clip_norm: float = float("inf"), device=None):
    """The sharded counterpart of ``train.make_esac_train_step``: returns
    ``step(seed, images, R_gts, t_gts, idx=None) -> loss``: zero the
    gradients, the sharded loss, backward, :meth:`reduce_grads`, a clip of
    every gradient to the global norm ``clip_norm`` over gating and all
    experts (one all-reduce; inf clips nothing), then ``optimizer.step()``.
    The optimizer holds this rank's experts (:func:`shard_esac_params`) and
    the gating net; an expert no frame routed to has no gradient, and Adam
    skips it."""
    loss_fn = make_sharded_esac_loss(mesh, experts, gating, centers, pixels, f, c, cfg, mode,
                                     capacity, device)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(seed, images, R_gts, t_gts, idx=None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(images, R_gts, t_gts, seed, idx=idx)
        loss.backward()
        loss_fn.reduce_grads()
        if math.isfinite(clip_norm):
            coef = clip_norm / (math.sqrt(loss_fn.grad_sq_norm()) + 1e-6)
            if coef < 1.0:
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(coef)
        optimizer.step()
        return loss.detach()

    step.loss_fn = loss_fn
    return step


def shard_esac_params(mesh, experts, gating):
    """This rank's experts (an ``nn.ModuleList`` slice of the M, which must
    divide the expert axis) and the replicated gating net (counterpart of
    ``shard_esac_params``, which places the stacked params on the mesh)."""
    M = len(experts)
    E = axis_size(mesh, "expert")
    if M % E:
        raise ValueError(f"M={M} not divisible by expert axis {E}")
    m = M // E
    lo = axis_index(mesh, "expert") * m
    return nn.ModuleList(list(experts)[lo:lo + m]), gating
