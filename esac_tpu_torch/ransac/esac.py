"""Multi-expert ESAC (counterpart of ``esac_tpu/ransac/esac.py``): dense
inference and the end-to-end training loss.

Every expert gets ``cfg.n_hyps`` hypotheses (the reference's "256
hyp/expert", BASELINE config #2), each scored on its own expert's
coordinate map; the best-supported hypothesis across experts wins and is
refined.  All B x M (frame, expert) problems of a dispatch are one batched
P3P solve and one scoring-kernel launch.

:func:`esac_train_loss_frames` is the training loss, differentiable with
respect to the coordinates and the gating logits: "dense" weighs every
expert's expected pose loss by its gating probability (an exact gating
gradient), "sampled" draws an expert per hypothesis and carries the gating
gradient by a REINFORCE term.

Still to port (ROADMAP): top-k, routed and prior-slot entries.
"""

from __future__ import annotations

import torch

from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.fused_scoring import broadcast_pixels
from esac_tpu_torch.geometry.camera import reprojection_errors
from esac_tpu_torch.geometry.pnp import solve_pnp_minimal
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.kernel import (
    _infer_winner,
    _refine_hypotheses,
    _score_hypotheses,
    _take,
    as_f32,
    frame_pixels,
    generate_hypotheses,
    per_frame,
    pose_loss,
)
from esac_tpu_torch.ransac.refine import refine_soft_inliers
from esac_tpu_torch.ransac.sampling import sample_correspondence_sets, sample_expert_indices
from esac_tpu_torch.ransac.scoring import soft_inlier_score, subsample_cells
from esac_tpu_torch.utils.precision import resolve_device


def _expert_hypotheses(generators, coords_all, pixels, f, c, cfg, idx=None):
    """n_hyps hypotheses per expert: coords_all (B, M, N, 3), pixels (N, 2)
    or (B, N, 2), f (B,), one generator per frame; ``idx``
    (B, M, n_hyps, 4) injects the sets.  Returns poses (B, M, n_hyps, 3)
    and the focal per problem (B, M)."""
    B, M, N = coords_all.shape[:3]
    if idx is None:
        idx = torch.stack([sample_correspondence_sets(g, cfg.n_hyps, N, (M,))
                           for g in generators])
    fBM = f[:, None].expand(B, M)
    rvecs, tvecs = generate_hypotheses(None, coords_all, pixels, fBM, c, cfg, idx=idx)
    return rvecs, tvecs, fBM


def _per_expert_winners(generators, coords_all, pixels, f, c, cfg, idx=None):
    """n_hyps hypotheses per expert, then score+select per expert.

    Shapes as in :func:`_expert_hypotheses`.  Returns ``(rvecs, tvecs,
    best_j, best_s, scores)``: poses (B, M, n_hyps, 3), per-expert winner
    index and score (B, M) -- scaled by N / score_cells when subsampling --
    and the (B, M, n_hyps) scores, None under "fused_select".  The global
    winner is ``m* = argmax(best_s)``, ``j* = best_j[m*]``: the flat
    first-max argmax over all M x n_hyps scores, ties included.
    """
    rvecs, tvecs, fBM = _expert_hypotheses(generators, coords_all, pixels, f, c, cfg, idx)
    coords_s, pixels_s, scale = subsample_cells(generators, coords_all, pixels,
                                                cfg.score_cells)
    best_j, best_s, scores = _infer_winner(rvecs, tvecs, coords_s, pixels_s, fBM, c, cfg)
    return rvecs, tvecs, best_j, best_s * scale, None if scores is None else scores * scale


def _no_stage(name: str) -> None:
    """The default stage hook of the training loss and step: nothing."""


def _per_expert_hypotheses(generators, coords_all, pixels, f, c, cfg, idx=None,
                           on_stage=_no_stage):
    """Training sibling of :func:`_per_expert_winners` (counterpart of
    ``_per_expert_hypotheses``): every hypothesis of every expert scored on
    its own expert's map through ``_score_hypotheses`` (every problem of
    the call in one scoring call).  Returns rvecs, tvecs (B, M, n_hyps, 3)
    and scores (B, M, n_hyps); calls ``on_stage`` after "hypotheses" and
    "scoring_forward"."""
    rvecs, tvecs, fBM = _expert_hypotheses(generators, coords_all, pixels, f, c, cfg, idx)
    on_stage("hypotheses")
    scores = _score_hypotheses(generators, rvecs, tvecs, coords_all, pixels, fBM, c, cfg)
    on_stage("scoring_forward")
    return rvecs, tvecs, scores


def _expected_losses_per_expert(rvecs, tvecs, scores, coords_all, pixels, f, c, R_gt,
                                t_gt, cfg):
    """Within-expert softmax-selection expectation of the refined pose loss
    (counterpart of ``_expected_losses_per_expert``).  rvecs/tvecs
    (B, M, H, 3), scores (B, M, H), coords_all (B, M, N, 3), pixels (N, 2)
    or (B, N, 2), f (B,), R_gt (B, 3, 3), t_gt (B, 3).  Returns (B, M)
    expected losses and (B, M, H) per-hypothesis losses; without
    ``cfg.grad_through_refine`` the losses are detached, so gradients flow
    through the selection path alone."""
    probs = torch.softmax(cfg.alpha * scores, dim=-1)
    rv, tv = _refine_hypotheses(rvecs, tvecs, coords_all[:, :, None],
                                frame_pixels(pixels, 2), per_frame(f, 2), c, cfg)
    losses = pose_loss(rv, tv, per_frame(R_gt, 2), per_frame(t_gt, 2), cfg)
    if not cfg.grad_through_refine:
        losses = losses.detach()
    return torch.sum(probs * losses, dim=-1), losses


def esac_infer_frames(
    generators: list[torch.Generator],
    gating_logits,
    coords_all,
    pixels,
    f,
    c,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
) -> dict:
    """B frames x M experts in one dispatch.

    gating_logits (B, M), coords_all (B, M, N, 3), pixels (N, 2) shared or
    (B, N, 2), f (B,) or scalar, c (2,), one generator per frame (on
    ``device``).  Returns per-frame 'rvec', 'tvec', 'expert',
    'gating_probs', 'inlier_frac' and 'scores' (B, M, n_hyps) -- or the
    winner's 'score' under "fused_select".  Selection is by consensus
    score; the gate is reported, not used.
    """
    dev = resolve_device(device)
    coords_all, pixels, c = as_f32(coords_all, dev), as_f32(pixels, dev), as_f32(c, dev)
    gating_logits = as_f32(gating_logits, dev)
    B, N = coords_all.shape[0], coords_all.shape[2]
    f = as_f32(f, dev).expand(B)
    rvecs, tvecs, best_j, best_s, scores = _per_expert_winners(
        generators, coords_all, pixels, f, c, cfg, idx=idx)
    m_star = torch.argmax(best_s, dim=1)
    j_star = _take(best_j, m_star)
    rvec, tvec = refine_soft_inliers(
        _take(_take(rvecs, m_star), j_star), _take(_take(tvecs, m_star), j_star),
        _take(coords_all, m_star), broadcast_pixels(pixels, (B,)), f, c,
        cfg.tau, cfg.beta, iters=cfg.refine_iters)
    best = _take(best_s, m_star)
    out = {
        "rvec": rvec,
        "tvec": tvec,
        "expert": m_star,
        "gating_probs": torch.softmax(gating_logits, dim=-1),
        "inlier_frac": best / N,
    }
    if scores is None:
        out["score"] = best
    else:
        out["scores"] = scores
    return out


def esac_infer(
    generator: torch.Generator,
    gating_logits,
    coords_all,
    pixels,
    f,
    c,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
) -> dict:
    """One frame: gating_logits (M,), coords_all (M, N, 3), pixels (N, 2);
    ``idx`` (M, n_hyps, 4).  :func:`esac_infer_frames` on a batch of one."""
    dev = resolve_device(device)
    out = esac_infer_frames(
        [generator], as_f32(gating_logits, dev)[None], as_f32(coords_all, dev)[None],
        pixels, as_f32(f, dev).reshape(1), c, cfg,
        idx=None if idx is None else torch.as_tensor(idx)[None], device=dev)
    return {k: v[0] for k, v in out.items()}


def esac_train_loss_frames(
    generators: list[torch.Generator],
    gating_logits,
    coords_all,
    pixels,
    f,
    c,
    R_gt,
    t_gt,
    cfg: RansacConfig = RansacConfig(),
    mode: str = "dense",
    idx=None,
    experts=None,
    device=None,
    on_stage=None,
) -> tuple[torch.Tensor, dict]:
    """End-to-end expected pose loss per frame, differentiable with respect
    to ``coords_all`` and ``gating_logits`` (counterpart of
    ``esac_train_loss``), B frames in one call.  ``on_stage(name)``, when
    given, is called as "hypotheses", "scoring_forward" and
    "refine_and_loss" have been issued (a timing hook).

    gating_logits (B, M), coords_all (B, M, N, 3), pixels (N, 2) or
    (B, N, 2), f (B,) or scalar, c (2,), R_gt (B, 3, 3), t_gt (B, 3), one
    generator per frame.

    - dense: loss = sum_m softmax(g)_m * E_j[pose_loss]; ``idx``
      (B, M, n_hyps, 4) injects the sets.  aux: 'expected_loss',
      'per_expert_loss', 'gating_probs', 'scores'.
    - sampled: an expert drawn per hypothesis from softmax(g) (``experts``
      (B, n_hyps) injects the draws), one hypothesis per draw on that
      expert's map (``idx`` (B, n_hyps, 4)), and the gating gradient by a
      REINFORCE term with the unweighted mean loss as baseline, added by
      its gradient only.  aux: 'expected_loss', 'drawn_experts',
      'gating_probs', 'scores'.

    Returns (loss (B,), aux).
    """
    dev = resolve_device(device)
    coords_all, pixels, c = as_f32(coords_all, dev), as_f32(pixels, dev), as_f32(c, dev)
    gating_logits = as_f32(gating_logits, dev)
    R_gt, t_gt = as_f32(R_gt, dev), as_f32(t_gt, dev)
    B, M, N = coords_all.shape[:3]
    f = as_f32(f, dev).expand(B)
    g = torch.softmax(gating_logits, dim=-1)
    stage = on_stage or _no_stage

    if mode == "dense":
        if experts is not None:
            raise ValueError("experts injection is sampled-mode only")
        rvecs, tvecs, scores = _per_expert_hypotheses(generators, coords_all, pixels, f, c,
                                                      cfg, idx=idx, on_stage=stage)
        exp_losses, _ = _expected_losses_per_expert(rvecs, tvecs, scores, coords_all,
                                                    pixels, f, c, R_gt, t_gt, cfg)
        total = torch.sum(g * exp_losses, dim=-1)
        stage("refine_and_loss")
        return total, {"expected_loss": total, "per_expert_loss": exp_losses,
                       "gating_probs": g, "scores": scores}
    if mode != "sampled":
        raise ValueError(f"unknown mode {mode!r}")

    if experts is None:
        experts = torch.stack([sample_expert_indices(gen, g[b], cfg.n_hyps)
                               for b, gen in enumerate(generators)])
    if idx is None:
        idx = torch.stack([sample_correspondence_sets(gen, cfg.n_hyps, N)
                           for gen in generators])
    experts = torch.as_tensor(experts, device=dev).long()
    idx = torch.as_tensor(idx, device=dev).long()
    frame = torch.arange(B, device=dev)[:, None]
    coords_sel = coords_all[frame, experts]                      # (B, H, N, 3)
    X4 = coords_all[frame[..., None], experts[..., None], idx]   # (B, H, 4, 3)
    x4 = (pixels[idx] if pixels.dim() == 2 else pixels[frame[..., None], idx])
    rvecs, tvecs = solve_pnp_minimal(X4, x4, f[:, None], c, polish_iters=cfg.polish_iters)
    stage("hypotheses")

    # Each hypothesis scored on its own expert's map.
    px = frame_pixels(pixels, 1)
    scores = soft_inlier_score(
        reprojection_errors(rodrigues(rvecs), tvecs, coords_sel, px, f[:, None], c),
        cfg.tau, cfg.beta)
    stage("scoring_forward")
    probs = torch.softmax(cfg.alpha * scores, dim=-1)
    rv, tv = _refine_hypotheses(rvecs, tvecs, coords_sel, px, f[:, None], c, cfg)
    losses = pose_loss(rv, tv, per_frame(R_gt, 1), per_frame(t_gt, 1), cfg)
    expected = torch.sum(probs * losses, dim=-1)

    # Score-function term for the discrete draw, with the unweighted mean
    # loss as baseline (the selection-weighted expectation would make
    # p_j * (loss_j - b) vanish by construction); only its gradient counts.
    log_g = torch.log(g + 1e-12)
    baseline = losses.mean(dim=-1, keepdim=True).detach()
    weights = (probs * (losses - baseline)).detach()
    reinforce = torch.sum(weights * torch.gather(log_g, -1, experts), dim=-1)
    total = expected + reinforce - reinforce.detach()
    stage("refine_and_loss")
    return total, {"expected_loss": expected, "drawn_experts": experts,
                   "gating_probs": g, "scores": scores}


def esac_train_loss(
    generator: torch.Generator,
    gating_logits,
    coords_all,
    pixels,
    f,
    c,
    R_gt,
    t_gt,
    cfg: RansacConfig = RansacConfig(),
    mode: str = "dense",
    idx=None,
    experts=None,
    device=None,
) -> tuple[torch.Tensor, dict]:
    """One frame: gating_logits (M,), coords_all (M, N, 3), pixels (N, 2),
    R_gt (3, 3), t_gt (3,); ``idx`` (M, n_hyps, 4) dense or (n_hyps, 4)
    sampled, ``experts`` (n_hyps,).  :func:`esac_train_loss_frames` on a
    batch of one."""
    dev = resolve_device(device)

    def one(x):
        return None if x is None else torch.as_tensor(x)[None]

    loss, aux = esac_train_loss_frames(
        [generator], as_f32(gating_logits, dev)[None], as_f32(coords_all, dev)[None],
        pixels, as_f32(f, dev).reshape(1), c, as_f32(R_gt, dev)[None],
        as_f32(t_gt, dev)[None], cfg, mode, idx=one(idx), experts=one(experts),
        device=dev)
    return loss[0], {k: v[0] for k, v in aux.items()}
