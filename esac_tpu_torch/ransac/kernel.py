"""The single-expert hypothesis loop (counterpart of ``esac_tpu/ransac/kernel.py``):
sample -> solve -> score -> select -> refine.

Frames-major by construction: where the JAX package ``vmap``s one frame's
pipeline over frames and hypotheses, every stage here is one batched tensor
computation over (frames, [experts,] hypotheses), and scoring is one kernel
launch per dispatch.

Randomness: one ``torch.Generator`` per frame (JAX: one key per frame).  A
frame's generator draws its hypothesis sets first and its scoring-cell
subsample (``score_cells``) after, so the hypothesis stream is the same
with or without subsampling -- the property ``_split_score_key`` keeps in
the JAX package, without a split.  A frame's draws depend only on its own
generator, so a frame's result does not depend on the batch it rides.

Training: :func:`dsac_train_loss_frames` is the expected pose loss under
softmax hypothesis selection, differentiable with respect to the
coordinates (and through them the network) by autograd; scoring runs
through :func:`_score_hypotheses`, whose "pallas" impl launches the
scoring kernel in the forward pass and recomputes its formula in the
backward (``fused_scoring.SoftInlierScores``).
"""

from __future__ import annotations

import torch

from esac_tpu_torch.geometry.camera import pose_errors
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.fused_scoring import (
    _scores_plain,
    broadcast_pixels,
    soft_inlier_score_select,
    soft_inlier_scores_chunked,
    soft_inlier_scores_fused,
    soft_inlier_scores_kernel,
)
from esac_tpu_torch.geometry.pnp import solve_pnp_minimal
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.refine import refine_soft_inliers
from esac_tpu_torch.ransac.sampling import sample_correspondence_sets
from esac_tpu_torch.ransac.scoring import (
    reprojection_error_map,
    soft_inlier_score,
    subsample_cells,
)
from esac_tpu_torch.utils.precision import resolve_device


def frame_generators(seeds, device) -> list[torch.Generator]:
    """One seeded ``torch.Generator`` per frame, on ``device``."""
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _gather_cells(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, D) at idx (..., H, K) -> (..., H, K, D)."""
    lead, (H, K) = idx.shape[:-2], idx.shape[-2:]
    flat = idx.reshape(lead + (H * K, 1)).expand(lead + (H * K, x.shape[-1]))
    return torch.gather(x.expand(lead + x.shape[-2:]), -2, flat).reshape(
        lead + (H, K, x.shape[-1]))


def generate_hypotheses(
    generator: torch.Generator | None,
    coords: torch.Tensor,
    pixels: torch.Tensor,
    f: torch.Tensor,
    c: torch.Tensor,
    cfg: RansacConfig,
    idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample minimal sets and solve PnP for every hypothesis.

    coords (L..., N, 3); pixels (N, 2) or (L[0], N, 2); f (L...).  Returns
    rvecs, tvecs (L..., n_hyps, 3).  ``idx`` (L..., n_hyps, 4) injects
    precomputed correspondence sets (the cross-package parity tests inject
    the same table into both packages); otherwise ``generator`` draws them.
    """
    lead, N = coords.shape[:-2], coords.shape[-2]
    if idx is None:
        idx = sample_correspondence_sets(generator, cfg.n_hyps, N, lead)
    idx = torch.as_tensor(idx, device=coords.device).long()
    X4 = _gather_cells(coords, idx)
    x4 = _gather_cells(broadcast_pixels(pixels, lead), idx)
    return solve_pnp_minimal(X4, x4, f[..., None], c, polish_iters=cfg.polish_iters)


def _infer_winner(rvecs, tvecs, coords, pixels, f, c, cfg):
    """Score and select over leading problem dims L: rvecs/tvecs
    (L..., H, 3), coords (L..., N, 3), pixels (N, 2) or (L[0], N, 2),
    f (L...).  Returns ``(best, best_score, scores)``, ``scores`` (L..., H)
    or None under "fused_select":

    - "fused_select": the score+select kernel (one launch); only the
      winner's index and score exist;
    - "pallas": the scoring kernel (one launch), argmax of its output;
    - "errmap" / "fused": plain PyTorch scoring chunked over hypotheses
      (the error-map formulation, or the kernels' formula).

    ``torch.argmax`` returns the first maximal index, the contract the
    select kernel keeps too.
    """
    impl = cfg.scoring_impl
    if impl == "fused_select":
        best, best_score, _ = soft_inlier_score_select(
            rodrigues(rvecs), tvecs, coords, pixels, f, c, cfg.tau, cfg.beta)
        return best, best_score, None
    if impl == "pallas":
        scores = soft_inlier_scores_kernel(
            rodrigues(rvecs), tvecs, coords, pixels, f, c, cfg.tau, cfg.beta)
    elif impl == "fused":
        scores = _scores_plain(rodrigues(rvecs), tvecs, coords, pixels, f, c,
                               cfg.tau, cfg.beta, chunk=cfg.score_chunk)
    elif impl == "errmap":
        scores = soft_inlier_scores_chunked(
            rvecs, tvecs, coords, broadcast_pixels(pixels, coords.shape[:-2]), f, c,
            cfg.tau, cfg.beta, chunk=cfg.score_chunk)
    else:
        raise ValueError(f"unknown RansacConfig.scoring_impl: {impl!r}")
    best = torch.argmax(scores, dim=-1)
    return best, torch.gather(scores, -1, best[..., None])[..., 0], scores


def _score_hypotheses(generators, rvecs, tvecs, coords, pixels, f, c, cfg):
    """Every hypothesis' soft-inlier score, differentiable: the training
    path's scoring entry (counterpart of ``_score_hypotheses``; the softmax
    expectation needs every score, so no select runs here).  Shapes as in
    :func:`_infer_winner`; optionally on a per-frame cell subsample
    (``cfg.score_cells``, drawn from ``generators``), scaled by
    N / score_cells.  Returns (L..., H); :func:`_score_cells` on the
    subsample."""
    return _score_cells(rvecs, tvecs, subsample_cells(generators, coords, pixels,
                                                      cfg.score_cells), f, c, cfg)


def _score_cells(rvecs, tvecs, cells, f, c, cfg):
    """Scores of every hypothesis on the cells ``(coords_s, pixels_s,
    scale)`` of :func:`~esac_tpu_torch.ransac.scoring.subsample_cells`,
    times ``scale``.  The prior slot of the serving path scores here, on
    the sampled stream's own subsample.

    - "pallas": the scoring kernel through ``SoftInlierScores`` (one launch
      in the forward pass, the plain recompute in the backward);
    - "fused": the kernels' formula as one plain broadcast;
    - "fused_select": the error-map math chunked over hypotheses, each
      chunk checkpointed (the peak stays one (chunk, N) tile forward and
      backward);
    - "errmap": the full error map.
    """
    coords_s, pixels_s, scale = cells
    impl = cfg.scoring_impl
    if impl == "pallas":
        return soft_inlier_scores_kernel(rodrigues(rvecs), tvecs, coords_s, pixels_s, f, c,
                                         cfg.tau, cfg.beta, chunk=cfg.score_chunk) * scale
    px = broadcast_pixels(pixels_s, coords_s.shape[:-2])
    if impl == "fused":
        scores = soft_inlier_scores_fused(rodrigues(rvecs), tvecs, coords_s, px, f, c,
                                          cfg.tau, cfg.beta)
    elif impl == "fused_select":
        scores = soft_inlier_scores_chunked(rvecs, tvecs, coords_s, px, f, c, cfg.tau,
                                            cfg.beta, chunk=cfg.score_chunk)
    elif impl == "errmap":
        scores = soft_inlier_score(
            reprojection_error_map(rvecs, tvecs, coords_s, px, f, c), cfg.tau, cfg.beta)
    else:
        raise ValueError(f"unknown RansacConfig.scoring_impl: {impl!r}")
    return scores * scale


def pose_loss(rvec, tvec, R_gt, t_gt, cfg: RansacConfig) -> torch.Tensor:
    """max(rotation error deg, translation error m * trans_scale), clamped
    at ``loss_clamp`` (counterpart of ``pose_loss``).  Broadcasts over
    leading dims: rvec/tvec (..., 3), R_gt (..., 3, 3), t_gt (..., 3)."""
    r_err, t_err = pose_errors(rodrigues(rvec), tvec, R_gt, t_gt)
    return torch.clamp(torch.maximum(r_err, t_err * cfg.trans_scale), max=cfg.loss_clamp)


def _refine_hypotheses(rvecs, tvecs, coords, pixels, f, c, cfg):
    """``cfg.train_refine_iters`` IRLS rounds of every hypothesis (leading
    dims broadcast as in ``refine_soft_inliers``); under ``cfg.remat``
    checkpointed, so the backward recomputes the rounds instead of keeping
    their Jacobians."""
    def refine(rv, tv, co, px, fi):
        return refine_soft_inliers(rv, tv, co, px, fi, c, cfg.tau, cfg.beta,
                                   iters=cfg.train_refine_iters)

    if cfg.remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(refine, rvecs, tvecs, coords, pixels, f, use_reentrant=False)
    return refine(rvecs, tvecs, coords, pixels, f)


def per_frame(x: torch.Tensor, extra: int) -> torch.Tensor:
    """A per-frame tensor (B, *rest) with ``extra`` unit axes after the
    frame axis, to broadcast against (B, <extra axes>, ...)."""
    return x.reshape(x.shape[:1] + (1,) * extra + x.shape[1:])


def frame_pixels(pixels: torch.Tensor, extra: int) -> torch.Tensor:
    """Pixels (N, 2) shared, or (B, N, 2) per frame, broadcastable against
    (B, <extra axes>, N, 2)."""
    return pixels if pixels.dim() == 2 else per_frame(pixels, extra)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) at per-row index i (B,) -> (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), i]


def dsac_infer_frames(
    generators: list[torch.Generator],
    coords,
    pixels,
    f,
    c,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
) -> dict:
    """Frames-major single-expert inference: B frames in one dispatch.

    coords (B, N, 3), pixels (N, 2) shared or (B, N, 2), f (B,) or scalar,
    c (2,), one generator per frame (on ``device``); ``idx`` (B, n_hyps, 4)
    optionally injects the correspondence sets.  Returns per-frame 'rvec',
    'tvec' (the refined winner), 'best', 'inlier_frac', and 'scores'
    (B, n_hyps) -- or the winner's 'score' under "fused_select".
    """
    dev = resolve_device(device)
    coords, pixels, c = as_f32(coords, dev), as_f32(pixels, dev), as_f32(c, dev)
    B, N = coords.shape[0], coords.shape[-2]
    f = as_f32(f, dev).expand(B)
    if idx is None:
        idx = torch.stack([sample_correspondence_sets(g, cfg.n_hyps, N)
                           for g in generators])
    rvecs, tvecs = generate_hypotheses(None, coords, pixels, f, c, cfg, idx=idx)
    coords_s, pixels_s, scale = subsample_cells(generators, coords, pixels,
                                                cfg.score_cells)
    best, best_score, scores = _infer_winner(rvecs, tvecs, coords_s, pixels_s,
                                             f, c, cfg)
    best_score = best_score * scale
    rvec, tvec = refine_soft_inliers(
        _take(rvecs, best), _take(tvecs, best), coords, broadcast_pixels(pixels, (B,)),
        f, c, cfg.tau, cfg.beta, iters=cfg.refine_iters)
    out = {"rvec": rvec, "tvec": tvec, "best": best, "inlier_frac": best_score / N}
    if scores is None:
        out["score"] = best_score
    else:
        out["scores"] = scores * scale
    return out


def dsac_infer(
    generator: torch.Generator,
    coords,
    pixels,
    f,
    c,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
) -> dict:
    """One frame: coords (N, 3), pixels (N, 2); ``idx`` (n_hyps, 4).
    :func:`dsac_infer_frames` on a batch of one."""
    dev = resolve_device(device)
    out = dsac_infer_frames(
        [generator], as_f32(coords, dev)[None], pixels, as_f32(f, dev).reshape(1), c,
        cfg, idx=None if idx is None else torch.as_tensor(idx)[None], device=dev)
    return {k: v[0] for k, v in out.items()}


def dsac_train_loss_frames(
    generators: list[torch.Generator],
    coords,
    pixels,
    f,
    c,
    R_gt,
    t_gt,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
) -> tuple[torch.Tensor, dict]:
    """Frames-major training loss: per frame, the expected pose loss under
    softmax hypothesis selection (counterpart of ``dsac_train_loss``),

        E_{j ~ softmax(alpha * score)} [pose_loss(refine_light(h_j))].

    coords (B, N, 3), pixels (N, 2) or (B, N, 2), f (B,) or scalar, c (2,),
    R_gt (B, 3, 3), t_gt (B, 3), one generator per frame; ``idx``
    (B, n_hyps, 4) injects the correspondence sets.  Every hypothesis gets
    ``cfg.train_refine_iters`` IRLS rounds.  Gradients reach ``coords``
    through the minimal solves, the scores inside the softmax and the
    refinement.  Returns (loss (B,), aux) with aux 'expected_loss',
    'best_loss', 'selection_probs', 'scores', 'entropy'.
    """
    dev = resolve_device(device)
    coords, pixels, c = as_f32(coords, dev), as_f32(pixels, dev), as_f32(c, dev)
    R_gt, t_gt = as_f32(R_gt, dev), as_f32(t_gt, dev)
    B, N = coords.shape[0], coords.shape[-2]
    f = as_f32(f, dev).expand(B)
    if idx is None:
        idx = torch.stack([sample_correspondence_sets(g, cfg.n_hyps, N)
                           for g in generators])
    rvecs, tvecs = generate_hypotheses(None, coords, pixels, f, c, cfg, idx=idx)
    scores = _score_hypotheses(generators, rvecs, tvecs, coords, pixels, f, c, cfg)
    probs = torch.softmax(cfg.alpha * scores, dim=-1)
    rv, tv = _refine_hypotheses(rvecs, tvecs, per_frame(coords, 1),
                                frame_pixels(pixels, 1), per_frame(f, 1), c, cfg)
    losses = pose_loss(rv, tv, per_frame(R_gt, 1), per_frame(t_gt, 1), cfg)
    expected = torch.sum(probs * losses, dim=-1)
    aux = {
        "expected_loss": expected,
        "best_loss": _take(losses, torch.argmax(scores, dim=-1)),
        "selection_probs": probs,
        "scores": scores,
        "entropy": -torch.sum(probs * torch.log(probs + 1e-12), dim=-1),
    }
    return expected, aux


def dsac_train_loss(
    generator: torch.Generator,
    coords,
    pixels,
    f,
    c,
    R_gt,
    t_gt,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
) -> tuple[torch.Tensor, dict]:
    """One frame: coords (N, 3), pixels (N, 2), R_gt (3, 3), t_gt (3,);
    ``idx`` (n_hyps, 4).  :func:`dsac_train_loss_frames` on a batch of one."""
    dev = resolve_device(device)
    loss, aux = dsac_train_loss_frames(
        [generator], as_f32(coords, dev)[None], pixels, as_f32(f, dev).reshape(1), c,
        as_f32(R_gt, dev)[None], as_f32(t_gt, dev)[None], cfg,
        idx=None if idx is None else torch.as_tensor(idx)[None], device=dev)
    return loss[0], {k: v[0] for k, v in aux.items()}
