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

``_score_hypotheses``, ``pose_loss`` and ``dsac_train_loss`` belong to the
training slice.
"""

from __future__ import annotations

import torch

from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.fused_scoring import (
    _scores_plain,
    broadcast_pixels,
    soft_inlier_score_select,
    soft_inlier_scores_chunked,
    soft_inlier_scores_kernel,
)
from esac_tpu_torch.geometry.pnp import solve_pnp_minimal
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.refine import refine_soft_inliers
from esac_tpu_torch.ransac.sampling import sample_correspondence_sets
from esac_tpu_torch.ransac.scoring import subsample_cells
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
