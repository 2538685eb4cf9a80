"""Dense multi-expert ESAC inference (counterpart of the inference entries of
``esac_tpu/ransac/esac.py``).

Every expert gets ``cfg.n_hyps`` hypotheses (the reference's "256
hyp/expert", BASELINE config #2), each scored on its own expert's
coordinate map; the best-supported hypothesis across experts wins and is
refined.  All B x M (frame, expert) problems of a dispatch are one batched
P3P solve and one scoring-kernel launch.

Still to port (ROADMAP): top-k, routed and prior-slot entries, and the
training loss.
"""

from __future__ import annotations

import torch

from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.fused_scoring import broadcast_pixels
from esac_tpu_torch.ransac.kernel import (
    _infer_winner,
    _take,
    as_f32,
    generate_hypotheses,
)
from esac_tpu_torch.ransac.refine import refine_soft_inliers
from esac_tpu_torch.ransac.sampling import sample_correspondence_sets
from esac_tpu_torch.ransac.scoring import subsample_cells
from esac_tpu_torch.utils.precision import resolve_device


def _per_expert_winners(generators, coords_all, pixels, f, c, cfg, idx=None):
    """n_hyps hypotheses per expert, then score+select per expert.

    coords_all (B, M, N, 3), pixels (N, 2) or (B, N, 2), f (B,), one
    generator per frame; ``idx`` (B, M, n_hyps, 4) injects the sets.
    Returns ``(rvecs, tvecs, best_j, best_s, scores)``: poses
    (B, M, n_hyps, 3), per-expert winner index and score (B, M) -- scaled
    by N / score_cells when subsampling -- and the (B, M, n_hyps) scores,
    None under "fused_select".  The global winner is
    ``m* = argmax(best_s)``, ``j* = best_j[m*]``: the flat first-max argmax
    over all M x n_hyps scores, ties included.
    """
    B, M, N = coords_all.shape[:3]
    if idx is None:
        idx = torch.stack([sample_correspondence_sets(g, cfg.n_hyps, N, (M,))
                           for g in generators])
    fBM = f[:, None].expand(B, M)
    rvecs, tvecs = generate_hypotheses(None, coords_all, pixels, fBM, c, cfg, idx=idx)
    coords_s, pixels_s, scale = subsample_cells(generators, coords_all, pixels,
                                                cfg.score_cells)
    best_j, best_s, scores = _infer_winner(rvecs, tvecs, coords_s, pixels_s, fBM, c, cfg)
    return rvecs, tvecs, best_j, best_s * scale, None if scores is None else scores * scale


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
