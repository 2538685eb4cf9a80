"""Multi-expert ESAC (counterpart of ``esac_tpu/ransac/esac.py``): dense,
top-k, routed and prior-slot inference, and the end-to-end training loss.

Every expert gets ``cfg.n_hyps`` hypotheses (the reference's "256
hyp/expert", BASELINE config #2), each scored on its own expert's
coordinate map; the best-supported hypothesis across experts wins and is
refined.  All B x M (frame, expert) problems of a dispatch are one batched
P3P solve and one scoring-kernel launch.

The serving variants share that one path (:func:`_serve_frames`):

- top-k (:func:`esac_infer_topk_frames`): the dense path over the k maps
  with the largest gating logits;
- routed (:func:`esac_infer_routed_frames`): the K maps each frame's
  capacity dispatch kept, ``cfg.n_hyps * M // K`` hypotheses each, dropped
  (frame, expert) pairs scored ``-inf``.  A frame's generator draws
  (M, nh, 4) sets and the selected experts' rows are kept, so every
  expert's stream is keyed by its global index, as
  ``jax.random.split(key, M)[sel]`` keys it in the reference: at K = M
  the routed path is the dense path draw for draw, bit for bit;
- prior slot (:func:`esac_infer_frames_prior`,
  :func:`esac_infer_routed_frames_prior`): a frame's P motion-prior poses
  scored on every (live) map through :func:`_score_hypotheses`' math, on
  the SAME cell subsample as the sampled stream, replacing an expert's
  streamed winner only on a strictly greater score, so an all-invalid mask
  gives the plain entry's result bit for bit.

After sampling the path is three stages (:data:`_SERVE_CHAIN`), which a
bucket function's graph cache (``registry.graphs``) replays as CUDA graphs
on the card; called without one, they run eagerly.

:func:`esac_train_loss_frames` is the training loss, differentiable with
respect to the coordinates and the gating logits: "dense" weighs every
expert's expected pose loss by its gating probability (an exact gating
gradient), "sampled" draws an expert per hypothesis and carries the gating
gradient by a REINFORCE term.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from esac_tpu_torch.obs.trace import serve_stage
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.fused_scoring import broadcast_pixels
from esac_tpu_torch.geometry.camera import reprojection_errors
from esac_tpu_torch.geometry.pnp import solve_pnp_minimal
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.kernel import (
    _infer_winner,
    _refine_hypotheses,
    _score_cells,
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
from esac_tpu_torch.ransac.scoring import (
    draw_cells,
    gather_cells,
    soft_inlier_score,
    subsample_cells,
)
from esac_tpu_torch.utils.precision import resolve_device


def _expert_sets(generators, n_hyps, N, M):
    """Each frame's generator draws (M, n_hyps, 4) correspondence sets, one
    stream per expert index.  Returns (B, M, n_hyps, 4)."""
    return torch.stack([sample_correspondence_sets(g, n_hyps, N, (M,)) for g in generators])


def _expert_hypotheses(generators, coords_all, pixels, f, c, cfg, idx=None):
    """n_hyps hypotheses per expert: coords_all (B, M, N, 3), pixels (N, 2)
    or (B, N, 2), f (B,), one generator per frame; ``idx``
    (B, M, n_hyps, 4) injects the sets.  Returns poses (B, M, n_hyps, 3)
    and the focal per problem (B, M)."""
    B, M, N = coords_all.shape[:3]
    if idx is None:
        idx = _expert_sets(generators, cfg.n_hyps, N, M)
    fBM = f[:, None].expand(B, M)
    rvecs, tvecs = generate_hypotheses(None, coords_all, pixels, fBM, c, cfg, idx=idx)
    return rvecs, tvecs, fBM


def _routed_sets(generators, n_hyps, N, M, sel):
    """Correspondence sets of the selected experts: each frame's generator
    draws (M, n_hyps, 4) -- one stream per GLOBAL expert index, as
    :func:`_expert_sets` draws them for the dense path -- and the rows of
    ``sel`` (B, K) are kept.  Returns (B, K, n_hyps, 4)."""
    idx = _expert_sets(generators, n_hyps, N, M)
    return idx[torch.arange(len(generators), device=idx.device)[:, None], sel.to(idx.device)]


def _per_expert_winners(generators, coords_all, pixels, f, c, cfg, idx=None, sel=None,
                        M=None):
    """n_hyps hypotheses per map, then score+select per map.

    Shapes as in :func:`_expert_hypotheses`; ``sel`` (B, K) names the
    global expert (of ``M``) behind each of the K maps of a routed
    dispatch, whose sets :func:`_routed_sets` draws; None for the dense
    path, where map k is expert k.  Returns
    ``(rvecs, tvecs, best_j, best_s, scores, cells)``: poses (B, K, n_hyps,
    3), per-map winner index and score (B, K) -- scaled by N / score_cells
    when subsampling --, the (B, K, n_hyps) scores (None under
    "fused_select"), and the cell subsample ``(coords_s, pixels_s, scale)``
    the scores were taken on (the prior slot scores on the same cells).
    The global winner is ``m* = argmax(best_s)``, ``j* = best_j[m*]``: the
    flat first-max argmax over all K x n_hyps scores, ties included.
    Marks the "sampling" and "hypotheses" stages (``obs.serve_stage``).
    """
    K, N = coords_all.shape[1:3]
    if idx is None:
        idx = (_expert_sets(generators, cfg.n_hyps, N, K) if sel is None
               else _routed_sets(generators, cfg.n_hyps, N, M, sel))
    serve_stage("sampling")
    rvecs, tvecs, fBM = _expert_hypotheses(generators, coords_all, pixels, f, c, cfg, idx)
    serve_stage("hypotheses")
    cells = subsample_cells(generators, coords_all, pixels, cfg.score_cells)
    return (rvecs, tvecs) + _map_winners(rvecs, tvecs, cells, fBM, c, cfg) + (cells,)


def _map_winners(rvecs, tvecs, cells, f, c, cfg):
    """Score and select on each map over the cells ``(coords_s, pixels_s,
    scale)``: the per-map winner (B, K), its score and every score (None
    under "fused_select"), the scores times ``scale``."""
    best_j, best_s, scores = _infer_winner(rvecs, tvecs, cells[0], cells[1], f, c, cfg)
    return best_j, best_s * cells[2], None if scores is None else scores * cells[2]


def _prior_slot_winner(prior_rvecs, prior_tvecs, prior_valid, cells, f, c, cfg):
    """Best of each frame's P motion-prior poses on each of its K maps
    (counterpart of ``_prior_slot_winner``): prior_rvecs/tvecs (B, P, 3),
    prior_valid (B, P) bool, ``cells`` the sampled stream's subsample
    (coords (B, K, n, 3), pixels, scale), f (B, K).  The priors score
    through :func:`_score_cells`, the math the sampled stream's scores are
    comparable with: under "pallas" one launch of the scoring kernel at
    H = P.  Invalid slots mask to ``-inf``.  Returns (pj, ps) (B, K): the
    winning prior and its masked score."""
    coords_s = cells[0]
    lead = coords_s.shape[:2] + prior_rvecs.shape[1:]
    scores = _score_cells(prior_rvecs[:, None].expand(lead), prior_tvecs[:, None].expand(lead),
                          cells, f, c, cfg)
    masked = torch.where(prior_valid[:, None, :], scores, -torch.inf)
    pj = torch.argmax(masked, dim=-1)
    return pj, torch.gather(masked, -1, pj[..., None])[..., 0]


# The RansacConfig fields the served chain after sampling reads (the key
# of its CUDA graphs, with the inputs' shapes; ``registry.graphs``).
_CHAIN_FIELDS = ("polish_iters", "scoring_impl", "score_chunk", "score_cells", "tau",
                 "beta", "refine_iters")


def _hypotheses_stage(cfg, x, _):
    """The "hypotheses" stage of the served chain: gather and P3P + polish
    of every set ``x["idx"]`` (B, K, nh, 4) on its map.  Returns the poses
    (B, K, nh, 3)."""
    B, K = x["coords"].shape[:2]
    rvecs, tvecs = generate_hypotheses(None, x["coords"], x["pixels"],
                                       x["f"][:, None].expand(B, K), x["c"], cfg, idx=x["idx"])
    return {"rvecs": rvecs, "tvecs": tvecs}


def _scoring_stage(cfg, x, h):
    """The "scoring" stage: the cell subsample's gathers (``x["cells"]``,
    drawn in sampling), score and select per map, the dropped slots and
    the prior slot, the argmax over maps and the winner's takes."""
    coords, c = x["coords"], x["c"]
    B, K = coords.shape[:2]
    fBK = x["f"][:, None].expand(B, K)
    cells = gather_cells(coords, x["pixels"], x.get("cells"))
    best_j, best_s, scores = _map_winners(h["rvecs"], h["tvecs"], cells, fBK, c, cfg)
    live = x.get("live")
    if live is not None:
        best_s = torch.where(live, best_s, -torch.inf)
        if scores is not None:
            scores = torch.where(live[..., None], scores, -torch.inf)
    ext_s = best_s
    prior = "prior_rvec" in x
    if prior:
        p_rv, p_tv = x["prior_rvec"], x["prior_tvec"]
        pj, ps = _prior_slot_winner(p_rv, p_tv, x["prior_valid"], cells, fBK, c, cfg)
        if live is not None:
            ps = torch.where(live, ps, -torch.inf)
        is_prior = ps > best_s  # strict: the sampled slots come first
        ext_s = torch.where(is_prior, ps, best_s)
    mi = torch.argmax(ext_s, dim=1)
    j = _take(best_j, mi)
    if live is not None:
        j = torch.where(_take(live, mi), j, torch.zeros_like(j))
    rv0, tv0 = _take(_take(h["rvecs"], mi), j), _take(_take(h["tvecs"], mi), j)
    s = {"mi": mi, "ext_s": ext_s, "scores": scores}
    if prior:
        s["hit"], s["slot"] = _take(is_prior, mi), _take(pj, mi)
        rv0 = torch.where(s["hit"][:, None], _take(p_rv, s["slot"]), rv0)
        tv0 = torch.where(s["hit"][:, None], _take(p_tv, s["slot"]), tv0)
    s.update(rv0=rv0, tv0=tv0, coords_w=_take(coords, mi))
    return s


def _refine_stage(cfg, x, s):
    """The "refine" stage: IRLS refinement of each frame's winner on its
    map, then the result's few ops."""
    coords, sel, mi = x["coords"], x.get("sel"), s["mi"]
    B, N = coords.shape[0], coords.shape[2]
    M = x["gating_logits"].shape[-1]
    rvec, tvec = refine_soft_inliers(
        s["rv0"], s["tv0"], s["coords_w"], broadcast_pixels(x["pixels"], (B,)), x["f"], x["c"],
        cfg.tau, cfg.beta, iters=cfg.refine_iters)
    best = _take(s["ext_s"], mi)
    out = {
        "rvec": rvec,
        "tvec": tvec,
        "expert": mi if sel is None else _take(sel, mi),
        "gating_probs": torch.softmax(x["gating_logits"], dim=-1),
        "inlier_frac": best / N,
    }
    if sel is not None:
        out["experts_evaluated"] = torch.where(x["live"], sel, torch.full_like(sel, M))
    if "hit" in s:
        out["prior_hit"] = s["hit"]
        out["prior_slot"] = torch.where(s["hit"], s["slot"],
                                        torch.full_like(s["slot"], x["prior_rvec"].shape[1]))
    if s["scores"] is None:
        out["score"] = best
    else:
        out["scores"] = s["scores"]
    return out


_SERVE_CHAIN = (("hypotheses", _hypotheses_stage), ("scoring", _scoring_stage),
                ("refine", _refine_stage))


def _serve_frames(generators, gating_logits, coords, pixels, f, c, cfg, idx, device,
                  routing=None, prior=None, graphs=None) -> dict:
    """The inference path every serving entry shares.

    coords (B, K, N, 3): the K maps of each frame -- every expert's for the
    dense path (``routing`` None, K = M), the capacity dispatch's for a
    routed one: ``routing = (selected (B, K), kept (B, K))``, global expert
    ids and the pairs that survived capacity; each map then gets
    ``cfg.n_hyps * M // K`` hypotheses and a dropped pair scores ``-inf``
    (a frame whose every pair dropped refines hypothesis 0 of slot 0: the
    reference's flat-argmax failure output).  ``prior = (rvecs, tvecs,
    valid)`` (B, P, 3), (B, P, 3), (B, P) adds the prior slot.

    Sampling (the sets, then the cell subsample, from each frame's
    generator) runs here; the chain after it, "hypotheses", "scoring" and
    "refine" (:data:`_SERVE_CHAIN`), runs on the call's tensors, made
    contiguous, through ``graphs.chain`` -- a bucket function's
    ``registry.graphs.ServeGraphs``, which replays each stage as a CUDA
    graph on the card -- or, without ``graphs``, eagerly.  Marks the
    "sampling" to "refine" stages of a traced dispatch
    (``obs.serve_stage``) between the stages; the marks change no result.
    """
    dev = resolve_device(device)
    coords = as_f32(coords, dev)
    B, K, N = coords.shape[:3]
    x = {"coords": coords, "pixels": as_f32(pixels, dev), "f": as_f32(f, dev).expand(B),
         "c": as_f32(c, dev), "gating_logits": as_f32(gating_logits, dev)}
    M = x["gating_logits"].shape[-1]
    if routing is not None:
        x["sel"] = torch.as_tensor(routing[0], device=dev).long()
        x["live"] = torch.as_tensor(routing[1], device=dev).bool()
        cfg = dataclasses.replace(cfg, n_hyps=max(1, cfg.n_hyps * M // K))
    if prior is not None:
        x["prior_rvec"], x["prior_tvec"] = as_f32(prior[0], dev), as_f32(prior[1], dev)
        x["prior_valid"] = torch.as_tensor(prior[2], device=dev).bool()
    injected = idx is not None
    if idx is None:
        idx = (_expert_sets(generators, cfg.n_hyps, N, K) if routing is None
               else _routed_sets(generators, cfg.n_hyps, N, M, x["sel"]))
    x["idx"] = torch.as_tensor(idx, device=dev).long()
    sub = draw_cells(generators, N, cfg.score_cells)  # after the sets, as in training
    if sub is not None:
        x["cells"] = sub.to(dev)
    x = {k: v.contiguous() for k, v in x.items()}
    serve_stage("sampling")
    key = (injected,) + tuple(getattr(cfg, name) for name in _CHAIN_FIELDS)

    def eager(stage, fn, prev, result=False):
        return fn(x, prev)

    got = None
    with contextlib.nullcontext() if graphs is None else graphs.chain(x, key) as run:
        for stage, fn in _SERVE_CHAIN:
            got = (run or eager)(stage, functools.partial(fn, cfg), got,
                                 result=stage == _SERVE_CHAIN[-1][0])
            serve_stage(stage)
    return got


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
    graphs=None,
) -> dict:
    """B frames x M experts in one dispatch.

    gating_logits (B, M), coords_all (B, M, N, 3), pixels (N, 2) shared or
    (B, N, 2), f (B,) or scalar, c (2,), one generator per frame (on
    ``device``).  Returns per-frame 'rvec', 'tvec', 'expert',
    'gating_probs', 'inlier_frac' and 'scores' (B, M, n_hyps) -- or the
    winner's 'score' under "fused_select".  Selection is by consensus
    score; the gate is reported, not used.  ``graphs`` (a bucket
    function's ``registry.graphs.ServeGraphs``; every serving entry takes
    it) replays the chain after sampling as CUDA graphs on the card.
    """
    return _serve_frames(generators, gating_logits, coords_all, pixels, f, c, cfg, idx,
                         device, graphs=graphs)


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


def esac_infer_frames_prior(
    generators: list[torch.Generator],
    gating_logits,
    coords_all,
    pixels,
    f,
    c,
    prior_rvecs,
    prior_tvecs,
    prior_valid,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
    graphs=None,
) -> dict:
    """:func:`esac_infer_frames` with a prior-hypothesis slot (counterpart
    of ``esac_infer_frames_prior``): each frame's P motion-prior poses
    ``prior_rvecs`` / ``prior_tvecs`` (B, P, 3) with a ``prior_valid``
    (B, P) mask are scored on every expert's map, on the sampled stream's
    cell subsample, and replace an expert's streamed winner only on a
    strictly greater score.  The sampled stream is :func:`esac_infer_frames`'
    draw for draw; with an all-invalid mask every output is bit-equal to
    it.  Extra outputs: 'prior_hit' (B,) and 'prior_slot' (B,), the winning
    prior or P when the sampled stream won."""
    return _serve_frames(generators, gating_logits, coords_all, pixels, f, c, cfg, idx,
                         device, prior=(prior_rvecs, prior_tvecs, prior_valid),
                         graphs=graphs)


def esac_infer_prior(
    generator: torch.Generator,
    gating_logits,
    coords_all,
    pixels,
    f,
    c,
    prior_rvecs,
    prior_tvecs,
    prior_valid,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
) -> dict:
    """One frame: gating_logits (M,), coords_all (M, N, 3), pixels (N, 2),
    priors (P, 3), (P, 3), (P,); ``idx`` (M, n_hyps, 4).
    :func:`esac_infer_frames_prior` on a batch of one."""
    dev = resolve_device(device)
    out = esac_infer_frames_prior(
        [generator], as_f32(gating_logits, dev)[None], as_f32(coords_all, dev)[None],
        pixels, as_f32(f, dev).reshape(1), c, as_f32(prior_rvecs, dev)[None],
        as_f32(prior_tvecs, dev)[None], torch.as_tensor(prior_valid, device=dev)[None], cfg,
        idx=None if idx is None else torch.as_tensor(idx)[None], device=dev)
    return {k: v[0] for k, v in out.items()}


def _top_experts(gating_logits: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest logits' expert ids in ``jax.lax.top_k``'s order:
    descending, equal logits by ascending index (a stable descending sort;
    ``torch.topk`` leaves the order of ties unspecified, and the zero
    logits of an ungated preset are all ties)."""
    return torch.sort(gating_logits, dim=-1, descending=True, stable=True).indices[..., :k]


def select_topk_experts(gating_logits, k: int) -> torch.Tensor:
    """Per-frame top-``k`` expert ids by gating logit, sorted ascending by
    global index (counterpart of ``select_topk_experts``): gating_logits
    (..., M) -> (..., k) int64.  With every expert selected the layout is
    0..M-1, which is what makes routed K = M the dense path bit for bit."""
    return torch.sort(_top_experts(torch.as_tensor(gating_logits), k), dim=-1).values


def routed_serve_capacity(cfg: RansacConfig, k: int, num_experts: int) -> int:
    """Per-expert frame capacity of the routed serving path (counterpart of
    ``routed_serve_capacity``): ``cfg.serve_capacity`` when positive, else
    twice the balanced per-expert load of the largest frame bucket,
    ceil(2 k max_bucket / M); at least 2 and at most that bucket.  One
    constant per (cfg, k) -- never a function of the dispatch's bucket --
    so the (frame, expert) pairs that survive capacity, and the expert
    CNNs' batch width, are the same in every bucket."""
    big = max(2, max(cfg.frame_buckets))
    cap = cfg.serve_capacity if cfg.serve_capacity > 0 else -(-2 * k * big // num_experts)
    return max(2, min(cap, big))


def esac_infer_topk_frames(
    generators: list[torch.Generator],
    gating_logits,
    coords_all,
    pixels,
    f,
    c,
    cfg: RansacConfig = RansacConfig(),
    k: int = 4,
    idx=None,
    device=None,
) -> dict:
    """Gating-pruned inference (counterpart of ``esac_infer_topk_frames``):
    per frame only the ``k`` experts with the largest logits (in
    :func:`_top_experts`' order) generate and score hypotheses, through
    :func:`esac_infer_frames` over their gathered maps; ``idx``
    (B, k, n_hyps, 4) injects the sets.  'expert' is a global index,
    'experts_evaluated' (B, k) the pruned set, 'gating_probs' the full
    M-way softmax; 'scores' rows follow 'experts_evaluated'."""
    dev = resolve_device(device)
    gating_logits, coords_all = as_f32(gating_logits, dev), as_f32(coords_all, dev)
    top = _top_experts(gating_logits, min(k, gating_logits.shape[-1]))
    frame = torch.arange(top.shape[0], device=dev)[:, None]
    out = esac_infer_frames(generators, gating_logits[frame, top], coords_all[frame, top],
                            pixels, f, c, cfg, idx=idx, device=dev)
    return {**out, "expert": _take(top, out["expert"]), "experts_evaluated": top,
            "gating_probs": torch.softmax(gating_logits, dim=-1)}


def esac_infer_topk(
    generator: torch.Generator,
    gating_logits,
    coords_all,
    pixels,
    f,
    c,
    cfg: RansacConfig = RansacConfig(),
    k: int = 4,
    idx=None,
    device=None,
) -> dict:
    """One frame: gating_logits (M,), coords_all (M, N, 3), pixels (N, 2);
    ``idx`` (k, n_hyps, 4).  :func:`esac_infer_topk_frames` on a batch of
    one."""
    dev = resolve_device(device)
    out = esac_infer_topk_frames(
        [generator], as_f32(gating_logits, dev)[None], as_f32(coords_all, dev)[None],
        pixels, as_f32(f, dev).reshape(1), c, cfg, k=k,
        idx=None if idx is None else torch.as_tensor(idx)[None], device=dev)
    return {key: v[0] for key, v in out.items()}


def esac_infer_routed_frames(
    generators: list[torch.Generator],
    gating_logits,
    coords_sel,
    selected,
    kept,
    pixels,
    f,
    c,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
    graphs=None,
) -> dict:
    """The RANSAC stage of gating-first routed serving (counterpart of
    ``esac_infer_routed_frames``): gating_logits (B, M); coords_sel
    (B, K, N, 3) the selected experts' maps, gathered back from the
    per-expert capacity blocks; selected (B, K) global expert ids,
    ascending (:func:`select_topk_experts`); kept (B, K) bool, False where
    the capacity dispatch dropped the pair; pixels (N, 2) or (B, N, 2);
    f (B,) or scalar; c (2,).  ``idx`` (B, K, nh, 4) injects the sets.

    Each evaluated expert runs nh = max(1, n_hyps * M // K) hypotheses, so
    a frame's budget stays M * n_hyps whatever K; all B x K problems score
    in one kernel launch.  Dropped slots score ``-inf`` (in 'scores' too)
    and show in 'experts_evaluated' as the sentinel M.  At K = M with
    nothing dropped the result is :func:`esac_infer_frames`' bit for bit.
    """
    return _serve_frames(generators, gating_logits, coords_sel, pixels, f, c, cfg, idx,
                         device, routing=(selected, kept), graphs=graphs)


def esac_infer_routed_frames_prior(
    generators: list[torch.Generator],
    gating_logits,
    coords_sel,
    selected,
    kept,
    pixels,
    f,
    c,
    prior_rvecs,
    prior_tvecs,
    prior_valid,
    cfg: RansacConfig = RansacConfig(),
    idx=None,
    device=None,
    graphs=None,
) -> dict:
    """:func:`esac_infer_routed_frames` with the prior slot (counterpart of
    ``esac_infer_routed_frames_prior``): the P priors of each frame
    (B, P, 3), (B, P, 3), (B, P) score on each LIVE slot's map -- a dropped
    slot's prior scores ``-inf`` -- as in :func:`esac_infer_frames_prior`;
    with an all-invalid mask the result is :func:`esac_infer_routed_frames`'
    bit for bit.  Extra outputs 'prior_hit' and 'prior_slot'."""
    return _serve_frames(generators, gating_logits, coords_sel, pixels, f, c, cfg, idx,
                         device, routing=(selected, kept),
                         prior=(prior_rvecs, prior_tvecs, prior_valid), graphs=graphs)


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
