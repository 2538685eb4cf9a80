"""Expert-sharded ESAC inference over ``torch.distributed`` ranks
(counterpart of ``esac_tpu/parallel/esac_sharded.py``).

BASELINE config #4: the experts are split over the mesh's ``expert``
axis; every rank draws and scores hypotheses for its local experts only,
refines its local winner, and the global winner is chosen by the argmax
all-reduce :func:`_winner_allreduce` -- a MAX of the scores, a MIN of the
tying global expert indices (ties go to the smallest index), a SUM of the
winner-masked pose.  Where the JAX package issues ``lax.pmax`` /
``lax.psum`` inside ``shard_map``, the port issues
``torch.distributed.all_reduce`` on the expert group; every function here
is collective: each rank of the mesh calls it with the same replicated
arguments (:func:`~esac_tpu_torch.parallel.multihost.lead` broadcasts them
from a dispatcher on rank 0).

Randomness is the port's own contract, stronger than the JAX package's:
each expert's hypothesis sets are drawn by its GLOBAL index (a frame's
generator draws (M, n_hyps, 4) sets on every rank and each rank keeps its
rows -- the ``sel=`` route of ``ransac.esac._per_expert_winners``), and
every rank draws the scoring-cell subsample from the same generator state.
So the sharded result is the single-device ``esac_infer_frames`` result
bit for bit, at every world size; the JAX package folds the shard index
into the key, so its result depends on the mesh.

Two inference paths, as in the JAX package:

- :func:`esac_infer_sharded` / the frames entries -- dense: every rank
  scores all of its local experts' coordinate maps.
- :func:`esac_infer_routed` -- gating-routed: each rank runs the CNNs of
  its top-``capacity`` local experts by gating mass; and
  :func:`make_esac_infer_routed_frames_sharded`, the sharded sibling of
  the routed serving bucket function: the global top-k experts, routed to
  the ranks that hold them through :func:`route_frames_to_experts`.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from esac_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import (
    _per_expert_winners,
    _top_experts,
    routed_serve_capacity,
    select_topk_experts,
)
from esac_tpu_torch.ransac.fused_scoring import broadcast_pixels
from esac_tpu_torch.ransac.kernel import _take, as_f32, frame_generators
from esac_tpu_torch.ransac.refine import refine_soft_inliers
from esac_tpu_torch.utils.precision import resolve_device


def _winner_allreduce(local_score, g_expert, rvec, tvec, M, group=None):
    """The argmax all-reduce over ``group`` (the expert group): MAX of the
    score, then MIN of the global expert index among the ranks that reach
    it (``M`` elsewhere), then SUM of the winner's pose (zeros elsewhere).
    Elementwise over leading frame axes: scores (...,), indices (...,)
    int64, poses (..., 3).  Shared by the dense and routed paths so their
    selection cannot diverge.  Returns (rvec, tvec, winner, best score)."""
    best = local_score.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    win = torch.where(local_score >= best, g_expert, torch.full_like(g_expert, M))
    dist.all_reduce(win, op=dist.ReduceOp.MIN, group=group)
    # A where, not a product: a losing rank's non-finite pose stays out.
    pose = torch.where((g_expert == win)[..., None], torch.cat([rvec, tvec], -1), 0.0)
    dist.all_reduce(pose, op=dist.ReduceOp.SUM, group=group)
    return pose[..., :3], pose[..., 3:], win, best


def _generators(gens, dev) -> list:
    """Per-frame generators: a list of them as given, or seeds."""
    if isinstance(gens, (list, tuple)) and gens and isinstance(gens[0], torch.Generator):
        return list(gens)
    return frame_generators(gens, dev)


def _expert_slice(mesh, M: int) -> tuple[int, int]:
    """(first global expert, count) of this rank's experts of ``M``."""
    E = axis_size(mesh, "expert")
    if M % E:
        raise ValueError(f"M={M} not divisible by expert shards {E}")
    m = M // E
    return axis_index(mesh, "expert") * m, m


def _refine_winner(rvecs, tvecs, best_j, mi, coords, pixels, f, c, cfg, j=None):
    """Refine each frame's winner: map ``mi`` (B,), hypothesis ``best_j``
    at it (or ``j``), on that map -- the arguments ``_serve_frames`` gives
    the refinement."""
    if j is None:
        j = _take(best_j, mi)
    B = mi.shape[0]
    return refine_soft_inliers(
        _take(_take(rvecs, mi), j), _take(_take(tvecs, mi), j), _take(coords, mi),
        broadcast_pixels(pixels, (B,)), f, c, cfg.tau, cfg.beta, iters=cfg.refine_iters)


def _sharded_frames(mesh, generators, coords_all, pixels, f, c, cfg, idx, dev) -> dict:
    """The dense sharded body: coords_all (B, M, N, 3) replicated, of which
    this rank scores its rows; returns replicated rvec, tvec (B, 3),
    expert (B,) and score (B,)."""
    coords_all = as_f32(coords_all, dev)
    B, M = coords_all.shape[:2]
    lo, m = _expert_slice(mesh, M)
    coords = coords_all[:, lo:lo + m]
    pixels, c = as_f32(pixels, dev), as_f32(c, dev)
    f = as_f32(f, dev).expand(B)
    if idx is not None:
        idx = torch.as_tensor(idx, device=dev)[:, lo:lo + m]
    sel = torch.arange(lo, lo + m, device=dev).expand(B, m)
    rvecs, tvecs, best_j, best_s, _, _ = _per_expert_winners(
        _generators(generators, dev), coords, pixels, f, c, cfg, idx=idx, sel=sel, M=M)
    mi = torch.argmax(best_s, dim=1)
    rvec, tvec = _refine_winner(rvecs, tvecs, best_j, mi, coords, pixels, f, c, cfg)
    rvec, tvec, expert, score = _winner_allreduce(
        _take(best_s, mi), lo + mi, rvec, tvec, M, axis_group(mesh, "expert"))
    return {"rvec": rvec, "tvec": tvec, "expert": expert, "score": score}


def esac_infer_sharded(
    mesh,
    generator: torch.Generator,
    coords_all,
    pixels,
    f,
    c,
    cfg: RansacConfig = RansacConfig(),
    gating_logits=None,
    idx=None,
    device=None,
):
    """Sharded multi-expert inference of one frame: coords_all (M, N, 3),
    M divisible by the mesh's expert axis; ``idx`` (M, n_hyps, 4) injects
    the sets.  Returns (rvec, tvec, expert, score), replicated on every
    rank, equal bit for bit to ``esac_infer``'s.  ``gating_logits`` is
    accepted for surface parity and not used: selection is by consensus
    score over all experts (use :func:`esac_infer_routed` for gating that
    prunes compute)."""
    del gating_logits
    dev = resolve_device(device)
    with torch.inference_mode():
        out = _sharded_frames(
            mesh, [generator], as_f32(coords_all, dev)[None], pixels,
            as_f32(f, dev).reshape(1), c, cfg,
            None if idx is None else torch.as_tensor(idx)[None], dev)
    return out["rvec"][0], out["tvec"][0], out["expert"][0], out["score"][0]


def make_esac_infer_sharded_frames_dynamic(mesh, cfg: RansacConfig = RansacConfig(),
                                           device=None):
    """The frames-major sharded entry with the principal point as an
    argument, so one function serves every scene that shares shapes and
    ``cfg``: ``fn(batch, c) -> dict``.  ``batch`` holds ``seed`` (B,) (per-
    frame generator seeds, in place of the JAX package's keys),
    ``coords_all`` (B, M, N, 3), ``pixels`` (B, N, 2) or (N, 2), ``f``
    (B,), and optionally ``idx`` (B, M, n_hyps, 4); the result has
    replicated (B,)-leading 'rvec', 'tvec', 'expert', 'score'.  Collective:
    every rank calls it with the same arguments.  ``fn._cache_size()``
    counts the batch signatures it ran (the JAX package's compiled
    programs)."""
    from esac_tpu_torch.serve.batching import batch_signature

    dev = resolve_device(device)
    seen = set()

    def infer_tree(batch, c):
        seen.add(batch_signature(batch))
        with torch.inference_mode():
            return _sharded_frames(mesh, batch["seed"], batch["coords_all"], batch["pixels"],
                                   batch["f"], c, cfg, batch.get("idx"), dev)

    infer_tree._cache_size = lambda: len(seen)
    return infer_tree


def make_esac_infer_sharded_frames(mesh, c, cfg: RansacConfig = RansacConfig(),
                                   as_tree: bool = False, device=None):
    """:func:`make_esac_infer_sharded_frames_dynamic` with ``c`` bound.
    Returns ``infer(generators, coords_all, pixels, f) -> dict`` (per-frame
    generators or seeds), or with ``as_tree`` the one-argument callable
    over the batch tree -- the dispatcher's contract
    (``serve.dispatcher.make_sharded_serve_fn``)."""
    infer_dyn = make_esac_infer_sharded_frames_dynamic(mesh, cfg, device)

    def infer_tree(batch):
        return infer_dyn(batch, c)

    infer_tree._cache_size = infer_dyn._cache_size
    if as_tree:
        return infer_tree

    def infer(generators, coords_all, pixels, f):
        return infer_tree({"seed": generators, "coords_all": coords_all, "pixels": pixels,
                           "f": f})

    infer._cache_size = infer_dyn._cache_size
    return infer


def esac_infer_sharded_frames(mesh, generators, coords_all, pixels, f, c,
                              cfg: RansacConfig = RansacConfig(), idx=None,
                              device=None) -> dict:
    """Direct call of the frames-major sharded entry (shapes as
    :func:`make_esac_infer_sharded_frames_dynamic` documents): equal bit
    for bit to ``esac_infer_frames`` on the same generators and sets."""
    batch = {"seed": generators, "coords_all": coords_all, "pixels": pixels, "f": f}
    if idx is not None:
        batch["idx"] = idx
    return make_esac_infer_sharded_frames_dynamic(mesh, cfg, device)(batch, c)


def pad_experts_for_mesh(experts, centers, n_shards: int):
    """Pad the experts and the scene centers (M, 3) so the expert count
    divides ``n_shards``, repeating expert 0: ``experts`` is an
    ``nn.ModuleList`` (deep copies are appended), a list, or an
    expert-stacked tensor.  Pad the gating logits per batch with
    :func:`pad_gating_logits`: a slot whose logit is -inf can be selected
    but never wins.  Returns (experts, centers, M_padded)."""
    M = centers.shape[0]
    M_pad = -(-M // n_shards) * n_shards
    extra = M_pad - M
    if extra == 0:
        return experts, centers, M
    if isinstance(experts, torch.Tensor):
        experts = torch.cat([experts, experts[:1].expand((extra,) + experts.shape[1:])])
    elif isinstance(experts, nn.ModuleList):
        experts = nn.ModuleList(list(experts) + [copy.deepcopy(experts[0])
                                                 for _ in range(extra)])
    else:
        experts = list(experts) + [experts[0]] * extra
    centers = torch.cat([centers, centers[:1].expand(extra, centers.shape[1])])
    return experts, centers, M_pad


def pad_gating_logits(logits, M_pad: int):
    """Pad the last (expert) axis of gating logits to ``M_pad`` with -inf
    (the per-batch companion of :func:`pad_experts_for_mesh`)."""
    logits = torch.as_tensor(logits)
    extra = M_pad - logits.shape[-1]
    if extra == 0:
        return logits
    return torch.cat([logits, logits.new_full(logits.shape[:-1] + (extra,), -torch.inf)], -1)


class PaddedGating(nn.Module):
    """A gating net whose logits come out padded to ``M_pad`` experts with
    -inf (:func:`pad_gating_logits`): the module the sharded trainer holds
    for a padded expert stack, its parameters the wrapped net's."""

    def __init__(self, net: nn.Module, M_pad: int):
        super().__init__()
        self.net, self.M_pad = net, M_pad

    def forward(self, images):
        return pad_gating_logits(self.net(images), self.M_pad)


def route_frames_to_experts(selected, num_experts: int, capacity: int):
    """Assign each (frame, selected-expert) pair a slot in that expert's
    block of ``capacity`` frames, dropping overflow deterministically
    (counterpart of ``route_frames_to_experts``).

    ``selected`` (B, K): global expert ids per frame, distinct within a
    frame (:func:`~esac_tpu_torch.ransac.esac.select_topk_experts`).  Drop
    priority is frame index: frame b's slot in expert m's block is the
    number of earlier frames that also selected m, and slots >= capacity
    drop.  Padding lanes come after every real frame, so a pad lane can
    never displace a real pair: the surviving pairs of a request do not
    depend on its bucket.

    Returns ``(kept, pos, slot_frame, slot_valid)``: kept (B, K) bool, the
    pair survived; pos (B, K) int64, its slot (meaningful where kept; clamp
    before gathering); slot_frame (M, C) int64, the frame riding each slot
    (0 where invalid: finite garbage, masked downstream); slot_valid (M, C)
    bool.  One-hot, cumulative sums and comparisons only.
    """
    selected = torch.as_tensor(selected).long()
    onehot = F.one_hot(selected, num_experts)            # (B, K, M)
    mask = onehot.sum(dim=1)                             # (B, M): b selected m
    order = torch.cumsum(mask, dim=0) - mask             # earlier frames first
    kept_bm = (mask == 1) & (order < capacity)
    pos = torch.gather(order, 1, selected)
    kept = torch.gather(kept_bm, 1, selected)
    slots = torch.arange(capacity, device=selected.device)
    slot_hit = kept_bm.T[:, None, :] & (order.T[:, None, :] == slots[None, :, None])  # (M, C, B)
    return kept, pos, torch.argmax(slot_hit.long(), dim=-1), slot_hit.any(dim=-1)


def _local_experts(mesh, experts, M: int) -> tuple[int, list]:
    """(first global index, this rank's experts): ``experts`` holds all M
    or this rank's M / n_expert."""
    lo, m = _expert_slice(mesh, M)
    experts = list(experts)
    if len(experts) == M:
        return lo, experts[lo:lo + m]
    if len(experts) != m:
        raise ValueError(f"{len(experts)} experts: expected all {M} or this rank's {m}")
    return lo, experts


def _check_logits(logits, M: int) -> None:
    if logits.shape[-1] != M:
        raise ValueError(f"gating_logits last dim {logits.shape[-1]} != padded expert count "
                         f"{M}; run pad_gating_logits(logits, {M}) alongside "
                         "pad_experts_for_mesh")


def make_esac_infer_routed_frames_sharded(mesh, experts, centers,
                                          cfg: RansacConfig = RansacConfig(), k: int = 4,
                                          capacity: int | None = None, device=None):
    """Expert-sharded, frames-major, gating-first routed serving: the
    sharded sibling of ``registry.serving.make_routed_scene_bucket_fn``.

    ``experts``: callables images (n, H, W, 3) -> (n, h, w, 3) -- all M, or
    this rank's M / n_expert; ``centers`` (M, 3).  Per frame the global
    top-``k`` experts by gating are selected; each rank runs the CNNs of
    its own selected experts, each over one fixed block of ``capacity``
    frames (:func:`route_frames_to_experts`; default
    ``routed_serve_capacity(cfg, k, M)``), scores the frame's k slots with
    ``cfg.n_hyps * M // k`` hypotheses each (slots it does not hold score
    -inf) and the winner rides :func:`_winner_allreduce`.  Returns
    ``infer(generators, gating_logits, images, focals, pixels, c) -> dict``
    (per-frame generators or seeds; gating_logits (B, M), images, focals
    (B,), pixels (N, 2), c (2,)) with replicated 'rvec', 'tvec', 'expert',
    'score' and 'experts_evaluated' (B, k) (sentinel M where capacity
    dropped the pair): the single-device routed entry's accounting and
    winners.  A frame that lost every slot reports ``selected[0]`` and the
    refinement of its hypothesis 0, as the single-device entry does.
    ``infer._cache_size()`` counts batch signatures."""
    from esac_tpu_torch.serve.batching import batch_signature

    dev = resolve_device(device)
    centers = as_f32(centers, dev)
    M = centers.shape[0]
    lo, local = _local_experts(mesh, experts, M)
    m = len(local)
    k = min(k, M)
    cap = capacity if capacity is not None else routed_serve_capacity(cfg, k, M)
    cfg_k = dataclasses.replace(cfg, n_hyps=max(1, cfg.n_hyps * M // k))
    group = axis_group(mesh, "expert")
    seen = set()

    def infer(generators, gating_logits, images, focals, pixels, c):
        logits = as_f32(gating_logits, dev)
        _check_logits(logits, M)
        imgs = as_f32(images, dev)
        seen.add(batch_signature({"gating_logits": logits, "image": imgs}))
        B = imgs.shape[0]
        with torch.inference_mode():
            selected = select_topk_experts(logits, k)
            kept, pos, slot_frame, _ = route_frames_to_experts(selected, M, cap)
            blocks = torch.stack([net(imgs[slot_frame[lo + i]]) for i, net in enumerate(local)])
            blocks = blocks.reshape(m, cap, -1, 3) + centers[lo:lo + m, None, None, :]
            live = kept & (selected >= lo) & (selected < lo + m)
            coords = blocks[(selected - lo).clamp(0, m - 1), pos.clamp(max=cap - 1)]
            f = as_f32(focals, dev).expand(B)
            pixels_d, c_d = as_f32(pixels, dev), as_f32(c, dev)
            rvecs, tvecs, best_j, best_s, _, _ = _per_expert_winners(
                _generators(generators, dev), coords, pixels_d, f, c_d, cfg_k, sel=selected,
                M=M)
            best_s = torch.where(live, best_s, -torch.inf)
            mi = torch.argmax(best_s, dim=1)
            j = torch.where(_take(live, mi), _take(best_j, mi), 0)
            rvec, tvec = _refine_winner(rvecs, tvecs, best_j, mi, coords, pixels_d, f, c_d,
                                        cfg_k, j=j)
            # A rank with no live slot for a frame loses the all-reduce,
            # except when the frame lost every slot everywhere: then the
            # rank holding selected[0] claims it (all scores -inf), the
            # single-device entry's failed-frame output.
            owner0 = (selected[:, 0] >= lo) & (selected[:, 0] < lo + m)
            g_expert = torch.where(live.any(1), _take(selected, mi),
                                   torch.where(owner0, selected[:, 0], M))
            rvec, tvec, expert, score = _winner_allreduce(
                _take(best_s, mi), g_expert, rvec, tvec, M + 1, group)
            # Each (frame, slot) pair lives on one rank: MIN recovers it.
            evaluated = torch.where(live, selected, M)
            dist.all_reduce(evaluated, op=dist.ReduceOp.MIN, group=group)
        return {"rvec": rvec, "tvec": tvec, "expert": expert, "score": score,
                "experts_evaluated": evaluated}

    infer._cache_size = lambda: len(seen)
    return infer


def esac_infer_routed(mesh, experts, centers, capacity: int,
                      cfg: RansacConfig = RansacConfig(), device=None):
    """Gating-routed sharded inference (config #4): each rank runs the CNNs
    of its top-``capacity`` local experts by gating mass per frame.

    ``experts``: callables images (n, H, W, 3) -> (n, h, w, 3), all M or
    this rank's M / n_expert (pad with :func:`pad_experts_for_mesh`);
    ``centers`` (M, 3).  Returns ``infer(generators, gating_logits, images,
    focals, pixels, c) -> dict`` (per-frame generators or seeds;
    gating_logits (B, M) and images (B, H, W, 3) replicated, focals (B,),
    pixels (N, 2), c (2,)) with replicated 'rvec', 'tvec' (B, 3), 'expert'
    (B,), 'score' (B,) and 'experts_evaluated' (B, n_expert * capacity),
    the global ids whose CNN ran for each frame.  A rank's selected experts
    run in ascending global order, each over the frames that selected it,
    with ``cfg.n_hyps`` hypotheses drawn by global index; only
    ``pad_gating_logits``' -inf entries are barred from winning.  With
    every local expert selected this is ``esac_infer_frames`` on the
    gating and expert forwards bit for bit."""
    dev = resolve_device(device)
    centers = as_f32(centers, dev)
    M = centers.shape[0]
    lo, local = _local_experts(mesh, experts, M)
    m = len(local)
    cap = min(capacity, m)
    E, e = axis_size(mesh, "expert"), axis_index(mesh, "expert")
    group = axis_group(mesh, "expert")

    def infer(generators, gating_logits, images, focals, pixels, c):
        logits = as_f32(gating_logits, dev)
        _check_logits(logits, M)
        imgs = as_f32(images, dev)
        B = imgs.shape[0]
        with torch.inference_mode():
            l_local = logits[:, lo:lo + m]
            top = torch.sort(_top_experts(torch.softmax(logits, -1)[:, lo:lo + m], cap),
                             dim=-1).values                          # (B, cap) local ids
            is_real = torch.isfinite(torch.gather(l_local, 1, top))
            coords = None
            for i, net in enumerate(local):
                hit = top == i                                       # (B, cap)
                frames = hit.any(1).nonzero()[:, 0]
                if frames.numel() == 0:
                    continue
                out = net(imgs[frames]).reshape(len(frames), -1, 3) + centers[lo + i]
                if coords is None:
                    coords = out.new_zeros((B, cap) + out.shape[1:])
                coords[frames, hit[frames].int().argmax(1)] = out
            f = as_f32(focals, dev).expand(B)
            pixels_d, c_d = as_f32(pixels, dev), as_f32(c, dev)
            gm = lo + top
            rvecs, tvecs, best_j, best_s, _, _ = _per_expert_winners(
                _generators(generators, dev), coords, pixels_d, f, c_d, cfg, sel=gm, M=M)
            best_s = torch.where(is_real, best_s, -torch.inf)
            mi = torch.argmax(best_s, dim=1)
            j = torch.where(_take(is_real, mi), _take(best_j, mi), 0)
            rvec, tvec = _refine_winner(rvecs, tvecs, best_j, mi, coords, pixels_d, f, c_d,
                                        cfg, j=j)
            rvec, tvec, expert, score = _winner_allreduce(
                _take(best_s, mi), _take(gm, mi), rvec, tvec, M, group)
            # The evaluated sets by a scatter and a SUM (no all_gather).
            slots = torch.zeros((B, E, cap), dtype=gm.dtype, device=dev)
            slots[:, e] = gm
            dist.all_reduce(slots, op=dist.ReduceOp.SUM, group=group)
        return {"rvec": rvec, "tvec": tvec, "expert": expert, "score": score,
                "experts_evaluated": slots.reshape(B, E * cap)}

    return infer
