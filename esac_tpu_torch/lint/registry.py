"""The traced entry points of the port (counterpart of
``esac_tpu/lint/registry.py``).

Each entry names a compiled-surface counterpart of the JAX registry -- the
hypothesis loop, the scoring impls, the P3P solve, the routed and prior
entries, the bucket functions, the retriever, the expert-sharded paths --
and a build function ``build(variant) -> (fn, args)``.  The graph audit
(:mod:`~.graph_audit`) records the aten graph of ``fn(*args)`` on the CPU
at the JAX registry's tiny shapes (16 cells for the gradient entries, 128
for inference), once per ``variant`` (0 and 1: the same shapes, other
contents), and holds the two graphs equal (J2).  Randomness is injected: every sampling entry takes
``idx=`` sets drawn here from numpy, so no ``torch.Generator`` draw is
traced.

- ``pinned=True``: geometry and scoring; J3 holds their forward program to
  the precision contract (no mm family, no long sum, no half precision).
  The CNN-bearing entries are audited for ops and shapes only.
- ``grad=True``: the build traces ``torch.autograd.grad`` inside ``fn``, so
  the graph holds the forward, a backward marker, and the backward (the
  J5 census reads the part after the marker).  The ``*_grad`` names equal
  the gradient witnesses' (:mod:`~.gradcheck`).
- ``allow``: the graph findings an entry has on purpose, each with its
  reason (the port's inline suppression for J1 / J3); an allowance that
  matches nothing is reported stale.

On the CPU the kernel wrappers take their plain versions, so the "pallas"
and "fused_select" entries record the plain versions' graphs (their notes
say so): the hand-written kernels are held to those on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

N_GRAD_CELLS = 16
N_INFER_CELLS = 128

# The marker between a gradient entry's forward and its backward: an
# assertion op no entry point issues on its own.
BACKWARD_MARK = "torch-lint backward"

# The one reduction over the cells a pinned forward keeps on purpose.
_CELL_SUM = ("_scores_plain, the select kernel's plain version that the CPU "
             "runs in its place (and the 'fused' impl on the card): one "
             "torch.sum over the cells per hypothesis, an innermost contiguous "
             "reduction per output row, held bit-equal across frame buckets by "
             "chip_smoke.py phase 5; on the card this entry launches the select "
             "kernel, whose partial pass sums 32-cell chunks in a fixed order")


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str
    pinned: bool            # J3: the forward keeps the precision contract
    build: Callable         # (variant) -> (fn, args)
    note: str = ""
    grad: bool = False      # fn differentiates: forward, marker, backward
    allow: tuple = ()       # ((rule, key, reason), ...)


def _rng(variant: int):
    import numpy as np

    return np.random.default_rng(1000 + variant)


def _t(x, dtype=None):
    import torch

    return torch.as_tensor(x, dtype=dtype if dtype is not None else torch.float32)


def _geom_inputs(variant: int, n_cells: int = N_GRAD_CELLS):
    """coords (N, 3), pixels (N, 2), f, c: numpy draws per variant."""
    rng = _rng(variant)
    coords = _t(rng.uniform(-1.0, 1.0, (n_cells, 3)) + [0.0, 0.0, 3.0])
    pixels = _t(rng.uniform(0.0, 64.0, (n_cells, 2)))
    return coords, pixels, _t(60.0), _t([32.0, 24.0])


def _sets(variant: int, lead: tuple, n_hyps: int, n_cells: int):
    """Injected correspondence sets (lead..., n_hyps, 4): 4 distinct cells
    a set."""
    import numpy as np
    import torch

    rng = _rng(variant + 7)
    n = int(np.prod(lead + (n_hyps,)))
    idx = np.stack([rng.permutation(n_cells)[:4] for _ in range(n)])
    return torch.as_tensor(idx.reshape(lead + (n_hyps, 4)), dtype=torch.int64)


def mark_backward(x):
    """Record the forward/backward boundary in a traced gradient entry."""
    import torch

    torch.ops.aten._assert_async.msg(torch.ones((), dtype=torch.bool), BACKWARD_MARK)
    return x


def _grad(loss, *inputs):
    import torch

    return torch.autograd.grad(mark_backward(loss), list(inputs), allow_unused=True)


def _leaf(x):
    return x.detach().clone().requires_grad_(True)


def _rvec_tvec(variant: int, n: int):
    rng = _rng(variant + 3)
    rv = _t([0.1, -0.05, 0.02] + rng.uniform(-0.02, 0.02, (n, 3)))
    tv = _t([0.0, 0.0, 2.0] + rng.uniform(-0.05, 0.05, (n, 3)))
    return rv, tv


# --------------------------------------------------------------------------
# build functions: geometry, scoring and the hypothesis loop


def _build_pnp_minimal_grad(variant):
    from esac_tpu_torch.geometry.pnp import solve_pnp_minimal

    coords, pixels, f, c = _geom_inputs(variant)

    def fn(X4, x4):
        X = _leaf(X4)
        rv, tv = solve_pnp_minimal(X, x4, f, c, polish_iters=1)
        return _grad(rv.sum() + tv.sum(), X)

    return fn, (coords[:4], pixels[:4])


def _build_refine_grad(variant):
    from esac_tpu_torch.ransac.refine import refine_soft_inliers

    coords, pixels, f, c = _geom_inputs(variant)
    rv, tv = _rvec_tvec(variant, 1)

    def fn(coords):
        x = _leaf(coords)
        r, t = refine_soft_inliers(rv[0], tv[0], x, pixels, f, c, tau=10.0, beta=0.5,
                                   iters=2)
        return _grad(r.sum() + t.sum(), x)

    return fn, (coords,)


def _cfg(**kw):
    from esac_tpu_torch.ransac.config import RansacConfig

    return RansacConfig(**kw)


# The inference entries' RANSAC shape: score_chunk < n_hyps so the chunked
# plain scoring is traced with more than one tile.
_INFER = dict(n_hyps=8, refine_iters=2, polish_iters=1, score_chunk=4)


def _build_dsac_infer(impl: str):
    def build(variant):
        from esac_tpu_torch.ransac.kernel import dsac_infer

        coords, pixels, f, c = _geom_inputs(variant, N_INFER_CELLS)
        cfg = _cfg(scoring_impl=impl, **_INFER)
        idx = _sets(variant, (), cfg.n_hyps, N_INFER_CELLS)

        def fn(coords):
            return dsac_infer(None, coords, pixels, f, c, cfg, idx=idx, device="cpu")

        return fn, (coords,)

    return build


def _build_dsac_train_grad(variant):
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.kernel import dsac_train_loss

    coords, pixels, f, c = _geom_inputs(variant)
    cfg = _cfg(n_hyps=4, train_refine_iters=1, polish_iters=1)
    idx = _sets(variant, (), cfg.n_hyps, N_GRAD_CELLS)
    R_gt, t_gt = rodrigues(_t([0.1, 0.0, 0.0])), _t([0.0, 0.0, 2.0])

    def fn(coords):
        x = _leaf(coords)
        loss, _ = dsac_train_loss(None, x, pixels, f, c, R_gt, t_gt, cfg, idx=idx,
                                  device="cpu")
        return _grad(loss, x)

    return fn, (coords,)


def _build_scoring(impl: str):
    def build(variant):
        from esac_tpu_torch.ransac.kernel import _score_hypotheses

        coords, pixels, f, c = _geom_inputs(variant)
        cfg = _cfg(n_hyps=4, scoring_impl=impl, score_chunk=2)
        rv, tv = _rvec_tvec(variant, 4)

        def fn(coords):
            x = _leaf(coords)
            scores = _score_hypotheses([None], rv[None], tv[None], x[None], pixels,
                                       f[None], c, cfg)
            return _grad(scores.sum(), x)

        return fn, (coords,)

    return build


def _build_scoring_fused_select_grad(variant):
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.fused_scoring import soft_inlier_score_select

    coords, pixels, f, c = _geom_inputs(variant)
    rv, tv = _rvec_tvec(variant, 4)
    Rs = rodrigues(rv)

    def fn(coords):
        x = _leaf(coords)
        _, best, pose = soft_inlier_score_select(Rs[None], tv[None], x[None], pixels, f[None],
                                                 c, 10.0, 0.5)
        return _grad(best.sum() + pose.sum(), x)

    return fn, (coords,)


def _build_esac_train_grad(variant):
    import torch

    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.esac import esac_train_loss

    coords, pixels, f, c = _geom_inputs(variant)
    M = 2
    cfg = _cfg(n_hyps=4, train_refine_iters=1, polish_iters=1)
    idx = _sets(variant, (M,), cfg.n_hyps, N_GRAD_CELLS)
    R_gt, t_gt = rodrigues(_t([0.1, 0.0, 0.0])), _t([0.0, 0.0, 2.0])

    def fn(coords_all, logits):
        x, g = _leaf(coords_all), _leaf(logits)
        loss, _ = esac_train_loss(None, g, x, pixels, f, c, R_gt, t_gt, cfg, "dense",
                                  idx=idx, device="cpu")
        return _grad(loss, x, g)

    return fn, (torch.stack([coords, coords + 0.1]), torch.zeros(M))


def _frames(variant, B, M):
    """B frames of M maps at the inference cell count, their pixels and f."""
    import torch

    coords, pixels, f, c = _geom_inputs(variant, N_INFER_CELLS)
    maps = torch.stack([coords + 0.1 * m for m in range(M)])
    return (torch.stack([maps + 0.05 * b for b in range(B)]),
            torch.stack([pixels] * B), f.expand(B).clone(), c)


def _build_dsac_infer_frames(variant):
    from esac_tpu_torch.ransac.kernel import dsac_infer_frames

    B = 2
    coords, pixels, f, c = _frames(variant, B, 1)
    cfg = _cfg(**_INFER)
    idx = _sets(variant, (B,), cfg.n_hyps, N_INFER_CELLS)

    def fn(coords):
        return dsac_infer_frames([None] * B, coords, pixels, f, c, cfg, idx=idx,
                                 device="cpu")

    return fn, (coords[:, 0],)


def _logits(variant, B, M):
    return _t(_rng(variant + 11).normal(size=(B, M)))


def _build_esac_infer_frames(variant):
    from esac_tpu_torch.ransac.esac import esac_infer_frames

    B, M = 2, 2
    coords, pixels, f, c = _frames(variant, B, M)
    cfg = _cfg(**_INFER)
    idx = _sets(variant, (B, M), cfg.n_hyps, N_INFER_CELLS)
    logits = _logits(variant, B, M)

    def fn(coords):
        return esac_infer_frames([None] * B, logits, coords, pixels, f, c, cfg, idx=idx,
                                 device="cpu")

    return fn, (coords,)


def _build_esac_infer_topk_frames(variant):
    from esac_tpu_torch.ransac.esac import esac_infer_topk_frames

    B, M, k = 2, 3, 2
    coords, pixels, f, c = _frames(variant, B, M)
    cfg = _cfg(**_INFER)
    idx = _sets(variant, (B, k), cfg.n_hyps, N_INFER_CELLS)
    logits = _logits(variant, B, M)

    def fn(coords):
        return esac_infer_topk_frames([None] * B, logits, coords, pixels, f, c, cfg, k=k,
                                      idx=idx, device="cpu")

    return fn, (coords,)


def _routed(variant, B=2, M=4, K=2):
    """Routed inputs: K of M experts a frame, the second frame's second
    slot capacity-dropped."""
    import torch

    coords, pixels, f, c = _frames(variant, B, K)
    selected = torch.tensor([[0, 2], [1, 3]])
    kept = torch.tensor([[True, True], [True, False]])
    cfg = _cfg(**_INFER)
    nh = cfg.n_hyps * M // K
    return coords, pixels, f, c, selected, kept, cfg, _logits(variant, B, M), \
        _sets(variant, (B, K), nh, N_INFER_CELLS)


def _build_esac_infer_routed_frames(variant):
    from esac_tpu_torch.ransac.esac import esac_infer_routed_frames

    coords, pixels, f, c, sel, kept, cfg, logits, idx = _routed(variant)

    def fn(coords):
        return esac_infer_routed_frames([None] * 2, logits, coords, sel, kept, pixels, f, c,
                                        cfg, idx=idx, device="cpu")

    return fn, (coords,)


def _priors(variant, B, P=3):
    import torch

    rv, tv = _rvec_tvec(variant + 5, B * P)
    valid = torch.tensor([[True, False, True], [False, True, True]])[:B, :P]
    return rv.reshape(B, P, 3), tv.reshape(B, P, 3), valid


def _build_esac_infer_frames_prior(variant):
    from esac_tpu_torch.ransac.esac import esac_infer_frames_prior

    B, M = 2, 2
    coords, pixels, f, c = _frames(variant, B, M)
    cfg = _cfg(**_INFER)
    idx = _sets(variant, (B, M), cfg.n_hyps, N_INFER_CELLS)
    logits = _logits(variant, B, M)
    prv, ptv, valid = _priors(variant, B)

    def fn(coords):
        return esac_infer_frames_prior([None] * B, logits, coords, pixels, f, c, prv, ptv,
                                       valid, cfg, idx=idx, device="cpu")

    return fn, (coords,)


def _build_esac_infer_routed_frames_prior(variant):
    from esac_tpu_torch.ransac.esac import esac_infer_routed_frames_prior

    coords, pixels, f, c, sel, kept, cfg, logits, idx = _routed(variant)
    prv, ptv, valid = _priors(variant, 2)

    def fn(coords):
        return esac_infer_routed_frames_prior([None] * 2, logits, coords, sel, kept, pixels,
                                              f, c, prv, ptv, valid, cfg, idx=idx,
                                              device="cpu")

    return fn, (coords,)


# --------------------------------------------------------------------------
# build functions: the bucket functions, the retriever, the sharded paths


def _preset(M: int, H: int = 16, W: int = 16):
    from esac_tpu_torch.registry.manifest import ScenePreset

    return ScenePreset(height=H, width=W, num_experts=M, stem_channels=(2, 2, 2),
                       head_channels=2, head_depth=1, gating_channels=(2,),
                       compute_dtype="float32", gated=True)


def _scene_batch(variant, preset, B, nh, K=None):
    import torch

    rng = _rng(variant + 13)
    N = (preset.height // preset.stride) * (preset.width // preset.stride)
    batch = {"image": _t(rng.uniform(0.0, 1.0, (B, preset.height, preset.width, 3))),
             "seed": torch.as_tensor(rng.integers(0, 2**31, B), dtype=torch.int64)}
    lead = (B, preset.num_experts if K is None else K)
    batch["idx"] = _sets(variant, lead, nh, N)
    return batch


def _build_scene_serve(routed: bool):
    def build(variant):
        from esac_tpu_torch.registry.serving import (
            init_scene_params,
            make_routed_scene_bucket_fn,
            make_scene_bucket_fn,
        )

        M, B, K = (4, 2, 2) if routed else (2, 2, None)
        preset = _preset(M)
        cfg = _cfg(n_hyps=4, refine_iters=1, polish_iters=1, frame_buckets=(1, 4),
                   score_chunk=2)
        params = init_scene_params(preset, seed=0, device="cpu")
        run = make_routed_scene_bucket_fn(preset, cfg, K, device="cpu") if routed \
            else make_scene_bucket_fn(preset, cfg, device="cpu")
        nh = cfg.n_hyps * M // K if routed else cfg.n_hyps
        batch = _scene_batch(variant, preset, B, nh, K)

        def fn(image):
            return run(params, dict(batch, image=image))

        return fn, (batch["image"],)

    return build


def _build_retrieval_posterior(variant):
    import torch

    from esac_tpu_torch.retrieval.model import (
        RetrievalConfig,
        build_retriever,
        make_retrieval_fn,
    )

    cfg = RetrievalConfig(height=16, width=16, max_scenes=8, embed_dim=4, channels=(2,))
    run = make_retrieval_fn(cfg, device="cpu")
    net = build_retriever(cfg, device="cpu")
    rng = _rng(variant + 17)
    protos = _t(rng.normal(size=(cfg.max_scenes, cfg.embed_dim)))
    mask = torch.tensor([True, True, False, True, False, False, True, False])

    def fn(images):
        return run(net, protos, mask, images)

    return fn, (_t(rng.uniform(0.0, 1.0, (1, cfg.height, cfg.width, 3))),)


def _build_sharded_infer_frames_dynamic(variant):
    import torch

    from esac_tpu_torch.parallel.esac_sharded import make_esac_infer_sharded_frames_dynamic

    B, M = 2, 4
    coords, pixels, f, c = _frames(variant, B, M)
    cfg = _cfg(n_hyps=4, refine_iters=1, polish_iters=1, score_chunk=2)
    run = make_esac_infer_sharded_frames_dynamic(_mesh(), cfg, device="cpu")
    batch = {"seed": torch.tensor([1, 2]), "pixels": pixels, "f": f,
             "idx": _sets(variant, (B, M), cfg.n_hyps, N_INFER_CELLS)}

    def fn(coords):
        return run(dict(batch, coords_all=coords), c)

    return fn, (coords,)


def _build_sharded_train(variant):
    import torch

    from esac_tpu_torch.data.synthetic import output_pixel_grid
    from esac_tpu_torch.parallel.train_sharded import make_sharded_esac_loss
    from esac_tpu_torch.registry.serving import init_scene_params

    M, B = 4, 2
    preset = _preset(M)
    params = init_scene_params(preset, seed=0, device="cpu")
    cfg = _cfg(n_hyps=4, train_refine_iters=1, polish_iters=1)
    pixels = output_pixel_grid(preset.height, preset.width, preset.stride, device="cpu")
    loss = make_sharded_esac_loss(_mesh(), list(params["expert"]), params["gating"],
                                  torch.zeros(M, 3), pixels, params["f"], params["c"], cfg,
                                  device="cpu")
    batch = _scene_batch(variant, preset, B, cfg.n_hyps)
    R = torch.eye(3).expand(B, 3, 3).contiguous()
    t = _t([[0.0, 0.0, 2.0]] * B)

    def fn(images):
        with torch.no_grad():
            return loss(images, R, t, 0, idx=batch["idx"])

    return fn, (batch["image"],)


def _mesh():
    """A world-size-1 mesh on the current gloo group (see
    :func:`single_rank_group`)."""
    from esac_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(1, 1)


def single_rank_group():
    """A context that gives the sharded entries a world of one gloo rank in
    this process, unless one exists already; destroyed on exit."""
    import contextlib

    import torch.distributed as dist

    @contextlib.contextmanager
    def group():
        if dist.is_initialized():
            yield
            return
        from esac_tpu_torch.parallel.multihost import free_port, initialize_multihost

        initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo", device="cpu")
        try:
            yield
        finally:
            dist.destroy_process_group()

    return group()


# --------------------------------------------------------------------------
# the registry

ENTRIES: tuple[Entry, ...] = (
    Entry("pnp_minimal_grad", pinned=True, grad=True, build=_build_pnp_minimal_grad,
          note="grad of solve_pnp_minimal wrt the 4 scene points"),
    Entry("refine_soft_inliers_grad", pinned=True, grad=True, build=_build_refine_grad,
          note="autodiff through IRLS (the _NormalEquations Function)"),
    Entry("dsac_infer", pinned=True, build=_build_dsac_infer("errmap"),
          note="single-frame hypothesis loop, errmap scoring"),
    Entry("dsac_train_loss_grad", pinned=True, grad=True, build=_build_dsac_train_grad,
          note="training expectation and its backward"),
    Entry("scoring_errmap_grad", pinned=True, grad=True, build=_build_scoring("errmap"),
          note="the error-map scoring impl"),
    Entry("scoring_fused_grad", pinned=True, grad=True, build=_build_scoring("fused"),
          note="the kernels' formula as one plain broadcast"),
    Entry("scoring_fused_select_train_grad", pinned=True, grad=True,
          build=_build_scoring("fused_select"),
          note="fused_select's training path: chunked, checkpointed error-map math"),
    Entry("scoring_pallas_grad", pinned=True, grad=True, build=_build_scoring("pallas"),
          note="SoftInlierScores (soft_inlier_scores_kernel) under autograd; on the CPU "
               "its forward is the plain version _scores_plain, the kernel's own graph "
               "is CUDA (held to the plain version by chip_smoke.py)"),
    Entry("scoring_fused_select_grad", pinned=True, grad=True,
          build=_build_scoring_fused_select_grad,
          note="SoftInlierScoreSelect (soft_inlier_score_select) under autograd: the "
               "plain select forward on the CPU, the winner-only backward"),
    Entry("dsac_infer_fused_select", pinned=True, build=_build_dsac_infer("fused_select"),
          note="single-frame loop under fused_select (the select's plain version on "
               "the CPU)",
          allow=(("J3", "sum:128", _CELL_SUM),)),
    Entry("esac_train_loss_dense_grad", pinned=True, grad=True, build=_build_esac_train_grad,
          note="multi-expert dense training loss and its backward"),
    Entry("dsac_infer_frames", pinned=True, build=_build_dsac_infer_frames,
          note="frames-major single-expert dispatch"),
    Entry("esac_infer_frames", pinned=True, build=_build_esac_infer_frames,
          note="frames-major multi-expert dispatch"),
    Entry("esac_infer_topk_frames", pinned=True, build=_build_esac_infer_topk_frames,
          note="gating-pruned dispatch, k = 2 of 3"),
    Entry("esac_infer_routed_frames", pinned=True, build=_build_esac_infer_routed_frames,
          note="capacity-routed hypothesis loop, K = 2 of 4, one slot dropped"),
    Entry("esac_infer_frames_prior", pinned=True, build=_build_esac_infer_frames_prior,
          note="prior-slot sibling of esac_infer_frames, 3 priors, mixed validity"),
    Entry("esac_infer_routed_frames_prior", pinned=True,
          build=_build_esac_infer_routed_frames_prior,
          note="prior-slot sibling of esac_infer_routed_frames"),
    Entry("routed_scene_serve", pinned=False, build=_build_scene_serve(True),
          note="make_routed_scene_bucket_fn, k = 2 of 4: gating CNN, top-k, capacity "
               "blocks, routed loop; ops and shapes audited"),
    Entry("registry_scene_serve", pinned=False, build=_build_scene_serve(False),
          note="make_scene_bucket_fn: gating and expert CNNs, frames-major loop"),
    Entry("retrieval_posterior", pinned=False, build=_build_retrieval_posterior,
          note="make_retrieval_fn: embedder CNN, masked cosine logits, posterior"),
    Entry("sharded_infer_frames_dynamic", pinned=True,
          build=_build_sharded_infer_frames_dynamic,
          note="make_esac_infer_sharded_frames_dynamic at world size 1 (gloo)"),
    Entry("sharded_train_step", pinned=False, build=_build_sharded_train,
          note="make_sharded_esac_loss at world size 1, forward only"),
)


# --------------------------------------------------------------------------
# R11 waivers: discovered entry points deliberately not traced as their own
# entries, each with its reason.

R11_WAIVED: dict[str, str] = {
    "refine_pose_gn": "Gauss-Newton polisher on rvecs; refine_pose_gn_R is traced "
                      "inside every pnp / dsac / esac entry",
    "refine_pose_gn_R": "traced inside solve_pnp_minimal's polish and refine_soft_inliers",
    "esac_infer": "per-frame core of esac_infer_frames (registered): the same ops "
                  "on a batch of one",
    "esac_infer_topk": "per-frame core of esac_infer_topk_frames (registered)",
    "esac_infer_prior": "per-frame core of esac_infer_frames_prior (registered)",
    "esac_train_loss_frames": "esac_train_loss (registered) is it on a batch of one",
    "dsac_train_loss_frames": "dsac_train_loss (registered) is it on a batch of one",
    "sample_correspondence_sets": "the sampler; every traced entry injects idx= "
                                  "instead (a torch.Generator draw)",
    "sample_correspondence_sets_exact": "the exact sampler; as sample_correspondence_sets",
    "soft_inlier_scores_kernel": "traced as scoring_pallas_grad, through "
                                 "_score_hypotheses' 'pallas' branch",
    "soft_inlier_scores_fused": "the kernels' plain formula, traced inside every "
                                "scoring entry",
    "soft_inlier_scores_chunked": "traced inside scoring_fused_select_train_grad and "
                                  "the errmap inference entries",
    "soft_inlier_score": "the error-map score, traced inside scoring_errmap_grad",
    "esac_infer_sharded": "per-frame sharded core of esac_infer_sharded_frames",
    "esac_infer_sharded_frames": "the static-c sibling of the dynamic sharded entry "
                                 "(registered): the same function with c bound",
    "make_esac_infer_sharded_frames": "builds esac_infer_sharded_frames (above)",
    "make_esac_infer_routed_frames_sharded": "expert-sharded sibling of "
                                             "esac_infer_routed_frames (registered); "
                                             "bit-equal to it in tests/test_torch_parallel.py",
    "esac_infer_routed": "the per-frame routed sharded core of the routed sharded maker",
    "make_sharded_esac_train_step": "Adam and gradient all-reduces around "
                                    "make_sharded_esac_loss (registered)",
    "make_registry_sharded_serve_fn": "the registry's resolution around the dynamic "
                                      "sharded entry (registered)",
    "make_dsac_serve_fn": "a closure over dsac_infer_frames (registered): the tree "
                          "unpack and a constant principal point",
    "make_esac_serve_fn": "a closure over esac_infer_frames (registered)",
    "make_dsac_train_step": "optimizer step around dsac_train_loss (registered)",
    "make_esac_train_step": "optimizer step around esac_train_loss_frames, whose core "
                            "esac_train_loss is registered",
    "make_expert_train_step": "expert CNN pretraining: bf16 CNN compute, no geometry core",
    "make_expert_reproj_train_step": "reprojection finetune: its geometry core is "
                                     "refine_soft_inliers_grad / dsac_train_loss_grad",
    "make_gating_train_step": "gating CNN step: no geometry core",
}
