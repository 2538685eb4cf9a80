"""The degenerate-input gradient witness (counterpart of
``esac_tpu/lint/gradcheck.py``).

The static pass (R14/R15, :mod:`esac_tpu_torch.lint.gradsafety`) argues
that a NaN cannot be emitted; this module runs the contract.  Each witness
evaluates one of the port's differentiated entry points under autograd on
a committed corpus of degenerate inputs -- collinear and coincident P3P
sets, zero-length rays, zero-depth cells, identity and pi rotations,
all-equal scores forcing selection ties, and the all-dropped routed frame
-- and every output and every gradient must be finite.

- **One shape for the whole corpus**: 16 cells, 4 hypotheses, 2 experts,
  as in the JAX package, so the kernels run at one shape (P = 1, H = 4,
  N = 16: below one 32-cell chunk of ``fused_scoring.cell_chunks``).
- **The corpus is committed** (``esac_tpu_torch/lint/grad_corpus.json``)
  with plain-float JSON arrays; :func:`default_corpus` equals it and the
  JAX package's ``.grad_corpus.json`` case for case.
- **Witness coverage**: one witness per JAX witness, plus
  ``scoring_pallas_grad`` through ``SoftInlierScores`` (the scoring
  kernel's Function).  ``scoring_fused_select_grad`` differentiates
  ``SoftInlierScoreSelect`` directly, so it runs the select's backward.
  ``routed_drop_mask`` is not a gradient entry: the ``-inf`` score of an
  all-dropped frame is the designed failure signal, so only the pose and
  its gradients are held finite there.
- **Device**: :func:`run_gradcheck` runs on the card unless the caller
  asks for the CPU; on the card the "pallas" and "fused_select" witnesses
  launch the hand-written kernels (one launch a case each; their
  backwards are the plain recompute).
- **Randomness**: each sampling witness draws from an explicit
  ``torch.Generator`` seeded per witness on the run's device.
"""

from __future__ import annotations

import json
import pathlib

GRAD_CORPUS_NAME = "esac_tpu_torch/lint/grad_corpus.json"

N_CELLS = 16
N_HYPS = 4
N_EXPERTS = 2

_PI = 3.141592653589793

# Per-hypothesis pose offsets of the generic cases (all zero when a case
# forces ties).
_OFFSETS = [[0.0, 0.0, 0.0], [0.02, -0.01, 0.005],
            [-0.03, 0.015, 0.0], [0.01, 0.02, -0.01]]


# --------------------------------------------------------------------------
# the corpus

def _grid_coords() -> list:
    """Deterministic well-posed scene points (plain floats: exact JSON)."""
    return [
        [((i * 7) % N_CELLS) / 8.0 - 1.0,
         ((i * 5) % N_CELLS) / 8.0 - 1.0,
         1.5 + (i % 4) * 0.25]
        for i in range(N_CELLS)
    ]


def _grid_pixels() -> list:
    return [[(i % 4) * 16.0 + 8.0, (i // 4) * 12.0 + 6.0]
            for i in range(N_CELLS)]


def default_corpus() -> dict:
    """The canonical degenerate-input corpus (the JAX package's eight cases,
    array for array).  Every case shares shapes: coords (16, 3), pixels
    (16, 2), scalar f, c (2,), rvec / tvec (3,)."""
    base = {
        "f": 60.0, "c": [32.0, 24.0],
        "rvec": [0.1, -0.05, 0.02], "tvec": [0.0, 0.0, 2.0],
        "tie_hypotheses": False, "kept": [True, True],
    }
    cases = {
        "collinear_p3p_triad": {
            **base,
            "description": "every sampled minimal set is collinear: the "
                           "triad frame's cross products vanish and the P3P "
                           "side lengths degenerate (penalty-branch "
                           "territory, SURVEY.md retry-on-bad-sample)",
            "coords": [[i * 0.1, i * 0.05, 1.0 + i * 0.02]
                       for i in range(N_CELLS)],
            "pixels": _grid_pixels(),
        },
        "coincident_points": {
            **base,
            "description": "all scene points AND all pixels identical: zero "
                           "difference vectors, zero norms, an all-zero "
                           "quartic, and every hypothesis scoring exactly "
                           "equal",
            "coords": [[0.5, -0.25, 1.0]] * N_CELLS,
            "pixels": [[32.0, 24.0]] * N_CELLS,
        },
        "zero_rays": {
            **base,
            "description": "every pixel sits exactly on the principal point: "
                           "bearing xy components are exactly 0 (the "
                           "safe_norm-guarded ray normalization's edge)",
            "coords": _grid_coords(),
            "pixels": [[32.0, 24.0]] * N_CELLS,
        },
        "zero_depth_cells": {
            **base,
            "description": "scene points on the camera plane (z = 0 at the "
                           "identity pose): the MIN_DEPTH clamp and the "
                           "behind-camera penalty branch carry both passes",
            "coords": [[((i * 7) % N_CELLS) / 8.0 - 1.0,
                        ((i * 5) % N_CELLS) / 8.0 - 1.0, 0.0]
                       for i in range(N_CELLS)],
            "pixels": _grid_pixels(),
            "rvec": [0.0, 0.0, 0.0], "tvec": [0.0, 0.0, 0.0],
        },
        "identity_rotation": {
            **base,
            "description": "exact-identity rotation: so3_log's theta -> 0 "
                           "limit and the small-angle Taylor blends, in both "
                           "passes",
            "coords": _grid_coords(),
            "pixels": _grid_pixels(),
            "rvec": [0.0, 0.0, 0.0],
        },
        "pi_rotation": {
            **base,
            "description": "rotation by exactly pi: so3_log's near-pi "
                           "outer-product branch with the skew part exactly "
                           "zero",
            "coords": _grid_coords(),
            "pixels": _grid_pixels(),
            "rvec": [_PI, 0.0, 0.0],
        },
        "tie_scores": {
            **base,
            "description": "all hypotheses identical (zero per-hypothesis "
                           "offsets): every score exactly equal, forcing the "
                           "argmax/streamed-select tie-break and a flat "
                           "selection softmax",
            "coords": _grid_coords(),
            "pixels": _grid_pixels(),
            "tie_hypotheses": True,
        },
        "all_dropped_routed": {
            **base,
            "description": "every routed slot capacity-dropped (kept all "
                           "False): the -inf score masking is the DESIGNED "
                           "failure signal, and the pose must still be "
                           "finite garbage with finite gradients",
            "coords": _grid_coords(),
            "pixels": _grid_pixels(),
            "kept": [False, False],
        },
    }
    return {
        "comment": "The port's degenerate-input gradient corpus: the JAX "
                   "package's eight cases (.grad_corpus.json), array for "
                   "array.  Every gradient witness must give all-finite "
                   "outputs and gradients on every case.  Regenerate only "
                   "through esac_tpu_torch/lint/gradcheck.py "
                   "default_corpus() and review the diff.",
        "cases": cases,
    }


def write_corpus(path: pathlib.Path, corpus: dict | None = None) -> None:
    corpus = corpus or default_corpus()
    path.write_text(json.dumps(corpus, indent=2, sort_keys=True) + "\n")


def load_corpus(path: pathlib.Path) -> dict | None:
    if not path.exists():
        return None
    return json.loads(path.read_text())


# --------------------------------------------------------------------------
# finiteness

def tree_all_finite(tree) -> bool:
    """Every floating tensor or number in a nested dict / list / tuple is
    finite (integer and bool leaves are vacuously finite; None is skipped:
    an input no gradient reaches)."""
    import math

    import torch

    if isinstance(tree, dict):
        return all(tree_all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(tree_all_finite(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        if not (tree.is_floating_point() or tree.is_complex()):
            return True
        return bool(torch.isfinite(tree).all())
    if isinstance(tree, float):
        return math.isfinite(tree)
    return True


def check_case(fn, arrays: dict) -> dict:
    """Run one witness on one corpus case -> verdict record.  Shared by
    :func:`run_gradcheck` and the planted-NaN test, so the proof that the
    witness catches a violation rides the same code path."""
    outputs, grads = fn(**arrays)
    return {
        "outputs_finite": tree_all_finite(outputs),
        "grads_finite": tree_all_finite(grads),
    }


def case_arrays(case: dict, device) -> dict:
    """One corpus case as float32 tensors on ``device``; ``offs`` (4, 3)
    the per-hypothesis pose offsets."""
    import torch

    offs = [[0.0] * 3] * N_HYPS if case.get("tie_hypotheses", False) else _OFFSETS

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return {
        "coords": f32(case["coords"]),
        "pixels": f32(case["pixels"]),
        "f": f32(case["f"]),
        "c": f32(case["c"]),
        "rvec": f32(case["rvec"]),
        "tvec": f32(case["tvec"]),
        "offs": f32(offs),
        "kept": torch.as_tensor(case.get("kept", [True, True]), device=device),
    }


def hypothesis_poses(rvec, tvec, offs):
    """The witnesses' scoring hypotheses: rvecs (1, H, 3) = rvec + offs,
    tvecs (1, H, 3) = tvec on every row (one problem)."""
    return (rvec[None, :] + offs)[None], tvec.expand(offs.shape)[None]


def _grad(loss, inputs: dict) -> dict:
    """d loss / d each input (None where nothing reaches it)."""
    import torch

    got = torch.autograd.grad(loss, list(inputs.values()), allow_unused=True)
    return dict(zip(inputs, got))


def _leaves(**xs):
    return {k: v.detach().clone().requires_grad_(True) for k, v in xs.items()}


def _generator(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


# --------------------------------------------------------------------------
# witnesses: one per JAX witness, plus the "pallas" scoring Function

def _make_pnp_minimal_grad():
    from esac_tpu_torch.geometry.pnp import solve_pnp_minimal

    def run(coords, pixels, f, c, rvec, tvec, offs, kept):
        x = _leaves(X4=coords[:4], x4=pixels[:4])
        rv, tv = solve_pnp_minimal(x["X4"], x["x4"], f, c, polish_iters=1)
        loss = rv.sum() + tv.sum()
        return {"rvec": rv, "tvec": tv, "loss": loss}, _grad(loss, x)

    return run


def _make_refine_soft_inliers_grad():
    from esac_tpu_torch.ransac.refine import refine_soft_inliers

    def run(coords, pixels, f, c, rvec, tvec, offs, kept):
        x = _leaves(coords=coords, rvec=rvec, tvec=tvec)
        rv, tv = refine_soft_inliers(x["rvec"], x["tvec"], x["coords"], pixels, f, c,
                                     tau=10.0, beta=0.5, iters=2)
        loss = rv.sum() + tv.sum()
        return {"rvec": rv, "tvec": tv, "loss": loss}, _grad(loss, x)

    return run


def _make_dsac_train_loss_grad():
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.kernel import dsac_train_loss

    cfg = RansacConfig(n_hyps=N_HYPS, train_refine_iters=1, polish_iters=1)

    def run(coords, pixels, f, c, rvec, tvec, offs, kept):
        x = _leaves(coords=coords)
        loss, aux = dsac_train_loss(_generator(coords.device, 0), x["coords"], pixels, f, c,
                                    rodrigues(rvec), tvec, cfg, device=coords.device)
        return ({"loss": loss, "scores": aux["scores"], "probs": aux["selection_probs"]},
                _grad(loss, x))

    return run


def _make_scoring_grad(impl: str):
    def make():
        from esac_tpu_torch.ransac.config import RansacConfig
        from esac_tpu_torch.ransac.kernel import _score_hypotheses

        cfg = RansacConfig(n_hyps=N_HYPS, scoring_impl=impl, score_chunk=2)

        def run(coords, pixels, f, c, rvec, tvec, offs, kept):
            rvecs, tvecs = hypothesis_poses(rvec, tvec, offs)
            x = _leaves(coords=coords[None], rvecs=rvecs, tvecs=tvecs)
            scores = _score_hypotheses([_generator(coords.device, 1)], x["rvecs"],
                                       x["tvecs"], x["coords"], pixels, f[None], c, cfg)
            loss = scores.sum()
            return {"loss": loss, "scores": scores[0]}, _grad(loss, x)

        return run

    return make


def _make_scoring_fused_select_grad():
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.fused_scoring import soft_inlier_score_select

    def run(coords, pixels, f, c, rvec, tvec, offs, kept):
        rvecs, tvecs = hypothesis_poses(rvec, tvec, offs)
        x = _leaves(coords=coords[None], rvecs=rvecs, tvecs=tvecs)
        best_i, best_s, pose = soft_inlier_score_select(
            rodrigues(x["rvecs"]), x["tvecs"], x["coords"], pixels, f[None], c, 10.0, 0.5)
        # The winner's score and its pose row: both cotangents of the
        # select's backward.
        loss = best_s.sum() + pose.sum()
        return ({"best_score": best_s[0], "best_idx": best_i[0], "best_pose": pose[0],
                 "loss": loss}, _grad(loss, x))

    return run


def _make_esac_train_loss_dense_grad():
    import torch

    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import esac_train_loss

    cfg = RansacConfig(n_hyps=N_HYPS, train_refine_iters=1, polish_iters=1)

    def run(coords, pixels, f, c, rvec, tvec, offs, kept):
        # Two experts sharing the same degenerate map: the cross-expert
        # selection ties exactly like the within-expert ones.
        x = _leaves(coords_all=torch.stack([coords, coords]),
                    logits=torch.zeros(N_EXPERTS, device=coords.device))
        loss, aux = esac_train_loss(_generator(coords.device, 2), x["logits"], x["coords_all"],
                                    pixels, f, c, rodrigues(rvec), tvec, cfg, "dense",
                                    device=coords.device)
        return ({"loss": loss, "per_expert_loss": aux["per_expert_loss"],
                 "gating_probs": aux["gating_probs"]}, _grad(loss, x))

    return run


def _make_routed_drop_mask():
    """The all-dropped routed leg: not a gradient entry, but the routed
    corpus case needs a consumer.  Only the pose and its gradients are
    held finite: the -inf winner score of an all-dropped frame is the
    designed failure signal (ransac/esac.esac_infer_routed_frames)."""
    import torch

    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import esac_infer_routed_frames

    cfg = RansacConfig(n_hyps=2, refine_iters=1, polish_iters=1, score_chunk=2)
    # M = K = 2: esac_infer_routed_frames is one code path whatever K and
    # M, and the drop-mask semantics under test do not depend on K.
    M = 2

    def run(coords, pixels, f, c, rvec, tvec, offs, kept):
        dev = coords.device
        x = _leaves(coords_sel=torch.stack([coords, coords + 0.1])[None])  # (1, K, N, 3)
        out = esac_infer_routed_frames(
            [_generator(dev, 3)], torch.zeros((1, M), device=dev), x["coords_sel"],
            torch.tensor([[0, 1]], device=dev), kept[None], pixels[None], f[None], c, cfg,
            device=dev)
        loss = out["rvec"].sum() + out["tvec"].sum()
        return {"rvec": out["rvec"], "tvec": out["tvec"], "loss": loss}, _grad(loss, x)

    return run


# Witness registry: name -> the maker of one run(**case arrays) function.
# The `*_grad` names are the JAX package's grad witnesses plus
# scoring_pallas_grad; `routed_drop_mask` is the extra leg the
# all_dropped_routed case exists for.
WITNESSES: dict = {
    "pnp_minimal_grad": _make_pnp_minimal_grad,
    "refine_soft_inliers_grad": _make_refine_soft_inliers_grad,
    "dsac_train_loss_grad": _make_dsac_train_loss_grad,
    "scoring_errmap_grad": _make_scoring_grad("errmap"),
    "scoring_fused_grad": _make_scoring_grad("fused"),
    "scoring_fused_select_train_grad": _make_scoring_grad("fused_select"),
    "scoring_pallas_grad": _make_scoring_grad("pallas"),
    "scoring_fused_select_grad": _make_scoring_fused_select_grad,
    "esac_train_loss_dense_grad": _make_esac_train_loss_dense_grad,
    "routed_drop_mask": _make_routed_drop_mask,
}

# The witnesses that reach a hand-written kernel on the card, and the
# launches each makes per case (forward only: the backwards recompute in
# plain PyTorch).
KERNEL_WITNESSES = {
    "scoring_pallas_grad": {"soft_inlier_scores": 1, "soft_inlier_select": 0},
    "scoring_fused_select_grad": {"soft_inlier_scores": 0, "soft_inlier_select": 1},
}


def run_gradcheck(corpus: dict | None = None, witnesses: dict | None = None,
                  device=None, record: dict | None = None) -> dict:
    """Evaluate every witness against every corpus case on ``device`` (the
    card unless the caller asks for the CPU).

    Returns the verdict block of the JAX package::

        {entry: {case: {"outputs_finite": bool, "grads_finite": bool}},
         ...,
         "clean": bool}

    ``record``, when given, receives ``(entry, case) -> (outputs, grads,
    arrays)`` for every run (``chip_smoke.py`` holds the kernel witnesses'
    outputs against the plain versions on the same arrays).
    """
    from esac_tpu_torch.utils.precision import resolve_device

    dev = resolve_device(device)
    if corpus is None:
        corpus = default_corpus()
    witnesses = witnesses if witnesses is not None else WITNESSES
    verdicts: dict = {}
    clean = True
    for name, make in witnesses.items():
        fn = make()
        per_case: dict = {}
        for case_name, case in sorted(corpus["cases"].items()):
            arrays = case_arrays(case, dev)
            if record is None:
                v = check_case(fn, arrays)
            else:
                outputs, grads = fn(**arrays)
                record[(name, case_name)] = (outputs, grads, arrays)
                v = {"outputs_finite": tree_all_finite(outputs),
                     "grads_finite": tree_all_finite(grads)}
            per_case[case_name] = v
            clean = clean and v["outputs_finite"] and v["grads_finite"]
        verdicts[name] = per_case
    verdicts["clean"] = clean
    return verdicts
