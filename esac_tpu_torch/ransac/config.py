"""Hyperparameters of the hypothesis loop: a copy of
``esac_tpu/ransac/config.py`` with the same fields, defaults and validation.

Copied, not imported: importing ``esac_tpu.ransac.config`` runs
``esac_tpu/ransac/__init__.py``, which imports jax.  Fields the port's
first slice does not read yet (training, routed serving, the dispatcher's
queue knobs) are kept so a config means the same thing in both packages;
``tests/test_torch_isolation.py`` holds the two field lists equal.
"""

from __future__ import annotations

import dataclasses

# The valid RansacConfig.scoring_impl values.
SCORING_IMPLS = ("errmap", "fused", "pallas", "fused_select")


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    # Number of pose hypotheses drawn per frame (per expert under ESAC).
    n_hyps: int = 256
    # Soft-inlier reprojection threshold, pixels.
    tau: float = 10.0
    # Sigmoid sharpness of the soft-inlier count: sigmoid(beta * (tau - r)).
    beta: float = 0.5
    # Softmax temperature over scores for hypothesis selection in training.
    alpha: float = 0.5
    # IRLS rounds when refining the winning pose (8 saturates, per the
    # reference's refine sweep).
    refine_iters: int = 8
    # Light per-hypothesis refinement rounds inside the training expectation.
    train_refine_iters: int = 2
    # Gauss-Newton polish iterations inside the minimal solver.
    polish_iters: int = 3
    # Pose-loss translation weight: loss = max(rot_deg, trans_m * trans_scale).
    trans_scale: float = 100.0
    # Clamp on the per-hypothesis pose loss (degrees-equivalent units).
    loss_clamp: float = 100.0
    # Score hypotheses on a random subset of this many cells (0 = all);
    # scores are rescaled by N / score_cells.  Refinement uses every cell.
    score_cells: int = 0
    # Scoring implementation:
    #   "errmap"       -- reprojection_error_map + sigmoid-sum, chunked over
    #                     hypotheses (plain PyTorch on every device);
    #   "fused"        -- the kernels' formula as plain PyTorch broadcasts;
    #   "pallas"       -- the hand-written scoring kernel (CUDA on the card;
    #                     the name is the JAX package's, kept so configs
    #                     mean the same in both packages);
    #   "fused_select" -- the hand-written score+select kernel: only the
    #                     winner's index and score exist, results carry
    #                     'score' instead of 'scores'.
    # Scoring stays float32: a bf16 variant measured 10% score deviation.
    scoring_impl: str = "errmap"
    # Deprecated alias: True resolves to scoring_impl="pallas".
    use_pallas_scoring: bool = False
    # Hypothesis-tile size for the chunked plain scoring paths.
    score_chunk: int = 64
    # Training knobs (the training slice reads them).
    grad_through_refine: bool = True
    remat: bool = False
    # ---- Frame-axis serving knobs ----
    # Allowed frame-batch sizes: every dispatch is padded up to one of these.
    frame_buckets: tuple[int, ...] = (1, 4, 16, 64)
    serve_max_wait_ms: float = 2.0
    serve_queue_depth: int = 256
    # ---- Gating-first routed serving knobs ----
    serve_topk: int = 0
    serve_capacity: int = 0

    def __post_init__(self):
        if self.use_pallas_scoring:
            object.__setattr__(self, "scoring_impl", "pallas")
            object.__setattr__(self, "use_pallas_scoring", False)
        if self.scoring_impl not in SCORING_IMPLS:
            raise ValueError(
                f"unknown RansacConfig.scoring_impl: {self.scoring_impl!r} "
                f"(valid: {SCORING_IMPLS})"
            )
