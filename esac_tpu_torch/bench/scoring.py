"""``scoring`` mode (counterpart of ``bench.py``'s ``_measure_scoring``): the
n_hyps x scoring-impl sweep of ``dsac_infer_frames`` at the serve operating
point (16 frames, the full 4800-cell grid) under {errmap, fused,
fused_select}.

The bench's kernel path: each ``fused_select`` call launches the hand-written
CUDA select kernel (``esac_soft_inlier_select``) once, at P = 16 problems,
H = n_hyps, N = 4800; "errmap" and "fused" score in plain PyTorch.  Per point
``winner_bit_identical`` RECORDS whether fused_select's (best index, refined
pose, inlier_frac) equal the errmap argmax's: the kernel sums the fused
formula, errmap the error-map formula, and the two round differently in
float32, so a near-tie among the top hypotheses may pick another winner;
where one differs, ``disagreements`` (a list the caller passes) receives the
frame, both indices and errmap's score gap between them.
"""

from __future__ import annotations

import time

import torch

from esac_tpu_torch.bench.constants import (
    C,
    SCORING_BATCH,
    SCORING_REPEATS,
    SCORING_SWEEP,
)
from esac_tpu_torch.bench.fixtures import fence
from esac_tpu_torch.bench.pipeline import correspondence_frames
from esac_tpu_torch.data.synthetic import CAMERA_F
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import dsac_infer_frames, frame_generators
from esac_tpu_torch.utils.precision import resolve_device

IMPLS = ("errmap", "fused", "fused_select")


def select_launches(n_hyps_sweep=SCORING_SWEEP, repeats: int = SCORING_REPEATS) -> int:
    """Select-kernel launches of one sweep on the card: one per
    ``fused_select`` call, the warm-up call included."""
    return len(n_hyps_sweep) * (1 + repeats)


def measure_scoring(n_hyps_sweep: tuple = SCORING_SWEEP, batch: int = SCORING_BATCH,
                    repeats: int = SCORING_REPEATS, disagreements: list | None = None,
                    device=None) -> dict:
    dev = resolve_device(device)
    coords, pixels = correspondence_frames(batch, dev)
    f_b = torch.full((batch,), CAMERA_F, device=dev)
    c_pt = torch.tensor(C, device=dev)
    n_cells = coords.shape[1]

    def run(cfg):
        return dsac_infer_frames(frame_generators(range(1_000, 1_000 + batch), dev), coords,
                                 pixels, f_b, c_pt, cfg, device=dev)

    curve = []
    for n_hyps in n_hyps_sweep:
        point = {
            "n_hyps": int(n_hyps),
            "total_hyps_per_dispatch": int(batch * n_hyps),
            "errmap_term_mb": round(batch * n_hyps * n_cells * 4 / 1e6, 2),
            "impls": {},
        }
        outs = {}
        for impl in IMPLS:
            cfg = RansacConfig(n_hyps=int(n_hyps), scoring_impl=impl)
            out = run(cfg)  # warm
            fence(dev)
            walls = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                out = run(cfg)
                fence(dev)
                walls.append(time.perf_counter() - t0)
            walls.sort()
            dt = walls[len(walls) // 2]
            outs[impl] = out
            point["impls"][impl] = {
                "dispatch_ms": round(dt * 1e3, 2),
                "hyps_per_s": round(batch * n_hyps / dt, 1),
                "wall_s_spread": [round(x, 4) for x in walls],
            }
        em, fs = outs["errmap"], outs["fused_select"]
        point["winner_bit_identical"] = bool(all(
            torch.equal(em[k], fs[k]) for k in ("best", "rvec", "tvec", "inlier_frac")))
        point["fused_select_speedup_x"] = round(
            point["impls"]["fused_select"]["hyps_per_s"]
            / point["impls"]["errmap"]["hyps_per_s"], 3)
        if not point["winner_bit_identical"] and disagreements is not None:
            disagreements += [{"n_hyps": int(n_hyps), **row} for row in _disagreement(em, fs)]
        curve.append(point)

    return {
        "batch_frames": batch,
        "n_cells": int(n_cells),
        "n_hyps_sweep": [int(h) for h in n_hyps_sweep],
        "curve": curve,
        "winner_bit_identical_all": bool(all(p["winner_bit_identical"] for p in curve)),
        "note": (
            "full dsac_infer_frames pipeline at the serve frame bucket; errmap and "
            "fused score in plain PyTorch in score_chunk tiles, fused_select launches "
            "the CUDA select kernel once a dispatch (the fused formula, its own float32 "
            "rounding), so fused_select's speedup isolates fusing SELECTION into the "
            "scoring pass; errmap_term_mb is the per-dispatch memory an unchunked "
            "error map would take"
        ),
    }


def _disagreement(em: dict, fs: dict) -> list:
    """Per frame where the two winners differ: both indices, errmap's
    scores at both and their gap (the evidence for a float32 near-tie)."""
    rows = []
    diff = (em["best"] != fs["best"]) | (em["inlier_frac"] != fs["inlier_frac"])
    for b in torch.nonzero(diff).flatten().tolist():
        i, j = int(em["best"][b]), int(fs["best"][b])
        s = em["scores"][b]
        rows.append({"frame": b, "errmap_best": i, "fused_select_best": j,
                     "errmap_score_at_errmap_best": float(s[i]),
                     "errmap_score_at_fused_select_best": float(s[j]),
                     "score_gap": float(s[i] - s[j]),
                     "fused_select_score": float(fs["score"][b])})
    return rows


def scoring_headline(scoring: dict) -> dict:
    top = scoring["curve"][-1]  # the largest-n_hyps point is the headline
    return {
        "metric": f"scoring_fused_select_hyps_per_s_at_{top['n_hyps']}",
        "value": top["impls"]["fused_select"]["hyps_per_s"],
        "unit": "hyps/s",
        "vs_baseline": None,
        "fused_select_speedup_x_at_max": top["fused_select_speedup_x"],
        "winner_bit_identical_all": scoring["winner_bit_identical_all"],
    }
