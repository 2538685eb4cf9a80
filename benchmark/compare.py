"""The comparison that decides ``correct``: what the timed path served for
a sample of frames against the plain reference on the same images, weights
and request seeds.

Numbers, each the worst frame of the sample but ``score_bias``:

- ``gating_gap``: the largest difference of a gating probability (the
  gating CNN).
- ``score_gap``: |served winning score - reference winning score| over the
  reference's (the expert CNNs' coordinates, the minimal solves, scoring
  and selection).  The winning score is the maximum over every hypothesis,
  which moves continuously with the coordinates even where the winning
  index flips between near-tied hypotheses.
- ``score_bias``: the mean over the sample of (served winning score -
  reference winning score) over the reference's, by magnitude.  Scoring
  in a lower precision shifts every frame's score one way; the worst
  frame's gap swings too much from seed to seed to show that.
- ``expert_gap``: how far the served expert's best reference score lies
  below the reference's winner, over the winner (0 where they agree): a
  near-tie between experts costs nothing, a wrong expert costs its deficit.
- ``rot_gap_deg``, ``trans_gap_cm``: rotation angle and camera-center
  distance between the served refined pose and the reference's (the
  refinement; both converge to the same optimum from the winners).
"""

from __future__ import annotations

import torch

from benchmark.reference import expm_so3, rotation_angle_deg

NUMBERS = ("gating_gap", "score_gap", "score_bias", "expert_gap", "rot_gap_deg",
           "trans_gap_cm")


def served_arrays(rows: list[dict], device) -> dict:
    """Stack the served per-frame result rows (host numpy) for comparison."""
    def col(key, dtype=torch.float64):
        return torch.stack([torch.as_tensor(r[key]) for r in rows]).to(device, dtype)

    return {"gating_probs": col("gating_probs"), "expert": col("expert", torch.long),
            "score": col("score"), "R": expm_so3(col("rvec")), "t": col("tvec")}


def numbers(served: dict, ref: dict) -> dict:
    """The compared numbers over a sample, both sides as ``served_arrays`` /
    ``reference.serve_frames`` give them (float64, same frame order)."""
    best = ref["score"]
    rows = torch.arange(best.shape[0], device=best.device)
    own = ref["best"][rows, served["expert"].clamp(0, ref["best"].shape[1] - 1)]
    centers = [-(R.transpose(-1, -2) @ t[..., None])[..., 0]
               for R, t in ((served["R"], served["t"]), (ref["R"], ref["t"]))]
    rel = (served["score"] - best) / best
    per = {
        "gating_gap": (served["gating_probs"] - ref["gating_probs"]).abs().amax(-1),
        "score_gap": rel.abs(),
        "score_bias": rel.mean().abs(),
        "expert_gap": (best - own) / best,
        "rot_gap_deg": rotation_angle_deg(served["R"], ref["R"]),
        "trans_gap_cm": 100 * torch.linalg.norm(centers[0] - centers[1], dim=-1),
    }
    # A NaN is as far off as anything: it must not pass a limit.
    return {k: float(torch.nan_to_num(v, nan=torch.inf).amax()) for k, v in per.items()}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its limit."""
    shown = {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS}
    return all(nums[k] <= limits[k] for k in NUMBERS), shown
