"""Bucketed frame batching (the planning subset of ``esac_tpu/serve/batching.py``).

Every dispatch is padded up to one of ``RansacConfig.frame_buckets``, with
at least ``MIN_LANES`` physical lanes, by repeating the last real frame.
Lanes are independent -- every stage of the frames-major pipeline is
per-frame, each frame has its own generator -- so padding cannot perturb a
real frame's result.  The staging cache and the dispatcher wait for the
serving slice.
"""

from __future__ import annotations

import numpy as np
import torch


class ConfigError(ValueError):
    """Caller misuse of the serving API (a bad frame count or bucket)."""

    retryable = False
    wire_name = "config"


# Smallest physical frame-batch any dispatch runs at.  In the JAX package a
# collapsed B=1 batch compiles differently from B >= 2; the port keeps the
# same lane floor so both packages dispatch the same shapes.
MIN_LANES = 2


def pick_bucket(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n; ``n`` above the largest bucket is a planning
    error (:func:`plan_dispatches` splits bulk requests first)."""
    if n < 1:
        raise ConfigError(f"need at least one frame, got {n}")
    for b in sorted(set(buckets)):
        if b >= n:
            return b
    raise ConfigError(f"{n} frames exceed the largest bucket {max(buckets)}")


def _lanes(chunks: list[int], buckets: tuple[int, ...]) -> int:
    """Total physical lanes a chunk list costs after bucket padding."""
    return sum(max(pick_bucket(c, buckets), MIN_LANES) for c in chunks)


def _plan_tail(rem: int, buckets: tuple[int, ...]) -> list[int]:
    """One padded dispatch, or the largest fitting bucket plus a planned
    remainder -- whichever costs fewer physical lanes; ties go to fewer
    dispatches.  E.g. with buckets (1, 4, 16, 64): 17 -> [16, 1],
    5 -> [4, 1], 63 -> [63]."""
    single = [rem]
    fit = [b for b in sorted(set(buckets)) if b <= rem]
    if not fit or rem in fit:
        return single
    split = [fit[-1]] + _plan_tail(rem - fit[-1], buckets)
    if _lanes(split, buckets) < _lanes(single, buckets):
        return split
    return single


def plan_dispatches(n: int, buckets: tuple[int, ...]) -> list[int]:
    """Split ``n`` frames into per-dispatch valid-frame counts: full
    largest-bucket dispatches, then a minimal-waste tail plan."""
    if n < 1:
        raise ConfigError(f"need at least one frame, got {n}")
    big = max(buckets)
    plan = [big] * (n // big)
    rem = n - big * len(plan)
    if rem:
        plan += _plan_tail(rem, buckets)
    return plan


def _pad_leaf(x, extra: int):
    """Append ``extra`` copies of the last frame along axis 0."""
    if extra == 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x] + [x[-1:]] * extra, dim=0)
    x = np.asarray(x)
    return np.concatenate([x] + [x[-1:]] * extra, axis=0)


def stack_frames(frames: list[dict]) -> dict:
    """Stack per-frame trees along a new leading frame axis: torch leaves
    with ``torch.stack``, everything else with ``np.stack`` on the host."""
    out = {}
    for name in frames[0]:
        leaves = [fr[name] for fr in frames]
        if isinstance(leaves[0], torch.Tensor):
            out[name] = torch.stack(leaves)
        else:
            out[name] = np.stack([np.asarray(v) for v in leaves])
    return out


def pad_batch(batch: dict, bucket: int) -> tuple[dict, int]:
    """Pad a frame-stacked tree to ``max(bucket, MIN_LANES)`` lanes by
    repeating the last real frame.  Returns (padded tree, n_valid);
    results beyond ``n_valid`` are padding and must be dropped."""
    n_valid = len(next(iter(batch.values())))
    lanes = max(bucket, MIN_LANES)
    if n_valid > bucket:
        raise ConfigError(f"{n_valid} frames do not fit bucket {bucket}")
    extra = lanes - n_valid
    return {k: _pad_leaf(v, extra) for k, v in batch.items()}, n_valid
