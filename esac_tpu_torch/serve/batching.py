"""Bucketed frame batching and pooled staging (``esac_tpu/serve/batching.py``).

Every dispatch is padded up to one of ``RansacConfig.frame_buckets``, with
at least ``MIN_LANES`` physical lanes, by repeating the last real frame.
Padding never perturbs a real frame: every stage is per-frame and each
frame has its own generator.  What the card was shown to keep when the
same frame rides another bucket (chip_smoke.py phase 5, NVIDIA H100):

- the RANSAC stage (``esac_infer_frames`` on given coordinates and seeds):
  bit-identical at 2, 4, 16 and 64 lanes under every scoring_impl -- the
  kernels' cell split depends on N alone and the geometry core sums in a
  batch-independent order (``utils/precision``);
- routed serving (``make_routed_scene_bucket_fn``, k = 2 of 7), end to
  end: bit-identical on every output but ``gating_probs`` (up to 2.4e-7
  apart at 16 lanes), since the expert CNNs run over blocks of one fixed
  width (``routed_serve_capacity``) in every bucket and the gating CNN at
  the bucket's width;
- dense serving (``make_scene_bucket_fn``), end to end: NOT bit-identical.
  cuDNN convolves a frame differently in a batch of 2 than of 4 or 16
  (scene coordinates up to 2e-4 apart at 16 lanes, gating logits 1.4e-6),
  and RANSAC may then pick another hypothesis: with the full-width
  preset's random weights the winning expert changed for some frames.
  The dense contract is weaker: a frame's scene coordinates agree across
  buckets to cuDNN's rounding, its pose only where the winner stays.

:class:`StagingCache` is the dispatch path's zero-allocation staging:
pooled host buffers per thread (pinned when the dispatcher serves the
card), filled by row copies.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from esac_tpu_torch.serve.slo import ConfigError

__all__ = ["ConfigError", "MIN_LANES", "StagingCache", "batch_signature",
           "count_signatures", "pad_batch", "pick_bucket", "plan_dispatches", "stack_frames"]


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


def _stage_leaf_slow(leaves: list, lanes: int):
    """One leaf through the allocation path: exactly the
    :func:`stack_frames` + :func:`_pad_leaf` composition (the staging
    cache's fallback for leaves its buffers cannot hold -- tensors on the
    card, dtypes numpy lacks, a dtype or shape drift mid-batch)."""
    x = stack_frames([{"x": v} for v in leaves])["x"]
    return _pad_leaf(x, lanes - len(leaves))


class _BufferPool:
    """A fixed rotation of preallocated staging buffers (one shape/dtype):
    each a host tensor and the numpy view its rows are written through."""

    __slots__ = ("bufs", "i")

    def __init__(self, bufs: list[tuple[torch.Tensor, np.ndarray]]):
        self.bufs = bufs
        self.i = 0

    def take(self) -> tuple[torch.Tensor, np.ndarray]:
        buf = self.bufs[self.i]
        self.i = (self.i + 1) % len(self.bufs)
        return buf


class StagingCache:
    """Pooled staging: the zero-allocation fast path of
    ``pad_batch(stack_frames(frames), bucket)``.

    Per-thread pools of preallocated ``(lanes, *frame_shape)`` host
    tensors keyed by (leaf name, lanes, dtype, shape): staging is row copies
    into an existing buffer and a broadcast fill of the pad tail.  With
    ``pin=True`` (a dispatcher serving the card) the buffers are pinned, so
    the dispatcher's one ``.to(device, non_blocking=True)`` per leaf is an
    asynchronous copy.  Leaves the buffers cannot hold bit-exactly -- torch
    tensors numpy cannot view (on the card, bfloat16), dtypes torch lacks,
    a dtype/shape drift mid-batch (``np.stack`` would promote; a buffer
    write would silently cast) -- fall back to :func:`_stage_leaf_slow`,
    per leaf per call.  The values are bit-identical to
    ``pad_batch(stack_frames(..))`` in every case.

    **Aliasing discipline** (why ``depth`` exists and must be >= 2): on the
    CPU, ``.to("cpu")`` is the tensor itself -- the "device" batch aliases
    the staging buffer -- and on the card the asynchronous copy reads the
    pinned buffer after the call returns.  A buffer may therefore only be
    rewritten once the dispatch that staged from it has been synchronized.
    Every dispatch path synchronizes before its thread stages again, and
    the double-buffered ``infer_many`` overlaps at most ONE staging with
    one in-flight dispatch, so a rotation of two buffers is exactly
    sufficient: the buffer reused at dispatch N was staged at N-2, whose
    stream the N-1 boundary already synchronized.  Pools are thread-local,
    which also isolates a watchdog-replaced worker from a predecessor
    wedged mid-dispatch.
    """

    def __init__(self, depth: int = 2, pin: bool = False):
        if depth < 2:
            raise ConfigError(
                f"staging depth {depth} < 2: the device batch may alias the "
                "staging buffer (CPU), or copy from it after the call returns "
                "(the card), so the buffer feeding an in-flight dispatch must "
                "never be the next one rewritten"
            )
        self._depth = depth
        self._pin = pin
        self._tls = threading.local()

    def _pool(self, pools: dict, key, row: np.ndarray) -> _BufferPool | None:
        pool = pools.get(key)
        if pool is None:
            try:
                dtype = torch.from_numpy(np.empty(0, row.dtype)).dtype
            except TypeError:
                return None  # a dtype torch lacks
            bufs = []
            for _ in range(self._depth):
                t = torch.empty((key[1],) + row.shape, dtype=dtype, pin_memory=self._pin)
                bufs.append((t, t.numpy()))
            pool = pools[key] = _BufferPool(bufs)
        return pool

    def _thread_pools(self) -> dict:
        pools = getattr(self._tls, "pools", None)
        if pools is None:
            pools = self._tls.pools = {}
        return pools

    def reserve(self, frame: dict, buckets) -> None:
        """Allocate this thread's pools for a frame tree like ``frame`` at
        every bucket in ``buckets``, so that no later :meth:`stage` pays a
        first (on the card, pinned) allocation."""
        pools = self._thread_pools()
        for bucket in buckets:
            lanes = max(bucket, MIN_LANES)
            for name, leaf in frame.items():
                try:
                    row = np.asarray(leaf)
                except (TypeError, RuntimeError):
                    continue  # staged through the fallback, no pool
                self._pool(pools, (name, lanes, row.dtype.str, row.shape), row)

    def stage(self, frames: list[dict], bucket: int) -> tuple[dict, int]:
        """``pad_batch(stack_frames(frames), bucket)``, bit-identical,
        through the per-thread buffer pools.  Returns (tree, n_valid): host
        tensors that alias pooled buffers (numpy arrays for fallback
        leaves).  Consume the tree (copy it to the device and synchronize)
        before this thread stages ``depth`` more batches."""
        n_valid = len(frames)
        lanes = max(bucket, MIN_LANES)
        if n_valid > bucket:
            raise ConfigError(f"{n_valid} frames do not fit bucket {bucket}")
        pools = self._thread_pools()
        out = {}
        for name in frames[0]:
            leaves = [fr[name] for fr in frames]
            buf = None
            try:
                row = np.asarray(leaves[0])
            except (TypeError, RuntimeError):
                row = None  # a tensor on the card, or one numpy cannot view
            pool = None if row is None else self._pool(
                pools, (name, lanes, row.dtype.str, row.shape), row)
            if pool is not None:
                buf, view = pool.take()
                view[0] = row
                for j in range(1, n_valid):
                    try:
                        a = np.asarray(leaves[j])
                    except (TypeError, RuntimeError):
                        buf = None
                        break
                    if a.dtype != view.dtype or a.shape != view.shape[1:]:
                        buf = None  # np.stack would promote; don't cast
                        break
                    view[j] = a
            if buf is None:
                out[name] = _stage_leaf_slow(leaves, lanes)
            else:
                if n_valid < lanes:
                    view[n_valid:] = view[n_valid - 1]
                out[name] = buf
        return out, n_valid

    def unalias(self, arrays: list) -> list:
        """Copy every host result array that may alias one of this thread's
        pooled staging buffers.

        A bucket function that passes an input straight through to an
        output (an echo field) returns, on the CPU, the staged tensor itself
        -- the pooled buffer -- and a result must stay valid after the pool
        rewrites that buffer.  ``np.may_share_memory`` is a cheap bounds
        check; a false positive just buys one defensive copy."""
        pools = getattr(self._tls, "pools", None)
        if pools is None:
            return list(arrays)
        views = [v for p in pools.values() for _, v in p.bufs]
        return [
            a.copy()
            if isinstance(a, np.ndarray)
            and any(np.may_share_memory(a, v) for v in views)
            else a
            for a in arrays
        ]


def batch_signature(batch: dict) -> tuple:
    """A batch's signature: (leaf name, shape, dtype name) per leaf, the
    lanes included in each shape.  The JAX package compiles one program per
    signature; the port's bucket functions record the signatures they run
    (``_cache_size``) so the same no-recompile invariants hold as counts of
    signatures."""
    out = []
    for name in sorted(batch):
        v = batch[name]
        if isinstance(v, torch.Tensor):
            dtype = str(v.dtype).removeprefix("torch.")
        else:
            v = np.asarray(v)
            dtype = v.dtype.name
        out.append((name, tuple(v.shape), dtype))
    return tuple(out)


def count_signatures(fn):
    """Wrap ``fn(..., batch)`` (the batch its last positional argument) so
    it records each distinct :func:`batch_signature` it is called with;
    ``wrapped._cache_size()`` is their count."""
    seen = set()

    def run(*args):
        seen.add(batch_signature(args[-1]))
        return fn(*args)

    run._cache_size = lambda: len(seen)
    return run
