"""From records to numbers: tails and rates over all requests and the whole
window, and the reduction of a ``torch.profiler`` trace to device time by
kind of kernel, the busy union and the idle gaps."""

from __future__ import annotations

import bisect
import math
import re

# Kernels of the soft-inlier score-and-select pass (csrc/soft_inlier.cu).
SCORE_KERNELS = re.compile(r"partial_kernel|select_final_kernel|sum_kernel")
# cuDNN's convolution kernels on the H100 (xmma / CUTLASS "fprop" implicit
# GEMMs and cuDNN's layout and padding kernels around them).  Classified by
# name: the profiler's link from a kernel to its launching op is not
# reliable across threads.
CONV_KERNELS = re.compile(r"fprop|cudnn|nhwcToNchw|nchwToNhwc|nhwcAddPadding")
COPY_PREFIXES = ("Memcpy", "Memset")


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of all values: the
    smallest value with at least q% of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    k = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
    return vals[k]


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def idle_gaps(intervals) -> list[tuple[float, float]]:
    """The gaps between the union of (start, end) intervals, in order."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def kind_of(name: str) -> str:
    """"copy", "score", "conv" or "eager" for a device event of ``name``."""
    if name.startswith(COPY_PREFIXES):
        return "copy"
    if SCORE_KERNELS.search(name):
        return "score"
    if CONV_KERNELS.search(name) and not name.startswith("void at::native::"):
        return "conv"
    return "eager"


def reduce_profile(events, window_s: float, top: int = 10) -> dict:
    """Device events of a profiled window (``prof.events()``): each kernel's
    (name, start us, duration us, kind), the busy time (union of every
    device interval), and the ``top`` device ops and idle gaps for the
    breakdown, each gap named by the innermost host op running through it."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start,
                            e.time_range.end - e.time_range.start, kind_of(e.name)))
        elif e.device_type == DeviceType.CPU and e.time_range.end > e.time_range.start:
            host.append((e.time_range.start, e.time_range.end, e.name))
    host.sort(key=lambda h: h[0])
    spans = [(s, s + d) for _, s, d, _ in kernels]
    busy_s = union_length(spans) / 1e6
    by_name: dict = {}
    for name, _, d, _ in kernels:
        by_name[name] = by_name.get(name, 0.0) + d / 1e6
    starts = [h[0] for h in host]
    reach, far = [], -math.inf  # reach[i]: the latest end among host[:i + 1]
    for h in host:
        far = max(far, h[1])
        reach.append(far)
    by_host: dict = {}
    for g0, g1 in idle_gaps(spans):
        # The latest-starting host op still running at the gap's middle is
        # the innermost one of its thread.
        mid, label = (g0 + g1) / 2, "no host op"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and reach[i] >= mid:
            if host[i][1] >= mid:
                label = host[i][2]
                break
            i -= 1
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0) / 1e6
    return {
        "kernels": kernels,
        "busy_s": busy_s,
        "window_s": window_s,
        "device_ops": sorted(([n[:120], v] for n, v in by_name.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([n, v] for n, v in by_host.items()), key=lambda kv: -kv[1])[:top],
    }


def device_seconds(profile: dict, kind: str) -> float:
    return sum(d for _, _, d, k in profile["kernels"] if k == kind) / 1e6


def launches(profile: dict, kind: str) -> int:
    return sum(1 for *_, k in profile["kernels"] if k == kind)
