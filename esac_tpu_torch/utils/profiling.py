"""Profiling: a fenced stage timer, the hypotheses/s counter and a profiler
trace (counterpart of the first half of ``esac_tpu/utils/profiling.py``).

PyTorch returns before the card has finished, so a wall clock around a
CUDA call measures the enqueue: every timer here fences with
``torch.cuda.synchronize`` before it reads the clock.  The JAX package's
FLOP and roofline helpers wait for the benchmark slice.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def wait_for(target) -> None:
    """Wait for the card: ``target`` is a tensor, a ``torch.device`` or
    None; nothing to wait for on the CPU."""
    dev = target if isinstance(target, torch.device) else getattr(target, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates fenced wall-clock time per named stage.

    >>> t = StageTimer()
    >>> with t("solve", fence=device):
    ...     out = kernel(...)        # the timer synchronizes on exit
    >>> t.summary()

    The fence is the ``fence`` argument, or a tensor the body appends to
    the yielded list.  ``calls[name]`` keeps every call's seconds, so a
    caller can drop a warm-up call.
    """

    def __init__(self):
        self.calls: dict[str, list[float]] = defaultdict(list)

    @property
    def totals(self) -> dict[str, float]:
        return {name: sum(xs) for name, xs in self.calls.items()}

    @property
    def counts(self) -> dict[str, int]:
        return {name: len(xs) for name, xs in self.calls.items()}

    @contextlib.contextmanager
    def __call__(self, name: str, fence=None):
        t0 = time.perf_counter()
        holder = []
        try:
            yield holder
        finally:
            wait_for(holder[0] if holder else fence)
            self.calls[name].append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = len(self.calls[name])
            lines.append(f"{name:24s} {1e3 * total:10.1f} ms total "
                         f"{1e3 * total / n:8.2f} ms/call x{n}")
        return "\n".join(lines)


def hypotheses_per_sec(fn, args: tuple, n_hyps_per_call: int, repeats: int = 20,
                       device=None) -> float:
    """Fenced throughput of a hypothesis-loop callable: ``repeats`` calls
    after one warm-up, synchronized on ``device`` before each clock read."""
    fn(*args)
    wait_for(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(*args)
    wait_for(device)
    return repeats * n_hyps_per_call / (time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the body, CPU and (when there is a
    card) CUDA activity, written to ``log_dir`` for TensorBoard."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
