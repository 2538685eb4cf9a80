"""CUDA graphs of the served RANSAC chain: the cache a bucket function owns.

``ransac.esac._serve_frames`` runs the chain after sampling as three
stages -- "hypotheses" (gather, P3P + polish), "scoring" (the cell
subsample's gathers, score and select, the prior slot, the argmax over
maps, the winner's takes) and "refine" (IRLS and the result's few ops) --
through :meth:`ServeGraphs.chain`.  Those stages are a fixed sequence of a
few thousand small kernels at fixed shapes that never syncs with the host;
run eagerly on the card, the host's issue of them, not the card, sets
their pace.
On CUDA tensors, per call signature:

- the first call runs eagerly: it is the warm-up (the kernel library,
  cuDNN, the allocator);
- the second copies its inputs into static buffers and captures each
  stage as one CUDA graph (on a side stream, with
  ``capture_error_mode="thread_local"`` so that work other threads issue,
  such as a prefetcher's loads, cannot break the capture; one memory pool
  a cache and device), then replays the three;
  ``SceneRegistry.prewarm_programs`` makes both calls on the card;
- every later call copies its inputs into the static buffers and replays.

The signature is what the call's inputs show: the device type, every
input's name, shape and dtype (so which optional inputs are present:
routing, the prior slot, the cell subsample), whether the sets were
injected, and the config fields the chain reads.  Nothing else is baked
into a graph: the scene's focal length, principal point, maps and logits
are inputs, so one bucket function serves every scene of its preset.  The
results are cloned out of the graph's memory, so a later replay never
overwrites a result still being read.  The lock serializes one cache's
graphed calls from copy-in to clone-out (fleet replicas in one process may
share a bucket function), and each holder's stream waits for the previous
holder's last copy.  A stage whose capture raised is never captured again:
its signature runs eagerly from then on.

Sampling stays eager (the seed readback, the generators' draws); CPU
tensors run every stage eagerly, as before.  ``capture`` replaces the
CUDA capture (the CPU tests' stand-in re-runs the captured closure over
the static buffers) and then engages on every device.

Counts: the scoring kernels' launch counters (``ransac.fused_scoring``)
keep counting real launches -- a capture leaves on them the launches its
stages made in its own thread (``thread_launches``: other threads launch
meanwhile), since its first replay is the call's run, and each later
replay adds them again.  ``serve_graph_captures_total`` and
``serve_graph_replays_total`` (label ``stage``) count captures and
replays; a traced dispatch gets ``graph.<stage>``, the host seconds of
each replayed stage (``obs.trace.graph_replayed``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from esac_tpu_torch.obs.metrics import CounterVec
from esac_tpu_torch.obs.trace import graph_replayed
from esac_tpu_torch.ransac.fused_scoring import (
    soft_inlier_score_select,
    soft_inlier_scores_kernel,
    thread_launches,
)

CAPTURES = "serve_graph_captures_total"
REPLAYS = "serve_graph_replays_total"
HELP = {CAPTURES: "served-chain stages captured as CUDA graphs, by stage",
        REPLAYS: "served-chain stages replayed as CUDA graphs, by stage"}
# The wrappers whose ``launches`` counters a replay advances.
_COUNTED = (soft_inlier_score_select, soft_inlier_scores_kernel)


def cuda_capture(fn, pool):
    """Capture ``fn()`` as one CUDA graph in the memory pool ``pool``, on a
    side stream that first waits for the current one.  Returns the graph's
    replay and ``fn``'s outputs (the graph's memory).  ``torch.cuda.graph``
    would also synchronize the card, collect the interpreter's garbage and
    empty the allocator's cache first: a capture lands on a served dispatch
    (under the dispatcher's watchdog), so it does none of that."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outs = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph.replay, outs


class _Signature:
    """One signature's static input buffers and captured stages
    (stage -> (replay, outputs, launches a replay adds))."""

    __slots__ = ("inputs", "stages", "broken")

    def __init__(self):
        self.inputs: dict | None = None
        self.stages: dict = {}
        self.broken = False


class _Graphed:
    """The runner of one graphed call: capture (the signature's second
    call) or replay each stage as ``_serve_frames`` reaches it."""

    def __init__(self, sig: _Signature, inputs: dict, capture, pool):
        self.capturing = not sig.stages
        if self.capturing:
            sig.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=v.device)
                          for k, v in inputs.items()}
        for k, v in inputs.items():
            sig.inputs[k].copy_(v)
        self._sig, self._capture, self._pool = sig, capture, pool
        self.captured: list[str] = []
        self.replayed: list[str] = []

    def __call__(self, stage, fn, prev, result=False):
        sig = self._sig
        t0 = time.perf_counter()
        if self.capturing:
            before = thread_launches(_COUNTED)
            replay, outs = self._capture(lambda: fn(sig.inputs, prev), self._pool)
            sig.stages[stage] = (replay, outs, [b - a for a, b in zip(
                before, thread_launches(_COUNTED))])
            replay()
            self.captured.append(stage)
        else:
            replay, outs, launches = sig.stages[stage]
            replay()
            for counted, n in zip(_COUNTED, launches):
                counted.launches += n
        if result:
            outs = {k: v.clone() for k, v in outs.items()}
        if not self.capturing:
            graph_replayed(stage, time.perf_counter() - t0)
            self.replayed.append(stage)
        return outs


class ServeGraphs:
    """The captured chains of one bucket function (module docstring),
    keyed by signature.  ``captures`` / ``replays``: the counters to
    advance (``SceneRegistry`` passes its obs registry's; by default the
    cache's own).  ``capture(fn, pool) -> (replay, outputs)`` replaces the
    CUDA capture, on every device."""

    def __init__(self, captures: CounterVec | None = None,
                 replays: CounterVec | None = None, capture=None):
        self.captures = captures if captures is not None else CounterVec(CAPTURES,
                                                                         HELP[CAPTURES])
        self.replays = replays if replays is not None else CounterVec(REPLAYS, HELP[REPLAYS])
        self._capture = capture
        self._lock = threading.Lock()
        self._sigs: dict = {}
        self._pools: dict = {}
        self._done = None

    def signatures(self) -> int:
        """Signatures seen (each ran eagerly once)."""
        with self._lock:
            return len(self._sigs)

    def _pool(self, device):
        """The memory pool every graph of this cache on ``device`` shares."""
        if device not in self._pools:
            self._pools[device] = (torch.cuda.graph_pool_handle()
                                   if self._capture is None else None)
        return self._pools[device]

    @contextlib.contextmanager
    def chain(self, inputs: dict, key: tuple):
        """The runner of one call of the chain over ``inputs`` (name ->
        tensor, all on one device) under ``key`` (what the caller observes
        beside the inputs); None where the call runs eagerly: CPU tensors
        under the CUDA capture, a signature's first call, a signature whose
        capture raised."""
        dev = next(iter(inputs.values())).device
        if self._capture is None and dev.type != "cuda":
            yield None
            return
        sig_key = (dev.type, key) + tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items()))
        with self._lock:
            sig = self._sigs.get(sig_key)
            if sig is None:
                self._sigs[sig_key] = _Signature()
        if sig is None or sig.broken:
            yield None
            return
        cuda = dev.type == "cuda"
        with self._lock:
            if cuda and self._done is not None:
                torch.cuda.current_stream(dev).wait_event(self._done)
            run = _Graphed(sig, inputs, self._capture or cuda_capture, self._pool(dev))
            try:
                yield run
            except BaseException:
                sig.broken = sig.broken or run.capturing
                raise
            if cuda:
                self._done = torch.cuda.Event()
                self._done.record(torch.cuda.current_stream(dev))
        for stage in run.captured:
            self.captures.inc(stage=stage)
        for stage in run.replayed:
            self.replays.inc(stage=stage)
