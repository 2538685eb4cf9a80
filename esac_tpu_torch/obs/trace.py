"""Request-scoped span chains and causal traces (a copy of
``esac_tpu/obs/trace.py``).

A traced request carries ONE :class:`SpanChain`: an append-only list of
(stage, monotonic-timestamp) stamps written at the dispatcher's existing
choke points -- no new threads, no device syncs.  The canonical stage
sequence of a served request:

  ``admitted``   -- ``submit()`` accepted the request (its ``t_submit``)
  ``coalesced``  -- the worker popped it into a dispatch batch
  ``staged``     -- the batch is padded, stacked and copied to the device
  ``dispatched`` -- the bucket function returned (its work may still be
                   queued on the card)
  ``device``     -- the dispatch's stream was synchronized (the sync the
                   dispatch path already performs)
  ``sliced``     -- per-request host results were cut from the batch
  ``<outcome>``  -- terminal stamp at ``t_done`` (served / degraded /
                   expired / failed), written by ``_finish``

Each consecutive stamp pair defines one duration, attributed to the LATER
stage, so a request that never dispatched (expired in queue, failed by the
watchdog) still yields a well-formed chain.  Durations telescope: their sum
is exactly last-stamp minus first-stamp, the request's end-to-end latency
(``t_done - t_submit``).  A dispatch retry re-stamps staged / dispatched /
device for each attempt; :meth:`SpanChain.durations` aggregates by stage
name.

Inside ``dispatched`` a traced dispatch nests the stages of the bucket
call (:data:`SERVE_STAGES`), each ending where the code reaches its
boundary (:func:`serve_stage`):

  ``resolve``    -- the registry's serve up to the bucket function's body
                   (probe drain, manifest resolve, ``_fn_for``, the weight
                   cache)
  ``cnn``        -- the images to float32 and the expert and gating CNNs
  ``sampling``   -- the per-frame generators (the seed readback, which
                   waits for the CNNs on the card), the correspondence
                   sets and the cell subsample's draws
  ``hypotheses`` -- gather, P3P and polish of every hypothesis
  ``scoring``    -- the cell subsample's gathers, score and select, the
                   prior slot, the argmax over experts and the winner's
                   takes
  ``refine``     -- IRLS refinement of the winner and the result's few ops
  ``outputs``    -- the health probe, up to the ``dispatched`` stamp

A gating-first routed call (``registry.serving.make_routed_scene_bucket_fn``
with top-k below M) has one stage more, :data:`ROUTE_STAGE`, between
``resolve`` and ``cnn``: the gating CNN, the top-k and the slot
assignment; its ``cnn`` is then the expert blocks alone.  Such a call also
announces its routing (:func:`serve_routing`), and once the dispatch's
``experts_evaluated`` reached the host the dispatcher counts it
(:func:`route_counts`): ``route.pairs`` (the real frames' selected pairs
that capacity kept), ``route.dropped`` (those it dropped) and
``route.slots`` (the expert-CNN images convolved), nested on every traced
request of the dispatch as counts, not seconds (:func:`is_count`), and
added to the routing counter the call named.  Every traced bucket call
also counts its convolutions (:func:`convs_issued`): ``cnn.convs`` and,
of those, ``cnn.fused_convs`` (bias, residual and ReLU in cuDNN's
epilogue, ``models.expert.conv_epilogue``), nested as counts on the
dispatch's first traced request only, so that a sum over requests counts
each dispatch once.

They land on the chain as nested entries: ``dispatched.<stage>`` (host
seconds, the dispatcher's clock) and, on the card, ``gpu.<stage>`` (the
device's seconds from reaching one boundary to reaching the next, idle
gaps inside the stage included; CUDA events read after the
synchronization the dispatch already performs) and, where a stage ran as
a CUDA graph replay (``registry.graphs``), ``graph.<stage>`` (the host
seconds of the replay call).  The nested host stages
telescope to ``dispatched`` on their own; :meth:`SpanChain.segments`,
:meth:`~SpanChain.total` and :meth:`~SpanChain.residual` stay over the
top-level stages, and :meth:`~SpanChain.durations` reports both.  The same
boundaries open and close host-only profiler ranges ``esac.<stage>`` (not
user annotations, so the device trace gains no event), and the
dispatcher's waits get their own (``esac.wait_work``, ``esac.hold``,
``esac.staging``, ``esac.to_host``): a ``torch.profiler`` trace names each
idle gap of the card by the stage the host was in.

Chains are written by one thread at a time (the submitter, then the worker
that owns the batch, then whoever resolves the request under the
dispatcher lock), so they carry no lock of their own -- with one
exception: a request abandoned mid-dispatch (caller timeout, watchdog) is
resolved by its terminal stamp while the wedged worker may still be
walking the batch.  Every accessor therefore truncates the chain at the
FIRST terminal stamp, so late post-terminal writes are inert.

:class:`Trace` ties one request's tiers together under one trace id: a root
SpanChain in the minting tier's clock plus lockless child :class:`Span`
records (the registry fault path: cache miss -> disk load -> stage; breaker
events as zero-duration spans).  Trace CONTEXT reaches the registry tiers
through a contextvar: the dispatcher wraps each dispatch attempt in
:func:`trace_scope`, and the weight cache and scene-health machinery record
spans into :func:`active_traces` only when the running dispatch carries
one.  :class:`TraceStore` is the ring-bounded home of completed traces
(the ``traces`` collector); its lock is a leaf: nothing is acquired under
it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import math
import os
import threading

# The non-terminal stages, in dispatch order.
STAGES = ("admitted", "coalesced", "staged", "dispatched", "device",
          "sliced")
# Terminal stamps reuse the outcome-class names of the SLO accounting.
TERMINAL_STAGES = ("served", "degraded", "shed", "expired", "failed")
# The stages of a traced bucket call, nested inside ``dispatched``, in order.
SERVE_STAGES = ("resolve", "cnn", "sampling", "hypotheses", "scoring",
                "refine", "outputs")
# The routed call's stage between "resolve" and "cnn".
ROUTE_STAGE = "route"
# The profiler range that opens as each stage is marked.
_NEXT_RANGE = dict(zip(SERVE_STAGES, SERVE_STAGES[1:]), **{ROUTE_STAGE: "cnn"})
# The counts of a traced routed dispatch (module docstring), and the
# prefix of their nested keys.
ROUTE_COUNTS = ("pairs", "dropped", "slots")
_COUNT_PREFIX = ROUTE_STAGE + "."
# The convolution counts of a traced bucket call (module docstring).
CONV_COUNTS = ("cnn.convs", "cnn.fused_convs")


def is_count(key: str) -> bool:
    """Whether a nested key of :meth:`SpanChain.durations` is a count
    (``route.<count>``, ``cnn.<count>``) rather than seconds."""
    return key.startswith(_COUNT_PREFIX) or key in CONV_COUNTS


class SpanChain:
    """Append-only (stage, t) stamps for one request, plus the nested
    stages of its bucket calls; see module doc."""

    __slots__ = ("stamps", "nested")

    def __init__(self, stage: str, t: float):
        self.stamps: list[tuple[str, float]] = [(stage, t)]
        # (stamps written before it, "dispatched.<stage>" | "gpu.<stage>", dt)
        self.nested: list[tuple[int, str, float]] | None = None

    def stamp(self, stage: str, t: float) -> None:
        self.stamps.append((stage, t))

    def nest(self, stages) -> None:
        """Add nested (key, dt) entries; like a stamp, an entry written
        after the first terminal stamp is inert."""
        if self.nested is None:
            self.nested = []
        at = len(self.stamps)
        self.nested.extend((at, key, dt) for key, dt in stages)

    def _effective(self) -> list[tuple[str, float]]:
        """The chain up to (and including) its FIRST terminal stamp —
        the truncation that makes late post-terminal writes from an
        abandoned dispatch's worker inert (see module docstring)."""
        for i, (stage, _) in enumerate(self.stamps):
            if stage in TERMINAL_STAGES:
                return self.stamps[:i + 1]
        return self.stamps

    def total(self) -> float:
        """First terminal stamp (or last stamp, unresolved) minus first:
        the chain's end-to-end span."""
        eff = self._effective()
        return eff[-1][1] - eff[0][1]

    def segments(self) -> list[tuple[str, float]]:
        """(stage, dt) per consecutive stamp pair, attributed to the
        later stage, in stamp order (retries appear as repeats);
        truncated at the first terminal stamp."""
        eff = self._effective()
        out = []
        for (_, t0), (stage, t1) in zip(eff, eff[1:]):
            out.append((stage, t1 - t0))
        return out

    def nested_durations(self) -> dict[str, float]:
        """The nested stages (``dispatched.<stage>``, ``gpu.<stage>``,
        ``graph.<stage>``) and counts (``route.<count>``) aggregated by
        key, truncated like the stamps."""
        agg: dict[str, float] = {}
        if self.nested:
            eff = self._effective()
            # Entries written before the terminal stamp (if any) count.
            limit = len(eff) - (eff[-1][0] in TERMINAL_STAGES)
            for at, key, dt in self.nested:
                if at <= limit:
                    agg[key] = agg.get(key, 0.0) + dt
        return agg

    def durations(self) -> dict[str, float]:
        """Per-stage durations aggregated by stage name, then the nested
        stages (:meth:`nested_durations`).  The ``math.fsum`` of the
        top-level ones equals :meth:`total` (telescoping — the span
        integrity pin); the ``dispatched.<stage>`` ones sum to
        ``dispatched``."""
        agg: dict[str, float] = {}
        for stage, dt in self.segments():
            agg[stage] = agg.get(stage, 0.0) + dt
        if self.nested:
            agg.update(self.nested_durations())
        return agg

    def residual(self) -> float:
        """|fsum(top-level durations) - total| — 0 up to float summation
        noise; the span-integrity check."""
        return abs(math.fsum(dt for _, dt in self.segments()) - self.total())


def top_level(durations: dict) -> dict:
    """The top-level stages of a :meth:`SpanChain.durations` dict (the
    ones that telescope to the chain's total): nested keys carry a dot."""
    return {k: v for k, v in durations.items() if "." not in k}


# ---------------------------------------------------------------------------
# Causal traces: trace ids, child spans, context propagation.
# ---------------------------------------------------------------------------

_TRACE_SEQ = itertools.count(1)  # .__next__ is GIL-atomic


def new_trace_id() -> str:
    """Process-unique, cheap trace id (no uuid import on the hot path)."""
    return f"t{os.getpid():x}-{next(_TRACE_SEQ):x}"


class Span:
    """One child record of a :class:`Trace`: a named [t0, t1] interval
    (``kind`` in dispatch / weight_fault / event) with optional per-stage
    segments (a dispatch span carries the underlying request's chain
    segments) and free-form annotations.  Immutable after construction
    except ``parent_id``, which :meth:`Trace.finish` may assign by
    interval containment (a weight-fault span recorded mid-dispatch is
    adopted by the dispatch span that covers it)."""

    __slots__ = ("span_id", "parent_id", "name", "kind", "t0", "t1",
                 "stages", "annotations")

    def __init__(self, span_id, name, kind, t0, t1, stages=None,
                 parent_id=None, annotations=None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t0 = t0
        self.t1 = t1
        self.stages = stages  # [(stage, dt)] or None
        self.annotations = annotations or {}

    def to_dict(self) -> dict:
        out = {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "t0": self.t0,
            "duration_s": (self.t1 - self.t0
                           if self.t1 is not None else None),
        }
        if self.stages:
            out["stages"] = [[s, dt] for s, dt in self.stages]
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        return out


class Trace:
    """One sampled request's causal trace: a root :class:`SpanChain` in
    the minting tier's clock plus lockless child spans (module
    docstring).  ``root`` is stamped by the tier that minted the trace —
    a standalone traced dispatcher hands the root chain to the request
    itself (``req.spans is trace.root``), a FleetRouter keeps the root
    and gives each underlying request a fresh child chain."""

    __slots__ = ("trace_id", "scene", "root", "spans", "outcome", "done",
                 "sampled_1_in", "_span_seq")

    def __init__(self, t_submit: float, scene=None, trace_id: str = None,
                 sampled_1_in: int = 1, root_stage: str = "submitted"):
        self.trace_id = trace_id if trace_id is not None else new_trace_id()
        self.scene = scene
        self.root = SpanChain(root_stage, t_submit)
        self.spans: list[Span] = []  # append-only; GIL-atomic appends
        self.outcome = None
        self.done = False
        self.sampled_1_in = sampled_1_in
        self._span_seq = itertools.count(1)

    # -- write side (lockless; see module docstring) --

    def stamp(self, stage: str, t: float) -> None:
        """Stamp the ROOT chain (router overhead boundaries).  Inert
        after the terminal stamp — the SpanChain read-side truncation."""
        self.root.stamp(stage, t)

    def add_span(self, name: str, kind: str, t0: float, t1: float,
                 stages=None, parent_id=None, **annotations) -> Span:
        sp = Span(next(self._span_seq), name, kind, t0, t1, stages,
                  parent_id, annotations)
        self.spans.append(sp)
        return sp

    def add_event(self, name: str, t: float, **annotations) -> Span:
        """Zero-duration event span (breaker trips, quarantines,
        prefetch coalescing)."""
        return self.add_span(name, "event", t, t, **annotations)

    def finish(self, outcome: str, t_done: float) -> bool:
        """Terminal root stamp + adopt orphan spans into the dispatch
        span whose interval contains them.  Idempotent (first caller
        wins), mirroring the dispatcher's exactly-once ``_finish``."""
        if self.done:
            return False
        self.stamp(outcome, t_done)
        self.outcome = outcome
        dispatches = [s for s in list(self.spans) if s.kind == "dispatch"]
        for sp in list(self.spans):
            if sp.parent_id is None and sp.kind != "dispatch":
                for d in dispatches:
                    if d.t0 is not None and sp.t0 is not None \
                            and d.t0 <= sp.t0 and (d.t1 is None
                                                   or sp.t0 <= d.t1):
                        sp.parent_id = d.span_id
                        break
        self.done = True
        return True

    # -- read side --

    def total(self) -> float:
        return self.root.total()

    def durations(self) -> dict[str, float]:
        return self.root.durations()

    def residual(self) -> float:
        """The telescoping check: |fsum(root durations) - total|."""
        return self.root.residual()

    def to_dict(self) -> dict:
        eff = self.root._effective()
        return {
            "trace_id": self.trace_id,
            "scene": self.scene,
            "outcome": self.outcome,
            "sampled_1_in": self.sampled_1_in,
            "t_submit": eff[0][1],
            "total_s": self.total(),
            "root_stages": [[stage, dt] for stage, dt
                            in self.root.segments()],
            "nested_stages": [[key, dt] for key, dt
                              in self.root.nested_durations().items()],
            "residual_s": self.residual(),
            "spans": [s.to_dict() for s in list(self.spans)],
        }


class TraceStore:
    """Ring-bounded home of completed traces — the ``traces`` obs
    collector.  The lock is a LEAF of the committed lock graph
    (``add``/readers only touch the deque and counters; nothing is
    acquired under it), so publishing a trace from inside a dispatcher
    or router critical section is a sanctioned owner -> leaf nesting,
    exactly like the obs instrument locks."""

    def __init__(self, maxlen: int = 256):
        if maxlen < 1:
            raise ValueError(f"maxlen {maxlen} < 1")
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        self.added = 0

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)
            self.added += 1

    def traces(self) -> list[Trace]:
        with self._lock:
            return list(self._ring)

    def slowest(self, k: int = 5) -> list[dict]:
        """The K slowest COMPLETED retained traces, slowest first —
        rendered (to_dict) outside the lock."""
        done = [t for t in self.traces() if t.done]
        done.sort(key=lambda t: t.total(), reverse=True)
        return [t.to_dict() for t in done[:k]]

    def snapshot(self) -> dict:
        """The ``traces`` collector payload: counts + the 5 slowest."""
        with self._lock:
            retained = len(self._ring)
            added = self.added
        return {
            "added": added,
            "retained": retained,
            "slowest": self.slowest(5),
        }


# -- context propagation (dispatcher -> registry tiers) --

_ACTIVE_TRACES: contextvars.ContextVar = contextvars.ContextVar(
    "esac_obs_active_traces", default=()
)
_ISSUER: contextvars.ContextVar = contextvars.ContextVar(
    "esac_obs_issuer", default="demand"
)


def active_traces() -> tuple:
    """The traces carried by the dispatch currently running in this
    thread (empty when untraced — the common case, one contextvar
    read)."""
    return _ACTIVE_TRACES.get()


@contextlib.contextmanager
def trace_scope(traces):
    """Run a dispatch attempt with ``traces`` visible to the registry
    fault path (weight cache, host tier, scene health)."""
    token = _ACTIVE_TRACES.set(tuple(traces))
    try:
        yield
    finally:
        _ACTIVE_TRACES.reset(token)


def current_issuer() -> str:
    """Who is driving this thread's cache/tier loads: "demand" (a
    dispatch) or "prefetch" (the predictive prefetcher's cycle)."""
    return _ISSUER.get()


@contextlib.contextmanager
def issuer_scope(name: str):
    token = _ISSUER.set(name)
    try:
        yield
    finally:
        _ISSUER.reset(token)


# -- stages of a traced bucket call (dispatcher -> registry -> ransac) --

_STAGE_CLOCK: contextvars.ContextVar = contextvars.ContextVar(
    "esac_obs_stage_clock", default=None
)


def serve_stage(stage: str) -> None:
    """Boundary: the bucket call's ``stage`` (:data:`SERVE_STAGES`) has
    been issued.  One contextvar read when the dispatch is untraced (no
    sync, no allocation); under :func:`stage_scope` the running
    :class:`StageClock` marks it."""
    clock = _STAGE_CLOCK.get()
    if clock is not None:
        clock.mark(stage)


def serve_routing(num_experts: int, slots: int, counter=None) -> None:
    """The bucket call will route its frames gating-first over
    ``num_experts`` experts into ``slots`` expert-CNN images: its
    :data:`ROUTE_STAGE` follows ``resolve`` (call before marking that).
    One contextvar read when the dispatch is untraced; under
    :func:`stage_scope` the running :class:`StageClock` keeps the numbers
    for :meth:`StageClock.route_stages` and ``counter`` (a
    :class:`~esac_tpu_torch.obs.metrics.CounterVec` labelled ``count``, or
    None) to add them to."""
    clock = _STAGE_CLOCK.get()
    if clock is not None:
        clock.routing(num_experts, slots, counter)


def route_counts(evaluated, num_experts: int, slots: int) -> dict:
    """The counts of one routed dispatch from its real frames'
    ``experts_evaluated`` rows on the host ((frames, k), the sentinel
    ``num_experts`` where capacity dropped the pair)."""
    import numpy as np

    dropped = int(np.count_nonzero(np.asarray(evaluated) == num_experts))
    return {"pairs": int(np.size(evaluated)) - dropped, "dropped": dropped, "slots": slots}


def convs_issued(n: int, fused: int) -> None:
    """The bucket call issued ``n`` convolutions, ``fused`` of them with
    bias, residual and ReLU in cuDNN's epilogue.  One contextvar read when
    the dispatch is untraced; under :func:`stage_scope` the running
    :class:`StageClock` adds them up."""
    clock = _STAGE_CLOCK.get()
    if clock is not None:
        clock.convs(n, fused)


def graph_replayed(stage: str, seconds: float) -> None:
    """The bucket call's ``stage`` ran as a CUDA graph replay whose call
    took ``seconds`` of host time (``registry.graphs``); under
    :func:`stage_scope` the running :class:`StageClock` keeps it as
    ``graph.<stage>``."""
    clock = _STAGE_CLOCK.get()
    if clock is not None:
        clock.graph(stage, seconds)


@contextlib.contextmanager
def stage_scope(clock):
    """Run a traced bucket call with ``clock`` marking its stages."""
    token = _STAGE_CLOCK.set(clock)
    try:
        yield
    finally:
        _STAGE_CLOCK.reset(token)


def _profiling() -> bool:
    from torch.autograd import profiler

    return profiler._is_profiler_enabled


def open_range(name: str):
    """Enter a host-only profiler range ``esac.<name>`` while a profiler
    runs: a record function that is not a user annotation, so kineto
    mirrors no device event for it.  None while no profiler runs (or
    where this torch has no such range)."""
    if not _profiling():
        return None
    try:
        from torch._C._profiler import _RecordFunctionFast
    except ImportError:
        return None
    rf = _RecordFunctionFast("esac." + name)
    rf.__enter__()
    return rf


def close_range(rf) -> None:
    """Exit a range :func:`open_range` entered (None: nothing)."""
    if rf is None:
        return
    try:
        rf.__exit__(None, None, None)
    except RuntimeError:
        # Entered as the profiler started, before it recorded: nothing open.
        pass


@contextlib.contextmanager
def host_range(name: str):
    """The body inside the host-only profiler range ``esac.<name>``."""
    rf = open_range(name)
    try:
        yield
    finally:
        close_range(rf)


class StageClock:
    """The boundaries of one traced bucket call: the dispatcher's clock at
    each (:meth:`begin` at the ``staged`` stamp, :func:`serve_stage` marks,
    :meth:`finish` at the ``dispatched`` stamp, which marks ``outputs``), a
    timing CUDA event recorded on the current stream at each when
    ``device`` is a card, and the profiler range of the stage running.
    After each mark the range of the next stage in :data:`SERVE_STAGES`
    opens (:data:`ROUTE_STAGE` after ``resolve`` in a call that routes,
    ``cnn`` after it).  The device's stage times are read only after the
    caller's synchronization (:meth:`device_stages`), the routing counts
    after the results reached the host (:meth:`route_stages`)."""

    __slots__ = ("_clock", "_device", "marks", "_events", "_range", "_graphs", "_route",
                 "_convs")

    def __init__(self, clock, device):
        self._clock = clock
        self._device = device if getattr(device, "type", None) == "cuda" else None
        self.marks: list[tuple[str | None, float]] = []
        self._events: list = []
        self._range = None
        self._graphs: list[tuple[str, float]] = []
        self._route = None
        self._convs = [0, 0]

    def _record(self) -> None:
        if self._device is not None:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
            self._events.append(ev)

    def begin(self) -> float:
        t = self._clock()
        self.marks.append((None, t))
        self._record()
        self._range = open_range(SERVE_STAGES[0])
        return t

    def mark(self, stage: str) -> float:
        t = self._clock()
        self._record()
        close_range(self._range)
        nxt = ROUTE_STAGE if stage == "resolve" and self._route else _NEXT_RANGE.get(stage)
        self._range = open_range(nxt) if nxt is not None else None
        self.marks.append((stage, t))
        return t

    def routing(self, num_experts: int, slots: int, counter=None) -> None:
        """The call routes (:func:`serve_routing`): keep its numbers."""
        self._route = (num_experts, slots, counter)

    def routed(self) -> bool:
        return self._route is not None

    def route_stages(self, evaluated) -> list[tuple[str, float]]:
        """``(route.<count>, n)`` of a routed call (:func:`route_counts`
        over its real frames' ``experts_evaluated`` rows on the host),
        each also added to the call's counter; empty for a call that did
        not route."""
        if self._route is None:
            return []
        num_experts, slots, counter = self._route
        counts = route_counts(evaluated, num_experts, slots)
        if counter is not None:
            for name, n in counts.items():
                counter.inc(n, count=name)
        return [(_COUNT_PREFIX + name, counts[name]) for name in ROUTE_COUNTS]

    def convs(self, n: int, fused: int) -> None:
        """Count ``n`` convolutions of the call, ``fused`` of them fused
        (:func:`convs_issued`)."""
        self._convs[0] += n
        self._convs[1] += fused

    def conv_stages(self) -> list[tuple[str, float]]:
        """``(cnn.convs, n)`` and ``(cnn.fused_convs, n)`` of the call;
        empty where it issued no convolution."""
        if not self._convs[0]:
            return []
        return list(zip(CONV_COUNTS, self._convs))

    def finish(self) -> float:
        """Mark ``outputs``; returns the ``dispatched`` stamp's time."""
        return self.mark("outputs")

    def abandon(self) -> None:
        """Close the open range of a call that raised."""
        close_range(self._range)
        self._range = None

    def marked(self) -> bool:
        """Whether the call marked any stage of its own (a bucket function
        of the registry does; a bare infer_fn does not)."""
        return len(self.marks) > 2

    def host_stages(self) -> list[tuple[str, float]]:
        """``(dispatched.<stage>, seconds)`` between consecutive marks."""
        return [("dispatched." + stage, t1 - t0)
                for (_, t0), (stage, t1) in zip(self.marks, self.marks[1:])]

    def graph(self, stage: str, seconds: float) -> None:
        """Keep the host seconds of ``stage``'s CUDA graph replay
        (:func:`graph_replayed`)."""
        self._graphs.append(("graph." + stage, seconds))

    def graph_stages(self) -> list[tuple[str, float]]:
        """``(graph.<stage>, seconds)`` of each stage that replayed."""
        return list(self._graphs)

    def stages(self) -> list[tuple[str, float]]:
        """Every nested entry of the call: :meth:`host_stages`,
        :meth:`graph_stages` and :meth:`device_stages` (call after a
        synchronization past :meth:`finish`)."""
        return self.host_stages() + self.graph_stages() + self.device_stages()

    def device_stages(self) -> list[tuple[str, float]]:
        """``(gpu.<stage>, seconds)`` between consecutive events; call
        after a synchronization past :meth:`finish` (empty off the card)."""
        return [("gpu." + stage, e0.elapsed_time(e1) / 1e3)
                for (stage, _), e0, e1 in zip(self.marks[1:], self._events,
                                              self._events[1:])]
