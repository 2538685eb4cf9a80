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


class SpanChain:
    """Append-only (stage, t) stamps for one request; see module doc."""

    __slots__ = ("stamps",)

    def __init__(self, stage: str, t: float):
        self.stamps: list[tuple[str, float]] = [(stage, t)]

    def stamp(self, stage: str, t: float) -> None:
        self.stamps.append((stage, t))

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

    def durations(self) -> dict[str, float]:
        """Per-stage durations aggregated by stage name.  Their
        ``math.fsum`` equals :meth:`total` (telescoping — the span
        integrity pin)."""
        agg: dict[str, float] = {}
        for stage, dt in self.segments():
            agg[stage] = agg.get(stage, 0.0) + dt
        return agg

    def residual(self) -> float:
        """|fsum(durations) - total| — 0 up to float summation noise;
        the span-integrity check."""
        return abs(math.fsum(self.durations().values()) - self.total())


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
