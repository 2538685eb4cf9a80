"""Micro-batching dispatcher: single-frame requests -> frames-major dispatches
(the port of ``esac_tpu/serve/dispatcher.py``).

The serial small-tensor chain of the hypothesis loop (P3P, selection,
winner-only IRLS) amortizes only by adding *frames* to a dispatch, so
requests that arrive one frame at a time are coalesced into fixed
frame-batch shapes before they reach the card:

- ``infer_one`` -- blocking single-request API.  A background worker holds
  the first queued request up to ``cfg.serve_max_wait_ms`` while more
  arrive, packs the queue into the smallest ``cfg.frame_buckets`` bucket,
  pads the tail (serve.batching), and fans results back out.
- ``infer_many`` -- bulk API: plans bucket-sized dispatches and
  double-buffers host staging against the in-flight dispatch (while
  dispatch *i* runs, dispatch *i+1* is stacked, padded and copied).

Staging and results: a dispatch's frames are row-copied into pooled host
buffers (pinned on the card; :class:`~esac_tpu_torch.serve.batching.\
StagingCache`), every leaf goes to the device with one
``.to(device, non_blocking=True)``, and after the call a CUDA event
recorded on the current stream is synchronized before ``t_done`` and the
"device" span stamp.  Results come back as host numpy: the result dict's
keys in sorted order, one ``.cpu()`` per leaf per dispatch, then per-frame
rows.  Everything runs on ``device`` (``None`` = the card; raises without
one unless the caller passes ``device="cpu"``).

The dispatcher is generic over the batched entry point: ``infer_fn`` takes
one frame-stacked dict (every leaf with a leading physical-lane axis) and
returns a flat dict of tensors or arrays with the same leading axis.
Builders for the single-map and multi-expert paths are below
(``make_dsac_serve_fn``, ``make_esac_serve_fn``).  PyTorch compiles
nothing per shape; each builder instead records the distinct batch
signatures (leaf names, shapes, dtypes) it has run and exposes their count
as ``_cache_size()`` -- the counterpart of the JAX package's jit cache,
which compiles one program per signature.  ``cache_size()`` reads it.

Multi-scene serving (esac_tpu_torch.registry): every request may carry a
``scene`` key and, for gating-first routed serving, a ``route_k`` top-K
value.  Requests coalesce per (scene, route_k, frame-bucket) lane -- a
dispatch is always single-scene, because the scene decides which weights
ride the call, and single-K, because K selects the routed bucket function
-- and the worker round-robins across lanes with pending work, so a hot
lane cannot starve a cold one.  Scene-carrying dispatches call
``infer_fn(tree, scene)`` (the registry's serve fn resolves weights from
its device cache per dispatch), routed ones ``infer_fn(tree, scene,
route_k)``; scene-less requests keep the ``infer_fn(tree)`` contract.

SLO serving (esac_tpu_torch.serve.slo): passing an ``slo`` policy opts the
request path into per-request deadlines (``submit``/``infer_one`` take
``deadline_ms``/``timeout``), bounded-queue admission control (a full
queue or a predicted deadline miss SHEDS with a typed
:class:`~esac_tpu_torch.serve.slo.ShedError` instead of blocking -- the
open-loop contract; bulk ``infer_many`` keeps blocking backpressure),
graceful degradation (under overload a lane's ``route_k`` downshifts one
rung of ``slo.degrade_route_k``), and a watchdog thread: a dispatch that
makes no progress within ``slo.watchdog_ms`` has its requests failed with
:class:`~esac_tpu_torch.serve.slo.DispatchStalledError` *within their
deadline*, its lane quarantined, and a replacement worker takes over the
healthy lanes instead of the whole server hanging.  A thread wedged inside
a CUDA call cannot be killed, only abandoned: its generation is retired
and whatever it returns is discarded.  Every request's fate lands in the
outcome accounting -- served / shed / expired / degraded / failed -- which
sums exactly to ``offered``.  Whether or not a policy is set, ``close()``
and a dying worker wake every pending caller with a typed error.

Every stat the dispatcher keeps (latencies, dispatch/scene/route/outcome
logs) is a ring buffer sized by ``stats_window``; the per-lane
``dispatch_counts`` / outcome totals are keyed by (scene, route_k),
bounded by the fleet, not by traffic.

Observability (esac_tpu_torch.obs): every dispatcher publishes its
accounting into a :class:`~esac_tpu_torch.obs.MetricsRegistry` (``obs``
attribute; pass one in to aggregate, default private) -- offered/outcome
counters, per-lane dispatch counters, and streaming-quantile latency
histograms.  ``dispatch_totals``/``slo_totals`` are views over those
counters (updated in the same locked sections as the attributes).  With
``trace=True`` every request additionally carries a
:class:`~esac_tpu_torch.obs.SpanChain` stamped at the existing choke
points (admitted -> coalesced -> staged -> dispatched -> device -> sliced
-> outcome); the stamps reuse the dispatch path's own timestamps and its
one synchronization -- zero added syncs -- and per-stage durations land in
the ``serve_stage_seconds`` histogram at ``_finish``.  NOTE on sharing:
give two dispatchers one registry only if you want AGGREGATED counters --
``slo_totals`` then spans both dispatchers while ``pending`` stays
per-instance; collector registration is last-wins, and ``reset_stats``
subtracts only the CALLING dispatcher's contribution from the shared
counters but clears the shared latency/stage histograms.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from esac_tpu_torch.obs import MetricsRegistry, Trace, trace_scope
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import esac_infer_frames
from esac_tpu_torch.ransac.kernel import dsac_infer_frames, frame_generators
from esac_tpu_torch.serve.batching import (
    StagingCache,
    count_signatures,
    pick_bucket,
    plan_dispatches,
)
from esac_tpu_torch.serve.slo import (
    DeadlineExceededError,
    DispatcherClosedError,
    DispatchStalledError,
    LaneQuarantinedError,
    ShedError,
    SLOPolicy,
    WorkerDiedError,
)
from esac_tpu_torch.utils.precision import resolve_device

# close() join budgets, seconds (every join is bounded: a thread wedged
# inside a device call can never be killed, only abandoned).
# Legacy mode (no SLOPolicy) drains the whole queue, so its window is
# generous; the watchdog exits within one poll of _closed.  Module-level
# so tests can shrink them to drill the wedged-close path.
_LEGACY_DRAIN_JOIN_S = 60.0
_WATCHDOG_JOIN_S = 2.0


class _Request:
    """One queued frame.  ``result``/``error`` are plain attributes for
    back-compat; :meth:`get` is the timeout-taking accessor every new
    caller should use (a bare ``event.wait()`` on a dead server is the
    exact unbounded-blocking bug this layer exists to kill)."""

    __slots__ = ("frame", "scene", "route_k", "event", "result",
                 "error", "t_submit", "t_done", "deadline", "done", "outcome",
                 "owner", "spans", "trace")

    def __init__(self, frame, t_submit, scene=None, route_k=None,
                 deadline=None, owner=None):
        self.frame = frame
        self.scene = scene
        self.route_k = route_k
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_submit = t_submit
        self.t_done = None
        self.deadline = deadline  # absolute clock() time, or None
        self.done = False
        self.outcome = None       # served|shed|expired|degraded|failed
        self.owner = owner        # dispatcher, for timeout abandonment
        self.spans = None         # obs.SpanChain when tracing is on
        self.trace = None         # obs.Trace when tracing is on

    def get(self, timeout: float | None = None):
        """Wait up to ``timeout`` seconds for the result; raises the
        request's typed error, or :class:`DeadlineExceededError` on
        timeout.  A timeout ABANDONS the request — same semantics as
        ``infer_one``'s timeout: it is marked expired, a late result is
        discarded, and the accounting agrees with what this call raised.
        The dispatcher guarantees the event fires on close, worker death
        and watchdog abandonment, so a bounded wait here is a real
        bound, not a hope."""
        if not self.event.wait(timeout):
            err = DeadlineExceededError(
                f"no result within {timeout}s — request abandoned"
            )
            if self.owner is not None:
                self.owner._abandon(self, err)
            if self.error is not None:  # resolved in the race window
                raise self.error
            if not self.done:
                raise err  # ownerless request (sync path): nothing to mark
            return self.result
        if self.error is not None:
            raise self.error
        return self.result


class _Inflight:
    __slots__ = ("gen", "lane", "reqs", "t_start")

    def __init__(self, gen, lane, reqs, t_start):
        self.gen = gen
        self.lane = lane
        self.reqs = reqs
        self.t_start = t_start


class MicroBatchDispatcher:
    """Accumulate single-frame requests into bucketed frames-major dispatches.

    ``infer_fn``: batched callable, frame-stacked tree -> tree (leading axis
    = physical lanes).  ``cfg`` supplies the static serving knobs
    (``frame_buckets``, ``serve_max_wait_ms``, ``serve_queue_depth``).
    ``start_worker=False`` skips the background thread: ``infer_one``
    dispatches synchronously (per-frame-call semantics) and ``infer_many``
    is unaffected -- the mode used by benchmarks and equivalence tests.
    ``slo`` (an :class:`~esac_tpu_torch.serve.slo.SLOPolicy`) opts into the
    deadline / admission-control / degradation / watchdog machinery; None
    keeps the blocking contract.  ``device`` is where dispatches are staged
    and synchronized (``None`` = the card).  ``warm_frame``, a frame tree
    shaped like the traffic's, allocates the staging pools of every frame
    bucket up front: here for the constructing thread (``infer_many`` and
    the sync path stage from their caller's thread), and in each worker
    thread before it takes a request (:meth:`start` waits for that), so no
    request pays a first pinned allocation.
    """

    def __init__(
        self,
        infer_fn,
        cfg: RansacConfig = RansacConfig(),
        start_worker: bool = True,
        clock=time.perf_counter,
        stats_window: int = 10_000,
        slo: SLOPolicy | None = None,
        obs: MetricsRegistry | None = None,
        trace: bool = False,
        device=None,
        warm_frame: dict | None = None,
    ):
        if stats_window < 1:
            raise ValueError(f"stats_window {stats_window} < 1")
        self._device = resolve_device(device)
        self._infer = infer_fn
        self._buckets = tuple(sorted(set(cfg.frame_buckets)))
        # Pooled host staging (per-thread buffers, see batching.py):
        # padding templates are built once per (leaf, lanes, dtype,
        # shape), not rebuilt every dispatch.
        self._staging = StagingCache(pin=self._device.type == "cuda")
        self._warm_frame = warm_frame
        if warm_frame is not None:
            self._staging.reserve(warm_frame, self._buckets)
        self._max_wait_s = cfg.serve_max_wait_ms / 1e3
        self._depth = cfg.serve_queue_depth
        self._clock = clock
        self._slo = slo
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)   # waiters: worker
        self._space = threading.Condition(self._lock)  # waiters: submitters
        # Per-(scene, route_k) lane queues in round-robin order (lane
        # (None, None) = the legacy single-scene mode); a dispatch never
        # mixes scenes — the scene decides the weights — and never mixes
        # route_k values, because K selects the routed bucket function:
        # one dispatch rides exactly one bucket function.
        self._pending: "collections.OrderedDict[tuple, collections.deque[_Request]]" = (
            collections.OrderedDict()
        )
        self._n_pending = 0
        self._closed = False
        # SLO state (all guarded by self._lock; the only nesting this
        # class takes is dispatcher lock -> obs instrument locks): the worker
        # generation counter lets the watchdog abandon a wedged worker — a
        # stale-generation worker discards whatever it eventually returns
        # and exits; quarantined maps lane -> reason; the dispatch-time EMA
        # feeds admission control's predicted-wait estimate.
        self._gen = 0
        self._inflight: _Inflight | None = None
        self._quarantined: dict[tuple, str] = {}
        self._fail_streak: collections.Counter = collections.Counter()
        self._ema_dispatch_s = 0.0
        self._ema_n = 0  # completed-dispatch samples behind the EMA
        self._worker_dead: str | None = None
        # Bounded stats: a serving process runs for days — EVERY per-request
        # and per-dispatch record here is a ring buffer, sized by
        # ``stats_window`` dispatches, or latency_quantiles() would sort an
        # unbounded history under the dispatch lock and host memory would
        # grow without limit (pinned by the long-stream regression test in
        # tests).  Quantiles are over the recent window; the
        # only unbounded-looking structures left are ``dispatch_counts``
        # and the outcome counters, keyed by (scene, route_k) lane /
        # outcome class and therefore bounded by the fleet, not by traffic.
        self.latencies_s: collections.deque[float] = collections.deque(
            maxlen=10 * stats_window
        )
        self.dispatch_log: collections.deque[tuple[int, int]] = (
            collections.deque(maxlen=stats_window)  # (bucket, n_valid)
        )
        # Scene / route_k of each dispatch, aligned with dispatch_log (None
        # entries for scene-less / dense traffic) — fairness tests zip them.
        self.scene_log: collections.deque = collections.deque(
            maxlen=stats_window
        )
        self.route_log: collections.deque = collections.deque(
            maxlen=stats_window
        )
        # Lifetime totals per lane (fairness monitoring without a log).
        self.dispatch_counts: collections.Counter = collections.Counter()
        # SLO accounting: every request ever offered ends in exactly one
        # outcome class — served / shed / expired / degraded / failed —
        # and the classes sum to ``offered`` (the acceptance invariant,
        # pinned in the tests).  ``outcome_log`` is the
        # ring-bounded per-request trail (outcome, scene, route_k, eff_k).
        self.offered = 0
        self.outcome_counts: collections.Counter = collections.Counter()
        self.outcome_log: collections.deque = collections.deque(
            maxlen=stats_window
        )
        # Observability: the unified metrics registry this
        # dispatcher publishes into.  The instruments are created once
        # here and cached as handles — the hot path never takes the
        # registry lock, only per-instrument locks, always nested INSIDE
        # the dispatcher lock (acyclic order: registry -> dispatcher ->
        # instrument; see esac_tpu_torch/obs/metrics.py).  ``trace`` gates the
        # per-request span chains; everything else is always on.
        self.obs = obs if obs is not None else MetricsRegistry()
        self._trace = bool(trace)
        # Completed traces land here (the ``traces`` collector).
        self._trace_store = self.obs.trace_store() if self._trace else None
        self._m_offered = self.obs.counter(
            "serve_offered_total",
            "requests ever offered (re-based by reset_stats)",
        )
        self._m_outcomes = self.obs.counter(
            "serve_outcomes_total",
            "terminal outcome classes; with pending they sum to offered",
        )
        self._m_dispatches = self.obs.counter(
            "serve_dispatches_total",
            "completed dispatches per (scene, route_k) lane",
        )
        # Two latency instruments on purpose: the FLEET histogram is one
        # unlabeled child whose window is the most recent 10*stats_window
        # samples GLOBALLY — the exact recent-window semantics of the
        # latencies_s deque it replaced (per-lane windows alone would let
        # an idle lane's stale samples dominate merged quantiles forever)
        # -- while the LANE histogram carries the
        # per-(scene, route_k) breakdown the open-loop views read.
        self._m_latency = self.obs.histogram(
            "serve_request_latency_seconds",
            "fleet-wide per-request completion latency (recent window)",
            window=10 * stats_window,
        )
        self._m_lane_latency = self.obs.histogram(
            "serve_lane_latency_seconds",
            "per-request completion latency by (scene, route_k) lane",
            window=10 * stats_window,
        )
        self._m_stage = self.obs.histogram(
            "serve_stage_seconds",
            "per-stage span durations of traced requests",
            window=10 * stats_window,
        )
        self.obs.register_collector("serve_slo_totals", self.slo_totals)
        self.obs.register_collector("serve_dispatch_totals",
                                    self.dispatch_totals)
        self.obs.register_collector("serve_quarantined_lanes",
                                    self.quarantined_lanes)
        self._worker = None
        self._watchdog = None
        if start_worker:
            self.start()

    def start(self):
        """Start the background worker (idempotent).  Requests may be
        ``submit``ted before start() — they dispatch on the first wakeup,
        the deterministic sequencing the coalescing tests rely on.  Don't
        race start() against ``infer_one`` from other threads: infer_one
        picks its (sync vs queued) path by whether a worker exists.  With a
        ``warm_frame``, returns once the worker's staging pools exist (a
        bounded wait)."""
        with self._work:
            ready = None
            if self._worker is None:
                self._worker, ready = self._spawn_worker()
            if self._slo is not None and self._watchdog is None:
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop, daemon=True,
                    name="esac-serve-watchdog",
                )
                self._watchdog.start()
        if ready is not None:
            ready.wait(_LEGACY_DRAIN_JOIN_S)

    def _spawn_worker(self) -> tuple[threading.Thread, threading.Event]:
        """Build + start a worker thread bound to the CURRENT generation
        (lock held); the event fires once its staging pools are reserved."""
        ready = threading.Event()
        t = threading.Thread(
            target=self._worker_loop, args=(self._gen, ready), daemon=True,
            name="esac-serve",
        )
        t.start()
        return t, ready

    # ---------------- request path ----------------

    def submit(self, frame: dict, scene=None, route_k=None,
               deadline_ms: float | None = None) -> _Request:
        """Enqueue one frame tree (optionally for a registry ``scene`` and
        a routed top-K program ``route_k``); returns a request whose
        ``event`` fires when ``result`` (or ``error``) is set.

        Without an SLO policy: blocks for queue space — backpressure
        across ALL lanes, never drops.  With one:
        admission control instead — a full queue, a quarantined lane, or
        a predicted deadline miss raises a typed
        :class:`~esac_tpu_torch.serve.slo.ShedError` subclass immediately, and
        the request carries ``deadline_ms`` (default
        ``slo.deadline_ms``)."""
        t_submit = self._clock()
        # An EXPLICIT deadline_ms is honored with or without a policy —
        # silently ignoring a requested bound would reintroduce the
        # unbounded-blocking bug for exactly the caller who asked not to
        # have it; the policy only supplies the default.
        if deadline_ms is None and self._slo is not None:
            deadline_ms = self._slo.deadline_ms
        deadline = (t_submit + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = _Request(frame, t_submit, scene, route_k, deadline, owner=self)
        self._init_trace(req, t_submit, scene)
        lane = (scene, route_k)
        with self._work:
            if self._slo is None:
                # Legacy backpressure — but a request WITH a deadline must
                # not strand in the space wait either: the bound applies
                # from the first instant, not only once queued.
                while self._n_pending >= self._depth and not self._closed \
                        and self._worker_dead is None:
                    remaining = (None if deadline is None
                                 else deadline - self._clock())
                    if remaining is not None and remaining <= 0:
                        self._count_offered()
                        self._count_outcome("expired", scene, route_k, None)
                        raise DeadlineExceededError(
                            "deadline expired waiting for queue space"
                        )
                    self._space.wait(remaining)
            self._raise_if_unservable()
            self._count_offered()
            if self._slo is not None:
                why = self._admission_reject(lane, req, t_submit)
                if why is not None:
                    self._count_outcome("shed", scene, route_k, None)
                    raise why
            q = self._pending.get(lane)
            if q is None:
                q = self._pending[lane] = collections.deque()
            q.append(req)
            self._n_pending += 1
            self._work.notify()
        return req

    def _init_trace(self, req: _Request, t_submit, scene):
        """Arm tracing for one request: a traced dispatcher mints a
        :class:`~esac_tpu_torch.obs.Trace` whose ROOT chain is the
        request's chain."""
        if self._trace:
            req.trace = Trace(t_submit, scene=scene, root_stage="admitted")
            req.spans = req.trace.root

    def _raise_if_unservable(self):
        """Reject submissions to a server that can no longer serve them
        (lock held): closed, or the worker thread died with the queue —
        the typed replacement for stranding callers forever."""
        if self._worker_dead is not None:
            raise WorkerDiedError(self._worker_dead)
        if self._closed:
            raise DispatcherClosedError("dispatcher is closed")

    def _abandon(self, req: _Request, err) -> None:
        """Caller-side timeout: mark ``req`` expired so the worker skips
        it (if still queued) or its late result is discarded (if in
        flight) — the accounting then agrees with the error the caller
        saw.  No-op if the request already resolved."""
        with self._work:
            self._finish(req, error=err, outcome="expired")

    def _admission_reject(self, lane, req, now):
        """SLO admission control (lock held): the typed error to raise, or
        None to admit.  Sheds on quarantine, a full bounded queue, and a
        predicted deadline miss (dispatch-time EMA x dispatches queued
        ahead — rejecting in microseconds beats serving a corpse late).
        Predicted-miss shedding needs >= 2 completed dispatches behind
        the EMA: a single sample may be a warm-up-inflated outlier, and
        shedding on it would poison a healthy server forever (nothing
        would ever dispatch to correct the estimate)."""
        reason = self._quarantined.get(lane)
        if reason is not None:
            return LaneQuarantinedError(
                f"lane {lane} is quarantined ({reason}); release_lane() "
                "after the fault is cleared"
            )
        if self._n_pending >= self._depth:
            return ShedError(
                f"queue full ({self._n_pending}/{self._depth} pending)"
            )
        if (self._slo.shed_on_predicted_miss and req.deadline is not None
                and self._ema_n >= 2):
            # Dispatches needed before this request's own dispatch lands:
            # everything already queued, bucket-coalesced, plus its own.
            ahead = 1 + self._n_pending // self._buckets[-1]
            predicted = now + ahead * self._ema_dispatch_s
            if predicted > req.deadline:
                return ShedError(
                    f"predicted wait {ahead * self._ema_dispatch_s * 1e3:.1f}ms "
                    f"exceeds deadline "
                    f"({(req.deadline - now) * 1e3:.1f}ms remaining)"
                )
        return None

    def infer_one(self, frame: dict, scene=None, route_k=None,
                  timeout: float | None = None,
                  deadline_ms: float | None = None) -> dict:
        """Blocking single-frame inference through the batching queue.

        ``timeout`` bounds the wait in seconds (independent of any SLO);
        ``deadline_ms`` rides the request into the queue (SLO mode).  On a
        deadline/timeout the request is abandoned — marked expired so a
        late result is discarded — and a typed
        :class:`DeadlineExceededError` is raised: no caller ever blocks
        past its deadline, even when the dispatch path is wedged.

        The worker-less sync mode (``start_worker=False``) executes the
        dispatch in the CALLER's thread, so a wedged ``infer_fn`` cannot
        be interrupted there; the bounds are instead enforced at
        completion — a result landing past ``deadline_ms``/``timeout``
        raises :class:`DeadlineExceededError` (outcome expired) rather
        than being returned as served."""
        with self._work:
            has_worker = self._worker is not None
        if not has_worker:
            t_submit = self._clock()
            if deadline_ms is None and self._slo is not None:
                deadline_ms = self._slo.deadline_ms
            bounds = ([t_submit + deadline_ms / 1e3]
                      if deadline_ms is not None else [])
            bounds += [t_submit + timeout] if timeout is not None else []
            req = _Request(frame, t_submit, scene, route_k,
                           min(bounds) if bounds else None, owner=self)
            self._init_trace(req, t_submit, scene)
            lane = (scene, route_k)
            with self._work:
                self._raise_if_unservable()
                self._count_offered()
                # Same lock acquisition as the offered count: the request
                # must never be observable in neither table (the invariant
                # holds at every instant on the sync path too).
                self._inflight = _Inflight(None, lane, [req], t_submit)
            self._run([req], lane, route_k, False, None)
        else:
            if deadline_ms is None and timeout is not None:
                # The timeout is an end-to-end bound: riding it into the
                # queue as the deadline bounds the space wait and queue
                # residency too, not just the event wait at the end.
                deadline_ms = timeout * 1e3
            req = self.submit(frame, scene, route_k, deadline_ms)
            limit = timeout
            if req.deadline is not None:
                # Clamp to the REMAINING deadline window: submit() may
                # have consumed part of it in the space wait, and a fresh
                # full `timeout` anchored here would let the caller block
                # up to ~2x the requested end-to-end bound.
                remaining = max(0.0, req.deadline - self._clock())
                limit = remaining if limit is None else min(limit, remaining)
            if not req.event.wait(limit):
                self._abandon(
                    req,
                    DeadlineExceededError(
                        f"request exceeded its "
                        f"{'deadline' if timeout is None else 'timeout'} "
                        f"after {(self._clock() - req.t_submit) * 1e3:.1f}ms"
                    ),
                )
        if req.error is not None:
            raise req.error
        return req.result

    def infer_many(self, frames: list[dict], scene=None,
                   route_k=None) -> list[dict]:
        """Bulk inference: bucket-planned dispatches, staging double-buffered
        against in-flight compute.  Returns per-frame result trees (host
        numpy), in input order.  Bulk submission is inherently
        backpressured — each dispatch blocks the caller — so SLO admission
        control does not apply here; outcomes still land in the
        accounting."""
        t_submit = self._clock()
        plan = plan_dispatches(len(frames), self._buckets)
        bounds = []
        lo = 0
        for n in plan:
            bounds.append((lo, lo + n))
            lo += n

        def stage(lo, hi):
            bucket = pick_bucket(hi - lo, self._buckets)
            padded, n_valid = self._staging.stage(frames[lo:hi], bucket)
            return self._to_device(padded), n_valid, bucket

        results: list[dict] = []
        staged = stage(*bounds[0])
        for i in range(len(bounds)):
            tree, n_valid, bucket = staged
            # the call returns once its work is queued (or, where the
            # RANSAC path synchronizes inside, once that sync passed)
            out = self._call(tree, scene, route_k)
            done = self._record_done()
            if i + 1 < len(bounds):
                staged = stage(*bounds[i + 1])  # host staging overlaps compute
            self._wait(done)
            t_done = self._clock()
            keys, host_leaves = self._to_host(out)
            with self._lock:
                self._record(
                    bucket, n_valid, scene,
                    route_k, [t_done - t_submit] * n_valid,
                )
                self._count_offered(n_valid)
                # Bulk serves ride the per-request trail too: the ring and
                # the counters must tell one story on a mixed-traffic
                # server.
                self._count_outcome("served", scene, route_k, route_k,
                                    n=n_valid)
            results.extend(
                dict(zip(keys, (hl[j] for hl in host_leaves)))
                for j in range(n_valid)
            )
        return results

    # ---------------- worker ----------------

    def _call(self, tree, scene, route_k=None):
        """Invoke the entry point: scene-carrying dispatches pass the scene
        (and, for routed programs, ``route_k``) through — registry serve
        fns take ``(tree, scene[, route_k])``; legacy traffic keeps the
        one-argument contract byte-for-byte."""
        if route_k is not None:
            return self._infer(tree, scene, route_k)
        if scene is None:
            return self._infer(tree)
        return self._infer(tree, scene)

    def _count_offered(self, n: int = 1):
        """Count ``n`` offered requests (lock held): legacy attribute and
        obs counter move in the same critical section, so the two can
        never tell different stories."""
        self.offered += n
        self._m_offered.inc(n)

    def _count_outcome(self, outcome, scene, route_k, eff_k, n: int = 1):
        """Count ``n`` requests into one terminal outcome class (lock
        held): Counter + ring trail + obs counter, one choke point."""
        self.outcome_counts[outcome] += n
        self.outcome_log.extend(
            (outcome, scene, route_k, eff_k) for _ in range(n)
        )
        self._m_outcomes.inc(n, outcome=outcome)

    def _stamp(self, reqs, stage, t=None):
        """Span-stamp every traced request in ``reqs`` — a no-op (one
        attribute check) with tracing off.  Chains are only ever written
        by the thread that currently owns the request/batch, so no lock
        is involved.  Requests already resolved (abandoned by caller
        timeout / watchdog while this dispatch was in flight) are
        skipped best-effort; the unavoidable race remnant — a late stamp
        landing after the terminal one — is made inert by the chain's
        read-side truncation (obs.trace)."""
        if not self._trace:
            return
        if t is None:
            t = self._clock()
        for r in reqs:
            if r.spans is not None and not r.done:
                r.spans.stamp(stage, t)

    def _record(self, bucket, n_valid, scene, route_k, latencies):
        """Append one dispatch to the bounded stat rings (lock held)."""
        self.dispatch_log.append((bucket, n_valid))
        self.scene_log.append(scene)
        self.route_log.append(route_k)
        self.dispatch_counts[(scene, route_k)] += 1
        self.latencies_s.extend(latencies)
        self._m_dispatches.inc(scene=scene, route_k=route_k)
        # Bulk publish: two histogram-lock acquisitions per DISPATCH
        # (was two per lane-latency sample).
        self._m_latency.observe_many(latencies)
        self._m_lane_latency.observe_many(latencies, scene=scene,
                                          route_k=route_k)

    def _finish(self, req: _Request, result=None, error=None,
                outcome: str = "served", eff_k=None,
                count: bool = True) -> bool:
        """Resolve one request exactly once (lock held).  Returns False if
        the request was already resolved — a late result from an abandoned
        (wedged, expired) dispatch is DISCARDED here, which is what makes
        watchdog/timeout abandonment safe against the worker eventually
        unsticking.  ``count=False`` defers the outcome accounting to the
        caller, which MUST publish one aggregate ``_count_outcome`` for
        every True return before releasing the lock (the batched
        completion path in ``_run``)."""
        if req.done:
            return False
        req.done = True
        req.result = result
        req.error = error
        req.outcome = outcome
        req.t_done = self._clock()
        if count:
            self._count_outcome(outcome, req.scene, req.route_k, eff_k)
        if req.spans is not None:
            # Terminal stamp at t_done: the chain's total now telescopes
            # to the measured end-to-end latency, and each stage duration
            # lands in the stage histogram.
            req.spans.stamp(outcome, req.t_done)
            for stage, dt in req.spans.durations().items():
                self._m_stage.observe(dt, stage=stage)
            if req.trace is not None:
                # The request's chain IS the trace's root (terminally
                # stamped above, so the trace only needs its outcome/done
                # marks) and this dispatcher's ring-bounded store is its
                # home.
                req.trace.outcome = outcome
                req.trace.done = True
                if self._trace_store is not None:
                    self._trace_store.add(req.trace)
        req.event.set()
        return True

    def _drain_lane(self, lane, error_factory, outcome: str) -> None:
        """Fail every request still queued on ``lane`` (lock held) — used
        when the lane is quarantined so its backlog cannot re-wedge the
        replacement worker."""
        q = self._pending.pop(lane, None)
        if q is None:
            return
        for r in q:
            if r.done:
                self._n_pending -= 1
            elif self._finish(r, error=error_factory(), outcome=outcome):
                self._n_pending -= 1
        self._space.notify_all()

    def _prepare_batch(self, batch: list[_Request], lane):
        """SLO pre-dispatch pass (lock held): drop requests that are
        already resolved (abandoned by their caller) or past their
        deadline, and decide the dispatch's effective route_k — under
        overload the lane downshifts one rung of the degradation ladder
        (a cheaper routed bucket function the registry already holds).
        Returns (live requests, effective_k, degraded?)."""
        scene, route_k = lane
        now = self._clock()
        live = []
        for r in batch:
            if r.done:
                continue  # abandoned by its caller; outcome already counted
            # Drop only the ACTUALLY expired: a predicted-to-miss request
            # rides the dispatch anyway (padding makes the lane free, and
            # if the EMA was a warm-up-inflated outlier the completion
            # corrects it); a completion that really lands late counts
            # expired at fan-out, never served.
            if r.deadline is not None and now > r.deadline:
                self._finish(
                    r,
                    error=DeadlineExceededError(
                        f"expired in queue after "
                        f"{(now - r.t_submit) * 1e3:.1f}ms"
                    ),
                    outcome="expired",
                )
                continue
            live.append(r)
        eff_k, degraded = route_k, False
        if (live and self._slo is not None
                and (scene is not None or route_k is not None)
                and self._n_pending + len(live) >= max(
                    1, int(self._slo.degrade_queue_frac * self._depth))):
            down = self._slo.degrade_k(route_k)
            if down != route_k:
                eff_k, degraded = down, True
        return live, eff_k, degraded

    def _hold_deadline(self, first: _Request) -> float:
        """How long the worker may hold ``first`` to coalesce (lock held):
        the configured window, shrunk so that (hold + a dispatch with
        HEADROOM) still lands inside the request's deadline — adaptive
        serve_max_wait under SLO pressure.  The reserve is 1.5x the EMA
        (scheduling jitter margin), or half the request's remaining
        budget before any dispatch has been measured — a reserve of
        exactly the EMA (or zero) would hold a lone tight-deadline
        request right up to its deadline and deterministically expire it
        on an idle server."""
        hold = first.t_submit + self._max_wait_s
        if first.deadline is not None:
            if self._ema_n:
                reserve = 1.5 * self._ema_dispatch_s
            else:
                reserve = 0.5 * max(first.deadline - first.t_submit, 0.0)
            hold = min(hold, first.deadline - reserve)
        return hold

    def _worker_loop(self, gen: int, ready: threading.Event):
        big = self._buckets[-1]
        try:
            try:
                if self._warm_frame is not None:
                    self._staging.reserve(self._warm_frame, self._buckets)
            finally:
                ready.set()
            while True:
                with self._work:
                    while not self._n_pending and not self._closed \
                            and gen == self._gen:
                        self._work.wait()
                    if gen != self._gen:
                        return  # abandoned by the watchdog: a new worker owns the queue
                    if not self._n_pending:
                        return  # closed and drained
                    # Fairness: serve the lane at the head of the round-robin
                    # order; if it still has pending work afterwards it moves to
                    # the back, so a flooding lane cannot starve the others.
                    lane, q = next(iter(self._pending.items()))
                    deadline = self._hold_deadline(q[0])
                    while len(q) < big and not self._closed \
                            and gen == self._gen:
                        remaining = deadline - self._clock()
                        if remaining <= 0:
                            break
                        self._work.wait(remaining)
                    if gen != self._gen:
                        return
                    # Re-fetch the lane: the watchdog's expiry sweep /
                    # quarantine drain may have emptied (or removed) it
                    # while the wait above had the lock released.
                    q = self._pending.get(lane)
                    if not q:
                        if q is not None:
                            del self._pending[lane]
                        continue
                    # serve_max_wait_ms == 0 means coalescing is OFF: exactly one
                    # request per dispatch (per-frame-call semantics), even when
                    # a burst is already queued.
                    take = 1 if self._max_wait_s == 0 else min(len(q), big)
                    batch = [q.popleft() for _ in range(take)]
                    self._n_pending -= take
                    if q:
                        self._pending.move_to_end(lane)
                    else:
                        del self._pending[lane]
                    self._space.notify_all()
                    batch, eff_k, degraded = self._prepare_batch(batch, lane)
                    if batch:
                        # Track the popped batch BEFORE the lock drops: in
                        # the gap until _run re-registers it, these
                        # requests are in neither _pending nor _inflight —
                        # a worker death there would strand their callers
                        # and the accounting would undercount pending.
                        self._inflight = _Inflight(gen, lane, batch,
                                                   self._clock())
                if batch:
                    self._run(batch, lane, eff_k, degraded, gen)
        except BaseException as e:  # noqa: BLE001 — a dying worker must not strand callers
            self._on_worker_death(gen, e)
            raise

    def _on_worker_death(self, gen, exc):
        """The worker thread is dying with the queue: fail every pending
        and in-flight request with a typed error and poison future
        submissions — callers wake instead of stranding forever."""
        with self._work:
            if gen is not None and gen != self._gen:
                return  # stale worker: the replacement owns the queue
            self._worker_dead = f"worker thread died: {exc!r}"
            err_reqs = []
            if self._inflight is not None:
                err_reqs += self._inflight.reqs
                self._inflight = None
            for q in self._pending.values():
                err_reqs += list(q)
            self._pending.clear()
            self._n_pending = 0
            for r in err_reqs:
                self._finish(r, error=WorkerDiedError(self._worker_dead),
                             outcome="failed")
            self._work.notify_all()
            self._space.notify_all()

    def _run(self, reqs: list[_Request], lane, eff_k, degraded, gen):
        """Execute one dispatch (worker thread or sync path), with SLO
        retry/quarantine handling.  ``gen`` is the worker generation (None
        on the sync path); a dispatch whose generation was abandoned by
        the watchdog discards its late outcome entirely."""
        scene, route_k = lane
        self._stamp(reqs, "coalesced")
        # Trace context for the registry fault path: the
        # batch's traces ride a contextvar through the dispatch so the
        # weight cache / host tier / health machinery can record spans
        # without signature plumbing.  Zero-cost with tracing off.
        traced = ([r.trace for r in reqs if r.trace is not None]
                  if self._trace else [])
        attempt = 0
        while True:
            with self._work:
                if gen is not None and gen != self._gen:
                    return
                infl = _Inflight(gen, lane, reqs, self._clock())
                self._inflight = infl
            try:
                if traced:
                    with trace_scope(traced):
                        host, bucket, n_valid, t_done = self._dispatch(
                            reqs, scene, eff_k)
                else:
                    host, bucket, n_valid, t_done = self._dispatch(
                        reqs, scene, eff_k)
                # Host-side result slicing: inside the try — a malformed
                # result tree must fail THIS batch, never the worker — but
                # OUTSIDE the lock: admission control's microsecond-
                # rejection promise dies if submitters queue behind a
                # full bucket's fan-out.
                keys, host_leaves = host
                results = [
                    dict(zip(keys, (hl[i] for hl in host_leaves)))
                    for i in range(len(reqs))
                ]
                self._stamp(reqs, "sliced")
            except Exception as e:  # noqa: BLE001 — fan the failure out
                attempt += 1
                with self._work:
                    stale = gen is not None and gen != self._gen
                    # Deterministic typed faults (retryable=False — e.g. a
                    # registry checksum mismatch or breaker shed, whose
                    # loader-level transients were already retried) fail
                    # the batch immediately: re-running the dispatch can
                    # only re-pay the fault and delay the typed outcome.
                    retrying = (not stale and self._slo is not None
                                and attempt <= self._slo.retry_max
                                and getattr(e, "retryable", True)
                                and not self._closed)
                    if retrying:
                        # Stay registered through the backoff (fresh age
                        # clock): the accounting invariant — outcomes +
                        # pending == offered — must hold at EVERY instant,
                        # and an unregistered in-flight batch would drop
                        # out of ``pending`` for the sleep window.
                        self._inflight = _Inflight(gen, lane, reqs,
                                                   self._clock())
                    elif not stale:
                        self._inflight = None
                        for r in reqs:
                            self._finish(r, error=e, outcome="failed")
                        if self._slo is not None:
                            self._fail_streak[lane] += 1
                            if self._fail_streak[lane] >= \
                                    self._slo.quarantine_after:
                                self._quarantined[lane] = (
                                    f"{self._fail_streak[lane]} consecutive "
                                    f"dispatch failures (last: {e!r})"
                                )
                                self._drain_lane(
                                    lane,
                                    lambda: LaneQuarantinedError(
                                        f"lane {lane} quarantined after "
                                        "repeated dispatch failures"
                                    ),
                                    "shed",
                                )
                if not retrying:
                    return
                time.sleep(self._slo.backoff_s(attempt))
                continue
            with self._work:
                if gen is not None and gen != self._gen:
                    return  # abandoned mid-dispatch: requests already failed
                self._inflight = None
                self._fail_streak[lane] = 0
                dt = t_done - infl.t_start
                self._ema_dispatch_s = (
                    dt if self._ema_n == 0
                    else 0.25 * dt + 0.75 * self._ema_dispatch_s
                )
                self._ema_n += 1
                self._record(bucket, n_valid, scene, route_k,
                             [t_done - r.t_submit for r in reqs])
                outcome = "degraded" if degraded else "served"
                n_ok = 0
                for r, res in zip(reqs, results):
                    if r.deadline is not None and t_done > r.deadline:
                        # Landed past the deadline: the SLO contract says
                        # this is not a serve — discard, count expired.
                        self._finish(
                            r,
                            error=DeadlineExceededError(
                                f"result landed "
                                f"{(t_done - r.deadline) * 1e3:.1f}ms past "
                                "the deadline"
                            ),
                            outcome="expired",
                        )
                    elif self._finish(r, result=res, outcome=outcome,
                                      eff_k=eff_k, count=False):
                        n_ok += 1
                if n_ok:
                    # Batched outcome publish: every cleanly-served
                    # request in this dispatch shares one outcome class,
                    # so ONE counter/ring update covers them all — still
                    # inside the same critical section as the _finish
                    # calls, so accounting and done-flags move together.
                    self._count_outcome(outcome, scene, route_k, eff_k,
                                        n=n_ok)
            return

    def _dispatch(self, reqs: list[_Request], scene, route_k):
        """Pad, stage and execute one dispatch; returns the host-side
        results + timing.  No dispatcher state is touched here -- the
        caller owns locking and fan-out.  The span stamps reuse the
        timeline the dispatch path already walks (the copy to the device,
        the call, the synchronization the path ALWAYS performs) -- tracing
        adds clock reads, never a sync."""
        bucket = pick_bucket(len(reqs), self._buckets)
        padded, n_valid = self._staging.stage(
            [r.frame for r in reqs], bucket
        )
        staged = self._to_device(padded)
        self._stamp(reqs, "staged")
        out = self._call(staged, scene, route_k)
        self._stamp(reqs, "dispatched")
        self._wait(self._record_done())
        t_done = self._clock()
        self._stamp(reqs, "device", t_done)
        return self._to_host(out), bucket, n_valid, t_done

    def _to_device(self, tree: dict) -> dict:
        """Every staged leaf onto the serving device: one
        ``.to(device, non_blocking=True)`` per leaf (asynchronous from the
        pinned staging buffers on the card; the leaf itself on the CPU)."""
        return {k: torch.as_tensor(v).to(self._device, non_blocking=True)
                for k, v in tree.items()}

    def _record_done(self):
        """A CUDA event recorded on the current stream after the call (None
        on the CPU, where every op has finished when it returns)."""
        if self._device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    @staticmethod
    def _wait(done) -> None:
        if done is not None:
            done.synchronize()

    def _to_host(self, out: dict) -> tuple[list, list]:
        """(sorted keys, host numpy leaves) of a flat result dict: one
        ``.cpu()`` per leaf for the whole batch, then per-request slicing
        is a leaf-indexed row view.  Leaves that alias this thread's
        staging buffers (a passed-through input, on the CPU) are copied."""
        keys = sorted(out)
        host = [out[k].cpu().numpy() if isinstance(out[k], torch.Tensor)
                else np.asarray(out[k]) for k in keys]
        return keys, self._staging.unalias(host)

    # ---------------- watchdog ----------------

    def _watchdog_loop(self):
        poll = self._slo.watchdog_poll_ms / 1e3
        limit = self._slo.watchdog_ms / 1e3
        while True:
            with self._work:
                if self._closed and self._inflight is None \
                        and not self._n_pending:
                    return
                now = self._clock()
                self._expire_queued(now)
                infl = self._inflight
                if infl is not None and now - infl.t_start > limit:
                    self._abandon_inflight(infl, now)
            time.sleep(poll)

    def _expire_queued(self, now):
        """Fail queued requests past their deadline (lock held) — the
        sweep that bounds waiting even while the worker is busy or
        wedged on another lane."""
        drop = []
        removed = 0
        for lane, q in self._pending.items():
            kept = []
            for r in q:
                if r.done:
                    self._n_pending -= 1
                    removed += 1
                elif r.deadline is not None and now > r.deadline:
                    self._finish(
                        r,
                        error=DeadlineExceededError(
                            f"expired in queue after "
                            f"{(now - r.t_submit) * 1e3:.1f}ms"
                        ),
                        outcome="expired",
                    )
                    self._n_pending -= 1
                    removed += 1
                else:
                    kept.append(r)
            if len(kept) != len(q):
                # Mutate IN PLACE: the worker may hold a reference to this
                # deque across a lock-released coalescing wait — swapping
                # the object under it would desync the pending count.
                q.clear()
                q.extend(kept)
            if not q:
                drop.append(lane)
        for lane in drop:
            del self._pending[lane]
        if removed:
            self._space.notify_all()

    def _abandon_inflight(self, infl: _Inflight, now):
        """Declare the in-flight dispatch wedged (lock held): fail its
        requests with a precise typed error INSIDE their deadline,
        quarantine the lane, abandon the stuck worker's generation and
        hand the healthy lanes to a replacement worker.  The stuck thread
        is never killed (a thread inside a device call cannot be); when
        -- if -- it unsticks, its stale
        generation discards everything."""
        age_ms = (now - infl.t_start) * 1e3
        err = DispatchStalledError(
            f"dispatch on lane {infl.lane} made no progress for "
            f"{age_ms:.0f}ms (watchdog_ms={self._slo.watchdog_ms}); lane "
            "quarantined"
        )
        for r in infl.reqs:
            self._finish(r, error=err, outcome="failed")
        self._quarantined[infl.lane] = f"wedged dispatch ({age_ms:.0f}ms)"
        self._inflight = None
        # The quarantined lane's backlog must not re-wedge the replacement.
        self._drain_lane(
            infl.lane,
            lambda: LaneQuarantinedError(
                f"lane {infl.lane} quarantined (wedged dispatch)"
            ),
            "shed",
        )
        if infl.gen is not None and infl.gen == self._gen:
            self._gen += 1
            if not self._closed or self._n_pending:
                self._worker, _ = self._spawn_worker()
            else:
                self._worker = None  # nothing left to drain: close() can stop joining the wedged thread
            self._work.notify_all()

    # ---------------- stats / lifecycle ----------------

    def latency_quantiles(self, qs=(0.5, 0.99)) -> dict[float, float]:
        """Per-request latency quantiles (seconds) over the recent
        window, read from the fleet obs streaming histogram in
        O(buckets) — the former implementation sorted the whole
        ``10*stats_window`` ``latencies_s`` deque under the dispatch
        lock on EVERY call, an O(n log n) hazard on a serving thread.
        The window is GLOBAL (most recent samples fleet-wide, matching
        the deque it replaced), not per-lane.  Values are sketch
        estimates within the histogram's pinned tolerance of exact
        nearest-rank; NaN when no samples, exactly
        as before."""
        return {q: self._m_latency.quantile(q) for q in qs}

    def dispatch_totals(self) -> dict:
        """Per-(scene, route_k) lifetime dispatch counts — a thin view
        over the obs ``serve_dispatches_total`` counter, snapshotted
        under the dispatch lock so it is write-consistent (every writer
        holds the lock; iterating ``dispatch_counts`` raw while the
        worker appends is a torn read; the lock discipline applies
        to callers too)."""
        with self._lock:
            # Zero-valued children (a lane fully subtracted out by
            # reset_stats) are dropped: the legacy Counter never held
            # explicit zeros and the view's shape is pinned.
            return {
                (labels.get("scene"), labels.get("route_k")): int(v)
                for labels, v in self._m_dispatches.items() if v
            }

    def slo_totals(self) -> dict:
        """Locked snapshot of the outcome accounting — a thin view over
        the obs ``serve_offered_total``/``serve_outcomes_total`` counters
        (updated in the same critical sections as the legacy attributes)
        plus the live ``pending`` count.  The invariant — served + shed +
        expired + degraded + failed + pending == offered — is pinned by
        the tests.  (A request abandoned by its caller
        stays physically queued until the next watchdog sweep; those are
        already counted in their outcome class, so only unresolved
        requests count as pending here.)"""
        with self._lock:
            out = {"offered": int(self._m_offered.total())}
            for o in ("served", "shed", "expired", "degraded", "failed"):
                out[o] = int(self._m_outcomes.get(outcome=o))
            out["pending"] = self._unresolved_count()
            return out

    def _unresolved_count(self) -> int:
        """Requests not yet in any outcome class (lock held): queued ones
        that are still live plus the not-yet-done in-flight batch.  BOTH
        ``slo_totals``'s pending and ``reset_stats``'s offered re-base
        depend on this exact computation — one definition, one truth."""
        infl = (sum(1 for r in self._inflight.reqs if not r.done)
                if self._inflight else 0)
        queued_done = sum(
            sum(1 for r in q if r.done) for q in self._pending.values()
        )
        return self._n_pending - queued_done + infl

    def quarantined_lanes(self) -> dict:
        """Locked snapshot: lane -> quarantine reason."""
        with self._lock:
            return dict(self._quarantined)

    def release_lane(self, scene=None, route_k=None) -> bool:
        """Operator action: clear a lane's quarantine + failure streak
        after the underlying fault (a recovered device, fixed weights) is
        resolved.  New submissions to the lane are admitted again.
        Idempotent — a double release (two operators racing the same
        runbook) is a no-op, and releasing a lane that a concurrent
        watchdog/fail-streak trip is about to quarantine is safe: both
        orders leave a consistent breaker state and exact accounting
        (pinned in the tests).  True when a quarantine
        was actually cleared."""
        lane = (scene, route_k)
        with self._work:
            was = self._quarantined.pop(lane, None)
            self._fail_streak.pop(lane, None)
        return was is not None

    def reset_stats(self):
        """Clear the stat rings and outcome accounting.  ``offered`` is
        re-based to the requests still unresolved at reset time — they
        will land in the (now zeroed) outcome counts later, and a reset
        that set offered to 0 would break the accounting invariant
        forever on a busy server."""
        with self._lock:
            # The obs counter views re-base in the same critical section
            # by SUBTRACTING this dispatcher's own contribution (exactly
            # what the legacy books recorded): on a private registry
            # that leaves offered == unresolved and outcomes zero; on a
            # SHARED registry another dispatcher's history survives a
            # local reset instead of being wiped.
            # Histograms have no subtractable contribution — a local
            # reset clears them, one more shared-registry caveat the
            # class docstring states.
            unresolved = self._unresolved_count()
            self._m_offered.inc(-(self.offered - unresolved))
            for o, n in self.outcome_counts.items():
                if n:
                    self._m_outcomes.inc(-n, outcome=o)
            for (scene, route_k), n in self.dispatch_counts.items():
                if n:
                    self._m_dispatches.inc(-n, scene=scene,
                                           route_k=route_k)
            self._m_latency.reset()
            self._m_lane_latency.reset()
            self._m_stage.reset()
            self.latencies_s.clear()
            self.dispatch_log.clear()
            self.scene_log.clear()
            self.route_log.clear()
            self.dispatch_counts.clear()
            self.outcome_counts.clear()
            self.outcome_log.clear()
            self.offered = unresolved

    def cache_size(self) -> int | None:
        """Distinct batch signatures the entry point has run -- the
        counterpart of the JAX package's compiled-program count (None when
        the infer fn does not expose ``_cache_size``)."""
        probe = getattr(self._infer, "_cache_size", None)
        return probe() if callable(probe) else None

    def close(self):
        """Drain the queue, stop the worker, reject new submissions.
        Anything a (dead, wedged, or never-started) worker cannot drain is
        failed with a typed error — close() never strands a caller."""
        with self._work:
            self._closed = True
            self._work.notify_all()
            self._space.notify_all()
        # Let the live worker drain.  Bounded join slices: if the watchdog
        # replaces a wedged worker mid-close, switch to joining the
        # replacement (the stuck daemon thread is abandoned, never killed).
        while True:
            with self._work:
                worker = self._worker
            if worker is None or worker is threading.current_thread() \
                    or not worker.is_alive():
                break
            worker.join(0.2)
            with self._work:
                replaced = self._worker is not worker
            if not replaced and not worker.is_alive():
                break
            if not replaced and self._slo is None:
                # Legacy mode drains the whole queue, but inside a
                # bounded window: a wedged device call must not hang
                # close() forever — leftovers fail typed below and the
                # daemon thread is abandoned, never killed.
                worker.join(_LEGACY_DRAIN_JOIN_S)
                break
        # Fail whatever could not drain (no worker ever started, worker
        # dead, quarantined lanes) so every waiter wakes.
        with self._work:
            leftovers = []
            if self._inflight is not None:
                leftovers += self._inflight.reqs
                self._inflight = None
            for q in self._pending.values():
                leftovers += [r for r in q if not r.done]
            self._pending.clear()
            self._n_pending = 0
            for r in leftovers:
                self._finish(
                    r,
                    error=DispatcherClosedError(
                        "dispatcher closed with the request still pending"
                    ),
                    outcome="failed",
                )
            watchdog = self._watchdog
        if watchdog is not None and watchdog is not threading.current_thread():
            # Exits within one watchdog poll of _closed; bounded join
            # so even a wedged poll cannot hang close() -- the
            # daemon thread is abandoned past the budget.
            watchdog.join(_WATCHDOG_JOIN_S)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_dsac_serve_fn(c, cfg: RansacConfig = RansacConfig(), device=None):
    """Frames-major single-map (dsac) entry over a frame dict with leaves
    ``seed`` (a per-frame generator seed, in place of the JAX package's
    PRNG key), ``coords`` (N, 3), ``pixels`` (N, 2), ``f`` (scalar focal)."""
    dev = resolve_device(device)
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)

    def serve_dsac(batch):
        with torch.inference_mode():
            return dsac_infer_frames(frame_generators(batch["seed"], dev), batch["coords"],
                                     batch["pixels"], batch["f"], c, cfg, device=dev)

    return count_signatures(serve_dsac)


def make_esac_serve_fn(c, cfg: RansacConfig = RansacConfig(), device=None):
    """Frames-major multi-expert (esac) entry over a frame dict with leaves
    ``seed``, ``gating_logits`` (M,), ``coords_all`` (M, N, 3), ``pixels``
    (N, 2), ``f``."""
    dev = resolve_device(device)
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)

    def serve_esac(batch):
        with torch.inference_mode():
            return esac_infer_frames(frame_generators(batch["seed"], dev),
                                     batch["gating_logits"], batch["coords_all"],
                                     batch["pixels"], batch["f"], c, cfg, device=dev)

    return count_signatures(serve_esac)
