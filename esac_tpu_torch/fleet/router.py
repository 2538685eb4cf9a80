"""Scene-affinity replica fleet: the scheduler tier above the dispatchers
(the port of ``esac_tpu/fleet/router.py``).

Everything below this module is ONE dispatcher in front of ONE serving
device.  A :class:`FleetRouter` routes requests over N replicas -- each a
:class:`~esac_tpu_torch.serve.dispatcher.MicroBatchDispatcher` over its own
:class:`~esac_tpu_torch.registry.serving.SceneRegistry` and weight cache
(in-process; replicas may share one card) -- and survives a replica going
bad:

- **Scene-affinity routing.**  A request goes to a replica already holding
  its scene warm (its *home*), spilling to the least-loaded healthy replica
  only on overload (the home shed it) or cold (no healthy home yet -- the
  chosen replica becomes one).  Route kinds -- affinity / spill / cold /
  dense -- are counted per replica (``fleet_routes_total``) and summarized
  by :meth:`FleetRouter.affinity_stats`.
- **Per-replica health breakers**, composing with the per-scene ones one
  level down: a wedge-class fault (``DispatchStalledError`` /
  ``WorkerDiedError`` / ``DispatcherClosedError``) quarantines the replica
  immediately, a streak of other replica-INDICTING faults after
  ``FleetPolicy.replica_quarantine_after`` -- while a per-scene LANE
  quarantine drain only fails over, never indicts the replica (see
  ``_REPLICA_INDICTING``); quarantined replicas shed typed
  (:class:`ReplicaQuarantinedError`, a
  :class:`~esac_tpu_torch.serve.slo.ShedError`) and
  :meth:`FleetRouter.release_replica` is the operator hook mirroring
  ``release_lane`` / ``release_scene``.
- **Failover within the deadline.**  A request whose replica faults is
  re-dispatched to a surviving replica with its REMAINING deadline, up to
  ``failover_max`` times; the faulted attempt's underlying request is
  abandoned first (its late result is discarded by the dispatcher's
  exactly-once ``_finish``), so fleet books record exactly ONE outcome per
  offered request.  Every replica runs the same bucket functions on weights
  loaded from the same manifest, so a failed-over result equals
  dispatching the surviving replica directly.
- **Hot-scene replication.**  The completion thread periodically replicates
  a scene to a second home when its share of the recent arrival window
  crosses ``FleetPolicy.replicate_share`` (optionally gated on the home
  replica's per-scene p99 from the obs lane histogram --
  ``replicate_p99_ms``); the new home is warmed OFF the request path.
- **Fleet-level outcome accounting** that sums exactly to offered at every
  instant: ``offered == served + degraded + shed + expired + failed +
  pending`` (:meth:`FleetRouter.fleet_totals`).

Pure host code: this module imports neither torch nor numpy.  Concurrency:
all mutable router state lives under ONE instance lock; routing decisions
snapshot under it and every blocking call -- dispatcher submits,
underlying-request abandons, scene warms, the poll sleep -- happens OUTSIDE
it.  The router's lock nests only over the obs instrument locks.

The completion loop is a single poll thread (``FleetPolicy.poll_ms``):
underlying requests expose no callback, so the router polls their events,
settles finished ones, and runs the rebalancer between polls -- bounded
work, no per-request threads, and failover latency is measured through it
(``fleet_failover_seconds``).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from esac_tpu_torch.obs import MetricsRegistry, Trace
from esac_tpu_torch.retrieval.errors import (
    RetrievalCandidatesExhaustedError,
    RetrievalMissError,
)
from esac_tpu_torch.serve.gate import DISPATCH_GATE
from esac_tpu_torch.serve.slo import (
    ConfigError,
    DeadlineExceededError,
    DispatcherClosedError,
    DispatchStalledError,
    LaneQuarantinedError,
    ServeError,
    ShedError,
    WorkerDiedError,
)


class ReplicaQuarantinedError(ShedError):
    """The request's replica (or every healthy candidate) is quarantined
    after a wedge or fault streak; an operator must ``release_replica``
    it.  A quarantine rejection is a shed (admission semantics), so
    callers that only distinguish *admitted vs not* catch
    :class:`~esac_tpu_torch.serve.slo.ShedError` — the exact contract
    ``LaneQuarantinedError`` set one level down."""

    # NOT retryable, unlike LaneQuarantinedError: this is only raised
    # once routing found NO healthy replica — there is nowhere else to
    # retry until an operator releases one.
    retryable = False
    wire_name = "replica_quarantined"


# FAILOVER-ELIGIBLE fault classes — another replica may well serve the
# request: the dispatch wedged, the worker died,
# the dispatcher was closed under us, or a lane/replica quarantine
# drained the queue.  Anything else (a scene's checksum mismatch, a
# breaker shed) would fault identically on every replica and fails the
# request typed instead of re-paying the fault.
_REPLICA_FAULTS = (
    DispatchStalledError,
    WorkerDiedError,
    DispatcherClosedError,
    LaneQuarantinedError,
    ReplicaQuarantinedError,
)
# The subset that INDICTS THE REPLICA and feeds its breaker.  Lane- and
# replica-quarantine drains deliberately do NOT: a lane quarantine is
# the dispatcher's verdict on ONE (scene, route_k) — typically a
# scene-scoped fault — and a hot scene's drained backlog counting
# per-victim toward the replica streak would cascade a single corrupt
# scene into quarantining every replica in turn, fleet-wide (review
# finding); the drained requests simply fail over, and if the scene is
# truly broken everywhere they die typed on the scene's own error
# there.  (ReplicaQuarantinedError drains are the router's OWN trip —
# re-counting them would be circular.)
_REPLICA_INDICTING = (
    DispatchStalledError,
    WorkerDiedError,
    DispatcherClosedError,
)

OUTCOMES = ("served", "shed", "expired", "degraded", "failed")

# close() drain budget for the completion/poll thread, seconds.  Orders
# of magnitude above poll_ms, so a healthy loop always beats it; bounded
# so a wedged dispatch cannot hang close() forever.
_CLOSE_JOIN_S = 5.0


@dataclasses.dataclass(frozen=True)
class Replica:
    """One serving replica: a name, its dispatcher, and (optionally) the
    SceneRegistry behind it — the registry is only needed for warm-on-
    replicate and the cache-stats block of the fleet view; a bare
    dispatcher replica routes fine without one."""

    name: str
    dispatcher: object
    registry: object = None


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Host-side fleet scheduling knobs (frozen, like SLOPolicy — pure
    scheduler state)."""

    # Completion-loop poll interval: bounds failover detection latency
    # (the dispatcher's own watchdog_poll_ms is the same order).
    poll_ms: float = 5.0
    # Max re-dispatches per request after replica faults; exhausted ->
    # the request fails typed with the replica fault it last saw.
    failover_max: int = 2
    # Consecutive non-wedge replica-INDICTING faults before quarantine.
    # Wedge-class faults (stall / dead worker / closed dispatcher) trip
    # instantly; in the in-process transport those are the only
    # indicting classes, so this knob is the seam for the multi-host
    # transport's softer fault classes (RPC timeouts, connection
    # resets).  Lane-quarantine drains never count (see
    # _REPLICA_INDICTING).
    replica_quarantine_after: int = 3
    # Scene-affinity table: how many home replicas one scene may hold.
    max_homes_per_scene: int = 2
    # Hot-scene replication: a scene whose share of the recent arrival
    # window reaches this fraction gets a second home (up to the cap).
    replicate_share: float = 0.4
    # ...but only once the window carries enough evidence.
    replicate_min_requests: int = 32
    # Optional obs gate: additionally require the scene's p99 on its
    # first home (obs lane histogram) at/above this before replicating.
    # None = share alone decides.
    replicate_p99_ms: float | None = None
    # Rebalancer cadence, and the arrival-window length it judges over.
    rebalance_every_s: float = 0.25
    arrivals_window: int = 512
    # Causal-trace sampling: 0 = tracing off; N >= 1 mints a fleet Trace
    # for every Nth submission (1 = every request); 1-in-N divides the
    # per-request cost.  Sampled traces land in the obs registry's
    # ring-bounded TraceStore (`traces` collector).
    trace_sample: int = 0

    def __post_init__(self):
        if self.trace_sample < 0:
            raise ValueError(f"trace_sample {self.trace_sample} < 0")
        if self.poll_ms <= 0:
            raise ValueError(f"poll_ms {self.poll_ms} <= 0")
        if self.failover_max < 0:
            raise ValueError(f"failover_max {self.failover_max} < 0")
        if self.replica_quarantine_after < 1:
            raise ValueError("replica_quarantine_after must be >= 1")
        if self.max_homes_per_scene < 1:
            raise ValueError("max_homes_per_scene must be >= 1")
        if not 0.0 < self.replicate_share <= 1.0:
            raise ValueError(
                f"replicate_share {self.replicate_share} outside (0, 1]"
            )
        if self.replicate_min_requests < 1 or self.arrivals_window < 1:
            raise ValueError("replicate_min_requests / arrivals_window "
                             "must be >= 1")
        if self.rebalance_every_s <= 0:
            raise ValueError("rebalance_every_s must be > 0")


class FleetRequest:
    """One fleet-level request.  Duck-compatible with the dispatcher's
    ``_Request`` where the open-loop harness reads it (``event``,
    ``outcome``, ``error``, ``deadline``, ``t_submit``, ``t_done``), so
    ``serve.loadgen.run_open_loop`` drives a :class:`FleetRouter`
    unchanged.  The underlying per-replica request (``ureq``) changes
    across failovers; the fleet outcome is recorded exactly once."""

    __slots__ = ("frame", "scene", "route_k", "n_hyps", "deadline",
                 "t_submit", "event", "result", "error", "outcome",
                 "t_done", "done", "replica", "ureq", "attempts",
                 "failover_from", "t_faulted", "owner", "_key", "trace",
                 "_last_span")

    def __init__(self, frame, scene, route_k, deadline, t_submit, owner,
                 n_hyps=None):
        self.frame = frame
        self.scene = scene
        self.route_k = route_k
        self.n_hyps = n_hyps       # per-dispatch budget override
        self.deadline = deadline   # absolute clock() time, or None
        self.t_submit = t_submit
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.outcome = None        # one of OUTCOMES, exactly once
        self.t_done = None
        self.done = False
        self.replica = None        # current replica name
        self.ureq = None           # current underlying dispatcher request
        self.attempts = 0          # failover re-dispatches so far
        self.failover_from = []    # replicas that faulted this request
        self.t_faulted = None      # first replica-fault instant
        self.owner = owner
        self._key = None           # router _pending key (set at submit)
        self.trace = None          # sampled obs.Trace, or None
        self._last_span = None     # last dispatch child span (failover
        #                            siblings link through it: retry_of)

    def get(self, timeout: float | None = None):
        """Wait up to ``timeout`` seconds; raises the request's typed
        error, or :class:`~esac_tpu_torch.serve.slo.DeadlineExceededError` on
        timeout — the timeout ABANDONS the request (fleet outcome
        expired, any late result discarded), mirroring the dispatcher's
        ``_Request.get`` contract."""
        if not self.event.wait(timeout):
            err = DeadlineExceededError(
                f"no fleet result within {timeout}s — request abandoned"
            )
            self.owner._abandon(self, err)
            if self.error is not None:
                raise self.error
            return self.result
        if self.error is not None:
            raise self.error
        return self.result


class FleetRouter:
    """Scene-affinity scheduler over N dispatcher replicas (module
    docstring has the full story).  ``replicas`` is a list of
    :class:`Replica`; give each dispatcher an
    :class:`~esac_tpu_torch.serve.slo.SLOPolicy` — the router's spill and
    failover semantics need typed sheds and the watchdog, not the
    legacy block-for-space contract.  ``start=False`` skips the
    completion thread (attach a lock witness, then :meth:`start`)."""

    def __init__(
        self,
        replicas,
        policy: FleetPolicy = FleetPolicy(),
        clock=time.perf_counter,
        obs: MetricsRegistry | None = None,
        start: bool = True,
    ):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {sorted(names)}")
        self._replicas = {r.name: r for r in replicas}
        self._policy = policy
        self._clock = clock
        self._lock = threading.Lock()
        # Fleet books (all under self._lock): pending fleet requests by
        # submission sequence, per-replica quarantine + fault streaks,
        # the scene -> home-replicas affinity table, per-replica
        # in-flight load, the recent-arrival window the rebalancer
        # judges, and the outcome accounting.
        self._seq = 0
        self._pending: dict[int, FleetRequest] = {}
        self._quarantined: dict[str, str] = {}
        self._fail_streak: collections.Counter = collections.Counter()
        self._scene_home: dict = {}
        # Incremental mirror of "homes held per replica" (the tie-break
        # _route_locked orders by): maintained by _claim_home_locked so
        # the per-request routing pass stops rebuilding a Counter over
        # the whole affinity table (the host-path overhaul).
        self._homes_held: collections.Counter = collections.Counter()
        self._load: collections.Counter = collections.Counter()
        self._recent_scenes: collections.deque = collections.deque(
            maxlen=policy.arrivals_window
        )
        self._route_counts: collections.Counter = collections.Counter()
        self.offered = 0
        self.outcome_counts: collections.Counter = collections.Counter()
        self._closed = False
        # Observability: the dispatcher's convention —
        # instruments created once, counted in the same critical
        # sections as the legacy attributes, one truth.
        self.obs = obs if obs is not None else MetricsRegistry()
        self._m_offered = self.obs.counter(
            "fleet_offered_total", "requests ever offered to the fleet",
        )
        self._m_outcomes = self.obs.counter(
            "fleet_outcomes_total",
            "terminal fleet outcome classes; with pending they sum to "
            "offered",
        )
        self._m_routes = self.obs.counter(
            "fleet_routes_total",
            "route decisions per (replica, kind: affinity|spill|cold|"
            "dense|failover)",
        )
        self._m_failovers = self.obs.counter(
            "fleet_failovers_total",
            "re-dispatches after a replica fault, by (from, to) replica",
        )
        self._m_events = self.obs.counter(
            "fleet_events_total",
            "breaker/rebalance events by kind (replica_quarantined, "
            "replica_released, scene_replicated)",
        )
        self._m_latency = self.obs.histogram(
            "fleet_request_latency_seconds",
            "fleet end-to-end latency of served+degraded requests",
            window=100_000,
        )
        self._m_failover_s = self.obs.histogram(
            "fleet_failover_seconds",
            "replica-fault -> served latency of failed-over requests",
            window=100_000,
        )
        self.obs.register_collector("fleet", self.fleet_view)
        # Sampled causal traces: the ring-bounded store is
        # created only when sampling is on, so an untraced fleet's
        # snapshot schema is unchanged.
        self._trace_store = (self.obs.trace_store()
                             if policy.trace_sample else None)
        # Retrieval front-end: attach_retrieval installs it;
        # image-only requests (infer_image) carry no scene id and are
        # book-kept by the front, not the fleet books — each candidate
        # dispatch below them is an ordinary fleet request.
        self._retrieval = None
        self._image_seq = 0
        self._thread = None
        if start:
            self.start()

    # ---------------- lifecycle ----------------

    def start(self):
        """Start the completion/rebalance thread (idempotent)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="esac-fleet-router",
            )
            self._thread.start()

    def close(self, close_replicas: bool = True):
        """Stop routing, drain the books, optionally close the replica
        dispatchers.  Every pending fleet request resolves typed —
        nobody strands on a closed fleet (the dispatcher contract,
        lifted a level)."""
        with self._lock:
            self._closed = True
        if close_replicas:
            for rep in self._replicas.values():
                rep.dispatcher.close()
        thread = self._thread
        own = thread is not None and thread is threading.current_thread()
        if thread is not None and not own:
            # BOUNDED grace join: let already-resolved underlying
            # requests settle to their real outcomes.  Unbounded would
            # hang when a replica never resolves (close_replicas=False
            # over a watchdog-less dispatcher): the
            # loop only exits once pending drains, and it is the typed
            # cleanup BELOW that drains the stragglers.
            thread.join(max(0.05, 10 * self._policy.poll_ms / 1e3))
        # Whatever the loop could not settle (no thread ever started, a
        # replica that never resolved its requests) fails typed here.
        with self._lock:
            leftovers = [r for r in self._pending.values() if not r.done]
            for r in leftovers:
                if r.replica is not None and r.ureq is not None:
                    self._load[r.replica] -= 1
                    r.ureq = None
                self._finish_locked(
                    r,
                    error=DispatcherClosedError(
                        "fleet router closed with the request still pending"
                    ),
                    outcome="failed",
                )
        if thread is not None and not own:
            # Pending is drained and submit() rejects closed, so the
            # poll loop exits on its next tick; the join is bounded
            # anyway — if the poll body itself is wedged on a
            # dispatch, the daemon thread is abandoned, never waited on
            # forever and never killed.
            thread.join(_CLOSE_JOIN_S)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------- request path ----------------

    def submit(self, frame, scene=None, route_k=None,
               deadline_ms: float | None = None,
               n_hyps: int | None = None) -> FleetRequest:
        """Route one request into the fleet; returns a
        :class:`FleetRequest` whose event fires at its (single) fleet
        outcome.  Raises typed at admission: a
        :class:`~esac_tpu_torch.serve.slo.ShedError` subclass when every
        healthy replica rejected it (or none is healthy —
        :class:`ReplicaQuarantinedError`), both counted shed;
        :class:`~esac_tpu_torch.serve.slo.DeadlineExceededError` when the
        deadline died during admission (counted expired).  ``n_hyps``
        rides the per-dispatch hypothesis-budget override through to the
        chosen replica's dispatcher (the session lane); scene
        affinity is unchanged, so a session's shrunken-budget frames
        land on the replica already holding its scene warm."""
        t_submit = self._clock()
        deadline = (t_submit + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = FleetRequest(frame, scene, route_k, deadline, t_submit, self,
                           n_hyps=n_hyps)
        route = None
        route_err = None
        with self._lock:
            if self._closed:
                raise DispatcherClosedError("fleet router is closed")
            # Offered and pending move together: the accounting
            # invariant (offered == outcomes + pending) holds at every
            # instant, including while this request is being routed.
            self.offered += 1
            self._m_offered.inc()
            self._recent_scenes.append(scene)
            self._seq += 1
            req._key = self._seq
            self._pending[req._key] = req
            n = self._policy.trace_sample
            if n and self._seq % n == 0:
                # Mint the fleet trace (1-in-N deterministic sampling).
                # The root chain lives in THIS router's clock: its
                # consecutive stamps partition [t_submit, t_done] into
                # routing / replica / failover_routing segments whose
                # fsum equals the end-to-end span EXACTLY — the
                # telescoping invariant at fleet scope.
                req.trace = Trace(t_submit, scene=scene, sampled_1_in=n)
            # First route decision in the SAME critical section as the
            # books (the host-path overhaul: one lock pass per request
            # on the happy path, not one for books plus one to route).
            # A dead-on-arrival deadline skips it — _dispatch_to_replica
            # expires the request before any placement side effect (a
            # cold route claims a home), exactly as the two-pass path
            # did.  A routing shed is classified here, not re-raised
            # through the handlers below, because the lock must be
            # released between the decision and the finish.
            if deadline is None or deadline > t_submit:
                try:
                    route = self._route_locked(scene, set(), None)
                except ShedError as e:  # incl. ReplicaQuarantinedError
                    route_err = e
                    self._finish_locked(req, error=e, outcome="shed")
        if route_err is not None:
            raise route_err
        try:
            self._dispatch_to_replica(req, exclude=set(), route=route)
        except DeadlineExceededError as e:
            with self._lock:
                self._finish_locked(req, error=e, outcome="expired")
            raise
        except ShedError as e:  # incl. ReplicaQuarantinedError
            with self._lock:
                self._finish_locked(req, error=e, outcome="shed")
            raise
        except BaseException as e:  # noqa: BLE001 — accounting backstop
            # An unexpected routing fault must not leak a forever-
            # pending request (the invariant holds at every instant,
            # bugs included); classify failed, re-raise unchanged.
            with self._lock:
                self._finish_locked(req, error=e, outcome="failed")
            raise
        return req

    def infer_one(self, frame, scene=None, route_k=None,
                  timeout: float | None = None,
                  deadline_ms: float | None = None,
                  n_hyps: int | None = None):
        """Blocking single-request inference through the fleet.  The
        bound is end-to-end: on timeout/deadline the request is
        abandoned (fleet outcome expired, late results discarded) and a
        typed error raised — no caller blocks past its bound even when
        a replica is wedged."""
        if deadline_ms is None and timeout is not None:
            deadline_ms = timeout * 1e3
        req = self.submit(frame, scene, route_k, deadline_ms,
                          n_hyps=n_hyps)
        limit = timeout
        if req.deadline is not None:
            # Remaining deadline + settle grace: the terminal event
            # fires from the completion loop one poll after the
            # underlying request resolves, so the grace covers loop
            # scheduling, never correctness (abandonment below is the
            # hard bound).
            remaining = max(0.0, req.deadline - self._clock())
            grace = remaining + 4 * self._policy.poll_ms / 1e3 + 0.25
            limit = grace if limit is None else min(limit, grace)
        return req.get(limit)

    # ---------------- image-only request path ----------------

    def attach_retrieval(self, front) -> None:
        """Install the retrieval front-end: wires the default per-scene
        breaker gate (a candidate is healthy when ANY replica registry
        still has prefetchable targets for it — i.e. it is not
        breaker-tripped everywhere), feeds every replica prefetcher from
        the posterior (the ``observe_candidates`` seam), and registers
        the ``retrieval`` obs collector.  One front per router."""
        with self._lock:
            if self._retrieval is not None:
                raise ConfigError(
                    "a retrieval front is already attached to this router"
                )
            self._retrieval = front
        if not front.has_health():
            front.attach_health(self._candidate_healthy)
        for rep in self._replicas.values():
            pf = getattr(rep.registry, "_prefetcher", None)
            if pf is not None and hasattr(pf, "observe_candidates"):
                front.add_prefetch_sink(pf.observe_candidates)
        self.obs.register_collector("retrieval", front.stats)

    def _candidate_healthy(self, scene) -> bool:
        """Default retrieval breaker gate: ``prefetch_targets`` is the
        registries' health-aware resolution (active + canary minus
        tripped), so "no targets anywhere" == "tripped/unknown
        everywhere" — exactly the candidates that must be SKIPPED, not
        dispatched.  Runs with NO router lock held (registry locks
        inside)."""
        regs = [rep.registry for rep in self._replicas.values()
                if rep.registry is not None]
        if not regs:
            return True  # bare-dispatcher fleet: no breaker state exists
        return any(reg.prefetch_targets(scene) for reg in regs)

    def infer_image(self, frame, route_k=None,
                    timeout: float | None = None,
                    deadline_ms: float | None = None):
        """Blocking IMAGE-ONLY inference: no scene id — the retrieval
        front decides the top-K candidate scenes (each breaker-gated),
        every candidate is dispatched through the ordinary fleet path,
        and the winner is chosen by soft-inlier score.  Typed faults:
        :class:`~esac_tpu_torch.retrieval.errors.RetrievalMissError` (shed —
        low confidence / empty index / all candidates tripped) and
        :class:`~esac_tpu_torch.retrieval.errors.\
RetrievalCandidatesExhaustedError` (failed — every candidate dispatch
        died).  The image request books EXACTLY one outcome in the
        front's accounting; the per-candidate fleet requests carry
        their own books underneath.  A sampled trace gets a
        ``retrieval`` root segment + per-candidate dispatch child spans
        (the telescoping invariant at image scope)."""
        with self._lock:
            front = self._retrieval
        if front is None:
            raise ConfigError(
                "no retrieval front attached — attach_retrieval() first"
            )
        if deadline_ms is None and timeout is not None:
            deadline_ms = timeout * 1e3
        t0 = self._clock()
        deadline = (t0 + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        trace = None
        with self._lock:
            if self._closed:
                raise DispatcherClosedError("fleet router is closed")
            self._image_seq += 1
            n = self._policy.trace_sample
            if n and self._image_seq % n == 0:
                trace = Trace(t0, scene=None, sampled_1_in=n)
        tok = front.offer()
        try:
            try:
                # The retriever's forward is a device call: the process's
                # prefetch work yields to it (serve/gate.py).
                with DISPATCH_GATE.held():
                    decision = front.decide(frame)
            except RetrievalMissError as e:
                # Typed retrieval shed: no candidate was dispatchable.
                tok.book("shed", e)
                raise
            t_dec = self._clock()
            if trace is not None:
                # Root boundary: everything up to here is the retrieval
                # decision (index snapshot + retriever posterior + gates).
                trace.stamp("retrieval", t_dec)
                trace.add_event(
                    "retrieval_decision", t_dec,
                    candidates=list(decision.candidates),
                    top1=decision.top1, top1_p=decision.top1_p,
                    entropy=decision.entropy,
                    tripped_skipped=decision.tripped_skipped,
                )
            # Posterior-driven prefetch: runner-up scenes stage ahead
            # of their fault, whatever candidate wins below.
            front.feed_prefetch(decision)
            # Fan out: submit every candidate first (admission only),
            # then collect — candidates overlap in flight instead of
            # paying each other's latency.
            submitted = []
            last_err = None
            for cand in decision.candidates:
                now = self._clock()
                if deadline is not None and now >= deadline:
                    break
                remaining_ms = (None if deadline is None
                                else (deadline - now) * 1e3)
                try:
                    submitted.append((cand, self.submit(
                        frame, scene=cand, route_k=route_k,
                        deadline_ms=remaining_ms,
                    )))
                except ServeError as e:
                    # Per-candidate admission fault (shed/quarantine/
                    # dead deadline): counted in the fleet books by
                    # submit itself; the image request survives on the
                    # remaining candidates.
                    last_err = e
            results = []
            for cand, req in submitted:
                limit = None
                if req.deadline is not None:
                    remaining = max(0.0, req.deadline - self._clock())
                    limit = (remaining
                             + 4 * self._policy.poll_ms / 1e3 + 0.25)
                try:
                    results.append((cand, req.get(limit)))
                except ServeError as e:
                    last_err = e
                if trace is not None:
                    trace.add_span(
                        f"candidate:{cand}", "dispatch",
                        req.t_submit, req.t_done or self._clock(),
                        scene=cand, outcome=req.outcome,
                    )
            if trace is not None:
                trace.stamp("candidates", self._clock())
            if results:
                winner_scene, wres = front.select_winner(results)
                # The winning replica answer is returned UNTOUCHED
                # under its own keys (the confident-query bit-identity
                # contract); retrieval evidence rides alongside.
                out = dict(wres)
                out["retrieval"] = {
                    "scene": winner_scene,
                    "candidates": list(decision.candidates),
                    "top1": decision.top1,
                    "top1_p": decision.top1_p,
                    "entropy": decision.entropy,
                }
                front.note_result(winner_scene, decision)
                tok.book("served")
                self._finish_image_trace(trace, "served")
                return out
            if deadline is not None and self._clock() >= deadline:
                expired_err = DeadlineExceededError(
                    "image request deadline died across "
                    f"{len(decision.candidates)} candidate dispatch(es)"
                )
                tok.book("expired", expired_err)
                raise expired_err
            exhausted_err = RetrievalCandidatesExhaustedError(
                f"all {len(decision.candidates)} candidate dispatch(es) "
                f"failed (last: {last_err!r})"
            )
            tok.book("failed", exhausted_err)
            raise exhausted_err
        except BaseException as e:  # noqa: BLE001 — accounting backstop
            # Every error path lands exactly one outcome (the booking
            # token is first-wins, so typed paths above keep theirs);
            # the trace finishes with whatever was booked.
            tok.book("failed", e)
            self._finish_image_trace(trace, tok.outcome or "failed")
            raise

    def _finish_image_trace(self, trace, outcome: str) -> None:
        """Terminal root stamp + store publication for one image-request
        trace (idempotent through Trace.finish: racing error paths store
        it exactly once; the append is a leaf-lock deque op)."""
        if trace is None:
            return
        with self._lock:
            store = self._trace_store
        if trace.finish(outcome, self._clock()) and store is not None:
            store.add(trace)

    def _dispatch_to_replica(self, req: FleetRequest, exclude: set,
                             route=None) -> None:
        """Admit ``req`` to a replica chosen by the affinity table
        (NO router lock held across the dispatcher submit).
        Spills walk the healthy set; a replica whose dispatcher is
        closed/dead is noted as a replica fault and skipped.  Raises
        the last typed rejection when nobody could take it.  ``route``
        is an optional pre-made first (name, kind) decision — submit
        routes inside its books critical section — consumed on the
        first attempt only; every retry re-decides under the lock."""
        exclude = set(exclude)
        last_shed = None
        while True:
            now = self._clock()
            if req.deadline is not None and now >= req.deadline:
                raise DeadlineExceededError(
                    "deadline expired while routing "
                    f"(scene {req.scene!r}, "
                    f"{len(exclude)} replica(s) already tried)"
                )
            if route is not None:
                name, kind = route
                route = None
            else:
                with self._lock:
                    name, kind = self._route_locked(req.scene, exclude,
                                                    last_shed)
            rep = self._replicas[name]
            remaining_ms = (None if req.deadline is None
                            else (req.deadline - now) * 1e3)
            try:
                kw = {}
                if req.trace is not None:
                    # Trace context rides into the replica: its request
                    # gets a child chain + the registry fault path sees
                    # the trace, whatever the dispatcher's own flag.
                    kw["trace_ctx"] = req.trace
                ureq = rep.dispatcher.submit(
                    req.frame, scene=req.scene, route_k=req.route_k,
                    deadline_ms=remaining_ms, n_hyps=req.n_hyps, **kw,
                )
            except (DispatcherClosedError, WorkerDiedError) as e:
                # The replica itself is unroutable: breaker bookkeeping,
                # then try the next one.
                self._note_replica_fault(name, e)
                exclude.add(name)
                last_shed = ReplicaQuarantinedError(
                    f"replica {name!r} is unservable ({e!r})"
                )
                continue
            except ShedError as e:  # overload / lane quarantine: spill
                with self._lock:
                    self._m_routes.inc(replica=name, kind="rejected")
                exclude.add(name)
                last_shed = e
                continue
            with self._lock:
                if req.done:
                    # A caller-side abandon resolved the request while
                    # this (failover) routing was in flight: do not
                    # register the fresh dispatch — hand it back below
                    # so its late result is discarded and the load
                    # books never skew.
                    stale_err = req.error
                else:
                    if req.failover_from:
                        kind = "failover"
                        self._m_failovers.inc(**{
                            "from": req.failover_from[-1], "to": name,
                        })
                    req.replica = name
                    req.ureq = ureq
                    self._load[name] += 1
                    self._route_counts[kind] += 1
                    self._m_routes.inc(replica=name, kind=kind)
                    if req.trace is not None:
                        # Root boundary: time up to here is router
                        # overhead (routing / failover_routing); the
                        # routing DECISION rides as an event span.
                        t = self._clock()
                        req.trace.stamp(
                            "failover_routing" if req.failover_from
                            else "routing", t,
                        )
                        req.trace.add_event("route_decision", t,
                                            replica=name, route_kind=kind)
                    return
            rep.dispatcher._abandon(ureq, stale_err or
                                    DeadlineExceededError(
                                        "request abandoned during routing"
                                    ))
            return

    def _route_locked(self, scene, exclude: set, last_shed):
        """Pick (replica name, route kind) for ``scene`` (lock held).
        Affinity first (least-loaded healthy home), else least-loaded
        healthy replica — ``cold`` claims a home slot for the scene,
        ``spill`` (healthy homes exist but all rejected/excluded) does
        not.  Raises typed when no candidate remains: the last shed if
        replicas rejected, :class:`ReplicaQuarantinedError` otherwise."""
        healthy = [n for n in self._replicas if n not in self._quarantined]
        if not healthy:
            raise ReplicaQuarantinedError(
                f"all {len(self._replicas)} replicas are quarantined "
                f"({sorted(self._quarantined)}); release_replica() after "
                "recovery"
            )
        avail = [n for n in healthy if n not in exclude]
        if not avail:
            if last_shed is not None:
                raise last_shed
            raise ReplicaQuarantinedError(
                f"no replica left for scene {scene!r}: every healthy "
                "replica already failed this request"
            )
        # Least-loaded ordering with a placement tie-break: equal
        # in-flight load falls back to fewest homes held, so cold
        # scenes SPREAD across an idle fleet instead of all claiming
        # the first replica — the scene-sharded placement the affinity
        # table then preserves.  (_homes_held is the incrementally
        # maintained count — this used to be a full rebuild over the
        # affinity table on EVERY route decision.)
        homes_held = self._homes_held
        order = {n: (self._load[n], homes_held[n], n) for n in avail}
        if scene is None:
            return min(avail, key=order.__getitem__), "dense"
        homes = self._scene_home.get(scene, [])
        homes_avail = [n for n in homes if n in avail]
        if homes_avail:
            name = min(homes_avail, key=order.__getitem__)
            return name, "affinity"
        name = min(avail, key=order.__getitem__)
        homes_healthy = [n for n in homes if n in healthy]
        if homes_healthy:
            # Healthy homes exist but shed/failed this request: serve
            # elsewhere without moving the scene's home (one overloaded
            # burst must not thrash the affinity table).
            return name, "spill"
        self._claim_home_locked(scene, name)
        return name, "cold"

    def _claim_home_locked(self, scene, name) -> None:
        """Record ``name`` as a home for ``scene`` (lock held), pruning
        quarantined homes first and capping at ``max_homes_per_scene``
        (oldest out)."""
        homes = self._scene_home.setdefault(scene, [])
        if name in homes:
            return
        homes.append(name)
        self._homes_held[name] += 1
        while len(homes) > self._policy.max_homes_per_scene:
            dead = next((h for h in homes if h in self._quarantined),
                        homes[0])
            homes.remove(dead)
            self._homes_held[dead] -= 1

    def _abandon(self, req: FleetRequest, err) -> None:
        """Caller-side timeout (FleetRequest.get): record the fleet
        outcome expired and abandon the underlying request so a late
        result is discarded — the books agree with the error the caller
        saw.  No-op if already resolved."""
        with self._lock:
            if req.done:
                return
            ureq = req.ureq
            if req.replica is not None and ureq is not None:
                self._load[req.replica] -= 1
                req.ureq = None
            self._finish_locked(req, error=err, outcome="expired")
        if ureq is not None and ureq.owner is not None:
            ureq.owner._abandon(ureq, err)

    def _finish_locked(self, req: FleetRequest, result=None, error=None,
                       outcome: str = "served",
                       publish: bool = True) -> None:
        """Resolve one fleet request exactly once (lock held): outcome
        books + latency/failover histograms + event, one choke point.
        ``publish=False`` defers the obs counter/histogram publishes to
        the caller — the batched completion pass — which MUST publish
        the aggregates for every such finish before releasing the lock;
        the legacy books, pending pop, trace finish and event always
        happen here."""
        if req.done:
            return
        req.done = True
        req.result = result
        req.error = error
        req.outcome = outcome
        req.t_done = self._clock()
        self.outcome_counts[outcome] += 1
        if publish:
            self._m_outcomes.inc(outcome=outcome)
        if req._key is not None:
            self._pending.pop(req._key, None)
        if publish and outcome in ("served", "degraded"):
            self._m_latency.observe(req.t_done - req.t_submit)
            if req.t_faulted is not None:
                self._m_failover_s.observe(req.t_done - req.t_faulted)
        if req.trace is not None:
            # Terminal root stamp in the SAME clock and with the SAME
            # instant as the fleet accounting, so the trace's total is
            # bit-equal to the measured end-to-end latency; publication
            # into the store is a leaf-lock deque append.
            req.trace.finish(outcome, req.t_done)
            if self._trace_store is not None:
                self._trace_store.add(req.trace)
        req.event.set()

    # ---------------- completion loop ----------------

    def _loop(self):
        poll = self._policy.poll_ms / 1e3
        next_rebalance = self._clock() + self._policy.rebalance_every_s
        while True:
            if self._settle():
                return
            now = self._clock()
            if now >= next_rebalance:
                self._rebalance()
                next_rebalance = now + self._policy.rebalance_every_s
            # Drive the timeline and the health rules between polls: both
            # are piggyback hooks (one clock compare when not due) and run
            # with no router lock held.
            tl = self.obs.timeline()
            if tl is not None:
                tl.maybe_tick()
                eng = self.obs.health_rules()
                if eng is not None:
                    eng.maybe_evaluate()
            time.sleep(poll)

    def _settle(self) -> bool:
        """One BATCHED completion pass: scan for resolved underlying
        requests and consume every one of them — fulfill, classify, or
        queue for failover — in a SINGLE critical section (the host-path
        overhaul: one lock acquisition per poll tick, not one for the
        scan plus one per ready request), with the obs publishes
        aggregated per outcome class at the end of the section.  Each
        ureq is detached under the lock, so a racing abandon can never
        settle it twice.  Fault follow-up — breaker bookkeeping and the
        failover re-dispatch, both potentially blocking — runs OUTSIDE
        the lock, exactly as the per-request path did.  Returns
        True when the router is closed and fully drained (the poll
        loop's exit test, folded into the same acquisition)."""
        n_by_outcome: collections.Counter = collections.Counter()
        lats: list[float] = []
        fo_lats: list[float] = []
        faults = []
        with self._lock:
            if self._closed and not self._pending:
                return True
            ready = [r for r in self._pending.values()
                     if not r.done and r.ureq is not None
                     and r.ureq.event.is_set()]
            for req in ready:
                ureq = req.ureq
                req.ureq = None
                self._load[req.replica] -= 1
                if req.trace is not None:
                    # Child dispatch span: the underlying request's chain
                    # (ITS clock domain — it telescopes on its own) under
                    # the fleet root; failover siblings link via retry_of.
                    sp = req.trace.add_span(
                        f"replica:{req.replica}", "dispatch",
                        ureq.t_submit, ureq.t_done,
                        stages=(ureq.spans.segments()
                                if ureq.spans is not None else None),
                        replica=req.replica, outcome=ureq.outcome,
                        retry_of=(req._last_span.span_id
                                  if req._last_span is not None else None),
                    )
                    req._last_span = sp
                    # Root boundary (router clock): the replica segment
                    # ends when the completion loop CONSUMED it — poll
                    # latency is router overhead charged to the replica
                    # segment honestly, not hidden.
                    req.trace.stamp("replica", self._clock())
                err = ureq.error
                if err is None:
                    self._fail_streak.pop(req.replica, None)
                    self._finish_locked(req, result=ureq.result,
                                        outcome=ureq.outcome,
                                        publish=False)
                    n_by_outcome[req.outcome] += 1
                    lats.append(req.t_done - req.t_submit)
                    if req.t_faulted is not None:
                        fo_lats.append(req.t_done - req.t_faulted)
                elif not isinstance(err, _REPLICA_FAULTS):
                    if isinstance(err, DeadlineExceededError):
                        self._finish_locked(req, error=err,
                                            outcome="expired",
                                            publish=False)
                    else:
                        # Scene-/request-level typed fault: every replica
                        # would re-pay it — fail fast, don't fail over.
                        self._finish_locked(req, error=err,
                                            outcome="failed",
                                            publish=False)
                    n_by_outcome[req.outcome] += 1
                else:
                    faults.append((req, req.replica, err))
            # Aggregated obs publish — still inside the critical
            # section, so the counters and the done-flags/pending books
            # move together (one truth), but with ONE instrument-lock
            # acquisition per outcome class / histogram instead of one
            # per request.
            for o, n in n_by_outcome.items():
                self._m_outcomes.inc(n, outcome=o)
            if lats:
                self._m_latency.observe_many(lats)
            if fo_lats:
                self._m_failover_s.observe_many(fo_lats)
        # Failover path, outside the lock: replica-INDICTING faults feed
        # the breaker first (it may quarantine and abandon the replica's
        # other in-flight work); lane/replica-quarantine drains skip it
        # (see _REPLICA_INDICTING) and only re-route.
        for req, faulted, err in faults:
            if isinstance(err, _REPLICA_INDICTING):
                self._note_replica_fault(faulted, err)
            self._failover(req, faulted, err)
        return False

    def _failover(self, req: FleetRequest, from_name: str, err) -> None:
        """Re-dispatch ``req`` to a surviving replica inside its
        remaining deadline (no lock held).  Exhausted budget or no
        survivor -> the request fails typed with the replica fault; a
        dead deadline -> expired."""
        now = self._clock()
        if req.t_faulted is None:
            req.t_faulted = now
        req.attempts += 1
        req.failover_from.append(from_name)
        if req.trace is not None:
            req.trace.add_event("replica_fault", now, replica=from_name,
                                error=type(err).__name__,
                                attempt=req.attempts)
        if req.deadline is not None and now >= req.deadline:
            with self._lock:
                self._finish_locked(req, error=DeadlineExceededError(
                    f"replica {from_name!r} fault ({err!r}) left no "
                    "deadline for failover"
                ), outcome="expired")
            return
        if req.attempts > self._policy.failover_max:
            with self._lock:
                self._finish_locked(req, error=err, outcome="failed")
            return
        try:
            self._dispatch_to_replica(req, exclude=set(req.failover_from))
        except DeadlineExceededError as e:
            with self._lock:
                self._finish_locked(req, error=e, outcome="expired")
        except ShedError:
            # No survivor could admit it: the request was already
            # admitted to the fleet once, so this is a failure of the
            # original fault's making, not a shed.
            with self._lock:
                self._finish_locked(req, error=err, outcome="failed")

    # ---------------- replica breaker ----------------

    def _note_replica_fault(self, name: str, err) -> None:
        """Breaker bookkeeping for one observed replica fault (no lock
        held on entry).  A trip abandons every in-flight underlying
        request on the replica OUTSIDE the lock — their events fire
        with :class:`ReplicaQuarantinedError` and the completion loop
        fails each over exactly once (drained, never double-counted)."""
        wedge = isinstance(err, _REPLICA_INDICTING)
        victims = []
        reason = None
        with self._lock:
            self._fail_streak[name] += 1
            if name not in self._quarantined and (
                    wedge or self._fail_streak[name]
                    >= self._policy.replica_quarantine_after):
                what = ("wedge-class fault" if wedge else
                        f"{self._fail_streak[name]} consecutive "
                        "replica faults")
                reason = f"{what} (last: {err!r})"
                self._quarantined[name] = reason
                self._m_events.inc(event="replica_quarantined")
                # Snapshot the (request, underlying) PAIRS under the
                # lock: a concurrent settle may swap req.ureq to a
                # fresh dispatch on a HEALTHY replica, and abandoning
                # that would kill good work — the snapshotted ureq is
                # pinned to this replica (replica and ureq only change
                # together, under the lock), and abandoning one that
                # already resolved is a no-op.
                victims = [(r, r.ureq) for r in self._pending.values()
                           if r.replica == name and not r.done
                           and r.ureq is not None]
        if reason is None:
            return
        disp = self._replicas[name].dispatcher
        t_quar = self._clock()
        for r, ureq in victims:
            if r.trace is not None:
                r.trace.add_event("replica_quarantined", t_quar,
                                  replica=name)
            disp._abandon(ureq, ReplicaQuarantinedError(
                f"replica {name!r} quarantined ({reason}); request "
                "failed over"
            ))

    def release_replica(self, name: str) -> bool:
        """Operator hook mirroring ``release_lane``/``release_scene``:
        clear a replica's quarantine + fault streak after the fault
        (a recovered device, a restarted worker) is fixed.  Idempotent;
        True when a quarantine was actually cleared."""
        if name not in self._replicas:
            raise ConfigError(f"unknown replica {name!r} "
                              f"(fleet: {sorted(self._replicas)})")
        with self._lock:
            was = self._quarantined.pop(name, None)
            self._fail_streak.pop(name, None)
            if was is not None:
                self._m_events.inc(event="replica_released")
        return was is not None

    def quarantined_replicas(self) -> dict:
        """Locked snapshot: replica name -> quarantine reason."""
        with self._lock:
            return dict(self._quarantined)

    # ---------------- rebalancer ----------------

    def _rebalance(self) -> None:
        """Hot-scene replication (completion thread, between polls):
        judge the recent arrival window under the lock, warm the new
        home OUTSIDE it, then commit the affinity-table change."""
        with self._lock:
            window = [s for s in self._recent_scenes if s is not None]
            if len(window) < self._policy.replicate_min_requests:
                return
            counts = collections.Counter(window)
            quarantined = set(self._quarantined)
            plans = []
            for scene, c in counts.items():
                # Share of the SCENE-CARRYING window: mixed-in dense
                # (scene=None) traffic must not dilute every scene's
                # share below the threshold and suppress replication
                # — hot is relative to scene-routed
                # demand, which is what the homes serve.
                share = c / len(window)
                if share < self._policy.replicate_share:
                    continue
                homes = [h for h in self._scene_home.get(scene, [])
                         if h not in quarantined]
                if not homes or len(homes) >= self._policy.max_homes_per_scene:
                    continue
                candidates = [n for n in self._replicas
                              if n not in quarantined and n not in homes]
                if not candidates:
                    continue
                load = {n: self._load[n] for n in candidates}
                target = min(candidates, key=load.__getitem__)
                plans.append((scene, homes[0], target))
        for scene, first_home, target in plans:
            if not self._replication_due(scene, first_home):
                continue
            rep = self._replicas[target]
            if rep.registry is not None:
                try:
                    rep.registry.warm(scene)
                except Exception:  # noqa: BLE001 — a failed warm skips,
                    # the demand path will retry typed; counted, not hidden
                    self._m_events.inc(event="warm_failed")
                    continue
            with self._lock:
                if target not in self._quarantined:
                    self._claim_home_locked(scene, target)
                    self._m_events.inc(event="scene_replicated")

    def _replication_due(self, scene, first_home) -> bool:
        """The optional obs gate (no lock held): when the policy pins a
        p99 threshold, the scene's latency on its first home (the obs
        lane histogram both the operator and this decision read) must
        be measurable and at/above it."""
        if self._policy.replicate_p99_ms is None:
            return True
        hist = self._replicas[first_home].dispatcher.obs.get(
            "serve_lane_latency_seconds"
        )
        if hist is None:
            return False
        p99 = hist.quantile(0.99, scene=scene)
        return p99 == p99 and p99 * 1e3 >= self._policy.replicate_p99_ms

    # ---------------- views ----------------

    def fleet_totals(self) -> dict:
        """Locked snapshot of the fleet accounting.  The invariant —
        served + shed + expired + degraded + failed + pending ==
        offered — holds at every instant."""
        with self._lock:
            return self._totals_locked()

    def _totals_locked(self) -> dict:
        out = {"offered": int(self._m_offered.total())}
        for o in OUTCOMES:
            out[o] = int(self._m_outcomes.get(outcome=o))
        out["pending"] = sum(1 for r in self._pending.values()
                             if not r.done)
        return out

    def affinity_stats(self) -> dict:
        """Locked snapshot of the routing mix.  ``hit_rate`` is
        affinity / (affinity + spill + cold) — scene-carrying routes
        only; dense and failover re-dispatches are reported but not
        part of the affinity denominator."""
        with self._lock:
            counts = {k: int(self._route_counts.get(k, 0))
                      for k in ("affinity", "spill", "cold", "dense",
                                "failover")}
        routed = counts["affinity"] + counts["spill"] + counts["cold"]
        counts["hit_rate"] = (counts["affinity"] / routed) if routed \
            else float("nan")
        return counts

    def scene_homes(self) -> dict:
        """Locked snapshot: scene -> home replica names (routing order)."""
        with self._lock:
            return {s: list(h) for s, h in self._scene_home.items()}

    def fleet_view(self) -> dict:
        """The ``fleet`` obs collector: one per-replica-labelled merge —
        each replica's serve accounting (its own ``slo_totals``),
        quarantine state, in-flight load and weight-cache stats — plus
        the affinity table and the fleet accounting.  Replica snapshots
        are taken OUTSIDE the router lock (each surface owns its own
        locked snapshot; nesting router -> dispatcher would be a new
        lock-graph edge for no benefit)."""
        with self._lock:
            quarantined = dict(self._quarantined)
            load = {n: int(self._load.get(n, 0)) for n in self._replicas}
            homes = {s: list(h) for s, h in self._scene_home.items()}
            totals = self._totals_locked()
            routes = {k: int(v) for k, v in self._route_counts.items()}
        replicas = {}
        for name, rep in self._replicas.items():
            block = {
                "slo": rep.dispatcher.slo_totals(),
                "quarantined": quarantined.get(name),
                "inflight": load.get(name, 0),
            }
            if rep.registry is not None:
                block["cache"] = rep.registry.cache.stats()
            replicas[name] = block
        return {
            "replicas": replicas,
            "scene_homes": homes,
            "route_counts": routes,
            "accounting": totals,
        }
