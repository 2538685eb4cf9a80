"""SLO machinery for the serving stack: typed outcomes, policy, faults (a
copy of ``esac_tpu/serve/slo.py``).

- **Typed request outcomes** (:class:`ServeError` tree): a caller of
  ``infer_one``/``submit`` can catch exactly the failure class it can act
  on -- :class:`ShedError` (admission control said no; retry elsewhere),
  :class:`DeadlineExceededError` (the request expired),
  :class:`DispatchStalledError` (the dispatch wedged and the watchdog
  failed it), :class:`LaneQuarantinedError` (the lane is known bad until
  an operator releases it), :class:`WorkerDiedError` /
  :class:`DispatcherClosedError` (the server is gone; nothing queued will
  ever run), :class:`ConfigError` (caller misuse).

- **:class:`SLOPolicy`**: one frozen host-side knob set handed to the
  dispatcher.  It does NOT ride
  :class:`~esac_tpu_torch.ransac.config.RansacConfig`: SLO knobs are pure
  host scheduling state, tunable on a live server without touching the
  bucket functions.

- **:class:`FaultInjector`**: the injectable stall/failure shim on the
  dispatch path.  A wedged device call is indistinguishable from an
  ``infer_fn`` call that never returns, so the shim wraps the dispatcher's
  ``infer_fn`` and can be armed to block on an Event (a stall the test
  releases later) or to raise (a transient failure) on the Nth dispatch;
  it also wraps the registry's checkpoint reader.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch


class ServeError(RuntimeError):
    """Base class of every typed serving failure.

    ``retryable`` tells the dispatcher's transient-failure retry loop
    whether re-running the dispatch could possibly change the outcome:
    subclasses representing *deterministic* faults (a checksum mismatch,
    a breaker-shed scene -- see esac_tpu_torch.registry.health) set it False
    and the dispatcher fails the batch immediately instead of re-paying
    the fault ``retry_max`` times.

    ``wire_name`` is the class's stable cross-process identity: a typed
    error crossing an RPC
    wire is identified by this snake_case token, never by a Python
    qualname, so classes can move between modules without breaking
    peers.  Every taxonomy member declares BOTH attributes explicitly
    as literals; inheritance is deliberately not enough."""

    retryable = True
    wire_name = "serve"


class ShedError(ServeError):
    """Admission control rejected the request before it entered the queue
    (bounded queue full, or predicted wait exceeds the request's SLO)."""

    retryable = True
    wire_name = "shed"


class LaneQuarantinedError(ShedError):
    """The request's (scene, route_k) lane is quarantined after a wedged or
    repeatedly failing dispatch; an operator must ``release_lane`` it.
    A quarantine rejection is a shed (it happens at admission), so callers
    that only distinguish *admitted vs not* can catch :class:`ShedError`."""

    # Retryable: other lanes (and, one tier up, other replicas) still
    # serve — a re-submit routed elsewhere can succeed.
    retryable = True
    wire_name = "lane_quarantined"


class DeadlineExceededError(ServeError):
    """The request missed its deadline — expired in the queue, or the
    caller's wait timed out before a result landed."""

    retryable = True
    wire_name = "deadline_exceeded"


class DispatchStalledError(ServeError):
    """The watchdog declared the in-flight dispatch wedged (no progress
    within ``SLOPolicy.watchdog_ms``) and failed its requests rather than
    letting callers hang -- a wedged device call made a bounded, typed
    error."""

    retryable = True
    wire_name = "dispatch_stalled"


class WorkerDiedError(ServeError):
    """The dispatcher's worker thread died with requests pending; nothing
    queued will ever dispatch.  Pending and future requests fail with
    this instead of stranding their callers forever."""

    # Retryable: the fleet tier treats a dead worker as a replica fault
    # and fails the request over to a surviving replica.
    retryable = True
    wire_name = "worker_died"


class DispatcherClosedError(ServeError):
    """``close()`` ran while requests were still pending and no worker
    could drain them."""

    # Closed is deliberate: nothing on THIS dispatcher will ever serve
    # again (the fleet tier may still fail over, but that is routing,
    # not a retry of the same dispatch).
    retryable = False
    wire_name = "dispatcher_closed"


class ConfigError(ServeError, ValueError):
    """Caller misuse of the serving API outside a constructor: a bad
    argument to an already-built dispatcher/router/loadgen surface
    (``route_k`` out of range, an unknown bucket, a non-positive rate).
    Deterministic — retrying the same call cannot help.  Subclasses
    ``ValueError`` too so callers catching ``ValueError`` keep working;
    ``__init__`` validation itself stays on bare ``ValueError``."""

    retryable = False
    wire_name = "config"


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Host-side serving SLO knobs (see module docstring for why these do
    not live on RansacConfig).  Passing a policy to the dispatcher opts
    the request path into deadlines, admission control, degradation and
    the watchdog; without one the blocking contract (block-for-space,
    wait forever) holds."""

    # Default per-request deadline, milliseconds; None = no deadline (the
    # other SLO machinery — shed-on-full, watchdog, degradation — still
    # applies).  ``submit``/``infer_one`` may override per request.
    deadline_ms: float | None = None
    # Admission control: with a bounded queue at capacity the dispatcher
    # SHEDS (typed ShedError) instead of blocking the submitter — open-loop
    # traffic must never convert overload into unbounded caller threads.
    # Additionally, a request whose PREDICTED wait (dispatch-time EMA x
    # queue occupancy ahead of it) already exceeds its deadline is shed at
    # submit time: rejecting in microseconds beats serving a corpse late.
    shed_on_predicted_miss: bool = True
    # Graceful degradation: when queue occupancy (pending / depth) reaches
    # this fraction, a lane's dispatches downshift ``route_k`` one rung
    # down ``degrade_route_k`` (ascending K ladder): K selects one of the
    # routed bucket functions the registry already holds, so degrading
    # adds no batch signature.  Empty ladder = degradation off.
    degrade_queue_frac: float = 0.75
    degrade_route_k: tuple[int, ...] = ()
    # Watchdog: an in-flight dispatch older than this is declared wedged —
    # its requests fail with DispatchStalledError, the lane is
    # quarantined, and a replacement worker takes over the other lanes.
    # Size it to a few healthy dispatch times and BELOW deadline_ms, so
    # the watchdog (not the caller's own timeout) is what fires first.
    # PREWARM before serving (SceneRegistry.prewarm_programs, or drive
    # each program once through a worker-less dispatcher): a first dispatch
    # of a bucket (cuDNN's algorithm choice, the allocator's first growth)
    # is slow and indistinguishable from a stall, so a cold bucket under a
    # tight watchdog gets its lane quarantined at
    # the first request — typed and bounded, but not what you wanted.
    watchdog_ms: float = 1_000.0
    # Watchdog poll interval (also bounds how stale queue-expiry is).
    watchdog_poll_ms: float = 20.0
    # Transient-failure retries per dispatch (an infer_fn that RAISES, as
    # opposed to one that hangs), with capped exponential backoff.
    retry_max: int = 1
    retry_backoff_ms: float = 10.0
    retry_backoff_max_ms: float = 200.0
    # Consecutive exhausted-retry dispatch failures on one lane before the
    # lane is quarantined (a wedged dispatch quarantines immediately).
    quarantine_after: int = 2

    def __post_init__(self):
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms {self.deadline_ms} <= 0")
        if not 0.0 < self.degrade_queue_frac <= 1.0:
            raise ValueError(
                f"degrade_queue_frac {self.degrade_queue_frac} outside (0, 1]"
            )
        if any(k < 1 for k in self.degrade_route_k):
            raise ValueError(
                f"degrade_route_k {self.degrade_route_k} has entries < 1"
            )
        if self.watchdog_ms <= 0 or self.watchdog_poll_ms <= 0:
            raise ValueError("watchdog_ms / watchdog_poll_ms must be > 0")
        if self.retry_max < 0 or self.quarantine_after < 1:
            raise ValueError("retry_max >= 0 and quarantine_after >= 1")

    def degrade_k(self, route_k: int | None) -> int | None:
        """The next-cheaper rung for a lane at ``route_k``: dense (None)
        downshifts to the ladder's LARGEST K (nearest-quality cheaper
        program); routed K to the largest rung strictly below K; already
        at/below the bottom rung stays put.  One rung per dispatch — the
        degradation is gradual, not a cliff."""
        ladder = sorted(set(self.degrade_route_k))
        if not ladder:
            return route_k
        if route_k is None:
            return ladder[-1]
        below = [k for k in ladder if k < route_k]
        return below[-1] if below else route_k

    def backoff_s(self, attempt: int) -> float:
        """Capped exponential backoff before retry ``attempt`` (1-based)."""
        return min(
            self.retry_backoff_ms * (2 ** (attempt - 1)),
            self.retry_backoff_max_ms,
        ) / 1e3


class FaultInjector:
    """Stall/failure shim wrapping a dispatcher ``infer_fn`` — and, since
    the registry's checkpoint-read path.

    Dispatch path: arm with :meth:`stall_once` (the Nth call blocks on an
    Event until the test releases it -- a wedged device call from the
    worker thread's point of view) or :meth:`fail_times`
    (the next calls raise).  Unarmed calls pass straight through.

    Per-replica targeting: each injector may carry a ``tag``
    (the fleet drill tags one injector per replica with the replica
    name), and the dispatch-path armings take an optional ``match``
    predicate over the dispatch context ``{"tag", "scene", "route_k"}``
    — so one drill recipe can arm every replica's injector identically
    and still fault exactly one replica (or one scene on one replica)
    without touching the others.  Unmatched armed calls pass through
    untouched and are counted (``dispatch_unmatched`` in
    :meth:`stats`), so the drill can assert the fault landed where it
    aimed and nowhere else.

    Registry path: :meth:`checkpoint_reader` wraps a checkpoint-reading
    fn (``load_checkpoint``-shaped: path -> (params, config)), making
    every way a scene load can go bad drillable — :meth:`fail_loads`
    (transient IO fault: the loader's retry/backoff is what's under
    test), :meth:`corrupt_loads` (the read returns bit-flipped content,
    so manifest checksum verification must catch it), and
    :meth:`stall_loads` (a read that never returns on the cold-load
    path; the weight cache's per-key load futures
    keep other scenes servable while the watchdog handles the wedge).
    Each arming takes an optional ``match`` predicate over the checkpoint
    path so a multi-scene drill can fault exactly one scene.

    All mutable state is guarded by the instance lock; stall waits
    happen OUTSIDE the lock so
    stats stay readable while a dispatch or load is wedged.
    """

    def __init__(self, infer_fn=None, tag=None):
        self._infer = infer_fn
        self.tag = tag  # immutable identity (e.g. the replica name)
        self._cache_size = getattr(infer_fn, "_cache_size", None)
        self._lock = threading.Lock()
        self._stall_release: threading.Event | None = None
        self._stall_after = 0
        self._stall_match = None
        self._fail_exc: Exception | None = None
        self._fail_left = 0
        self._fail_match = None
        self._calls = 0
        self._stalls = 0
        self._failures = 0
        self._unmatched = 0
        # Registry-path (checkpoint read) arming + counters.
        self._load_fail_exc: Exception | None = None
        self._load_fail_left = 0
        self._load_fail_match = None
        self._load_corrupt_left = 0
        self._load_corrupt_match = None
        self._load_stall_release: threading.Event | None = None
        self._load_stall_after = 0
        self._load_stall_match = None
        self._load_calls = 0
        self._load_failures = 0
        self._load_corruptions = 0
        self._load_stalls = 0

    def stall_once(self, release: threading.Event, after: int = 0,
                   match=None) -> None:
        """Arm ONE stall: the ``after``-th MATCHING call from now blocks
        on ``release`` (0 = the very next one).  ``match`` is a
        predicate over the dispatch context dict (``tag``/``scene``/
        ``route_k``); None matches every call."""
        with self._lock:
            self._stall_release = release
            self._stall_after = after
            self._stall_match = match

    def fail_times(self, exc: Exception, times: int = 1,
                   match=None) -> None:
        """Arm ``times`` consecutive MATCHING failures raising ``exc``
        (``match`` as in :meth:`stall_once`)."""
        with self._lock:
            self._fail_exc = exc
            self._fail_left = times
            self._fail_match = match

    # ---- registry-path (checkpoint read) arming ----

    def fail_loads(self, exc: Exception, times: int = 1, match=None) -> None:
        """Arm ``times`` checkpoint reads (matching ``match``, a predicate
        over the path string; None = every read) to raise ``exc`` —
        the transient-IO-fault drill for the loader's retry/backoff."""
        with self._lock:
            self._load_fail_exc = exc
            self._load_fail_left = times
            self._load_fail_match = match

    def corrupt_loads(self, times: int = 1, match=None) -> None:
        """Arm ``times`` matching reads to return CORRUPTED content (the
        first float leaf bit-flipped): the read itself succeeds, so only
        manifest checksum verification stands between the corruption and
        served garbage — exactly the gap under drill."""
        with self._lock:
            self._load_corrupt_left = times
            self._load_corrupt_match = match

    def stall_loads(self, release: threading.Event, after: int = 0,
                    match=None) -> None:
        """Arm ONE matching read to block on ``release`` (``after`` later
        matching reads first) -- a stall on the cold-load path."""
        with self._lock:
            self._load_stall_release = release
            self._load_stall_after = after
            self._load_stall_match = match

    def checkpoint_reader(self, read_fn):
        """Wrap a ``path -> (params, config)`` checkpoint reader with the
        armed registry faults.  Hand the result to
        ``load_scene_params(..., read_checkpoint=...)`` (or a
        functools.partial of it as a cache loader)."""

        def read(path):
            release = None
            corrupt = False
            p = str(path)
            with self._lock:
                self._load_calls += 1
                if self._load_stall_release is not None and (
                        self._load_stall_match is None
                        or self._load_stall_match(p)):
                    if self._load_stall_after <= 0:
                        release = self._load_stall_release
                        self._load_stall_release = None
                        self._load_stalls += 1
                    else:
                        self._load_stall_after -= 1
                if release is None and self._load_fail_left > 0 and (
                        self._load_fail_match is None
                        or self._load_fail_match(p)):
                    self._load_fail_left -= 1
                    self._load_failures += 1
                    exc = self._load_fail_exc
                    raise exc
                if release is None and self._load_corrupt_left > 0 and (
                        self._load_corrupt_match is None
                        or self._load_corrupt_match(p)):
                    self._load_corrupt_left -= 1
                    self._load_corruptions += 1
                    corrupt = True
            if release is not None:
                release.wait()  # the cold-load wedge
            params, config = read_fn(path)
            if corrupt:
                params = _bitflip_first_leaf(params)
            return params, config

        return read

    def stats(self) -> dict:
        with self._lock:
            return {
                "tag": self.tag,
                "calls": self._calls,
                "stalls": self._stalls,
                "failures": self._failures,
                "dispatch_unmatched": self._unmatched,
                "load_calls": self._load_calls,
                "load_failures": self._load_failures,
                "load_corruptions": self._load_corruptions,
                "load_stalls": self._load_stalls,
            }

    def __call__(self, tree, *rest):
        ctx = {
            "tag": self.tag,
            "scene": rest[0] if rest else None,
            "route_k": rest[1] if len(rest) > 1 else None,
        }
        release = None
        with self._lock:
            self._calls += 1
            armed = (self._stall_release is not None
                     or self._fail_left > 0)
            if self._stall_release is not None and (
                    self._stall_match is None or self._stall_match(ctx)):
                if self._stall_after <= 0:
                    release = self._stall_release
                    self._stall_release = None
                    self._stalls += 1
                else:
                    self._stall_after -= 1
            if release is None and self._fail_left > 0 and (
                    self._fail_match is None or self._fail_match(ctx)):
                self._fail_left -= 1
                self._failures += 1
                exc = self._fail_exc
                raise exc
            if release is None and armed:
                # An armed fault existed but this call passed clean:
                # either the predicate declined it, or the stall is
                # still counting down.  The drill's "nowhere else"
                # assertion reads this.
                self._unmatched += 1
        if release is not None:
            release.wait()  # the wedge: held until the test releases it
        return self._infer(tree, *rest)


def _bitflip_first_leaf(params):
    """Copy ``params`` with its first array leaf perturbed -- simulated
    read corruption (content changes, structure survives, so the damage
    is invisible to everything EXCEPT a content checksum).  Torch tensor
    leaves are cloned, numpy leaves copied: the read's own objects are
    never mutated."""
    done = {"flag": False}

    def flip(flat):
        floating = (flat.dtype.is_floating_point if isinstance(flat, torch.Tensor)
                    else np.issubdtype(flat.dtype, np.floating))
        if floating:
            flat[0] = flat[0] + 1.0
        else:
            flat[0] = ~flat[0]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if not done["flag"] and hasattr(node, "shape"):
            arr = (node.clone(memory_format=torch.contiguous_format)
                   if isinstance(node, torch.Tensor)
                   else np.array(node, copy=True, order="C"))
            if arr.size if isinstance(arr, np.ndarray) else arr.numel():
                flip(arr.reshape(-1))
                done["flag"] = True
                return arr
        return node

    return walk(params)
