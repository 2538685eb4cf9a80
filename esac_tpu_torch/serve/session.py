"""Temporal sessions: warm-start streaming relocalization (the port of
``esac_tpu/serve/session.py``).

Real traffic is video, not i.i.d. frames: a tracked frame whose pose is
within a motion model of the previous winner does not need the full sampled
hypothesis budget.  This module is the HOST side of that bargain -- three
pieces:

- :class:`SessionPolicy`: the frozen knob set (prior slot count, tracked
  hypothesis budget, track-loss threshold, table capacity).
- :class:`SessionTable`: per-session last-winner pose + soft-inlier score
  under its OWN leaf lock (no other lock is ever taken inside it), with LRU
  eviction and the session counters.
- :class:`SessionRouter`: the serving wrapper over a
  :class:`~esac_tpu_torch.serve.dispatcher.MicroBatchDispatcher` or a
  :class:`~esac_tpu_torch.fleet.router.FleetRouter`.  Per frame it (1)
  propagates the session's motion model into a STATIC-count prior-pose
  slate riding the frame tree (``prior_rvec`` / ``prior_tvec`` /
  ``prior_valid`` leaves -- arguments of the prior-slot bucket functions,
  so tracked / cold / lost frames share one batch signature), (2)
  dispatches tracked frames at the shrunken ``n_hyps`` override on their
  own coalescing lane, and (3) reads the winner's soft-inlier fraction back
  as the track detector: below the threshold the session drops to ``lost``
  and the NEXT frame runs the full budget (recovery within one frame).

The device side never branches: the validity mask -- not the batch tree
shape -- carries the tracked/cold/lost distinction, and an all-invalid mask
gives the plain bucket functions' result bit for bit
(``ransac.esac.esac_infer_prior``).  The motion model is float32 numpy,
the JAX table's arithmetic operation for operation.

Lock discipline: every dispatch and every result wait happens OUTSIDE the
table lock -- the lock only snapshots and updates host state.  Two threads
streaming the same session id are not an error (last writer wins on the
motion state), but sessions are meant to be single-stream.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

from esac_tpu_torch.serve.slo import ConfigError, ServeError, ShedError


class SessionEvictedError(ShedError):
    """The session was LRU-evicted from a full :class:`SessionTable`
    before this frame arrived; the caller must ``open()`` a new session
    (the next frame then runs cold — full budget, no priors).  A shed:
    admission said no before any dispatch."""

    retryable = True
    wire_name = "session_evicted"


class SessionUnknownError(ConfigError):
    """Caller misuse: a frame for a session id that was never opened (or
    was closed, or evicted long enough ago to leave the eviction ring).
    Deterministic — retrying the same call cannot help."""

    retryable = False
    wire_name = "session_unknown"


@dataclasses.dataclass(frozen=True)
class SessionPolicy:
    """Host-side session knobs (frozen, like
    :class:`~esac_tpu_torch.serve.slo.SLOPolicy`; ``prior_slots`` /
    ``track_n_hyps`` select among PREWARMED bucket functions and batch
    signatures, they do not make new ones).

    ``prior_slots``: P, the static prior-pose slot count of the session
    lane's batch trees (``SceneRegistry.prewarm_programs(prior_slots=P)``
    runs them up front).  Slot 0 is the last winner, slot 1
    the constant-velocity extrapolation; further slots ride invalid
    (headroom for richer motion models without recompiling).

    ``track_n_hyps``: the shrunken per-expert hypothesis budget of a
    TRACKED frame (the per-dispatch override; prewarm it via
    ``n_hyps_overrides``).  Cold and lost frames run the scene's full
    configured budget.

    ``track_loss_frac``: winner soft-inlier fraction below which the
    track is declared lost — the same signal the scene breaker consumes.
    ``track_enter_frac``: fraction a FULL-budget winner must reach to
    (re)enter tracked mode; defaults to ``track_loss_frac`` (enter and
    exit at the same bar) and may be set higher for hysteresis.

    ``max_sessions``: LRU table capacity; the eviction ring remembers
    the last ``evicted_ring`` evicted ids so their next frame raises the
    typed :class:`SessionEvictedError` instead of the generic unknown.
    """

    prior_slots: int = 4
    track_n_hyps: int = 32
    track_loss_frac: float = 0.10
    track_enter_frac: float | None = None
    max_sessions: int = 1024
    evicted_ring: int = 256

    def __post_init__(self):
        if self.prior_slots < 1:
            raise ValueError("prior_slots must be >= 1")
        if self.track_n_hyps < 1:
            raise ValueError("track_n_hyps must be >= 1")
        if not 0.0 < self.track_loss_frac < 1.0:
            raise ValueError("track_loss_frac must be in (0, 1)")
        if self.track_enter_frac is not None \
                and not 0.0 < self.track_enter_frac < 1.0:
            raise ValueError("track_enter_frac must be in (0, 1)")
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        if self.evicted_ring < 0:
            raise ValueError("evicted_ring must be >= 0")

    @property
    def enter_frac(self) -> float:
        return (self.track_enter_frac if self.track_enter_frac is not None
                else self.track_loss_frac)


class _SessionState:
    """One session's host motion state (mutated only under the table
    lock)."""

    __slots__ = ("scene", "route_k", "full_n_hyps", "last_rvec",
                 "last_tvec", "prev_rvec", "prev_tvec", "last_frac",
                 "tracked", "frames", "tracked_frames", "losses")

    def __init__(self, scene, route_k, full_n_hyps):
        self.scene = scene
        self.route_k = route_k
        self.full_n_hyps = full_n_hyps  # budget restored after loss/cold
        self.last_rvec = None           # np (3,) — None until first winner
        self.last_tvec = None
        self.prev_rvec = None           # the winner before last
        self.prev_tvec = None
        self.last_frac = 0.0
        self.tracked = False
        self.frames = 0
        self.tracked_frames = 0
        self.losses = 0


class SessionTable:
    """Per-session motion state + counters under one LEAF lock.

    The lock is a leaf: no code path acquires any other lock while holding
    it (snapshot under the lock, dispatch/wait outside), so it can be taken
    from dispatcher or fleet callbacks without extending the lock order.
    """

    def __init__(self, policy: SessionPolicy = SessionPolicy()):
        self.policy = policy
        self._lock = threading.Lock()
        self._sessions: collections.OrderedDict[str, _SessionState] = \
            collections.OrderedDict()
        self._evicted: collections.deque[str] = collections.deque(
            maxlen=policy.evicted_ring
        )
        # Counters (plain ints under the lock; the `session` collector
        # snapshots them).
        self.opened = 0
        self.evicted_count = 0
        self.closed = 0
        self.frames = 0
        self.tracked_frames = 0
        self.full_frames = 0
        self.track_losses = 0
        self.track_entries = 0
        self.budget_saved_hyps = 0
        self.dispatch_errors = 0

    # -- lifecycle --

    def open(self, session_id: str, scene=None, route_k=None,
             full_n_hyps: int | None = None) -> None:
        """Register a session (idempotent: re-opening resets its motion
        state).  ``full_n_hyps`` is the scene's configured full budget —
        used only for the ``budget_saved_hyps`` accounting (None skips
        that counter).  Evicts the LRU session beyond capacity."""
        with self._lock:
            old = self._sessions.pop(session_id, None)
            self._sessions[session_id] = _SessionState(
                scene, route_k, full_n_hyps
            )
            if old is None:
                self.opened += 1
            while len(self._sessions) > self.policy.max_sessions:
                evicted_id, _ = self._sessions.popitem(last=False)
                self._evicted.append(evicted_id)
                self.evicted_count += 1

    def close(self, session_id: str) -> bool:
        """Drop a session; True if it existed.  A closed id raises
        :class:`SessionUnknownError` on its next frame (closing is the
        caller's OWN action — the typed evicted error is reserved for
        table-pressure evictions the caller did not perform)."""
        with self._lock:
            existed = self._sessions.pop(session_id, None) is not None
            if existed:
                self.closed += 1
            return existed

    # -- per-frame host steps (each one short critical section) --

    def plan(self, session_id: str):
        """Snapshot one frame's dispatch decision: returns
        ``(scene, route_k, n_hyps, prior_rvecs, prior_tvecs,
        prior_valid, tracked)`` with the priors as host numpy
        (P, 3)/(P,) arrays.  Touches the LRU order.  Raises the typed
        session errors for evicted/unknown ids."""
        P = self.policy.prior_slots
        with self._lock:
            st = self._sessions.get(session_id)
            if st is None:
                if session_id in self._evicted:
                    raise SessionEvictedError(
                        f"session {session_id!r} was evicted "
                        f"(table capacity {self.policy.max_sessions}); "
                        "open() it again to resume cold"
                    )
                raise SessionUnknownError(
                    f"unknown session {session_id!r}: open() it first"
                )
            self._sessions.move_to_end(session_id)
            rv = np.zeros((P, 3), np.float32)
            tv = np.zeros((P, 3), np.float32)
            valid = np.zeros((P,), bool)
            if st.tracked and st.last_rvec is not None:
                rv[0], tv[0] = st.last_rvec, st.last_tvec
                valid[0] = True
                if P > 1 and st.prev_rvec is not None:
                    # Constant-velocity extrapolation, linear in the
                    # rvec/tvec coordinates — exact for the translation
                    # rate, first-order in the rotation vector (fine at
                    # video frame spacing; a wrong prior only costs its
                    # slot, never correctness).
                    rv[1] = 2.0 * st.last_rvec - st.prev_rvec
                    tv[1] = 2.0 * st.last_tvec - st.prev_tvec
                    valid[1] = True
            n_hyps = self.policy.track_n_hyps if st.tracked \
                else st.full_n_hyps
            return (st.scene, st.route_k, n_hyps, rv, tv, valid,
                    st.tracked)

    def observe(self, session_id: str, rvec, tvec, inlier_frac: float,
                was_tracked: bool) -> str:
        """Fold one served frame's winner back into the session.  Returns
        the transition: ``"tracked"`` (still/again tracking), ``"lost"``
        (track-loss event: the NEXT frame runs full budget), or
        ``"cold"`` (full-budget frame that did not reach the entry bar).
        A session evicted while the frame was in flight is a no-op
        (``"evicted"``) — its dispatch already happened; only state
        publication is skipped."""
        pol = self.policy
        # Materialize the winner pose to host numpy BEFORE the critical
        # section: rvec/tvec may still be device tensors and reading one
        # is an implicit device sync (never block under a lock).
        rvec_h = np.asarray(rvec, np.float32).copy()
        tvec_h = np.asarray(tvec, np.float32).copy()
        with self._lock:
            st = self._sessions.get(session_id)
            if st is None:
                return "evicted"
            st.frames += 1
            self.frames += 1
            st.last_frac = float(inlier_frac)
            st.prev_rvec, st.prev_tvec = st.last_rvec, st.last_tvec
            st.last_rvec = rvec_h
            st.last_tvec = tvec_h
            if was_tracked:
                st.tracked_frames += 1
                self.tracked_frames += 1
                if st.full_n_hyps is not None:
                    self.budget_saved_hyps += max(
                        0, st.full_n_hyps - pol.track_n_hyps
                    )
                if st.last_frac < pol.track_loss_frac:
                    st.tracked = False
                    # A lost track's stale motion state must not seed
                    # the recovery frame's priors.
                    st.prev_rvec = st.prev_tvec = None
                    st.last_rvec = st.last_tvec = None
                    st.losses += 1
                    self.track_losses += 1
                    return "lost"
                return "tracked"
            self.full_frames += 1
            if st.last_frac >= pol.enter_frac:
                if not st.tracked:
                    self.track_entries += 1
                st.tracked = True
                return "tracked"
            return "cold"

    def note_error(self, session_id: str) -> None:
        """A dispatch for this session failed with a typed serve error:
        drop to lost (its motion state may be stale by the time the
        caller retries) and count."""
        with self._lock:
            self.dispatch_errors += 1
            st = self._sessions.get(session_id)
            if st is not None and st.tracked:
                st.tracked = False
                st.prev_rvec = st.prev_tvec = None
                st.last_rvec = st.last_tvec = None
                st.losses += 1
                self.track_losses += 1

    # -- obs --

    def stats(self) -> dict:
        """The ``session`` collector snapshot (one lock pass)."""
        with self._lock:
            frames = self.frames
            return {
                "sessions": len(self._sessions),
                "opened": self.opened,
                "closed": self.closed,
                "evicted": self.evicted_count,
                "frames": frames,
                "tracked_frames": self.tracked_frames,
                "full_frames": self.full_frames,
                "tracked_frac": (self.tracked_frames / frames
                                 if frames else 0.0),
                "track_losses": self.track_losses,
                "track_entries": self.track_entries,
                "budget_saved_hyps": self.budget_saved_hyps,
                "dispatch_errors": self.dispatch_errors,
            }


class SessionRouter:
    """Session-aware serving lane over a dispatcher or fleet router.

    ``target`` needs the shared serve surface: ``submit(frame, scene=,
    route_k=, deadline_ms=, n_hyps=)`` returning a request with
    ``.get(timeout)`` (worker-backed
    :class:`~esac_tpu_torch.serve.dispatcher.MicroBatchDispatcher`,
    :class:`~esac_tpu_torch.fleet.router.FleetRouter`) — or, for worker-less
    sync dispatchers, ``infer_one(...)`` (detected via the dispatcher's
    published ``_worker`` state).  The table registers itself as the
    ``session`` obs collector on ``target.obs``.

    Per ``infer_frame``: plan under the table lock, attach the prior
    leaves to a SHALLOW COPY of the caller's frame tree, dispatch on the
    explicit ``n_hyps`` lane (session lanes are ALWAYS 3-tuples, so
    their prior-carrying batch trees never coalesce with plain
    traffic), wait outside every lock, then fold the winner back.  A
    track loss lands in the session counters and — when the fleet
    sampled this request — as a ``session:track_loss`` event span
    on the causal trace.
    """

    def __init__(self, target, policy: SessionPolicy = SessionPolicy(),
                 clock=None):
        self.target = target
        self.policy = policy
        self.table = SessionTable(policy)
        self._clock = clock if clock is not None \
            else getattr(target, "_clock", None)
        obs = getattr(target, "obs", None)
        if obs is not None:
            obs.register_collector("session", self.table.stats)

    # -- lifecycle passthrough --

    def open(self, session_id: str, scene=None, route_k=None,
             full_n_hyps: int | None = None) -> None:
        self.table.open(session_id, scene, route_k, full_n_hyps)

    def close(self, session_id: str) -> bool:
        return self.table.close(session_id)

    # -- the per-frame serve call --

    def infer_frame(self, session_id: str, frame: dict,
                    timeout: float | None = None,
                    deadline_ms: float | None = None) -> dict:
        """Serve one frame of a session.  Returns the per-frame result
        tree with two host fields added: ``session_tracked`` (was this
        dispatch on the shrunken tracked lane) and ``session_transition``
        (``tracked``/``lost``/``cold``/``evicted``).  Raises the
        session-typed errors at admission and the target's typed
        :class:`~esac_tpu_torch.serve.slo.ServeError` tree from the dispatch
        (after dropping the session to lost — fail toward the full
        budget, never toward a stale prior)."""
        scene, route_k, n_hyps, p_rv, p_tv, p_valid, tracked = \
            self.table.plan(session_id)
        sframe = dict(frame)
        sframe["prior_rvec"] = p_rv
        sframe["prior_tvec"] = p_tv
        sframe["prior_valid"] = p_valid
        trace = None
        try:
            result, trace = self._dispatch(
                sframe, scene, route_k, n_hyps, timeout, deadline_ms
            )
        except ServeError:
            # Disposal: publish the loss + count, then re-raise —
            # the caller sees exactly the target's typed error.
            self.table.note_error(session_id)
            raise
        transition = self.table.observe(
            session_id,
            np.asarray(result["rvec"]),
            np.asarray(result["tvec"]),
            float(np.asarray(result["inlier_frac"])),
            was_tracked=tracked,
        )
        if transition == "lost" and trace is not None:
            t = self._clock() if self._clock is not None else 0.0
            trace.add_event(
                "session:track_loss", t, session=session_id,
                inlier_frac=float(np.asarray(result["inlier_frac"])),
            )
        result = dict(result)
        result["session_tracked"] = tracked
        result["session_transition"] = transition
        return result

    def _dispatch(self, frame, scene, route_k, n_hyps, timeout,
                  deadline_ms):
        """One dispatch through the target, outside every session lock.
        Returns ``(result tree, sampled trace or None)``."""
        if getattr(self.target, "_worker", True) is None:
            # Worker-less sync dispatcher: the dispatch runs in THIS
            # thread via infer_one; no queue, no request object.
            return self.target.infer_one(
                frame, scene=scene, route_k=route_k, timeout=timeout,
                deadline_ms=deadline_ms, n_hyps=n_hyps,
            ), None
        if deadline_ms is None and timeout is not None:
            deadline_ms = timeout * 1e3
        req = self.target.submit(
            frame, scene=scene, route_k=route_k,
            deadline_ms=deadline_ms, n_hyps=n_hyps,
        )
        return req.get(timeout), getattr(req, "trace", None)
