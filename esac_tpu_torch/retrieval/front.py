"""Retrieval front-end: posterior -> candidate policy -> accounting (the
port of ``esac_tpu/retrieval/front.py``).

:class:`RetrievalFront` owns the retriever dispatch, the candidate policy
(top-K over the posterior, each candidate gated by the per-scene breaker
state), the posterior-prefetch feed, and the image-request outcome books
the ``retrieval`` obs collector publishes.  The router's ``infer_image`` is
a thin orchestration over this class -- retrieval POLICY lives here, fleet
SCHEDULING stays in fleet/router.py (which imports neither torch nor numpy;
the winner scoring that needs numpy therefore lives here too, see
:meth:`RetrievalFront.select_winner`).

Accounting contract: every offered image request books EXACTLY one terminal
outcome -- ``offered == served + shed + expired + failed + degraded +
pending`` at every instant -- via the first-wins :class:`_Booking` token
minted by :meth:`RetrievalFront.offer`.  Typed faults ride the
:class:`~esac_tpu_torch.retrieval.errors.RetrievalMissError` family.

Concurrency: all mutable front state lives under the one instance lock, a
leaf.  The retriever forward, the index snapshot, the health callable
(which takes registry locks) and the prefetch sinks all run with the front
lock RELEASED; only counter folds happen under it.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import threading

import numpy as np

from esac_tpu_torch.retrieval.errors import RetrievalMissError

# The image-tier outcome vocabulary: the fleet's classes (fleet.router
# OUTCOMES) — the booking token only ever receives these.
_OUTCOMES = ("served", "shed", "expired", "degraded", "failed")


@dataclasses.dataclass(frozen=True)
class RetrievalPolicy:
    """Host-side candidate-policy knobs (frozen — pure scheduler state;
    the static-shape knobs live in
    :class:`~esac_tpu_torch.retrieval.model.RetrievalConfig`)."""

    # Candidate fan-out: how many healthy top-posterior scenes one
    # image request dispatches to (the recall@K / latency dial).
    top_k: int = 2
    # Admission floor on the posterior's top-1 mass: below it the query
    # matches NO enrolled scene well enough to spend expert dispatches
    # on, and the request sheds typed (RetrievalMissError) instead of
    # burning fleet capacity on a guaranteed-garbage pose.
    min_confidence: float = 0.35
    # Posterior mass floor for the prefetch feed: scenes under it are
    # noise, not staging signal.
    prefetch_min_p: float = 0.05

    def __post_init__(self):
        if self.top_k < 1:
            raise ValueError(f"top_k {self.top_k} < 1")
        if not 0.0 <= self.min_confidence <= 1.0:
            raise ValueError(
                f"min_confidence {self.min_confidence} outside [0, 1]"
            )
        if not 0.0 <= self.prefetch_min_p <= 1.0:
            raise ValueError(
                f"prefetch_min_p {self.prefetch_min_p} outside [0, 1]"
            )


@dataclasses.dataclass(frozen=True)
class RetrievalDecision:
    """One image request's retrieval verdict: the dispatchable candidate
    scenes (posterior-ranked, breaker-gated, length <= top_k) plus the
    evidence the books and traces record."""

    candidates: tuple          # healthy scenes to dispatch, ranked
    posterior: dict            # scene_id -> posterior mass (enrolled only)
    ranked: tuple              # ALL enrolled scenes by posterior, no gate
    entropy: float             # posterior entropy, nats
    top1: str                  # ranked[0] — the health-agnostic best
    top1_p: float              # its posterior mass
    tripped_skipped: int       # candidates skipped by the breaker gate


class _Booking:
    """First-wins outcome token for one offered image request: however
    many error paths race to classify it, exactly one outcome lands in
    the front's books (the fleet ``_finish_locked`` contract, token-
    shaped because the image path has no request object of its own)."""

    __slots__ = ("_front", "outcome")

    def __init__(self, front):
        self._front = front
        self.outcome = None

    def book(self, outcome: str, error=None) -> bool:
        """Record the terminal outcome (idempotent: the first call
        wins, later calls are no-ops returning False)."""
        front = self._front
        with front._lock:
            if self.outcome is not None:
                return False
            self.outcome = outcome
            front._outcomes[outcome] += 1
            if error is not None:
                front._error_types[type(error).__name__] += 1
            return True


class RetrievalFront:
    """The "which scene am I in?" front-end over one retriever.

    ``fn`` is :func:`~esac_tpu_torch.retrieval.model.make_retrieval_fn`'s
    forward (it runs on the device ``fn`` was made for), ``params`` its
    :class:`~esac_tpu_torch.retrieval.model.RetrieverNet`, ``index`` the
    :class:`~esac_tpu_torch.retrieval.index.SceneIndex` whose snapshot rides
    every dispatch as tensor arguments.  ``healthy`` is an optional
    ``scene_id -> bool`` breaker gate (the router wires it to
    ``SceneRegistry.prefetch_targets`` truthiness across its replicas);
    ``prefetch_sinks`` are ``[(scene, p), ...] -> None`` callables fed
    after every decision (the posterior-prefetch seam)."""

    def __init__(self, fn, params, index,
                 policy: RetrievalPolicy = RetrievalPolicy(),
                 healthy=None, prefetch_sinks=()):
        if index.capacity < policy.top_k:
            raise ValueError(
                f"top_k {policy.top_k} > index capacity {index.capacity}"
            )
        self._fn = fn
        self._params = params
        self._index = index
        self._policy = policy
        self._healthy = healthy
        self._sinks = list(prefetch_sinks)
        self._lock = threading.Lock()
        # Image-tier books (all under self._lock).
        self._offered = 0
        self._outcomes: collections.Counter = collections.Counter()
        self._error_types: collections.Counter = collections.Counter()
        self._decided = 0
        self._missed_low_confidence = 0
        self._missed_no_candidate = 0
        self._missed_tripped = 0
        self._tripped_skipped = 0
        self._entropy_sum = 0.0
        self._fanout_sum = 0
        self._winners_noted = 0
        self._top1_hits = 0
        self._winner_in_topk = 0
        self._prefetch_feeds = 0
        self._feed_errors = 0

    # ---------------- wiring ----------------

    @property
    def policy(self) -> RetrievalPolicy:
        return self._policy

    @property
    def index(self):
        return self._index

    def attach_health(self, healthy) -> None:
        """Install the breaker gate (``scene_id -> bool``); the callable
        runs with NO front lock held — it may take registry locks."""
        with self._lock:
            self._healthy = healthy

    def has_health(self) -> bool:
        with self._lock:
            return self._healthy is not None

    def add_prefetch_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    # ---------------- the decision ----------------

    def decide(self, frame) -> RetrievalDecision:
        """One retrieval pass: index snapshot -> retriever posterior ->
        confidence gate -> breaker-gated top-K candidates.  Raises
        :class:`RetrievalMissError` (typed, accounted by the caller's
        booking token) when no dispatchable candidate exists; never
        dispatches anything itself."""
        protos, mask, ids = self._index.snapshot()
        enrolled = [(slot, sid) for slot, sid in enumerate(ids)
                    if sid is not None]
        if not enrolled:
            with self._lock:
                self._missed_no_candidate += 1
            raise RetrievalMissError(
                "retrieval index has no enrolled scene — image-only "
                "requests need at least one prototype"
            )
        # The serve tier's frames are leaf-named dicts ({"image": ...,
        # "coords": ...}); the retriever only reads the image leaf, and
        # the FULL frame goes on to the expert dispatch untouched.
        images = frame["image"] if isinstance(frame, dict) else frame
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[None]
        # The ONE retriever dispatch — outside every lock; prototypes and
        # mask are tensor arguments, so index mutations add no signature.
        out = self._fn(self._params, protos, mask, images)
        post = out["posterior"][0]
        post = np.asarray(post.cpu() if hasattr(post, "cpu") else post, np.float32)
        posterior = {sid: float(post[slot]) for slot, sid in enrolled}
        ranked = tuple(sorted(posterior, key=lambda s: (-posterior[s], s)))
        top1 = ranked[0]
        top1_p = posterior[top1]
        entropy = -math.fsum(
            p * math.log(p) for p in posterior.values() if p > 0.0
        )
        pol = self._policy
        if top1_p < pol.min_confidence:
            with self._lock:
                self._missed_low_confidence += 1
            raise RetrievalMissError(
                f"posterior top-1 {top1!r} at {top1_p:.3f} < "
                f"min_confidence {pol.min_confidence} — the query matches "
                "no enrolled scene well enough to dispatch"
            )
        # Breaker gate: a tripped candidate is SKIPPED (never
        # dispatched) and the next-ranked healthy scene backfills, so
        # the fan-out stays top_k-wide when the index allows.  The
        # callable is snapshotted under the lock (attach_health mutates
        # it there) and CALLED outside it — it takes registry locks.
        with self._lock:
            healthy = self._healthy
        candidates = []
        tripped = 0
        for sid in ranked:
            if len(candidates) >= pol.top_k:
                break
            if healthy is not None and not healthy(sid):
                tripped += 1
                continue
            candidates.append(sid)
        if not candidates:
            with self._lock:
                self._missed_tripped += 1
                self._tripped_skipped += tripped
            raise RetrievalMissError(
                f"every ranked candidate of {len(ranked)} enrolled "
                "scene(s) is breaker-tripped — release_scene() after "
                "recovery"
            )
        with self._lock:
            self._decided += 1
            self._entropy_sum += entropy
            self._fanout_sum += len(candidates)
            self._tripped_skipped += tripped
        return RetrievalDecision(
            candidates=tuple(candidates), posterior=posterior,
            ranked=ranked, entropy=entropy, top1=top1, top1_p=top1_p,
            tripped_skipped=tripped,
        )

    # ---------------- accounting ----------------

    def offer(self) -> _Booking:
        """Book one offered image request; the returned token records
        its single terminal outcome (first caller wins)."""
        with self._lock:
            self._offered += 1
        return _Booking(self)

    def note_result(self, winner_scene, decision: RetrievalDecision) -> None:
        """Fold one served request's winner into the recall proxies."""
        with self._lock:
            self._winners_noted += 1
            if winner_scene == decision.top1:
                self._top1_hits += 1
            if winner_scene in decision.candidates:
                self._winner_in_topk += 1

    # ---------------- the prefetch seam ----------------

    def feed_prefetch(self, decision: RetrievalDecision) -> None:
        """Feed the posterior into the staged-weights seam: every sink
        gets ``[(scene, p), ...]`` over the scenes carrying at least
        ``prefetch_min_p`` mass — ambiguous queries stage their
        runner-up scenes AHEAD of the fault.  Never raises (the
        arrival-feed contract): a broken sink is counted, not served."""
        weights = [(sid, p) for sid, p in decision.posterior.items()
                   if p >= self._policy.prefetch_min_p]
        if not weights:
            return
        with self._lock:
            sinks = list(self._sinks)
            self._prefetch_feeds += 1
        for sink in sinks:
            try:
                sink(weights)
            except Exception:  # noqa: BLE001 — the feed must never hurt serving
                with self._lock:
                    self._feed_errors += 1

    # ---------------- winner scoring ----------------

    @staticmethod
    def select_winner(results):
        """Pick the winning (scene, result) from per-candidate expert
        results by soft-inlier score — the max over each result's
        ``scores`` (the ESAC hypothesis-score semantics: the
        best-supported hypothesis of the best-matching scene wins), or
        its ``score`` leaf, the same maximum, where the scene serves
        "fused_select" and the result carries only the winner's score
        (the JAX package reads ``scores`` alone and raises KeyError on
        such results).  The first candidate wins a tie.  Lives here, not
        in fleet/router.py, so the router keeps its no-numpy discipline;
        the winning result dict is returned UNTOUCHED."""
        best = None
        best_score = -np.inf
        for scene, res in results:
            leaf = res["score"] if "score" in res else res["scores"]
            score = float(np.max(np.asarray(leaf)))
            if score > best_score:
                best_score = score
                best = (scene, res)
        return best

    # ---------------- observability ----------------

    def stats(self) -> dict:
        """The ``retrieval`` obs collector: image-tier accounting (sums
        exactly to offered with pending), miss counts by class,
        posterior-entropy / fan-out means, and the recall proxies."""
        with self._lock:
            outcomes = {o: int(self._outcomes.get(o, 0)) for o in _OUTCOMES}
            done = sum(outcomes.values())
            decided = self._decided
            winners = self._winners_noted
            snap = {
                "offered": self._offered,
                **outcomes,
                "pending": self._offered - done,
                "decided": decided,
                "missed_low_confidence": self._missed_low_confidence,
                "missed_no_candidate": self._missed_no_candidate,
                "missed_tripped": self._missed_tripped,
                "tripped_skipped": self._tripped_skipped,
                "posterior_entropy_mean": (
                    self._entropy_sum / decided if decided else float("nan")
                ),
                "candidate_fanout_mean": (
                    self._fanout_sum / decided if decided else float("nan")
                ),
                "winners_noted": winners,
                "top1_hits": self._top1_hits,
                "winner_in_topk": self._winner_in_topk,
                "recall_proxy_top1": (
                    self._top1_hits / winners if winners else float("nan")
                ),
                "prefetch_feeds": self._prefetch_feeds,
                "feed_errors": self._feed_errors,
                "error_types": dict(self._error_types),
            }
        # Index stats OUTSIDE the front lock: front._lock and
        # index._lock are both lock-graph LEAVES — nesting them would
        # be a new committed edge for no benefit.
        snap["enrolled"] = len(self._index)
        return snap
