"""Predictive weight prefetch: tier admissions driven by the request stream
instead of demand faults (the port of ``esac_tpu/registry/prefetch.py``).

With many scenes behind one device budget, the fault rate is the tail
latency.  A :class:`WeightPrefetcher` is a background thread over a
:class:`~esac_tpu_torch.registry.serving.SceneRegistry` that decides which
weights are warm:

- **Fed by arrivals, never by the hot path.**  The dispatcher calls
  :meth:`WeightPrefetcher.observe` once per scene-carrying submission --
  OUTSIDE its own lock, a bounded-deque append that never blocks and never
  raises (the ``arrival_sink`` contract in serve/dispatcher.py).
  Everything else happens on the prefetch thread.
- **Recency/frequency scores.**  Each cycle folds the drained arrivals into
  per-scene exponentially-decayed counters (half-life ``halflife_s``): a
  frequency ranking that forgets, so a scene that WAS hot ages out.
- **Tier admissions ahead of the fault.**  The top ``device_scenes`` ranked
  scenes are promoted into the device cache, the top ``host_scenes`` into
  the host tier, at most ``max_device_per_cycle`` / ``max_host_per_cycle``
  issues per cycle, sequentially on this one thread.  Promotions ride the
  SAME per-key load futures as demand faults (``DeviceWeightCache.get`` /
  ``HostWeightTier.get_or_load``), so a prefetch in flight coalesces with
  the demand fault it predicted onto one load, and a stalled or failing
  prefetch stalls THIS thread (and that scene's own demand), never the
  dispatch path; a failure caches nothing.  In the port "never the
  dispatch path" needs the dispatch gate (serve/gate.py): a dispatch of
  eager ops hands the GIL over at every op, so each step of a cycle --
  its start, each issue, each read, checksum, leaf copy or compression
  -- first waits until no dispatch of the process is in flight.
- **Health-aware targets.**  Scene -> entries resolution goes through
  ``SceneRegistry.prefetch_targets``: the active version plus any in-flight
  canary, minus breaker-tripped keys.
- **Every decision published.**  ``stats()`` rides obs as the ``prefetch``
  collector: issued/hit/wasted per tier, failures, cycle count.

Pure host code (the device staging happens inside
``DeviceWeightCache.get``).  Lock discipline: the one instance lock guards
scores/arrivals/credit/counters; cache, tier, manifest and health locks are
only ever taken with the prefetcher lock RELEASED (targets are snapshotted
under the lock, loads run outside).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time

from esac_tpu_torch.serve.gate import DISPATCH_GATE, prefetching, yield_to_dispatches


@dataclasses.dataclass(frozen=True)
class PrefetchPolicy:
    """Host-side knobs of the predictive prefetcher.  Like SLOPolicy and
    HealthPolicy it deliberately does NOT ride RansacConfig: nothing here
    may change a bucket function's batch signature."""

    # Cycle period of the background thread.  Admissions land between
    # request faults; shorter = fresher, at more wakeups.
    interval_ms: float = 20.0
    # Half-life of the per-scene arrival score decay: the window over
    # which "popular" is judged.
    halflife_s: float = 5.0
    # How many top-ranked scenes to keep DEVICE-resident ahead of their
    # faults.  The operator sizes this to the device byte budget
    # (budget_bytes // scene_nbytes); the cache's LRU still rules — a
    # prefetcher can only stage, never pin.
    device_scenes: int = 2
    # How many top-ranked scenes to keep HOST-resident (None = every
    # scene ever seen; the host tier's own byte budget still rules).
    host_scenes: int | None = None
    # Per-cycle issue caps: the strict bound on concurrent prefetch work
    # (one thread runs them sequentially; these bound each cycle's
    # staging burst so a ranking flip cannot stampede the loader).
    max_device_per_cycle: int = 2
    max_host_per_cycle: int = 4
    # At most this many top-ranked scenes are EXAMINED for host
    # admissions per cycle (each examination resolves the scene through
    # the manifest/health locks): at the fleet scale this module
    # targets — thousands of tracked scenes — an unbounded scan would
    # hammer the serving host's locks every interval even with nothing
    # to stage.  Scenes beyond the window are admitted as they rank up,
    # or on demand.
    host_scan_limit: int = 64
    # A key the prefetcher just staged is not re-issued for this long:
    # when the device budget is tight, a tail fault can evict a
    # just-promoted hot scene and an eager prefetcher would re-promote
    # it immediately — a promote/evict ping-pong that burns the serving
    # host's cycles for no locality gain.  The cooldown turns that loop
    # into at most one re-promotion per window; a DEMAND fault for the
    # key is never throttled (it rides cache.get as always).
    repromote_cooldown_s: float = 0.25
    # Arrivals buffered between cycles (bounded: a stalled prefetch
    # thread must never grow host memory).
    arrivals_window: int = 10_000

    def __post_init__(self):
        if self.interval_ms <= 0 or self.halflife_s <= 0:
            raise ValueError("interval_ms and halflife_s must be > 0")
        if self.device_scenes < 0:
            raise ValueError(f"device_scenes {self.device_scenes} < 0")
        if self.host_scenes is not None and self.host_scenes < 0:
            raise ValueError(f"host_scenes {self.host_scenes} < 0")
        if self.max_device_per_cycle < 0 or self.max_host_per_cycle < 0:
            raise ValueError("per-cycle caps must be >= 0")
        if self.arrivals_window < 1:
            raise ValueError(f"arrivals_window {self.arrivals_window} < 1")
        if self.host_scan_limit < 1:
            raise ValueError(f"host_scan_limit {self.host_scan_limit} < 1")
        if self.repromote_cooldown_s < 0:
            raise ValueError(
                f"repromote_cooldown_s {self.repromote_cooldown_s} < 0"
            )


class WeightPrefetcher:
    """Background tier-admission driver over a SceneRegistry (see the
    module docstring).  ``start()`` spawns the thread;
    :meth:`run_cycle` is the deterministic single-cycle entry the tests
    drive directly.  ``close()`` stops and joins."""

    def __init__(self, registry, policy: PrefetchPolicy = PrefetchPolicy(),
                 clock=time.monotonic):
        self._registry = registry
        self._policy = policy
        self._clock = clock
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._arrivals: collections.deque = collections.deque(
            maxlen=policy.arrivals_window
        )
        self._scores: dict[str, float] = {}
        self._scored_at: float = clock()
        # key -> tier ("device"|"host") of an issued prefetch that has
        # not yet been claimed by an arrival (hit) or fallen out of
        # residency unclaimed (wasted).
        self._credit: dict = {}
        # key -> last prefetch-issue time (the re-promotion cooldown).
        self._last_issue: dict = {}
        self._stop = False
        # Set by close(): the cycle's gate waits stop (serve/gate.py).
        self._closing = threading.Event()
        self._thread: threading.Thread | None = None
        self.prefetch_issued = collections.Counter()   # by tier
        self.prefetch_hits = 0
        self.prefetch_wasted = 0
        self.prefetch_failures = 0
        self.feed_errors = 0
        self.posterior_feeds = 0
        self.cycles = 0

    # ---- the arrival feed (dispatcher hot path; must never block) ----

    def observe(self, scene) -> None:
        """One scene arrival.  Called by the dispatcher OUTSIDE its own
        lock; a bounded append under this lock — O(1), non-blocking,
        never raises on any input."""
        try:
            t = self._clock()
            with self._lock:
                self._arrivals.append((scene, t, 1.0))
        except Exception:  # noqa: BLE001 — the feed must never hurt serving
            with self._lock:
                self.feed_errors += 1

    def observe_candidates(self, weights) -> None:
        """Posterior-weighted arrivals from the retrieval front:
        ``weights`` is ``[(scene, p), ...]`` over
        one image request's candidate posterior.  Each scene's score
        credit is scaled by its posterior mass — an ambiguous query
        stages its runner-up scenes AHEAD of the fault, at a fraction
        of a full arrival, so retrieval uncertainty ranks below real
        demand but above nothing.  Same contract as :meth:`observe`:
        bounded, non-blocking, never raises."""
        try:
            t = self._clock()
            items = [(scene, t, float(w)) for scene, w in weights
                     if w > 0.0]
            with self._lock:
                self._arrivals.extend(items)
                self.posterior_feeds += 1
        except Exception:  # noqa: BLE001 — the feed must never hurt serving
            with self._lock:
                self.feed_errors += 1

    # ---- lifecycle ----

    def start(self) -> "WeightPrefetcher":
        with self._wake:
            if self._thread is None and not self._stop:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="esac-prefetch",
                )
                self._thread.start()
        return self

    def close(self, timeout_s: float | None = 5.0) -> None:
        """Stop the prefetch thread and join it for up to ``timeout_s``.
        A thread wedged inside a stalled load is ABANDONED, never killed
        (the dispatcher-watchdog idiom; it is a daemon thread, and a
        stale cycle completing later is harmless — admissions are
        idempotent and ``_stop`` ends its loop) — an unbounded join here
        would hand the load's wedge to the caller."""
        with self._wake:
            self._stop = True
            self._wake.notify_all()
            thread = self._thread
        self._closing.set()
        DISPATCH_GATE.wake()
        # Join OUTSIDE the lock: the thread may be re-acquiring it.
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self) -> None:
        interval_s = self._policy.interval_ms / 1e3
        while True:
            with self._wake:
                if self._stop:
                    return
                self._wake.wait(interval_s)
                if self._stop:
                    return
            try:
                self.run_cycle()
            except Exception:  # noqa: BLE001 — a sick cycle must not kill the thread
                with self._lock:
                    self.prefetch_failures += 1

    # ---- the cycle ----

    def _fold_arrivals_locked(self, now: float) -> list:
        """Decay scores to ``now`` and fold the buffered arrivals in
        (lock held).  Returns the drained arrival list for credit
        accounting."""
        drained = list(self._arrivals)
        self._arrivals.clear()
        decay = math.exp(-math.log(2.0) * max(now - self._scored_at, 0.0)
                         / self._policy.halflife_s)
        for s in list(self._scores):
            v = self._scores[s] * decay
            if v < 1e-6:
                del self._scores[s]
            else:
                self._scores[s] = v
        self._scored_at = now
        for scene, t, w in drained:
            back = math.exp(-math.log(2.0) * max(now - t, 0.0)
                            / self._policy.halflife_s)
            self._scores[scene] = self._scores.get(scene, 0.0) + back * w
        return drained

    def run_cycle(self) -> dict:
        """One prefetch cycle: fold arrivals -> rank -> bounded device /
        host admissions -> credit accounting.  Loads and staging happen
        with NO prefetcher lock held, through the cache/tier per-key
        futures, and each step waits while a dispatch is in flight.
        Returns the cycle's decision record (issued keys per tier) — the
        deterministic hook the tests drive."""
        # Issuer mark: every per-key load future this cycle creates records
        # the prefetcher as its issuer, so a traced demand fault coalescing
        # onto it is annotated "prefetch-coalesced" instead of reading as a
        # plain disk wait.
        with prefetching(self._closing):
            yield_to_dispatches()
            return self._cycle()

    def _cycle(self) -> dict:
        now = self._clock()
        pol = self._policy
        cache = self._registry.cache
        tier = getattr(cache, "tier", None)
        with self._lock:
            drained = self._fold_arrivals_locked(now)
            scores = dict(self._scores)
            credit = dict(self._credit)
            cooled = {
                k for k, t in self._last_issue.items()
                if now - t < pol.repromote_cooldown_s
            }
        ranked = sorted(scores, key=lambda s: (-scores[s], s))
        # Credit the arrivals that a still-resident prefetch absorbed:
        # the prediction was right and the fault never happened.
        hits = []
        for scene, _t, _w in drained:
            for key in list(credit):
                if key[0] == scene and (key in cache or
                                        (tier is not None and key in tier)):
                    hits.append(key)
                    del credit[key]
        issued = {"device": [], "host": []}
        failures = 0
        device_targets = ranked[:pol.device_scenes]
        host_n = len(ranked) if pol.host_scenes is None else pol.host_scenes
        # The scan itself is bounded, not just the issues: every scene
        # examined costs prefetch_targets (health + manifest locks).
        host_targets = ranked[:min(host_n, pol.host_scan_limit)]
        for scene in device_targets:
            if len(issued["device"]) >= pol.max_device_per_cycle:
                break
            for entry in self._registry.prefetch_targets(scene):
                if len(issued["device"]) >= pol.max_device_per_cycle:
                    break
                if entry.key in cache or entry.key in cooled:
                    continue
                yield_to_dispatches()
                try:
                    cache.get(entry)  # rides the per-key load future
                    issued["device"].append(entry.key)
                except Exception:  # noqa: BLE001 — counted, never fatal
                    failures += 1
        if tier is not None:
            for scene in host_targets:
                if len(issued["host"]) >= pol.max_host_per_cycle:
                    break
                for entry in self._registry.prefetch_targets(scene):
                    if len(issued["host"]) >= pol.max_host_per_cycle:
                        break
                    if entry.key in tier or entry.key in cache:
                        continue
                    yield_to_dispatches()
                    try:
                        cache.preload_host(entry)
                        issued["host"].append(entry.key)
                    except Exception:  # noqa: BLE001
                        failures += 1
        # Wasted: credited keys that left BOTH tiers before any arrival
        # claimed them — the misprediction record.
        wasted = [
            key for key in credit
            if key not in cache and (tier is None or key not in tier)
        ]
        with self._lock:
            for key in hits:
                if key in self._credit:
                    del self._credit[key]
                    self.prefetch_hits += 1
            for key in wasted:
                if key in self._credit:
                    del self._credit[key]
                    self.prefetch_wasted += 1
            for tier_name in ("device", "host"):
                for key in issued[tier_name]:
                    self.prefetch_issued[tier_name] += 1
                    self._credit[key] = tier_name
                    self._last_issue[key] = now
            # Prune expired cooldown stamps: keyed by fleet, but stale
            # (scene, version) keys from old promotes must not pin host
            # memory forever.
            for key in [k for k, t in self._last_issue.items()
                        if now - t >= pol.repromote_cooldown_s]:
                del self._last_issue[key]
            self.prefetch_failures += failures
            self.cycles += 1
        return issued

    # ---- observability ----

    def scores(self) -> dict:
        with self._lock:
            return dict(self._scores)

    def bind_obs(self, metrics, name: str = "prefetch") -> None:
        """Publish the decision stream into an obs MetricsRegistry
        as a pull collector."""
        metrics.register_collector(name, self.stats)

    def stats(self) -> dict:
        with self._lock:
            return {
                "issued_device": int(self.prefetch_issued["device"]),
                "issued_host": int(self.prefetch_issued["host"]),
                "hits": self.prefetch_hits,
                "wasted": self.prefetch_wasted,
                "failures": self.prefetch_failures,
                "feed_errors": self.feed_errors,
                "posterior_feeds": self.posterior_feeds,
                "cycles": self.cycles,
                "in_credit": len(self._credit),
                "tracked_scenes": len(self._scores),
                "pending_arrivals": len(self._arrivals),
            }
