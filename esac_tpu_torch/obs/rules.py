"""Declarative health rules over the timeline (counterpart of
``esac_tpu/obs/rules.py``).

The timeline (``obs/timeline.py``) gives every fleet number a time axis;
this module judges it: a small catalog of declarative rules -- each a
frozen parameter set with one ``evaluate(windows)`` method -- producing
typed, ring-bounded :class:`Alert` events that ride ``obs.snapshot()``
(the ``health_alerts`` collector), the Prometheus page
(``health_alerts_total`` counter, ``health_alert_active`` gauge, labeled
per rule) and ``python -m esac_tpu_torch.obs``.  The catalog and its
thresholds are the JAX package's:

- :class:`BurnRateRule` -- SLO error-budget burn over a fast / slow window
  pair: bad outcomes / offered must pass the fast threshold (it is
  happening now) and the slow one (enough budget burned to matter).
- :class:`BadFracSlopeRule` -- the slope of a scene's ``bad_frac`` across
  windows (a drift toward the breaker, before it trips).
- :class:`PrefetchWasteRule` -- wasted / issued prefetches over recent
  windows.
- :class:`AffinitySagRule` -- the affinity hit rate of scene-routed routes
  below a floor.
- :class:`QueueKneeRule` -- queue occupancy (pending / depth) near the
  goodput knee.

Evaluation: ``RuleEngine.evaluate`` reads the windows through the
timeline's locked accessor, evaluates every rule with no lock held,
publishes its instruments (their locks only), then records edges under
its own leaf lock.  Alerts are edge-triggered: an event when a rule turns
active, one when it clears; the current state rides the
``health_alert_active`` gauge.

Pure host code: no torch import.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time


@dataclasses.dataclass(frozen=True)
class Alert:
    """One typed alert event (json-dumpable via :meth:`to_dict`)."""

    rule: str
    severity: str          # "warn" | "page"
    value: float           # the statistic that fired
    threshold: float       # the limit it crossed
    message: str
    labels: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "severity": self.severity,
            "value": self.value, "threshold": self.threshold,
            "message": self.message, "labels": dict(self.labels),
        }


def _counter_sum(windows, name: str, label_sub: str | None = None):
    """Sum of a counter's per-window deltas over ``windows`` (all label
    children, or only keys containing ``label_sub``)."""
    total = 0.0
    for w in windows:
        for key, d in w.get("counters", {}).get(name, {}).items():
            if label_sub is None or label_sub in key:
                total += d
    return total


def _collector_series(windows, collector: str, path_suffix: str):
    """Per-path series of a collector leaf across windows: {full_path:
    [values]} for every path ending in ``path_suffix`` (the per-scene
    fan-out -- one series per scene)."""
    series: dict[str, list[float]] = collections.defaultdict(list)
    for w in windows:
        block = w.get("collectors", {}).get(collector, {})
        for path, v in block.items():
            if path.endswith(path_suffix):
                series[path].append(v)
    return dict(series)


def _slope(ys) -> float:
    """Least-squares slope per window of ``ys`` (0.0 under 2 points)."""
    n = len(ys)
    if n < 2:
        return 0.0
    xbar = (n - 1) / 2.0
    ybar = sum(ys) / n
    num = sum((i - xbar) * (y - ybar) for i, y in enumerate(ys))
    den = sum((i - xbar) ** 2 for i in range(n))
    return num / den if den else 0.0


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """Multi-window SLO burn rate over an outcomes counter (module
    docstring).  ``bad`` outcome labels burn budget; the denominator is
    the offered counter."""

    name: str = "slo_burn_rate"
    severity: str = "page"
    outcomes_counter: str = "serve_outcomes_total"
    offered_counter: str = "serve_offered_total"
    bad_outcomes: tuple = ("shed", "expired", "failed")
    fast_windows: int = 3
    slow_windows: int = 30
    fast_bad_frac: float = 0.10
    slow_bad_frac: float = 0.02
    min_offered: int = 20  # evidence floor: no verdicts on a whisper

    def evaluate(self, windows) -> list[Alert]:
        if not windows:
            return []
        out = []
        fast = windows[-self.fast_windows:]
        slow = windows[-self.slow_windows:]

        def frac(ws):
            offered = _counter_sum(ws, self.offered_counter)
            bad = sum(_counter_sum(ws, self.outcomes_counter,
                                   f"outcome={o}")
                      for o in self.bad_outcomes)
            return bad / offered if offered else 0.0, offered

        fast_frac, fast_n = frac(fast)
        slow_frac, slow_n = frac(slow)
        if (fast_n >= self.min_offered
                and fast_frac >= self.fast_bad_frac
                and slow_frac >= self.slow_bad_frac):
            out.append(Alert(
                self.name, self.severity, round(fast_frac, 4),
                self.fast_bad_frac,
                f"error budget burning: bad-frac {fast_frac:.3f} over "
                f"last {len(fast)} window(s) (slow {slow_frac:.3f} over "
                f"{len(slow)}; offered {int(fast_n)})",
                {"slow_bad_frac": round(slow_frac, 4)},
            ))
        return out


@dataclasses.dataclass(frozen=True)
class BadFracSlopeRule:
    """Per-scene bad-frac drift: the slope of
    a scene's ``bad_frac`` series over the recent windows exceeds
    ``min_slope`` per window AND the latest value is already past a
    noise floor -- a flat-but-noisy breaker window cannot fire it, a
    steady drift toward the trip threshold does, BEFORE the trip."""

    name: str = "scene_bad_frac_slope"
    severity: str = "warn"
    collector: str = "scene_health"
    path_suffix: str = ".bad_frac"
    windows: int = 10
    min_slope: float = 0.02
    min_latest: float = 0.05

    def evaluate(self, windows) -> list[Alert]:
        out = []
        recent = windows[-self.windows:]
        for path, ys in _collector_series(recent, self.collector,
                                          self.path_suffix).items():
            if len(ys) < 3:
                continue
            slope = _slope(ys)
            if slope >= self.min_slope and ys[-1] >= self.min_latest:
                out.append(Alert(
                    self.name, self.severity, round(slope, 4),
                    self.min_slope,
                    f"{path} drifting up: slope {slope:.3f}/window over "
                    f"{len(ys)} windows, latest {ys[-1]:.3f}",
                    {"path": path, "latest": round(ys[-1], 4)},
                ))
        return out


@dataclasses.dataclass(frozen=True)
class PrefetchWasteRule:
    """Wasted / issued prefetch ratio over the recent windows (reads the
    ``prefetch`` collector's cumulative counters, diffing first->last):
    a predictor whose issues stopped converting is staging for nobody."""

    name: str = "prefetch_waste"
    severity: str = "warn"
    collector: str = "prefetch"
    windows: int = 10
    max_waste_ratio: float = 0.5
    min_issued: int = 8

    def evaluate(self, windows) -> list[Alert]:
        recent = windows[-self.windows:]
        if not recent:
            return []

        def series(path):
            ys = [w.get("collectors", {}).get(self.collector, {}).get(path)
                  for w in recent]
            ys = [y for y in ys if y is not None]
            return (ys[-1] - ys[0]) if len(ys) >= 2 else 0.0

        issued = series("issued_device") + series("issued_host")
        wasted = series("wasted")
        if issued >= self.min_issued:
            ratio = wasted / issued
            if ratio >= self.max_waste_ratio:
                return [Alert(
                    self.name, self.severity, round(ratio, 4),
                    self.max_waste_ratio,
                    f"prefetch waste {ratio:.2f} ({int(wasted)} wasted / "
                    f"{int(issued)} issued over {len(recent)} windows)",
                )]
        return []


@dataclasses.dataclass(frozen=True)
class AffinitySagRule:
    """Affinity hit rate over the recent windows' route deltas sagging
    below the floor (scene-routed routes only: affinity, spill, cold)."""

    name: str = "affinity_sag"
    severity: str = "warn"
    routes_counter: str = "fleet_routes_total"
    windows: int = 10
    min_hit_rate: float = 0.5
    min_routed: int = 16

    def evaluate(self, windows) -> list[Alert]:
        recent = windows[-self.windows:]
        if not recent:
            return []
        aff = _counter_sum(recent, self.routes_counter, "kind=affinity")
        spill = _counter_sum(recent, self.routes_counter, "kind=spill")
        cold = _counter_sum(recent, self.routes_counter, "kind=cold")
        routed = aff + spill + cold
        if routed >= self.min_routed:
            rate = aff / routed
            if rate < self.min_hit_rate:
                return [Alert(
                    self.name, self.severity, round(rate, 4),
                    self.min_hit_rate,
                    f"affinity hit rate {rate:.2f} over {len(recent)} "
                    f"windows ({int(aff)}/{int(routed)} scene-routed)",
                )]
        return []


@dataclasses.dataclass(frozen=True)
class QueueKneeRule:
    """Queue occupancy (``serve_slo_totals.pending`` / ``queue_depth``)
    near the knee: mean occupancy over the fast windows at/above the
    fraction where a load test's goodput curve bends (occupancy is its
    leading indicator)."""

    name: str = "queue_knee"
    severity: str = "warn"
    collector: str = "serve_slo_totals"
    queue_depth: int = 64
    windows: int = 3
    max_occupancy_frac: float = 0.7

    def evaluate(self, windows) -> list[Alert]:
        recent = windows[-self.windows:]
        ys = [w.get("collectors", {}).get(self.collector, {}).get("pending")
              for w in recent]
        ys = [y for y in ys if y is not None]
        if not ys:
            return []
        occ = (sum(ys) / len(ys)) / max(self.queue_depth, 1)
        if occ >= self.max_occupancy_frac:
            return [Alert(
                self.name, self.severity, round(occ, 4),
                self.max_occupancy_frac,
                f"queue occupancy {occ:.2f} of depth {self.queue_depth} "
                f"over {len(ys)} windows — approaching the goodput knee",
            )]
        return []


def default_rules(queue_depth: int = 64) -> tuple:
    """The shipped catalog (the JAX package's thresholds)."""
    return (
        BurnRateRule(),
        BadFracSlopeRule(),
        PrefetchWasteRule(),
        AffinitySagRule(),
        QueueKneeRule(queue_depth=queue_depth),
    )


class RuleEngine:
    """Evaluate a rule catalog over a timeline; typed, ring-bounded,
    edge-triggered alert events (module docstring)."""

    def __init__(self, timeline, rules, registry=None,
                 max_alerts: int = 256, clock=time.time):
        self._timeline = timeline
        self._rules = tuple(rules)
        self._clock = clock
        self._lock = threading.Lock()  # LEAF: ring + active/edge state
        self._alerts: collections.deque = collections.deque(
            maxlen=max_alerts
        )
        self._active: dict[str, Alert] = {}
        self._eval_errors = 0
        self._last_ticks = -1
        self._m_alerts = None
        self._g_active = None
        if registry is not None:
            self.bind_obs(registry)

    def bind_obs(self, registry) -> None:
        """Create/adopt the engine's instruments in ``registry`` and
        register the ``health_alerts`` collector (idempotent)."""
        self._m_alerts = registry.counter(
            "health_alerts_total",
            "edge-triggered health-rule alerts by (rule, edge)",
        )
        self._g_active = registry.gauge(
            "health_alert_active",
            "1 while a health rule's condition holds, else 0",
        )
        registry.register_collector("health_alerts", self.snapshot)

    def rules(self) -> tuple:
        return self._rules

    # ---- evaluation ----

    def evaluate(self) -> list[Alert]:
        """One pass: snapshot windows (timeline's lock), run every rule
        (NO lock held), publish instruments, then record edges under
        the engine's leaf lock.  Returns the alerts currently FIRING
        (not just the edges)."""
        windows = self._timeline.windows()
        firing: list[Alert] = []
        eval_errors = 0
        for rule in self._rules:
            try:
                firing.extend(rule.evaluate(windows))
            except Exception:  # noqa: BLE001 -- one sick rule must not
                eval_errors += 1  # silence the rest; counted, not hidden
        now = self._clock()
        by_key = {(a.rule, a.labels.get("path", "")): a for a in firing}
        with self._lock:
            self._eval_errors += eval_errors
            rising = [a for k, a in by_key.items()
                      if k not in self._active]
            falling = [k for k in self._active if k not in by_key]
            for a in rising:
                self._alerts.append({"t_unix": now, "edge": "raise",
                                     **a.to_dict()})
            for k in falling:
                prev = self._active[k]
                self._alerts.append({
                    "t_unix": now, "edge": "clear", "rule": prev.rule,
                    "labels": dict(prev.labels),
                })
            self._active = dict(by_key)
            rule_active = {r.name: 0.0 for r in self._rules}
            for a in by_key.values():
                rule_active[a.rule] = 1.0
        # Instrument publishes OUTSIDE the engine lock (leaf contract).
        if self._m_alerts is not None:
            for a in rising:
                self._m_alerts.inc(rule=a.rule, edge="raise")
            for k in falling:
                self._m_alerts.inc(rule=k[0], edge="clear")
        if self._g_active is not None:
            for name, v in rule_active.items():
                self._g_active.set(v, rule=name)
        return firing

    def maybe_evaluate(self) -> list[Alert] | None:
        """Evaluate once per NEW timeline window (the piggyback hook a
        polling loop calls every iteration)."""
        ticks = self._timeline.ticks
        with self._lock:
            if ticks == self._last_ticks:
                return None
            self._last_ticks = ticks
        return self.evaluate()

    # ---- read side ----

    def active(self) -> dict:
        with self._lock:
            return {f"{r}|{p}" if p else r: a.to_dict()
                    for (r, p), a in self._active.items()}

    def alerts(self) -> list[dict]:
        with self._lock:
            return [dict(a) for a in self._alerts]

    def snapshot(self) -> dict:
        """The ``health_alerts`` collector payload."""
        with self._lock:
            events = [dict(a) for a in self._alerts]
            active = {f"{r}|{p}" if p else r: a.to_dict()
                      for (r, p), a in self._active.items()}
            eval_errors = self._eval_errors
        return {
            "rules": [r.name for r in self._rules],
            "active": active,
            "events": events,
            "eval_errors": eval_errors,
        }
