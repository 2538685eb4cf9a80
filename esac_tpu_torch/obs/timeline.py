"""The time axis of the metrics registry (counterpart of
``esac_tpu/obs/timeline.py``).

Counters are lifetime totals, histograms cover a recent sample window and
collectors are point-in-time snapshots: none shows a trend.  A
:class:`Timeline` does:

- :meth:`Timeline.tick` closes one window: for every counter, the
  per-label delta (and rate) since the previous tick; for every histogram
  child, an exact per-window histogram (lifetime bucket counts diffed
  between ticks, ``StreamingHistogram.lifetime``) reduced to count / mean /
  p50 / p99; every gauge's last value; and, optionally, every numeric leaf
  of every pull collector (per-scene ``bad_frac``, prefetch counters, queue
  occupancy: what the rule engine reads), flattened to dotted paths with a
  per-collector cap so no collector can widen a window without bound.
- windows land in a ring (``deque(maxlen=max_windows)``): memory is
  bounded by max_windows x instrument cardinality.

Locking: ``Timeline._lock`` is a leaf.  :meth:`tick` aggregates with no
timeline lock held -- instrument and collector-owner locks are taken one
at a time, as ``snapshot()`` takes them -- and only the ring append and
the baseline swap happen under it.

Driving: pull, no thread of its own.  :meth:`maybe_tick` is the cheap
piggyback hook (one clock read and one compare when the window has not
elapsed) that ``FleetRouter``'s completion loop calls between polls;
tests call :meth:`tick` directly.

Pure host code: no torch import.
"""

from __future__ import annotations

import collections
import threading
import time

# Hard cap on numeric leaves recorded per collector per window: the
# flattener must bound a window's size even against a collector that
# returns unbounded structure (the ring pins window COUNT; this pins
# window WIDTH).
COLLECTOR_LEAF_CAP = 512


def _labels_key(labels: dict) -> str:
    """Canonical string key for a label set ("" for unlabeled): window
    records must be json-dumpable as they are."""
    if not labels:
        return ""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def flatten_numeric(obj, prefix: str = "", out=None, cap=COLLECTOR_LEAF_CAP):
    """Dotted-path -> scalar map of ``obj``'s numeric leaves (bools
    excluded; lists/events skipped: trend inputs are scalars), capped
    at ``cap`` entries in deterministic (sorted-key) order."""
    if out is None:
        out = {}
    if len(out) >= cap:
        return out
    if isinstance(obj, bool):
        return out
    if isinstance(obj, (int, float)):
        out[prefix] = float(obj)
        return out
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            if len(out) >= cap:
                break
            key = str(k) if not prefix else f"{prefix}.{k}"
            flatten_numeric(obj[k], key, out, cap)
    return out


class Timeline:
    """Ring-bounded windowed aggregates over one
    :class:`~esac_tpu_torch.obs.metrics.MetricsRegistry` (module docstring)."""

    def __init__(self, registry, window_s: float = 1.0,
                 max_windows: int = 120, collectors: bool = True,
                 clock=time.perf_counter):
        if window_s <= 0:
            raise ValueError(f"window_s {window_s} <= 0")
        if max_windows < 1:
            raise ValueError(f"max_windows {max_windows} < 1")
        self._registry = registry
        self.window_s = window_s
        self.max_windows = max_windows
        self._collectors = bool(collectors)
        self._clock = clock
        self._lock = threading.Lock()  # LEAF: ring + baseline only
        self._ring = collections.deque(maxlen=max_windows)
        self._baseline = None   # previous tick's raw aggregate
        self._t_baseline = None
        self.ticks = 0

    # ---- aggregation (NO timeline lock held) ----

    def _collect(self) -> dict:
        """Raw monotone/point aggregate of every instrument (and,
        optionally, collector numeric leaves).  Takes instrument /
        collector-owner locks one at a time; never the timeline lock."""
        metrics, collectors = self._registry.tables()
        counters, gauges, hists = {}, {}, {}
        for name, m in metrics.items():
            kind = getattr(m, "kind", None)
            if kind == "counter":
                counters[name] = {
                    _labels_key(labels): v for labels, v in m.items()
                }
            elif kind == "gauge":
                gauges[name] = {
                    _labels_key(labels): v for labels, v in m.items()
                }
            elif kind == "histogram":
                per = {}
                for labels, child in m.children():
                    counts, n, s = child.lifetime()
                    per[_labels_key(labels)] = (counts, n, s, child)
                hists[name] = per
        coll = {}
        if self._collectors:
            for name, fn in collectors.items():
                if name in ("timeline", "traces", "health_alerts"):
                    # Never aggregate ourselves, and skip the obs
                    # layer's own list-heavy collectors: the trace store's
                    # snapshot sorts and serializes the slowest traces,
                    # wasted work at a window's cadence for two scalars
                    # no rule reads.
                    continue
                try:
                    coll[name] = flatten_numeric(fn())
                except Exception:  # noqa: BLE001 -- a sick collector must
                    coll[name] = {}  # not kill the tick (snapshot contract)
        return {"counters": counters, "gauges": gauges, "hists": hists,
                "collectors": coll}

    @staticmethod
    def _window(prev, cur, t0, t1) -> dict:
        dt = max(t1 - t0, 1e-9)
        counters, rates = {}, {}
        for name, vals in cur["counters"].items():
            pvals = (prev or {}).get("counters", {}).get(name, {})
            # Counter-reset convention (the Prometheus rate() rule): a
            # value BELOW the baseline means the counter was re-based
            # (reset_stats subtracts the dispatcher's own contribution),
            # and the honest window delta is the value itself -- a raw
            # diff would record a huge negative delta and poison the
            # burn-rate denominator for a whole slow horizon.
            deltas = {}
            for k, v in vals.items():
                d = v - pvals.get(k, 0.0)
                deltas[k] = v if d < 0 else d
            counters[name] = deltas
            rates[name] = {k: d / dt for k, d in deltas.items()}
        gauges = {name: dict(vals) for name, vals in cur["gauges"].items()}
        hist = {}
        for name, per in cur["hists"].items():
            pper = (prev or {}).get("hists", {}).get(name, {})
            out = {}
            for key, (counts, n, s, child) in per.items():
                pcounts, pn, ps, _ = pper.get(key, (None, 0, 0.0, None))
                if pcounts is None:
                    dcounts = list(counts)
                else:
                    dcounts = [a - b for a, b in zip(counts, pcounts)]
                dn = n - pn
                rec = {"count": int(dn)}
                if dn > 0:
                    rec["mean"] = (s - ps) / dn
                    rec["p50"] = child.quantile_from_counts(
                        dcounts, dn, 0.5)
                    rec["p99"] = child.quantile_from_counts(
                        dcounts, dn, 0.99)
                out[key] = rec
            hist[name] = out
        return {
            "t0": t0, "t1": t1, "dt_s": dt,
            "counters": counters, "rates": rates, "gauges": gauges,
            "hist": hist, "collectors": dict(cur["collectors"]),
        }

    # ---- ticking ----

    def tick(self, now: float | None = None) -> dict | None:
        """Close one window against the previous tick's baseline and
        append it to the ring; the FIRST tick only establishes the
        baseline (there is no previous edge to diff against) and
        returns None.  The window diff is computed with no lock held; only
        the baseline swap and the ring append take the leaf lock, so
        concurrent ``snapshot()`` / ``windows()`` readers never wait out the
        aggregation.  One loop owns the cadence; a racing pair of tickers
        costs at most one out-of-order append, never corruption."""
        if now is None:
            now = self._clock()
        cur = self._collect()
        with self._lock:
            prev, t_prev = self._baseline, self._t_baseline
            self._baseline, self._t_baseline = cur, now
            self.ticks += 1
        if prev is None:
            return None
        win = self._window(prev, cur, t_prev, now)
        with self._lock:
            self._ring.append(win)
        return win

    def maybe_tick(self, now: float | None = None) -> dict | None:
        """Tick iff a full window elapsed since the last tick: the
        piggyback hook for an existing loop (one clock read and one
        compare when not due)."""
        if now is None:
            now = self._clock()
        with self._lock:
            due = (self._t_baseline is None
                   or now - self._t_baseline >= self.window_s)
        return self.tick(now) if due else None

    # ---- read side ----

    def windows(self) -> list[dict]:
        """Locked snapshot of the ring, oldest first (window dicts are
        immutable once appended: the copy is the list, not the
        records)."""
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> dict:
        """The ``timeline`` collector payload: sizing, tick count, and
        the last window (the full ring is read through :meth:`windows`: a
        fleet snapshot stays proportional to the fleet, not to the ring)."""
        with self._lock:
            last = self._ring[-1] if self._ring else None
            return {
                "window_s": self.window_s,
                "max_windows": self.max_windows,
                "ticks": self.ticks,
                "windows_retained": len(self._ring),
                "last_window": last,
            }
