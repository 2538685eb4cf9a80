"""Bounded metric instruments and the metrics registry (a copy of
``esac_tpu/obs/metrics.py``), with its attachments: the windowed
:class:`~esac_tpu_torch.obs.timeline.Timeline`, the health
:class:`~esac_tpu_torch.obs.rules.RuleEngine` and the Prometheus page
(``obs/export.py``).

One substrate for every number the serving stack publishes: the
dispatcher's request/outcome accounting, the SLO layer's sheds and
quarantines, the scene-health breaker, the weight cache and the
per-request trace spans all land in ONE :class:`MetricsRegistry`, which
renders to a locked, ``json.dumps``-able snapshot.  Three instrument
families:

- :class:`CounterVec` -- monotone labeled counters (``inc``), plus
  ``reset``/``rebase`` window hooks (the dispatcher's ``reset_stats``
  subtracts its own contribution via negative ``inc`` so a SHARED
  registry's other publishers survive a local reset).
- :class:`GaugeVec` -- labeled last-value-wins gauges.
- :class:`HistogramVec` -- labeled :class:`StreamingHistogram` children:
  fixed-memory log-bucketed quantile sketches; a snapshot reads quantiles
  in O(buckets), and the relative error is bounded by the bucket growth
  factor (sqrt(growth)-1, ~3.4% at the default 1.07).

Windowing: a histogram with ``window=N`` keeps ``epochs`` fixed-size
bucket arrays and rotates them by sample count, so quantiles cover the
most recent ~N observations with memory that never grows.

Concurrency: every instrument guards its mutable state with its own
instance lock, and the registry lock covers only the name->instrument /
collector tables.  Lock order is registry -> collector-owner (e.g. the
dispatcher) -> instrument; nothing here calls back into an owner while
holding an instrument lock, and ``snapshot()`` runs collectors OUTSIDE the
registry lock, so a slow collector cannot block instrument writes.

Pure host code: no torch import.
"""

from __future__ import annotations

import math
import threading
import time

OBS_SCHEMA = 1

# Default histogram resolution: log-spaced buckets over 0.1us..10000s with
# 7% growth — 374 buckets, worst-case relative quantile error
# sqrt(1.07)-1 ~= 3.4%.
_HIST_LO = 1e-7
_HIST_HI = 1e4
_HIST_GROWTH = 1.07


def _labelkey(labels: dict) -> tuple:
    """Canonical hashable key for a label set (sorted by label name;
    values may be None/int/str — they are stringified only at export)."""
    return tuple(sorted(labels.items()))


def _matches(key: tuple, sub: dict) -> bool:
    """True iff the child labeled ``key`` carries every (k, v) in ``sub``
    — the subset-match used to merge histogram children per label."""
    have = dict(key)
    return all(have.get(k, _MISSING) == v for k, v in sub.items())


_MISSING = object()


class StreamingHistogram:
    """Fixed-memory log-bucketed quantile sketch over positive samples.

    ``window`` bounds the number of retained observations (None =
    lifetime): internally ``epochs`` bucket arrays rotate by count, so
    between window*(epochs-1)/epochs and window samples are live at any
    time.  Non-positive/non-finite samples clamp into the underflow
    bucket (they exist — a clock can step backwards across threads — and
    must never corrupt the sketch or raise on the serving path).
    """

    __slots__ = ("_lo", "_log_lo", "_log_growth", "_n_buckets", "_lock",
                 "_epochs", "_epoch_cap", "_counts", "_stats",
                 "_life_counts", "_life_n", "_life_sum")

    def __init__(self, lo: float = _HIST_LO, hi: float = _HIST_HI,
                 growth: float = _HIST_GROWTH,
                 window: int | None = None, epochs: int = 8):
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(f"bad histogram bounds lo={lo} hi={hi} "
                             f"growth={growth}")
        if window is not None and window < 1:
            raise ValueError(f"window {window} < 1")
        if epochs < 1:
            raise ValueError(f"epochs {epochs} < 1")
        self._lo = lo
        self._log_lo = math.log(lo)
        self._log_growth = math.log(growth)
        self._n_buckets = int(math.ceil(math.log(hi / lo) / self._log_growth))
        self._lock = threading.Lock()
        self._epochs = 1 if window is None else epochs
        self._epoch_cap = (None if window is None
                           else max(1, window // self._epochs))
        # Ring of epochs, newest last; each epoch is (counts, stats) with
        # stats = [count, sum, min, max].
        self._counts: list[list[int]] = [self._new_counts()]
        self._stats: list[list[float]] = [[0, 0.0, math.inf, -math.inf]]
        # Lifetime (never rotated) bucket counts: the timeline diffs them
        # between ticks into exact per-window histograms (windowed epoch
        # counts rotate, so their diffs can go negative).  One more
        # fixed-size array and two scalars: the memory bound holds.
        self._life_counts: list[int] = self._new_counts()
        self._life_n = 0
        self._life_sum = 0.0

    def _new_counts(self) -> list[int]:
        return [0] * (self._n_buckets + 2)  # + underflow/overflow slots

    def _index(self, v: float) -> int:
        if not (v > self._lo) or not math.isfinite(v):
            return 0
        i = int((math.log(v) - self._log_lo) / self._log_growth) + 1
        return min(i, self._n_buckets + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            counts, stats = self._counts[-1], self._stats[-1]
            i = self._index(v)
            counts[i] += 1
            self._life_counts[i] += 1
            self._life_n += 1
            stats[0] += 1
            if math.isfinite(v):
                stats[1] += v
                stats[2] = min(stats[2], v)
                stats[3] = max(stats[3], v)
                self._life_sum += v
            if self._epoch_cap is not None and stats[0] >= self._epoch_cap:
                self._counts.append(self._new_counts())
                self._stats.append([0, 0.0, math.inf, -math.inf])
                if len(self._counts) > self._epochs:
                    del self._counts[0]
                    del self._stats[0]

    def observe_many(self, values) -> None:
        """Bulk :meth:`observe`: ONE lock acquisition for a whole
        dispatch's samples (the serving hot path publishes per-dispatch,
        not per-request).
        Sample-for-sample identical to a loop of scalar ``observe``
        calls: same bucket increments, same lifetime stream, and the
        epoch-rotation check runs after EVERY sample exactly as the
        scalar path does, so windowed quantiles cannot tell the two
        apart."""
        vs = [float(v) for v in values]
        if not vs:
            return
        with self._lock:
            for v in vs:
                counts, stats = self._counts[-1], self._stats[-1]
                i = self._index(v)
                counts[i] += 1
                self._life_counts[i] += 1
                self._life_n += 1
                stats[0] += 1
                if math.isfinite(v):
                    stats[1] += v
                    stats[2] = min(stats[2], v)
                    stats[3] = max(stats[3], v)
                    self._life_sum += v
                if self._epoch_cap is not None \
                        and stats[0] >= self._epoch_cap:
                    self._counts.append(self._new_counts())
                    self._stats.append([0, 0.0, math.inf, -math.inf])
                    if len(self._counts) > self._epochs:
                        del self._counts[0]
                        del self._stats[0]

    def _merged_locked(self):
        """(counts, count, sum, min, max) over the retained window
        (lock held by the caller)."""
        counts = self._new_counts()
        n, s, lo, hi = 0, 0.0, math.inf, -math.inf
        for epoch, stats in zip(self._counts, self._stats):
            for i, c in enumerate(epoch):
                counts[i] += c
            n += stats[0]
            s += stats[1]
            lo = min(lo, stats[2])
            hi = max(hi, stats[3])
        return counts, n, s, lo, hi

    def merged(self):
        with self._lock:
            return self._merged_locked()

    @staticmethod
    def _quantile_from(counts, n, lo_seen, hi_seen, q: float,
                       log_lo: float, log_growth: float) -> float:
        """Nearest-rank quantile from merged bucket counts, with the
        bucket's geometric midpoint as the representative value, clamped
        to the observed [min, max]."""
        if n == 0:
            return float("nan")
        rank = min(n - 1, round(q * (n - 1)))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen > rank:
                if i == 0:
                    v = lo_seen
                else:
                    # bucket i covers [lo*g^(i-1), lo*g^i): geometric mid.
                    v = math.exp(log_lo + (i - 0.5) * log_growth)
                if math.isfinite(lo_seen):
                    v = min(max(v, lo_seen), hi_seen)
                return float(v)
        return float(hi_seen)  # unreachable (counts sum to n)

    def quantile(self, q: float) -> float:
        counts, n, _, lo, hi = self.merged()
        return self._quantile_from(counts, n, lo, hi, q,
                                   self._log_lo, self._log_growth)

    def reset(self) -> None:
        """Clear the window.  The lifetime stream (:meth:`lifetime`) stays:
        it is monotone like a counter, so timeline deltas survive a stats
        reset instead of going negative."""
        with self._lock:
            self._counts = [self._new_counts()]
            self._stats = [[0, 0.0, math.inf, -math.inf]]

    def lifetime(self):
        """(bucket counts copy, n, sum) over the histogram's lifetime: the
        monotone stream the timeline diffs per window."""
        with self._lock:
            return list(self._life_counts), self._life_n, self._life_sum

    def quantile_from_counts(self, counts, n, q: float) -> float:
        """Nearest-rank quantile over caller-supplied bucket counts in this
        histogram's bucket geometry (the timeline's per-window histograms):
        bucket midpoints; a rank in the underflow bucket reports the floor
        ``lo`` (per-window extrema are not kept, and +inf would put a
        non-standard JSON token into a window record)."""
        return self._quantile_from(counts, n, self._lo, math.inf, q,
                                   self._log_lo, self._log_growth)

    def summary(self, quantiles=(0.5, 0.9, 0.99)) -> dict:
        counts, n, s, lo, hi = self.merged()
        out = {
            "count": int(n),
            "sum": float(s),
            "min": (float(lo) if n and math.isfinite(lo) else None),
            "max": (float(hi) if n and math.isfinite(hi) else None),
        }
        for q in quantiles:
            out[f"p{round(q * 100):d}"] = self._quantile_from(
                counts, n, lo, hi, q, self._log_lo, self._log_growth
            )
        return out


class CounterVec:
    """Labeled monotone counter family (plus the documented
    reset/rebase/negative-inc window hooks ``reset_stats``-style
    re-basing requires — see the module docstring)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.kind = "counter"
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labelkey(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def items(self) -> list[tuple[dict, float]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(
                self._values.items(), key=lambda kv: repr(kv[0])
            )]

    def rebase(self, value: float, **labels) -> None:
        """Set one child to an absolute value — a window hook for
        external monitors that re-anchor a counter wholesale; never for
        normal accounting.  (The dispatcher's ``reset_stats`` does NOT
        use this: it subtracts its own contribution via negative
        :meth:`inc` so shared-registry peers survive.)"""
        with self._lock:
            self._values[_labelkey(labels)] = float(value)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def export(self) -> dict:
        return {
            "kind": self.kind, "help": self.help,
            "samples": [{"labels": labels, "value": v}
                        for labels, v in self.items()],
        }


class GaugeVec:
    """Labeled last-value-wins gauge family."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.kind = "gauge"
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_labelkey(labels)] = float(value)

    def get(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labelkey(labels), float("nan"))

    def items(self) -> list[tuple[dict, float]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(
                self._values.items(), key=lambda kv: repr(kv[0])
            )]

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def export(self) -> dict:
        return {
            "kind": self.kind, "help": self.help,
            "samples": [{"labels": labels, "value": v}
                        for labels, v in self.items()],
        }


class HistogramVec:
    """Labeled family of :class:`StreamingHistogram` children.

    ``quantile``/``count``/``summary`` accept a PARTIAL label set and
    merge every child that matches it — the accessor the per-scene /
    per-route_k latency views use (merge over the other label).  Label
    cardinality is the caller's responsibility, exactly like the
    dispatcher's per-lane counters: keyed by fleet, not by traffic.
    """

    def __init__(self, name: str, help: str = "", lo: float = _HIST_LO,
                 hi: float = _HIST_HI, growth: float = _HIST_GROWTH,
                 window: int | None = None, epochs: int = 8):
        self.name = name
        self.help = help
        self.kind = "histogram"
        self._hist_kw = dict(lo=lo, hi=hi, growth=growth, window=window,
                             epochs=epochs)
        self._lock = threading.Lock()
        self._children: dict[tuple, StreamingHistogram] = {}

    def _child(self, labels: dict) -> StreamingHistogram:
        key = _labelkey(labels)
        with self._lock:
            h = self._children.get(key)
            if h is None:
                h = self._children[key] = StreamingHistogram(**self._hist_kw)
            return h

    def observe(self, v: float, **labels) -> None:
        self._child(labels).observe(v)

    def observe_many(self, values, **labels) -> None:
        """Bulk observe into one child: a single family-lock lookup and
        a single child-lock acquisition for the whole batch (vs one of
        each per sample on the scalar path)."""
        self._child(labels).observe_many(values)

    def labelsets(self) -> list[dict]:
        with self._lock:
            return [dict(k) for k in self._children]

    def children(self) -> list[tuple[dict, "StreamingHistogram"]]:
        """(labels, child) pairs -- the timeline's iteration surface
        (children lock themselves; the list is a copy)."""
        with self._lock:
            return [(dict(k), h) for k, h in self._children.items()]

    def _select(self, sub: dict) -> list[StreamingHistogram]:
        with self._lock:
            return [h for k, h in self._children.items() if _matches(k, sub)]

    def _merged(self, sub: dict):
        counts = None
        n, s, lo, hi = 0, 0.0, math.inf, -math.inf
        ref = None
        for h in self._select(sub):
            c, cn, cs, clo, chi = h.merged()
            if counts is None:
                counts = list(c)
                ref = h
            else:
                for i, x in enumerate(c):
                    counts[i] += x
            n += cn
            s += cs
            lo = min(lo, clo)
            hi = max(hi, chi)
        return ref, counts, n, s, lo, hi

    def quantile(self, q: float, **labels) -> float:
        ref, counts, n, _, lo, hi = self._merged(labels)
        if ref is None or n == 0:
            return float("nan")
        return StreamingHistogram._quantile_from(
            counts, n, lo, hi, q, ref._log_lo, ref._log_growth
        )

    def count(self, **labels) -> int:
        return int(self._merged(labels)[2])

    def summary(self, quantiles=(0.5, 0.9, 0.99), **labels) -> dict:
        ref, counts, n, s, lo, hi = self._merged(labels)
        out = {
            "count": int(n), "sum": float(s),
            "min": (float(lo) if n and math.isfinite(lo) else None),
            "max": (float(hi) if n and math.isfinite(hi) else None),
        }
        for q in quantiles:
            out[f"p{round(q * 100):d}"] = (
                float("nan") if ref is None or n == 0
                else StreamingHistogram._quantile_from(
                    counts, n, lo, hi, q, ref._log_lo, ref._log_growth
                )
            )
        return out

    def reset(self) -> None:
        with self._lock:
            children = list(self._children.values())
        for h in children:
            h.reset()

    def export(self) -> dict:
        with self._lock:
            items = sorted(self._children.items(),
                           key=lambda kv: repr(kv[0]))
        return {
            "kind": self.kind, "help": self.help,
            "samples": [{"labels": dict(k), **h.summary()}
                        for k, h in items],
        }


class MetricsRegistry:
    """The unified fleet registry: named instruments + pull collectors.

    ``counter``/``gauge``/``histogram`` are idempotent per name (the
    existing instrument is returned; a kind mismatch raises — two
    components silently sharing a name across kinds is a bug).
    ``register_collector`` attaches a zero-argument callable whose
    locked snapshot dict rides ``snapshot()`` under ``collectors`` — the
    pull side of the registry, used by surfaces that already own a
    consistent snapshot method (``slo_totals``, ``SceneRegistry.health``,
    ``DeviceWeightCache.stats``).  Collectors run OUTSIDE the registry
    lock (see module docstring for the lock order).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: dict[str, object] = {}
        # Attachments created on demand: the ring-bounded trace store, the
        # windowed timeline and the health-rule engine.  Each owns a leaf
        # lock; the registry lock only guards the slots themselves.
        self._trace_store = None
        self._timeline = None
        self._health_rules = None

    def _instrument(self, name: str, factory, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(  # torch-lint: disable=R16(obs imports nothing of serve, so no taxonomy here; registration misuse is a wiring-time programming error, never a servable fault)
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> CounterVec:
        return self._instrument(
            name, lambda: CounterVec(name, help), "counter"
        )

    def gauge(self, name: str, help: str = "") -> GaugeVec:
        return self._instrument(name, lambda: GaugeVec(name, help), "gauge")

    def histogram(self, name: str, help: str = "", **hist_kw) -> HistogramVec:
        return self._instrument(
            name, lambda: HistogramVec(name, help, **hist_kw), "histogram"
        )

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def register(self, instrument) -> None:
        """Adopt an EXISTING instrument object under its own name — the
        cross-registry sharing hook: a component that owns instruments
        (e.g. the SceneRegistry's health counters) registers the same
        objects into a dispatcher's registry so one fleet snapshot sees
        them.  Re-adopting the same object is a no-op; a different
        instrument under a taken name raises (silent shadowing would
        split the truth)."""
        with self._lock:
            have = self._metrics.get(instrument.name)
            if have is None:
                self._metrics[instrument.name] = instrument
            elif have is not instrument:
                raise ValueError(  # torch-lint: disable=R16(obs imports nothing of serve, so no taxonomy here; registration misuse is a wiring-time programming error, never a servable fault)
                    f"metric {instrument.name!r} already registered with a "
                    "different instrument object"
                )

    def trace_store(self, maxlen: int = 256) -> "TraceStore":
        """The registry's ring-bounded :class:`~esac_tpu_torch.obs.trace.TraceStore`, created on first call (idempotent; ``maxlen`` binds only
        at creation) and published as the ``traces`` collector.  Every
        tracing surface (dispatcher, FleetRouter) that mints traces
        calls this once at construction."""
        from esac_tpu_torch.obs.trace import TraceStore

        with self._lock:
            ts = self._trace_store
            if ts is None:
                ts = self._trace_store = TraceStore(maxlen)
        self.register_collector("traces", ts.snapshot)
        return ts

    def get_trace_store(self) -> "TraceStore | None":
        """The attached trace store, or None (never creates)."""
        with self._lock:
            return self._trace_store

    def tables(self) -> tuple[dict, dict]:
        """Locked copy of (instruments, collectors): the iteration surface
        ``snapshot()`` and the timeline share (the registry lock is released
        before any instrument lock is taken)."""
        with self._lock:
            return dict(self._metrics), dict(self._collectors)

    def attach_timeline(self, window_s: float = 1.0, max_windows: int = 120,
                        collectors: bool = True):
        """Attach (or return the existing) :class:`~esac_tpu_torch.obs.
        timeline.Timeline` over this registry, published as the
        ``timeline`` collector.  Idempotent: sizing binds at first attach."""
        from esac_tpu_torch.obs.timeline import Timeline

        with self._lock:
            tl = self._timeline
            if tl is None:
                tl = self._timeline = Timeline(self, window_s=window_s,
                                               max_windows=max_windows,
                                               collectors=collectors)
        self.register_collector("timeline", tl.snapshot)
        return tl

    def timeline(self):
        """The attached timeline, or None (never creates)."""
        with self._lock:
            return self._timeline

    def attach_health_rules(self, rules=None, max_alerts: int = 256, **timeline_kw):
        """Attach (or return the existing) :class:`~esac_tpu_torch.obs.rules.
        RuleEngine` over this registry's timeline (attached too when
        missing), published as the ``health_alerts`` collector plus the
        ``health_alerts_total`` counter and ``health_alert_active`` gauge.
        ``rules=None`` takes the default catalog."""
        from esac_tpu_torch.obs.rules import RuleEngine, default_rules

        tl = self.attach_timeline(**timeline_kw)
        with self._lock:
            eng = self._health_rules
            if eng is None:
                eng = self._health_rules = RuleEngine(
                    tl, default_rules() if rules is None else rules, registry=None,
                    max_alerts=max_alerts)
        eng.bind_obs(self)
        return eng

    def health_rules(self):
        """The attached rule engine, or None (never creates)."""
        with self._lock:
            return self._health_rules

    def register_collector(self, name: str, fn) -> None:
        """Attach a named pull collector: a zero-argument callable
        returning a snapshot-consistent dict.  Registration is
        LAST-WINS by design: ``SceneRegistry.bind_obs`` re-registers an
        equivalent ``scene_health`` collector into each dispatcher's
        registry it adopts.  Corollary for the shared-registry
        aggregation mode (see the dispatcher docstring's NOTE): two
        components of the same kind sharing one registry aggregate
        their COUNTERS but only the most recent registrant's collector
        block rides the snapshot — per-instance views want per-instance
        registries."""
        with self._lock:
            self._collectors[name] = fn

    def snapshot(self) -> dict:
        """One locked, ``json.dumps``-able fleet snapshot: every
        instrument's exported samples plus every collector's dict (tuple
        keys and numpy scalars sanitized).  Collector failures are
        recorded in place, never raised — a snapshot must not die on one
        sick surface."""
        metrics, collectors = self.tables()
        out = {
            "obs_schema": OBS_SCHEMA,
            "recorded_at_unix": time.time(),
            "metrics": {name: m.export() for name, m in metrics.items()},
            "collectors": {},
        }
        for name, fn in collectors.items():
            try:
                out["collectors"][name] = fn()
            except Exception as e:  # noqa: BLE001 — recorded, never raised
                out["collectors"][name] = {"error": repr(e)}
        return jsonable(out)

    def render_prometheus(self) -> str:
        from esac_tpu_torch.obs.export import render_prometheus

        return render_prometheus(self.snapshot())


def jsonable(obj):
    """Recursively convert ``obj`` into something ``json.dumps`` accepts:
    non-string dict keys stringify, tuples/sets/deques become lists,
    numpy scalars and 0-d tensors unwrap via ``.item()``, and anything else
    falls back to ``repr`` -- a snapshot must never raise on one odd leaf."""
    if obj is None or isinstance(obj, (bool, int, str, float)):
        return obj
    if isinstance(obj, dict):
        return {(k if isinstance(k, str) else str(k)): jsonable(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [jsonable(v) for v in obj]
    item = getattr(obj, "item", None)
    if callable(item) and tuple(getattr(obj, "shape", ())) == ():
        try:
            return jsonable(item())
        except (TypeError, ValueError, RuntimeError):
            pass
    if hasattr(obj, "__iter__"):
        try:
            return [jsonable(v) for v in obj]
        except (TypeError, ValueError, RuntimeError):
            pass
    return repr(obj)
