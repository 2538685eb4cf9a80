"""The port's timeline, health rules and export (esac_tpu_torch.obs)
against the JAX package's (esac_tpu.obs) on one scripted instrument
stream under a fake clock: the same windows, the same alerts and edges,
the same Prometheus exposition lines; plus the registry accessors, the
lifetime histogram stream, FleetRouter's loop hook and the dump CLI.

Both packages are pure host code here: the stream is Python floats and
ints, so everything is compared exactly.
"""

import json

import numpy as np
import pytest

from esac_tpu import obs as jobs
from esac_tpu.obs.rules import RuleEngine as JRuleEngine, default_rules as j_default_rules
from esac_tpu_torch import obs
from esac_tpu_torch.obs.__main__ import main as obs_main
from esac_tpu_torch.obs.rules import RuleEngine, default_rules

WINDOW_S = 0.5


class _Surface:
    """The pull collectors of the stream: per-scene bad_frac, prefetch
    counters, queue occupancy (what the default rules read)."""

    def __init__(self):
        self.bad = {"a": 0.0, "b": 0.0}
        self.prefetch = {"issued_device": 0, "issued_host": 0, "wasted": 0, "hits": 0}
        self.pending = 0

    def scene_health(self):
        return {"scenes": {f"{s}@v1": {"bad_frac": v, "frames": 10} for s, v in self.bad.items()},
                "events": [{"kind": "note"}]}

    def prefetch_stats(self):
        return dict(self.prefetch)

    def slo_totals(self):
        return {"offered": 0, "served": 0, "pending": self.pending}


def _stream(pkg):
    """Drive one registry of ``pkg`` through 18 windows: healthy, then a
    burn with drifting bad_frac, prefetch waste, affinity sag and a deep
    queue, then recovery.  Returns (registry, timeline, engine, the firing
    alerts of each evaluation)."""
    reg = pkg.MetricsRegistry()
    surf = _Surface()
    reg.register_collector("scene_health", surf.scene_health)
    reg.register_collector("prefetch", surf.prefetch_stats)
    reg.register_collector("serve_slo_totals", surf.slo_totals)
    offered = reg.counter("serve_offered_total", "requests offered")
    outcomes = reg.counter("serve_outcomes_total", "terminal outcomes")
    routes = reg.counter("fleet_routes_total", "routes by kind")
    lat = reg.histogram("serve_latency_seconds", "end-to-end latency")
    depth = reg.gauge("serve_queue_depth", "queued requests")
    tl = reg.attach_timeline(window_s=WINDOW_S, max_windows=32)
    rules = (default_rules if pkg is obs else j_default_rules)(queue_depth=16)
    engine = (RuleEngine if pkg is obs else JRuleEngine)(tl, rules, registry=reg,
                                                       clock=lambda: 1000.0)
    rng = np.random.default_rng(7)
    now = 100.0
    tl.tick(now)
    fired = []
    for w in range(18):
        burning = 4 <= w < 10
        n = 30
        offered.inc(n)
        bad = 12 if burning else 1
        outcomes.inc(n - bad, outcome="served")
        outcomes.inc(bad // 2, outcome="shed")
        outcomes.inc(bad - bad // 2, outcome="failed")
        for v in rng.lognormal(-3.0 + (1.0 if burning else 0.0), 0.4, n).tolist():
            lat.observe(v, scene="a" if v < 0.05 else "b")
        routes.inc(1 if burning else 18, kind="affinity")
        routes.inc(17 if burning else 2, kind="cold")
        depth.set(float(w), lane="a")
        surf.bad["a"] = 0.05 * max(0, w - 3) if burning else 0.0
        surf.prefetch["issued_device"] += 4
        surf.prefetch["wasted"] += 3 if burning else 0
        surf.pending = 14 if burning else 1
        if w == 7:
            reg.get("serve_latency_seconds").reset()  # a stats reset mid-stream
        now += WINDOW_S
        assert tl.maybe_tick(now - 1e-3) is None  # not due yet
        tl.maybe_tick(now)
        fired.append(sorted((a.rule, a.labels.get("path", ""), a.value)
                            for a in engine.evaluate()))
    return reg, tl, engine, fired


@pytest.fixture(scope="module")
def streams():
    return {"jax": _stream(jobs), "port": _stream(obs)}


def test_windows_match_jax(streams):
    (_, jtl, _, _), (_, tl, _, _) = streams["jax"], streams["port"]
    assert tl.ticks == jtl.ticks == 19
    assert tl.windows() == jtl.windows()
    assert json.dumps(tl.snapshot(), sort_keys=True) == json.dumps(jtl.snapshot(),
                                                                   sort_keys=True)


def test_alerts_match_jax(streams):
    jfired, fired = streams["jax"][3], streams["port"][3]
    assert fired == jfired
    rules_fired = {r for window in fired for r, _, _ in window}
    assert rules_fired == {"slo_burn_rate", "scene_bad_frac_slope", "prefetch_waste",
                           "affinity_sag", "queue_knee"}
    assert fired[-1] == []  # recovered
    assert streams["port"][2].snapshot() == streams["jax"][2].snapshot()
    assert streams["port"][2].alerts() == streams["jax"][2].alerts()


def test_prometheus_lines_match_jax(streams):
    """Every exposition line of the two snapshots, the clock-free ones
    (the snapshots' own timestamps are not rendered)."""
    jreg, reg = streams["jax"][0], streams["port"][0]
    jtext = jobs.render_prometheus(jreg.snapshot())
    text = obs.render_prometheus(reg.snapshot())
    assert text.splitlines() == jtext.splitlines()
    assert reg.render_prometheus().splitlines() == text.splitlines()
    assert 'esac_collector_value{collector="timeline",path="ticks"} 19.0' in text
    assert 'health_alerts_total{edge="raise",rule="slo_burn_rate"} 1.0' in text


def test_registry_accessors_and_attach_are_idempotent():
    reg = obs.MetricsRegistry()
    assert reg.timeline() is None and reg.health_rules() is None
    eng = reg.attach_health_rules(window_s=0.25)
    tl = reg.timeline()
    assert isinstance(tl, obs.Timeline) and tl.window_s == 0.25
    assert reg.attach_timeline(window_s=9.0) is tl and reg.attach_health_rules() is eng
    assert reg.health_rules() is eng and isinstance(eng, obs.RuleEngine)
    assert [r.name for r in eng.rules()] == [r.name for r in j_default_rules()]
    snap = reg.snapshot()
    assert {"timeline", "health_alerts"} <= set(snap["collectors"])
    json.dumps(snap)


def test_histogram_lifetime_matches_jax():
    j = jobs.StreamingHistogram(window=16, epochs=4)
    h = obs.StreamingHistogram(window=16, epochs=4)
    vals = np.random.default_rng(1).lognormal(-2.0, 1.0, 100).tolist() + [0.0, float("inf")]
    for x in (h, j):
        x.observe_many(vals[:50])
        for v in vals[50:]:
            x.observe(v)
        x.reset()
    assert h.lifetime() == j.lifetime()
    counts, n, _ = h.lifetime()
    assert n == len(vals) and sum(counts) == n
    for q in (0.0, 0.5, 0.99):
        assert h.quantile_from_counts(counts, n, q) == j.quantile_from_counts(counts, n, q)


def test_fleet_router_loop_ticks_timeline_and_rules():
    """FleetRouter's completion loop ticks the attached timeline and
    evaluates the rules between polls (esac_tpu/fleet/router.py:954-963)."""
    import time

    from esac_tpu_torch.fleet.router import FleetPolicy, FleetRouter, Replica
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher

    def echo(tree, scene=None, route_k=None, n_hyps=None):
        return {"echo": tree["x"]}

    cfg = RansacConfig(frame_buckets=(1,), serve_max_wait_ms=0.0)
    router = FleetRouter([Replica(f"r{i}", MicroBatchDispatcher(echo, cfg, device="cpu"))
                          for i in range(2)], FleetPolicy(poll_ms=2.0))
    tl = router.obs.attach_timeline(window_s=0.02)
    eng = router.obs.attach_health_rules()
    try:
        for i in range(6):
            router.infer_one({"x": np.full(2, i, np.float32)}, scene=f"s{i % 2}",
                             deadline_ms=5_000)
        t_end = time.perf_counter() + 10.0
        while (tl.ticks < 3 or eng._last_ticks < 2) and time.perf_counter() < t_end:
            time.sleep(0.01)
    finally:
        router.close()
    assert tl.ticks >= 3 and len(tl.windows()) >= 2
    assert eng._last_ticks >= 2  # evaluated on a new window
    assert eng.snapshot()["active"] == {}
    offered = sum(sum(w["counters"].get("fleet_offered_total", {}).values())
                  for w in tl.windows())
    assert offered <= 6


def test_dump_cli(tmp_path, capsys):
    assert obs_main([]) == 2
    assert "pass --file" in capsys.readouterr().err
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"x": 1}))
    assert obs_main(["--file", str(bad)]) == 2
    reg = jobs.MetricsRegistry()
    reg.counter("c", "a counter").inc(3, kind="x")
    path = tmp_path / "snap.json"
    path.write_text(json.dumps({"obs_provenance": jobs.provenance(reg.snapshot())}))
    capsys.readouterr()
    assert obs_main(["--file", str(path)]) == 0
    assert capsys.readouterr().out == jobs.render_prometheus(reg.snapshot())
    assert obs_main(["--demo"]) == 0
    out = capsys.readouterr().out
    assert 'esac_collector_value{collector="timeline",path="ticks"}' in out
    assert "health_alert_active" in out and "fleet_offered_total 8.0" in out


def test_obs_exports():
    for name in ("Timeline", "RuleEngine", "Alert", "default_rules", "render_prometheus",
                 "jsonable", "provenance"):
        assert name in obs.__all__ and name in jobs.__all__
    assert set(jobs.__all__) <= set(obs.__all__)
