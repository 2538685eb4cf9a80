"""``fleet`` mode (counterpart of ``bench.py``'s ``_measure_fleet``): the
scene-affinity replica fleet bench (DESIGN.md §18).  A
:class:`~esac_tpu_torch.fleet.FleetRouter` over FLEET_REPLICAS in-process
dispatcher replicas -- each with its own SceneRegistry and weight cache over
one shared manifest -- measured three ways:

- **knee vs replica count**: the open-loop goodput knee at 1, 2 and 3
  replicas under a Zipf scene trace, offered in multiples of the AGGREGATE
  capacity measured in this run;
- **affinity**: the route mix and per-replica weight-cache hit rates under
  the same trace below the knee;
- **replica-wedge drill**: mid-load, one replica's dispatch path stalls
  (every replica's injector armed with the same tag predicate; only the
  target fires); the watchdog types the wedge, the router quarantines the
  replica and fails its requests over within their deadlines.  Reported:
  exact fleet accounting, healthy-scene goodput retention, failover
  p50/p99, the failed-over result's bit-identity against the surviving
  replica, the batch-signature count and the lock-order witness.

Every replica shares this host's CPU cores and the one card: the knee legs
show the measurement, not a scale-out across cards."""

from __future__ import annotations

import collections
import gc
import threading
import time

import numpy as np

from esac_tpu_torch.bench.constants import (
    FLEET_BUCKET,
    FLEET_DRILL_RATE_X,
    FLEET_HW,
    FLEET_HYPS,
    FLEET_M,
    FLEET_MULTS,
    FLEET_REPLICAS,
    FLEET_SCENES,
    FLEET_SECONDS,
    FLEET_ZIPF_A,
)
from esac_tpu_torch.bench.fixtures import (
    ROOT,
    accounting_exact,
    image_frame,
    join_threads_started_since,
    lock_witness_block,
    scratch_dir,
    tiny_preset,
    write_scene,
)
from esac_tpu_torch.bench.loadtest import loadtest_knee
from esac_tpu_torch.fleet.router import FleetPolicy, FleetRouter, Replica
from esac_tpu_torch.lint.witness import LockWitness, OutcomeWitness
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.health import HealthPolicy
from esac_tpu_torch.registry.manifest import SceneManifest
from esac_tpu_torch.registry.serving import SceneRegistry
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
from esac_tpu_torch.serve.loadgen import poisson_arrivals
from esac_tpu_torch.serve.slo import DeadlineExceededError, FaultInjector, ServeError, SLOPolicy
from esac_tpu_torch.utils.precision import resolve_device


def measure_fleet(seconds: float = FLEET_SECONDS, device=None) -> dict:
    dev = resolve_device(device)
    with scratch_dir("esac_fleet_") as root:
        try:
            return _measure_fleet_at(root, seconds, dev)
        finally:
            gc.unfreeze()  # no-op on a clean exit


def _measure_fleet_at(root, seconds: float, dev) -> dict:
    H = FLEET_HW
    M = FLEET_M
    preset = tiny_preset(H, M)
    cfg = RansacConfig(n_hyps=FLEET_HYPS, refine_iters=2, polish_iters=1,
                       frame_buckets=(FLEET_BUCKET,), serve_max_wait_ms=2.0,
                       serve_queue_depth=256)
    hyps_per_request = M * FLEET_HYPS
    manifest = SceneManifest()
    scenes = [f"s{i}" for i in range(FLEET_SCENES)]
    for i, s in enumerate(scenes):
        manifest.add(write_scene(root, s, preset, cfg, seed=i, checksums=True))
    pool = [image_frame(i, H) for i in range(8)]

    threads_before = set(threading.enumerate())
    # The replicas: one registry + tagged injector + SLO dispatcher each
    # (workers started after the lock witness attaches).
    replicas, injectors, registries = [], {}, {}
    for i in range(FLEET_REPLICAS):
        name = f"r{i}"
        reg = SceneRegistry(manifest, device=dev,
                            health=HealthPolicy(window=16, min_samples=4, trip_bad_frac=0.5))
        inj = FaultInjector(reg.infer_fn(), tag=name)
        disp = MicroBatchDispatcher(inj, cfg, start_worker=False, device=dev)
        reg.bind_obs(disp.obs)
        replicas.append(Replica(name, disp, reg))
        injectors[name] = inj
        registries[name] = reg

    # Prewarm every replica on every scene (synchronous, pre-worker):
    # weights loaded and staged, every batch signature run once.
    for rep in replicas:
        for j, s in enumerate(scenes):
            rep.dispatcher.infer_one(pool[j % len(pool)], scene=s)
    compiled_before = sum(r.compile_cache_size() for r in registries.values())

    # Closed-loop per-replica capacity (warm, bucket-sized dispatches).
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        replicas[0].dispatcher.infer_many(pool[:FLEET_BUCKET], scene=scenes[0])
        walls.append(time.perf_counter() - t0)
    dispatch_s = sorted(walls)[len(walls) // 2]
    capacity_rps = FLEET_BUCKET / dispatch_s
    deadline_ms = max(4_000.0, 30 * dispatch_s * 1e3)
    watchdog_ms = max(500.0, 5 * dispatch_s * 1e3)
    slo = SLOPolicy(deadline_ms=deadline_ms, watchdog_ms=watchdog_ms, retry_max=1,
                    quarantine_after=2)
    for rep in replicas:
        rep.dispatcher._slo = slo  # sized from the measured dispatch

    # The prewarmed fixture's heap out of the collector's sight for the
    # measured legs (a mid-leg gen-2 pass reads as a server stall).
    gc.collect()
    gc.freeze()
    gc_before = gc.get_stats()

    # The lock witness over the WHOLE fleet, attached before any worker or
    # router thread starts; 1-in-8 causal trace sampling in every leg.
    witness = LockWitness()
    outcome_witness = OutcomeWitness.from_repo(ROOT)
    policy = FleetPolicy(poll_ms=5.0, replicate_share=0.3, replicate_min_requests=48,
                         trace_sample=8)
    router = FleetRouter(replicas, policy, start=False)
    witness.attach_fleet(router=router)
    for rep in replicas:
        rep.dispatcher.start()
    router.start()

    zipf_p = 1.0 / np.arange(1, FLEET_SCENES + 1) ** FLEET_ZIPF_A
    zipf_p /= zipf_p.sum()

    def open_loop(rtr, n, rate, seed):
        """A Zipf-scene Poisson trace, submitted open-loop: the per-request
        (scene, frame, FleetRequest, outcome, error type) records."""
        trace = np.random.RandomState(seed).choice(FLEET_SCENES, size=n, p=zipf_p)
        arrivals = poisson_arrivals(rate, n, seed=seed + 1)
        t0 = time.perf_counter()
        recs = []
        for i in range(n):
            target = t0 + float(arrivals[i])
            while True:
                now = time.perf_counter()
                if now >= target:
                    break
                time.sleep(min(target - now, 0.01))
            s = scenes[int(trace[i])]
            fr = pool[i % len(pool)]
            try:
                req = rtr.submit(fr, scene=s, deadline_ms=deadline_ms)
            except ServeError as e:  # typed shed / expiry at admission
                kind = "expired" if isinstance(e, DeadlineExceededError) else "shed"
                recs.append((s, fr, None, (kind, type(e).__name__)))
                continue
            recs.append((s, fr, req, None))
        out = []
        for s, fr, req, admitted_err in recs:
            if req is None:
                kind, errname = admitted_err
                out.append((s, fr, None, kind, errname))
                continue
            req.event.wait(deadline_ms / 1e3 + 30.0)
            err = type(req.error).__name__ if req.error is not None else None
            out.append((s, fr, req, req.outcome or "lost", err))
        for _, _, _, outcome, err in out:
            outcome_witness.observe(err, outcome)
        return out

    def leg_summary(recs, span_s):
        outcomes = collections.Counter(o for _, _, _, o, _ in recs)
        good = outcomes.get("served", 0) + outcomes.get("degraded", 0)
        lat = sorted(r.t_done - r.t_submit for _, _, r, o, _ in recs
                     if r is not None and o in ("served", "degraded"))

        def q(p):
            if not lat:
                return float("nan")
            return lat[min(len(lat) - 1, round(p * (len(lat) - 1)))]

        return {
            "offered": len(recs),
            "outcomes": dict(outcomes),
            "goodput_ratio": round(good / max(len(recs), 1), 4),
            "served_rps": round(good / max(span_s, 1e-9), 2),
            "sustained_hyps_per_s": round(good * hyps_per_request / max(span_s, 1e-9), 1),
            "p50_ms": round(q(0.5) * 1e3, 2),
            "p99_ms": round(q(0.99) * 1e3, 2),
        }

    # ---- leg A: aggregate knee vs replica count ----
    knee_legs = []
    for n_rep in range(1, FLEET_REPLICAS + 1):
        points = []
        for j, mult in enumerate(sorted(FLEET_MULTS)):
            rtr = FleetRouter(replicas[:n_rep], policy, start=True)
            rate = mult * n_rep * capacity_rps
            n = int(min(max(24, rate * seconds), 300))
            t0 = time.perf_counter()
            recs = open_loop(rtr, n, rate, seed=100 * n_rep + j)
            span = time.perf_counter() - t0
            totals = rtr.fleet_totals()
            rtr.close(close_replicas=False)
            points.append({"offered_x_aggregate_capacity": mult, "offered_rps": round(rate, 2),
                           **leg_summary(recs, span), "accounting_exact": accounting_exact(totals)})
        knee = loadtest_knee(points)
        knee_legs.append({
            "replicas": n_rep,
            "points": points,
            "knee_offered_rps": knee["offered_rps"] if knee else None,
            "knee_sustained_hyps_per_s": knee["sustained_hyps_per_s"] if knee else None,
        })

    # ---- leg B: affinity under the Zipf trace (below the knee) ----
    rtr = FleetRouter(replicas, policy, start=True)
    for rep in replicas:
        rep.dispatcher.reset_stats()
    # Cache stats as DELTAS over the leg (stats() is the cache's locked
    # snapshot): zeroing the counters here would race the workers.
    cache_before = {name: reg.cache.stats() for name, reg in registries.items()}
    rate = 0.5 * FLEET_REPLICAS * capacity_rps
    n = int(min(max(48, rate * 2 * seconds), 400))
    t0 = time.perf_counter()
    recs = open_loop(rtr, n, rate, seed=7)
    span = time.perf_counter() - t0
    affinity = rtr.affinity_stats()
    homes = {s: list(h) for s, h in rtr.scene_homes().items()}
    cache_rates = {}
    for name, reg in registries.items():
        st = reg.cache.stats()
        hits = st["hits"] - cache_before[name]["hits"]
        misses = st["misses"] - cache_before[name]["misses"]
        tot = hits + misses
        cache_rates[name] = {"hits": hits, "misses": misses,
                             "hit_rate": round(hits / tot, 4) if tot else None}
    affinity_leg = {"offered_rps": round(rate, 2), **leg_summary(recs, span),
                    "route_mix": affinity, "scene_homes": homes,
                    "replica_cache": cache_rates, "zipf_a": FLEET_ZIPF_A}
    rtr.close(close_replicas=False)

    # ---- leg C: mid-load replica-wedge drill ----
    # Seed affinity so the wedge target is a real home, then pick it.
    for j, s in enumerate(scenes):
        router.infer_one(pool[j % len(pool)], scene=s, deadline_ms=deadline_ms)
    target = router.scene_homes()[scenes[0]][0]  # the hottest scene's home
    release = threading.Event()
    for inj in injectors.values():
        # Every replica armed identically; the predicate picks exactly one,
        # after two of its dispatches served, so the wedge lands MID-load.
        inj.stall_once(release, after=2, match=lambda ctx, t=target: ctx["tag"] == t)
    rate = FLEET_DRILL_RATE_X * FLEET_REPLICAS * capacity_rps
    n = int(min(max(48, rate * 2 * seconds), 400))
    t_arm = time.perf_counter()
    recs = open_loop(router, n, rate, seed=23)
    span = time.perf_counter() - t_arm
    release.set()  # unwedge the abandoned worker (its generation is stale)
    totals = router.fleet_totals()
    quarantined = router.quarantined_replicas()
    # Healthy scenes: homed off the wedged replica when the fault hit.
    wedged_home_scenes = {s for s, h in router.scene_homes().items() if target in h}
    healthy = leg_summary([r for r in recs if r[0] not in wedged_home_scenes], span)
    drill = leg_summary(recs, span)
    failed_over = [r for _, _, r, o, _ in recs
                   if r is not None and r.failover_from and o in ("served", "degraded")]
    fo_lat = sorted(r.t_done - r.t_faulted for r in failed_over)

    def foq(p):
        if not fo_lat:
            return None
        return round(fo_lat[min(len(fo_lat) - 1, round(p * (len(fo_lat) - 1)))] * 1e3, 2)

    # Bit-identity: a failed-over result == the surviving replica
    # dispatched directly with the same frame.
    bit_identical = None
    if failed_over:
        probe = failed_over[0]
        frame_used = next(fr for _, fr, r, _, _ in recs if r is probe)
        direct = next(rep.dispatcher.infer_one(frame_used, scene=probe.scene,
                                               deadline_ms=deadline_ms)
                      for rep in replicas if rep.name == probe.replica)
        bit_identical = all(np.array_equal(np.asarray(probe.result[k]), np.asarray(direct[k]))
                            for k in ("rvec", "tvec", "scores", "expert"))
    compiled_after = sum(r.compile_cache_size() for r in registries.values())
    inj_stats = {name: inj.stats() for name, inj in injectors.items()}
    obs_snapshot = router.obs.snapshot()
    # Sampled-trace evidence: exemplar slow traces ride the artifact, and
    # every sampled trace must telescope exactly at fleet scope.
    store = router.obs.get_trace_store()
    drill_traces = [t for t in store.traces() if t.done] if store is not None else []
    trace_evidence = {
        "sample_1_in": policy.trace_sample,
        "sampled": len(drill_traces),
        "max_abs_residual_s": (max(t.residual() for t in drill_traces)
                               if drill_traces else None),
        "telescoping_exact": bool(drill_traces
                                  and max(t.residual() for t in drill_traces) < 1e-6),
        "exemplar_slow_traces": store.slowest(3) if store is not None else [],
    }
    router.close(close_replicas=True)
    join_threads_started_since(threads_before)

    lock_witness, _ = lock_witness_block(witness)
    outcome_witness.assert_consistent()
    gc_block = {
        "frozen": True,
        "collections_during_run": [int(a["collections"] - b["collections"])
                                   for a, b in zip(gc.get_stats(), gc_before)],
    }
    gc.unfreeze()

    return {
        "replicas": FLEET_REPLICAS,
        "scenes": {"n": FLEET_SCENES, "hw": [H, H], "num_experts": M, "n_hyps": FLEET_HYPS,
                   "frame_bucket": FLEET_BUCKET},
        "closed_loop_dispatch_ms": round(dispatch_s * 1e3, 2),
        "per_replica_capacity_rps": round(capacity_rps, 2),
        "deadline_ms": round(deadline_ms, 1),
        "watchdog_ms": round(watchdog_ms, 1),
        "knee_vs_replicas": knee_legs,
        "affinity": affinity_leg,
        "wedge_drill": {
            "wedged_replica": target,
            "offered_rps": round(rate, 2),
            "summary": drill,
            "fleet_totals": totals,
            "accounting_exact": accounting_exact(totals),
            "quarantined": {k: v[:120] for k, v in quarantined.items()},
            "healthy_scene_goodput_retention": healthy["goodput_ratio"],
            "failed_over_requests": len(failed_over),
            "failover_p50_ms": foq(0.5),
            "failover_p99_ms": foq(0.99),
            "failover_bit_identical": bit_identical,
            "injector_stats": inj_stats,
            "traces": trace_evidence,
        },
        "compiled_programs": {
            "before_load": compiled_before,
            "after_drill": compiled_after,
            "hot_path_recompiles": compiled_after - compiled_before,
        },
        "lock_witness": lock_witness,
        "fault_taxonomy": outcome_witness.snapshot(),
        "gc": gc_block,
        "obs_snapshot": obs_snapshot,
        "note": (
            "open-loop Zipf scene trace over a scene-affinity replica fleet; knee "
            "legs offered in multiples of aggregate (n-replica) capacity; the "
            "mid-load drill stalls ONE replica via tag-matched FaultInjectors (the "
            "others count dispatch_unmatched), the watchdog types the wedge, the "
            "router quarantines the replica and fails its requests over within "
            "their deadlines; fleet outcome classes sum exactly to offered; "
            "failed-over results bit-identical to the surviving replica dispatched "
            "directly; tiny scenes -- scheduling, not throughput.  NOTE on "
            "knee_vs_replicas: every replica is a thread of this process on one "
            "card and shares the host's cores, so the leg shows the measurement; "
            "a scale-out number needs a card and host cores per replica"
        ),
    }


def fleet_headline(fleet: dict) -> dict:
    drill = fleet["wedge_drill"]
    knees = {str(leg["replicas"]): leg["knee_sustained_hyps_per_s"]
             for leg in fleet["knee_vs_replicas"]}
    return {
        "metric": "fleet_healthy_goodput_retention_under_wedge",
        "value": drill["healthy_scene_goodput_retention"],
        "unit": "goodput_ratio",
        "vs_baseline": None,
        "accounting_exact": drill["accounting_exact"],
        "affinity_hit_rate": fleet["affinity"]["route_mix"]["hit_rate"],
        "failover_p99_ms": drill["failover_p99_ms"],
        "failover_bit_identical": drill["failover_bit_identical"],
        "hot_path_recompiles": fleet["compiled_programs"]["hot_path_recompiles"],
        "knee_sustained_hyps_per_s_by_replicas": knees,
    }
