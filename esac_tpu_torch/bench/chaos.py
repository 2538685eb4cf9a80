"""``chaos`` mode (counterpart of ``bench.py``'s ``_measure_chaos``): the
fleet fault-tolerance drill (DESIGN.md §13).  An open-loop mixed-scene load
over a 4-scene registry while three fault classes are injected -- a CORRUPT
checkpoint read (content checksums turn it into typed ChecksumMismatchError
failures and a lane quarantine, never served garbage), a TRANSIENT IO fault
(the loader's capped retry absorbs it) and a NaN-WEIGHT version promotion
(the scene health breaker trips and rolls back to the last good version).
Reported per fault: outcome accounting that sums exactly to offered, typed
error classes, recovery latency, healthy-scene goodput retention, the
post-rollback bit-identity check, the canary verdict and the batch-signature
count across the drill (a rollback is a pointer swap), under the committed
lock-graph and fault-taxonomy witnesses.

Tiny scenes on purpose: the drill measures fault ROUTING, not throughput."""

from __future__ import annotations

import collections
import functools
import time

import numpy as np

from esac_tpu_torch.bench.constants import (
    CHAOS_BUCKET,
    CHAOS_HW,
    CHAOS_HYPS,
    CHAOS_M,
    CHAOS_RATE_X,
    CHAOS_SECONDS,
)
from esac_tpu_torch.bench.fixtures import (
    ROOT,
    accounting_exact,
    image_frame,
    lock_witness_block,
    scratch_dir,
    tiny_preset,
    write_scene,
)
from esac_tpu_torch.lint.witness import LockWitness, OutcomeWitness
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.health import HealthPolicy
from esac_tpu_torch.registry.manifest import SceneManifest
from esac_tpu_torch.registry.serving import SceneRegistry, load_scene_params
from esac_tpu_torch.serve.loadgen import poisson_arrivals, run_open_loop
from esac_tpu_torch.serve.slo import FaultInjector, ServeError, SLOPolicy
from esac_tpu_torch.utils.checkpoint import load_checkpoint
from esac_tpu_torch.utils.precision import resolve_device


def measure_chaos(seconds: float = CHAOS_SECONDS, device=None) -> dict:
    dev = resolve_device(device)
    with scratch_dir("esac_chaos_") as root:
        return _measure_chaos_at(root, seconds, dev)


def _measure_chaos_at(root, seconds: float, dev) -> dict:
    H = CHAOS_HW
    M = CHAOS_M
    preset = tiny_preset(H, M)
    # Queue depth + deadline sized so the TRANSIENT backlog behind a faulting
    # scene's failing loads is absorbed rather than shed: the drill measures
    # fault routing on healthy-lane traffic (the loadtest owns overload).
    cfg = RansacConfig(n_hyps=CHAOS_HYPS, refine_iters=2, polish_iters=1,
                       frame_buckets=(CHAOS_BUCKET,), serve_max_wait_ms=2.0,
                       serve_queue_depth=512)
    hyps_per_request = M * CHAOS_HYPS

    def scene(name, version, seed, nan=False):
        return write_scene(root, name, preset, cfg, seed, version=version,
                           dirname=f"{name}_v{version}", nan=nan, checksums=True)

    manifest = SceneManifest()
    manifest.add(scene("s_ok", 1, seed=0))
    manifest.add(scene("s_ok", 2, seed=10), activate=False)
    manifest.add(scene("s_corrupt", 1, seed=1))
    manifest.add(scene("s_ioflaky", 1, seed=2))
    manifest.add(scene("s_nan", 1, seed=3))
    manifest.add(scene("s_nan", 2, seed=13, nan=True), activate=False)
    scenes = ["s_ok", "s_corrupt", "s_ioflaky", "s_nan"]

    inj = FaultInjector()
    loader = functools.partial(load_scene_params,
                               read_checkpoint=inj.checkpoint_reader(load_checkpoint),
                               retries=2, backoff_s=0.02)
    registry = SceneRegistry(manifest, loader=loader, device=dev,
                             health=HealthPolicy(window=16, min_samples=4, trip_bad_frac=0.5,
                                                 canary_min_samples=8))
    # The lock witness attaches before any traffic, so the drill's
    # acquisition edges (health -> manifest on rollback, cache under fault
    # load) are checked against the committed lock graph; the outcome
    # witness holds every (error type, outcome) pair to the committed fault
    # taxonomy.
    witness = LockWitness()
    witness.attach_fleet(registry=registry, injector=inj)
    outcome_witness = OutcomeWitness.from_repo(ROOT)
    pool = [image_frame(i, H) for i in range(8)]

    # Prewarm: load every scene + the first call of the shared function.
    warmer = registry.dispatcher(cfg, start_worker=False)
    for s in scenes:
        warmer.infer_one(pool[0], scene=s)
    compiled_before = registry.compile_cache_size()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        warmer.infer_many(pool[:CHAOS_BUCKET], scene="s_ok")
        walls.append(time.perf_counter() - t0)
    warmer.close()
    dispatch_s = sorted(walls)[len(walls) // 2]
    capacity_rps = CHAOS_BUCKET / dispatch_s
    deadline_ms = max(1_500.0, 20 * dispatch_s * 1e3)
    slo = SLOPolicy(deadline_ms=deadline_ms, watchdog_ms=max(10_000.0, 50 * dispatch_s * 1e3),
                    retry_max=1, quarantine_after=2)

    # Witness contract: attach before the worker starts.
    disp = registry.dispatcher(cfg, slo=slo, start_worker=False)
    witness.attach_fleet(disp=disp)
    disp.start()
    for i, s in enumerate(scenes):
        disp.infer_one(pool[i], scene=s, deadline_ms=60_000.0)

    def open_loop(n, seed):
        return run_open_loop(
            disp, lambda i: (pool[i % len(pool)], scenes[i % len(scenes)], None),
            poisson_arrivals(CHAOS_RATE_X * capacity_rps, n, seed=seed),
            deadline_ms=deadline_ms, hyps_per_request=hyps_per_request)

    def per_scene(res):
        """Per-scene (= per-fault-class) outcome + typed-error accounting;
        each scene's classes sum to its offered."""
        out = {}
        errs = res["per_request_error_types"]
        for i, o in enumerate(res["per_request_outcomes"]):
            rec = out.setdefault(scenes[i % len(scenes)], {
                "offered": 0, "outcomes": collections.Counter(),
                "error_types": collections.Counter()})
            rec["offered"] += 1
            rec["outcomes"][o] += 1
            if errs[i]:
                rec["error_types"][errs[i]] += 1
        for rec in out.values():
            rec["outcomes"] = dict(rec["outcomes"])
            rec["error_types"] = dict(rec["error_types"])
            rec["sums_to_offered"] = sum(rec["outcomes"].values()) == rec["offered"]
            good = rec["outcomes"].get("served", 0) + rec["outcomes"].get("degraded", 0)
            rec["goodput"] = round(good / max(rec["offered"], 1), 4)
        return out

    n_per_phase = int(min(max(32, CHAOS_RATE_X * capacity_rps * seconds), 400))
    n_per_phase -= n_per_phase % len(scenes)  # equal per-scene offered

    # ---- phase A: clean baseline under open-loop mixed-scene load ----
    disp.reset_stats()
    res_a = open_loop(n_per_phase, seed=11)
    baseline = per_scene(res_a)
    outcome_witness.observe_run(res_a)

    # ---- phase B: all three fault classes live under the same load ----
    registry.cache.evict(("s_corrupt", 1))
    inj.corrupt_loads(times=64, match=lambda p: "s_corrupt" in p)
    registry.cache.evict(("s_ioflaky", 1))
    inj.fail_loads(OSError("injected EIO"), times=2, match=lambda p: "s_ioflaky" in p)
    t_promote = time.perf_counter()
    registry.promote("s_nan", 2)  # the NaN-weight rollout
    disp.reset_stats()
    res_b = open_loop(n_per_phase, seed=23)
    fault = per_scene(res_b)
    outcome_witness.observe_run(res_b)
    totals_b = disp.slo_totals()
    exact = (
        all(rec["sums_to_offered"] for rec in fault.values())
        and all(rec["sums_to_offered"] for rec in baseline.values())
        and accounting_exact(totals_b))

    health = registry.health()
    rollback = next((e for e in health["events"]
                     if e["event"] == "auto_rollback" and e["scene"] == "s_nan"), None)
    garbage_frames = health["scenes"].get("s_nan@v2", {}).get("bad", 0)

    # ---- recovery: the operator clears the corrupt-checkpoint quarantine
    # and the scene breaker's failure samples ----
    inj.corrupt_loads(times=0)  # the "fixed checkpoint"
    quarantined = [list(lane) for lane in disp.quarantined_lanes()]
    t_release = time.perf_counter()
    disp.release_lane(scene="s_corrupt")
    registry.release_scene("s_corrupt")
    try:
        disp.infer_one(pool[0], scene="s_corrupt", deadline_ms=60_000.0)
        corrupt_recovered = True
        corrupt_recovery_s = time.perf_counter() - t_release
    except ServeError:  # recorded in the artifact, not raised
        corrupt_recovered = False
        corrupt_recovery_s = None

    # ---- bit-identity: post-rollback s_nan == v1 loaded directly ----
    probe = pool[3]
    via_rollback = disp.infer_one(probe, scene="s_nan", deadline_ms=60_000.0)
    solo = SceneRegistry(SceneManifest(), device=dev)
    solo.manifest.add(manifest.entry("s_nan", 1))
    solo_disp = solo.dispatcher(cfg, start_worker=False)
    direct = solo_disp.infer_one(probe, scene="s_nan")
    solo_disp.close()
    bit_identical = all(np.array_equal(np.asarray(via_rollback[k]), np.asarray(direct[k]))
                        for k in ("rvec", "tvec", "scores", "expert"))

    # ---- canary: healthy v2 of s_ok auto-finalizes ----
    registry.promote("s_ok", 2, canary=0.5)
    for i in range(24):
        disp.infer_one(pool[i % len(pool)], scene="s_ok", deadline_ms=60_000.0)
    canary_events = [e["event"] for e in registry.health()["events"]
                     if e["event"].startswith("canary")]
    canary_finalized = manifest.active_version("s_ok") == 2

    compiled_after = registry.compile_cache_size()
    disp.close()

    lock_witness, witness_snap = lock_witness_block(witness)
    # Hold times of the fleet's critical sections and the worst
    # blocked-while-held acquires (the runtime shadow of R13).
    lock_witness["hold_seconds"] = witness_snap["holds"]
    lock_witness["blocked_while_held_worst"] = sorted(
        witness_snap["blocked_while_held"], key=lambda e: -e["waited_s"])[:10]
    fault_taxonomy = outcome_witness.snapshot()
    outcome_witness.assert_consistent()

    return {
        "lock_witness": lock_witness,
        "fault_taxonomy": fault_taxonomy,
        "scenes": {"n": len(scenes), "hw": [H, H], "num_experts": M, "n_hyps": CHAOS_HYPS,
                   "frame_bucket": CHAOS_BUCKET},
        "closed_loop_dispatch_ms": round(dispatch_s * 1e3, 2),
        "offered_rps": round(CHAOS_RATE_X * capacity_rps, 2),
        "offered_x_capacity": CHAOS_RATE_X,
        "deadline_ms": round(deadline_ms, 1),
        "offered_per_phase": n_per_phase,
        "baseline": baseline,
        "fault_window": {
            "per_scene": fault,
            "accounting_exact": bool(exact),
            "dispatcher_totals": totals_b,
            "healthy_goodput_retention": fault["s_ok"]["goodput"],
        },
        "faults": {
            "corrupt_checkpoint": {
                "scene": "s_corrupt",
                "injected_corrupt_reads": inj.stats()["load_corruptions"],
                "typed_errors": fault["s_corrupt"]["error_types"],
                "quarantined_lanes": quarantined,
                "released_and_recovered": bool(corrupt_recovered),
                "recovery_latency_s": (round(corrupt_recovery_s, 4)
                                       if corrupt_recovery_s is not None else None),
            },
            "transient_io": {
                "scene": "s_ioflaky",
                "injected_failures": inj.stats()["load_failures"],
                "goodput": fault["s_ioflaky"]["goodput"],
                "retried_transparently": fault["s_ioflaky"]["outcomes"].get("failed", 0) == 0,
            },
            "nan_weights": {
                "scene": "s_nan",
                "auto_rolled_back": rollback is not None,
                "rollback_latency_s": (round(rollback["t"] - t_promote, 4)
                                       if rollback else None),
                "active_version_after": manifest.active_version("s_nan"),
                "garbage_frames_before_trip": int(garbage_frames),
                "post_rollback_bit_identical": bool(bit_identical),
            },
        },
        "canary": {
            "scene": "s_ok", "fraction": 0.5,
            "events": canary_events,
            "finalized": bool(canary_finalized),
            "active_version_after": manifest.active_version("s_ok"),
        },
        "compiled_programs": {
            "before_faults": compiled_before,
            "after_drill": compiled_after,
            "hot_path_recompiles": compiled_after - compiled_before,
        },
        "health_events": [
            {k: (round(v, 4) if isinstance(v, float) else v) for k, v in e.items()}
            for e in registry.health()["events"]
        ],
        "note": (
            "open-loop mixed-scene Poisson load below the knee; per-scene outcome "
            "classes sum exactly to offered (per fault class); corrupt reads become "
            "typed ChecksumMismatchError failures + lane quarantine (released by the "
            "operator after the fix); transient IO faults are absorbed by the "
            "loader's capped retry; the NaN-weight promote trips the health breaker, "
            "which rolls back to the previous version bit-identically with no new "
            "batch signature; garbage_frames_before_trip counts physical lanes "
            "(incl. padding) the bounded window served before tripping; tiny scenes "
            "-- fault routing, not throughput"
        ),
    }


def chaos_headline(chaos: dict) -> dict:
    return {
        "metric": "chaos_healthy_scene_goodput_retention",
        "value": chaos["fault_window"]["healthy_goodput_retention"],
        "unit": "goodput_ratio",
        "vs_baseline": None,
        "accounting_exact": chaos["fault_window"]["accounting_exact"],
        "auto_rollback_latency_s": chaos["faults"]["nan_weights"]["rollback_latency_s"],
        "post_rollback_bit_identical":
            chaos["faults"]["nan_weights"]["post_rollback_bit_identical"],
        "hot_path_recompiles": chaos["compiled_programs"]["hot_path_recompiles"],
    }
