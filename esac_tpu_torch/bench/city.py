"""``city`` mode (counterpart of ``bench.py``'s ``_measure_city``): the
city-scale scene-retrieval drill (DESIGN.md §22).  ``FleetRouter.infer_image``
-- image-only requests, no scene id -- over CITY_SCENES procedural scenes at
CITY_OVERSUB_X weight-cache oversubscription, swept over retrieval fan-out K
in CITY_TOPKS with a mixed easy / ambiguous / junk query set.  Per leg:
recall@K (misses count against), winner-vs-ground-truth agreement, served
p50/p99 and exact image-tier accounting.  Cross-leg pins: no new batch
signature across enrollment and every leg (prototypes are tensor
arguments), a confident-query bit-identity probe, a breaker fall-through +
``release_scene`` restore probe and a candidates-exhausted fault probe, all
under the committed lock-graph and fault-taxonomy witnesses.

The retriever is fit here (bench preparation, off every measured path) by
``train_steps`` Adam steps of symmetric InfoNCE over two noisy views per
scene with junk images as extra negative columns: ``torch.optim.Adam`` at
``bench.py``'s optax learning rate, the same loss.  A random-init embedder
gives a near-uniform posterior."""

from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch
import torch.nn.functional as F

from esac_tpu_torch.bench.constants import (
    CITY_BUCKET,
    CITY_EASY,
    CITY_EMBED,
    CITY_HARD,
    CITY_HW,
    CITY_HYPS,
    CITY_JUNK,
    CITY_M,
    CITY_MAX_SCENES,
    CITY_OVERSUB_X,
    CITY_REPLICAS,
    CITY_SCENES,
    CITY_TOPKS,
    CITY_TRAIN_STEPS,
)
from esac_tpu_torch.bench.fixtures import (
    REQUEST_SEED,
    ROOT,
    accounting_exact,
    lock_witness_block,
    pct,
    scratch_dir,
    tiny_preset,
    write_scene,
)
from esac_tpu_torch.fleet.router import FleetPolicy, FleetRouter, Replica
from esac_tpu_torch.lint.witness import LockWitness, OutcomeWitness
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.cache import tree_nbytes
from esac_tpu_torch.registry.health import HealthPolicy, SceneLoadError
from esac_tpu_torch.registry.manifest import SceneManifest
from esac_tpu_torch.registry.prefetch import PrefetchPolicy
from esac_tpu_torch.registry.serving import SceneRegistry, load_scene_params
from esac_tpu_torch.retrieval.errors import (
    RetrievalCandidatesExhaustedError,
    RetrievalMissError,
)
from esac_tpu_torch.retrieval.front import RetrievalFront, RetrievalPolicy
from esac_tpu_torch.retrieval.index import SceneIndex
from esac_tpu_torch.retrieval.model import RetrievalConfig, build_retriever, make_retrieval_fn
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
from esac_tpu_torch.serve.slo import (
    DeadlineExceededError,
    FaultInjector,
    ServeError,
    ShedError,
    SLOPolicy,
)
from esac_tpu_torch.utils.precision import resolve_device


# bench.py's floor of the drill's watchdog.
WATCHDOG_FLOOR_MS = 500.0


def measure_city(train_steps: int = CITY_TRAIN_STEPS, device=None) -> dict:
    dev = resolve_device(device)
    with scratch_dir("esac_city_") as root:
        try:
            return _measure_city_at(root, train_steps, dev)
        finally:
            gc.unfreeze()  # no-op on a clean exit


def fit_retriever(rmodel, bases: np.ndarray, junk, train_steps: int, temperature: float,
                  dev) -> tuple[float | None, float]:
    """Symmetric InfoNCE over two noisy views (sigma 0.1) per scene, junk
    images as extra negative columns, Adam at lr 3e-3; returns (the last
    step's loss, seconds)."""
    opt = torch.optim.Adam(rmodel.parameters(), lr=3e-3)
    rmodel.train()
    labels = torch.arange(bases.shape[0], device=dev)
    t0 = time.perf_counter()
    loss = None
    for it in range(train_steps):
        rs = np.random.RandomState(200_000 + it)
        va = np.clip(bases + rs.normal(0.0, 0.1, bases.shape), 0.0, 2.0).astype(np.float32)
        vb = np.clip(bases + rs.normal(0.0, 0.1, bases.shape), 0.0, 2.0).astype(np.float32)
        vj = np.stack([junk(1_000 + 8 * it + k) for k in range(8)])
        ea, eb, ej = (rmodel(torch.from_numpy(v).to(dev)) for v in (va, vb, vj))
        pos = ea @ eb.T / temperature                                   # (N, N)
        row = torch.cat([pos, ea @ ej.T / temperature], dim=1)
        col = torch.cat([pos.T, eb @ ej.T / temperature], dim=1)
        loss = F.cross_entropy(row, labels) + F.cross_entropy(col, labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    rmodel.eval()
    return (float(loss.detach()) if loss is not None else None), time.perf_counter() - t0


def _measure_city_at(root, train_steps: int, dev) -> dict:
    H = W = CITY_HW
    M = CITY_M
    preset = tiny_preset(H, M)
    cfg = RansacConfig(n_hyps=CITY_HYPS, refine_iters=2, polish_iters=1,
                       frame_buckets=(CITY_BUCKET,), serve_max_wait_ms=0.0,
                       serve_queue_depth=256)

    # ---- procedural city: a scene's visual identity = constant color +
    # x/y gradients + fixed texture (what the retriever must tell apart);
    # junk images share the pixel statistics but none of the structure.
    def scene_base(i):
        rs = np.random.RandomState(1000 + i)
        color = rs.uniform(0.2, 1.0, size=(1, 1, 3))
        gx = np.linspace(0.0, 1.0, W)[None, :, None] * rs.uniform(-1.0, 1.0, (1, 1, 3))
        gy = np.linspace(0.0, 1.0, H)[:, None, None] * rs.uniform(-1.0, 1.0, (1, 1, 3))
        tex = rs.uniform(-1.0, 1.0, (H, W, 3)) * 0.15
        return np.clip(color + gx + gy + tex, 0.0, 2.0).astype(np.float32)

    def view(base, noise, rs):
        return np.clip(base + rs.normal(0.0, noise, base.shape), 0.0, 2.0).astype(np.float32)

    def junk(k):
        return np.random.RandomState(7000 + k).uniform(0.0, 2.0, (H, W, 3)).astype(np.float32)

    bases = np.stack([scene_base(i) for i in range(CITY_SCENES)])
    scenes = [f"s{i}" for i in range(CITY_SCENES)]

    # ---- the retriever fit (bench prep, off every measured path) ----
    rcfg = RetrievalConfig(height=H, width=W, max_scenes=CITY_MAX_SCENES, embed_dim=CITY_EMBED,
                           channels=(4, 8), temperature=0.1)
    rmodel = build_retriever(rcfg, seed=0, device=dev)
    fn = make_retrieval_fn(rcfg, device=dev)
    final_loss, train_s = fit_retriever(rmodel, bases, junk, train_steps, rcfg.temperature, dev)

    # ---- enroll: prototype = normalized mean of 4 reference views per
    # scene, through the SAME forward the serve path uses (the index
    # snapshot rides as tensor arguments -- no new signature per enroll).
    index = SceneIndex(capacity=CITY_MAX_SCENES, embed_dim=CITY_EMBED)

    def embed(images):
        protos, mask, _ = index.snapshot()
        return fn(rmodel, protos, mask, images)["embedding"].cpu().numpy()

    for i, sid in enumerate(scenes):
        rs = np.random.RandomState(5_000 + i)
        index.enroll(sid, embed(np.stack([view(bases[i], 0.05, rs) for _ in range(4)])))

    # ---- confidence-floor calibration at the serve batch shape: midway
    # between the junk median and the ambiguous-view p5, so ambiguous
    # queries still dispatch while most junk sheds typed.
    def top1_p_of(img):
        protos, mask, _ = index.snapshot()
        return float(fn(rmodel, protos, mask, img[None])["posterior"][0].max())

    easy_ps = [top1_p_of(view(bases[i], 0.05, np.random.RandomState(9_000 + i)))
               for i in range(CITY_SCENES)]
    hard_ps = [top1_p_of(view(bases[i], 0.35, np.random.RandomState(9_500 + i)))
               for i in range(CITY_SCENES)]
    junk_ps = [top1_p_of(junk(500 + k)) for k in range(12)]
    min_conf = round(float(np.clip((np.median(junk_ps) + np.percentile(hard_ps, 5)) / 2.0,
                                   0.05, 0.95)), 4)
    calibration = {
        "min_confidence": min_conf,
        "easy_top1_p_p5": round(float(np.percentile(easy_ps, 5)), 4),
        "hard_top1_p_p5": round(float(np.percentile(hard_ps, 5)), 4),
        "junk_top1_p_p50": round(float(np.median(junk_ps)), 4),
        "junk_top1_p_p95": round(float(np.percentile(junk_ps, 95)), 4),
    }

    # ---- the scene fleet (expert + gating checkpoints) ----
    manifest = SceneManifest()
    for i, s in enumerate(scenes):
        manifest.add(write_scene(root, s, preset, cfg, seed=i, checksums=True))
    host = load_scene_params(manifest.resolve(scenes[0]))
    scene_bytes = tree_nbytes(host["expert"]) + tree_nbytes(host["gating"])

    # Device oversubscription: the cache holds ~1/CITY_OVERSUB_X of the
    # fleet; posterior-driven prefetch stages a candidate's weights ahead.
    budget_bytes = max(scene_bytes, int(CITY_SCENES * scene_bytes / CITY_OVERSUB_X))
    resident_max = max(1, budget_bytes // max(scene_bytes, 1))

    # ---- replicas: registry (+posterior-fed prefetcher) + tagged injector
    # + SLO dispatcher each (workers start after the witness attaches).
    replicas, injectors, registries = [], {}, {}
    for i in range(CITY_REPLICAS):
        name = f"r{i}"
        reg = SceneRegistry(manifest, budget_bytes=budget_bytes, device=dev,
                            health=HealthPolicy(window=16, min_samples=4, trip_bad_frac=0.5))
        reg.attach_prefetcher(PrefetchPolicy(interval_ms=5.0, halflife_s=2.0,
                                             device_scenes=max(1, int(resident_max) - 1),
                                             max_device_per_cycle=2), start=False)
        inj = FaultInjector(reg.infer_fn(), tag=name)
        disp = MicroBatchDispatcher(inj, cfg, start_worker=False, device=dev)
        reg.bind_obs(disp.obs)
        replicas.append(Replica(name, disp, reg))
        injectors[name] = inj
        registries[name] = reg

    def frame(img, qi):
        return {"seed": np.int64(REQUEST_SEED + qi), "image": img}

    # Prewarm every replica on every scene (synchronous, pre-worker): every
    # cold load and first call off the measured legs, and a clean baseline
    # for the batch-signature count (the retriever's included).
    for rep in replicas:
        for j, s in enumerate(scenes):
            rep.dispatcher.infer_one(frame(view(bases[j], 0.05, np.random.RandomState(j)), j),
                                     scene=s)
    compiled_before = (sum(r.compile_cache_size() for r in registries.values())
                       + int(fn._cache_size()))

    # The closed-loop per-candidate dispatch cost sizes the SLO.
    walls = []
    for k in range(5):
        t0 = time.perf_counter()
        replicas[0].dispatcher.infer_one(
            frame(view(bases[0], 0.05, np.random.RandomState(90 + k)), k), scene=scenes[0])
        walls.append(time.perf_counter() - t0)
    dispatch_s = sorted(walls)[len(walls) // 2]
    # The image deadline covers a K-wide candidate fan-out.
    deadline_ms = max(8_000.0, 60 * dispatch_s * 1e3)
    watchdog_ms = max(WATCHDOG_FLOOR_MS, 5 * dispatch_s * 1e3)
    slo = SLOPolicy(deadline_ms=deadline_ms, watchdog_ms=watchdog_ms, retry_max=1,
                    quarantine_after=2)
    for rep in replicas:
        rep.dispatcher._slo = slo  # sized from the measured dispatch

    # The long-lived fixture heap out of the collector's sight.
    gc.collect()
    gc.freeze()
    gc_before = gc.get_stats()

    witness = LockWitness()
    outcome_witness = OutcomeWitness.from_repo(ROOT)
    policy = FleetPolicy(poll_ms=5.0, trace_sample=8)
    # The witnessed probe router carries the retrieval front whose leaf
    # locks (front + index) the lock witness watches; the per-leg routers
    # share the same replicas and index.
    probe_front = RetrievalFront(fn, rmodel, index,
                                 RetrievalPolicy(top_k=2, min_confidence=min_conf))
    probe_rtr = FleetRouter(replicas, policy, start=False)
    probe_rtr.attach_retrieval(probe_front)
    witness.attach_fleet(router=probe_rtr)
    for rep in replicas:
        rep.dispatcher.start()
    for reg in registries.values():
        reg._prefetcher.start()
    probe_rtr.start()

    # ---- the shared query set (identical across legs, deterministic
    # shuffle): ground truth rides each record for recall@K.
    queries = []
    qrs = np.random.RandomState(31)
    for q in range(CITY_EASY):
        i = int(qrs.randint(CITY_SCENES))
        queries.append(("easy", scenes[i], view(bases[i], 0.05, np.random.RandomState(40_000 + q))))
    for q in range(CITY_HARD):
        i = int(qrs.randint(CITY_SCENES))
        queries.append(("hard", scenes[i], view(bases[i], 0.35, np.random.RandomState(50_000 + q))))
    for q in range(CITY_JUNK):
        queries.append(("junk", None, junk(600 + q)))
    order = [int(x) for x in qrs.permutation(len(queries))]
    n_localizable = CITY_EASY + CITY_HARD

    def classify(e):
        if isinstance(e, RetrievalMissError):
            return "shed"
        if isinstance(e, DeadlineExceededError):
            return "expired"
        if isinstance(e, RetrievalCandidatesExhaustedError):
            return "failed"
        return "shed" if isinstance(e, ShedError) else "failed"

    def same(a, b):
        return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                   for k in ("rvec", "tvec", "scores", "expert"))

    # ---- leg sweep: retrieval fan-out K vs recall / accuracy / tail ----
    legs = []
    max_residual = 0.0
    sampled_total = 0
    exemplar_traces = []
    for K in CITY_TOPKS:
        front = RetrievalFront(fn, rmodel, index, RetrievalPolicy(top_k=K, min_confidence=min_conf))
        rtr = FleetRouter(replicas, policy, start=True)
        rtr.attach_retrieval(front)
        recs = []
        for qi in order:
            kind, gt, img = queries[qi]
            fr = frame(img, qi)
            t0 = time.perf_counter()
            try:
                out = rtr.infer_image(fr, deadline_ms=deadline_ms)
            except ServeError as e:  # typed image faults
                recs.append((kind, gt, fr, classify(e), type(e).__name__,
                             time.perf_counter() - t0, None))
            else:
                recs.append((kind, gt, fr, "served", None, time.perf_counter() - t0, out))
        for _, _, _, outcome, err, _, _ in recs:
            outcome_witness.observe(err, outcome)
        # Confident-query bit-identity: the image-path winner's answer vs
        # the SAME frame dispatched with the winner's scene id.
        bit_identical = None
        for kind, gt, fr, outcome, _, _, out in recs:
            if kind != "easy" or outcome != "served":
                continue
            direct = rtr.infer_one(fr, scene=out["retrieval"]["scene"], deadline_ms=deadline_ms)
            bit_identical = same(out, direct)
            break
        fs = front.stats()
        totals = rtr.fleet_totals()
        store = rtr.obs.get_trace_store()
        leg_traces = [t for t in store.traces() if t.done] if store is not None else []
        if leg_traces:
            max_residual = max(max_residual, max(t.residual() for t in leg_traces))
            sampled_total += len(leg_traces)
        if K == 2 and store is not None:
            exemplar_traces = store.slowest(2)
        rtr.close(close_replicas=False)

        outcomes = collections.Counter(r[3] for r in recs)
        by_mix = {}
        for kind in ("easy", "hard", "junk"):
            sub = [r for r in recs if r[0] == kind]
            by_mix[kind] = {"offered": len(sub), **collections.Counter(r[3] for r in sub)}
        served_loc = [r for r in recs if r[0] != "junk" and r[3] == "served"]
        recall_hits = sum(1 for r in served_loc if r[1] in r[6]["retrieval"]["candidates"])
        top1_hits = sum(1 for r in served_loc if r[6]["retrieval"]["top1"] == r[1])
        winner_hits = sum(1 for r in served_loc if r[6]["retrieval"]["scene"] == r[1])
        lat = [r[5] for r in recs if r[3] == "served"]
        legs.append({
            "top_k": K,
            "offered": len(recs),
            "outcomes": dict(outcomes),
            "by_mix": by_mix,
            "recall_at_k": round(recall_hits / n_localizable, 4),
            "recall_hits": recall_hits,
            "retrieval_top1_acc": round(top1_hits / n_localizable, 4),
            "winner_accuracy_served": (round(winner_hits / len(served_loc), 4)
                                       if served_loc else None),
            "served_p50_ms": round(pct(lat, 0.5) * 1e3, 2) if lat else None,
            "served_p99_ms": round(pct(lat, 0.99) * 1e3, 2) if lat else None,
            "accounting_exact": accounting_exact(fs),
            "fleet_accounting_exact": accounting_exact(totals),
            "bit_identical": bit_identical,
            "front": fs,
        })

    # ---- probe A: breaker fall-through + release_scene restore: trip the
    # probe query's top-1 scene on EVERY replica; the front must skip it,
    # dispatch the runner-ups, and after release_scene the SAME frame must
    # reproduce the pre-trip answer bit for bit.
    _, gt0, img0q = next(queries[qi] for qi in order if queries[qi][0] == "easy")
    fr0 = frame(img0q, 999)
    out_before = probe_rtr.infer_image(fr0, deadline_ms=deadline_ms)
    outcome_witness.observe(None, "served")
    skipped_before = probe_front.stats()["tripped_skipped"]
    for reg in registries.values():
        with reg._health_lock:
            reg._tripped[(gt0, 1)] = "city drill: breaker fall-through"
    out_tripped = probe_rtr.infer_image(fr0, deadline_ms=deadline_ms)
    outcome_witness.observe(None, "served")
    released = [bool(reg.release_scene(gt0)) for reg in registries.values()]
    out_after = probe_rtr.infer_image(fr0, deadline_ms=deadline_ms)
    outcome_witness.observe(None, "served")
    breaker_probe = {
        "tripped_scene": gt0,
        "winner_before": out_before["retrieval"]["scene"],
        "candidates_before": out_before["retrieval"]["candidates"],
        "candidates_tripped": out_tripped["retrieval"]["candidates"],
        "tripped_excluded": gt0 not in out_tripped["retrieval"]["candidates"],
        "tripped_skipped_delta": probe_front.stats()["tripped_skipped"] - skipped_before,
        "released_everywhere": all(released),
        "bit_identical_restore": bool(out_after["retrieval"] == out_before["retrieval"]
                                      and same(out_after, out_before)),
    }

    # ---- probe B (LAST -- lane fallout stays off every measurement):
    # every candidate dispatch dies typed -> the image request must fail
    # as RetrievalCandidatesExhaustedError on a committed edge.
    for inj in injectors.values():
        inj.fail_times(SceneLoadError("city drill: staged weights refused to load"), times=32)
    try:
        probe_rtr.infer_image(fr0, deadline_ms=deadline_ms)
    except RetrievalCandidatesExhaustedError as e:
        outcome_witness.observe(type(e).__name__, "failed")
        exhausted_probe = {"raised": True, "type": type(e).__name__,
                           "retryable": bool(e.retryable), "wire_name": e.wire_name}
    else:
        exhausted_probe = {"raised": False}

    compiled_after = (sum(r.compile_cache_size() for r in registries.values())
                      + int(fn._cache_size()))
    prefetch_feeds = {name: reg._prefetcher.stats().get("posterior_feeds")
                      for name, reg in registries.items()}
    obs_snapshot = probe_rtr.obs.snapshot()
    store = probe_rtr.obs.get_trace_store()
    probe_traces = [t for t in store.traces() if t.done] if store is not None else []
    if probe_traces:
        max_residual = max(max_residual, max(t.residual() for t in probe_traces))
        sampled_total += len(probe_traces)
    trace_evidence = {
        "sample_1_in": policy.trace_sample,
        "sampled": sampled_total,
        "max_abs_residual_s": max_residual if sampled_total else None,
        "telescoping_exact": bool(sampled_total and max_residual < 1e-6),
        "exemplar_slow_traces": exemplar_traces,
    }
    probe_rtr.close(close_replicas=True)

    lock_witness, _ = lock_witness_block(witness)
    outcome_witness.assert_consistent()
    gc_block = {
        "frozen": True,
        "collections_during_run": [int(a["collections"] - b["collections"])
                                   for a, b in zip(gc.get_stats(), gc_before)],
    }
    gc.unfreeze()

    return {
        "scenes": {"n": CITY_SCENES, "hw": [H, W], "num_experts": M, "n_hyps": CITY_HYPS,
                   "frame_bucket": CITY_BUCKET},
        "replicas": CITY_REPLICAS,
        "retriever": {
            "embed_dim": CITY_EMBED, "max_scenes": CITY_MAX_SCENES,
            "channels": [4, 8], "temperature": rcfg.temperature,
            "train_steps": train_steps, "train_s": round(train_s, 2),
            "final_loss": round(final_loss, 4) if final_loss is not None else None,
            "enroll_refs_per_scene": 4,
        },
        "calibration": calibration,
        "weight_cache": {
            "budget_bytes": budget_bytes, "scene_bytes": scene_bytes,
            "oversubscription_x": CITY_OVERSUB_X, "resident_scenes_max": int(resident_max),
        },
        "closed_loop_dispatch_ms": round(dispatch_s * 1e3, 2),
        "deadline_ms": round(deadline_ms, 1),
        "watchdog_ms": round(watchdog_ms, 1),
        "query_mix": {"easy": CITY_EASY, "hard": CITY_HARD, "junk": CITY_JUNK,
                      "easy_noise": 0.05, "hard_noise": 0.35},
        "legs": legs,
        "probes": {"breaker": breaker_probe, "exhausted": exhausted_probe},
        "posterior_prefetch_feeds": prefetch_feeds,
        "compiled_programs": {
            "before_load": compiled_before,
            "after_drill": compiled_after,
            "hot_path_recompiles": compiled_after - compiled_before,
        },
        "lock_witness": lock_witness,
        "fault_taxonomy": outcome_witness.snapshot(),
        "gc": gc_block,
        "obs_snapshot": obs_snapshot,
        "traces": trace_evidence,
        "note": (
            "image-only requests over a procedural city fleet at "
            f"{CITY_OVERSUB_X}x weight-cache oversubscription; the retriever is fit "
            "at bench-prep time (symmetric InfoNCE, junk negatives) because a "
            "random-init embedder gives a near-uniform posterior; recall@K counts "
            "misses against; junk and heavy-noise confidences overlap, so the "
            "calibrated floor sheds MOST junk -- the per-mix tables report the "
            "overlap.  winner_accuracy is a pose PROXY (winner-scene agreement): "
            "experts are random-init, so cross-scene soft-inlier scores are weak "
            "evidence -- recall@K is the retrieval metric.  Tiny scenes: latencies "
            "measure scheduling, not throughput."
        ),
    }


def city_headline(city: dict) -> dict:
    legs = {str(leg["top_k"]): leg for leg in city["legs"]}
    return {
        "metric": "city_recall_at_2",
        "value": legs["2"]["recall_at_k"],
        "unit": "recall",
        "vs_baseline": None,
        "recall_by_k": {k: leg["recall_at_k"] for k, leg in legs.items()},
        "winner_accuracy_k2": legs["2"]["winner_accuracy_served"],
        "served_p99_ms_k2": legs["2"]["served_p99_ms"],
        "accounting_exact": all(leg["accounting_exact"] and leg["fleet_accounting_exact"]
                                for leg in city["legs"]),
        "min_confidence": city["calibration"]["min_confidence"],
        "breaker_bit_identical_restore": city["probes"]["breaker"]["bit_identical_restore"],
        "hot_path_recompiles": city["compiled_programs"]["hot_path_recompiles"],
    }
