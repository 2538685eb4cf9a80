"""``sessions`` mode (counterpart of ``bench.py``'s ``_measure_sessions``): the
temporal-session serving drill (DESIGN.md §23), four legs over the
warm-start session lane.

1. PARITY + TRANSITIONS: one registry scene with the prior-slot ladder
   prewarmed (``prewarm_programs(prior_slots=...)``); the all-invalid prior
   function compared BIT FOR BIT against the plain dense AND routed
   functions at the entry level and through a live worker-backed
   dispatcher, then a tracked -> lost -> recovered flap drill with the
   batch-signature count pinning no new signature, typed session-error
   probes, and the ``session:track_loss`` trace event.
2. SEQUENCE THROUGHPUT: a continuous SyntheticScene trajectory served
   coords-level through a SessionTable -- tracked frames at the shrunken
   budget with motion priors against the full-budget baseline; frames/s
   and pose accuracy per lane.
3. RECOVERY: the same sequence with one mid-sequence corrupted frame --
   the track loss is typed and accounted and the NEXT frame's full-budget
   fallback recovers pose accuracy within one frame.
4. SESSION LOADTEST: concurrent sessions as the unit of offered load over
   the live dispatcher -- exact session-level outcome accounting per point,
   under the lock and outcome witnesses.

``seq_frames`` (the trajectory's length) and ``load_frames`` (frames per
session in leg 4) are the only counts a caller may cut."""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import torch

from esac_tpu_torch.bench.constants import (
    SESSIONS_FULL_HYPS,
    SESSIONS_HW,
    SESSIONS_LOAD_FRAMES,
    SESSIONS_LOAD_SESSIONS,
    SESSIONS_M,
    SESSIONS_PRIOR_SLOTS,
    SESSIONS_SEQ_FRAMES,
    SESSIONS_SEQ_FULL,
    SESSIONS_SEQ_TRACK,
    SESSIONS_TRACK_HYPS,
)
from esac_tpu_torch.bench.fixtures import (
    REQUEST_SEED,
    ROOT,
    fence,
    image,
    lock_witness_block,
    scratch_dir,
    tiny_preset,
    write_scene,
)
from esac_tpu_torch.data.datasets import SyntheticScene
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.geometry.camera import pose_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.lint.witness import LockWitness, OutcomeWitness
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import esac_infer_prior
from esac_tpu_torch.registry.manifest import SceneManifest
from esac_tpu_torch.registry.serving import SceneRegistry
from esac_tpu_torch.serve.batching import MIN_LANES
from esac_tpu_torch.serve.session import (
    SessionEvictedError,
    SessionPolicy,
    SessionRouter,
    SessionTable,
    SessionUnknownError,
)
from esac_tpu_torch.serve.slo import ServeError, ShedError, SLOPolicy
from esac_tpu_torch.utils.precision import resolve_device


def measure_sessions(seq_frames: int = SESSIONS_SEQ_FRAMES,
                     load_frames: int = SESSIONS_LOAD_FRAMES, device=None) -> dict:
    dev = resolve_device(device)
    with scratch_dir("esac_sessions_") as root:
        return _measure_sessions_at(root, seq_frames, load_frames, dev)


def _measure_sessions_at(root, seq_frames: int, load_frames: int, dev) -> dict:
    H = SESSIONS_HW
    M = SESSIONS_M
    P = SESSIONS_PRIOR_SLOTS
    preset = tiny_preset(H, M)
    cfg = RansacConfig(n_hyps=SESSIONS_FULL_HYPS, refine_iters=2, polish_iters=1,
                       frame_buckets=(1,), serve_max_wait_ms=0.0, serve_queue_depth=64)
    manifest = SceneManifest()
    manifest.add(write_scene(root, "scene0", preset, cfg, seed=0, center_step=0.0))
    reg = SceneRegistry(manifest, device=dev)

    # Witness wiring BEFORE any traffic: the session table is a committed
    # LEAF lock -- the loadtest's concurrent sessions must show no edge
    # through it.
    witness = LockWitness()
    witness.attach_fleet(registry=reg)
    outcome_witness = OutcomeWitness.from_repo(ROOT)

    # The full session function ladder, off the hot path: {dense, routed} x
    # {full budget, tracked override} x {plain, prior-slot sibling}.
    compiled_prewarm = reg.prewarm_programs(
        "scene0", frame_buckets=(1,), route_ks=(None, M),
        n_hyps_overrides=(None, SESSIONS_TRACK_HYPS), prior_slots=P)

    # ---- leg 1a: entry-level parity through the registry serve fn ----
    serve = reg.infer_fn()
    B = max(1, MIN_LANES)

    def mk_plain():
        return {"seed": np.arange(11, 11 + B, dtype=np.int64),
                "image": torch.from_numpy(np.random.default_rng(5).random(
                    (B, H, H, 3), dtype=np.float32)).to(dev)}

    def mk_prior():
        b = mk_plain()
        b["prior_rvec"] = torch.zeros((B, P, 3), device=dev)
        b["prior_tvec"] = torch.zeros((B, P, 3), device=dev)
        b["prior_valid"] = torch.zeros((B, P), dtype=torch.bool, device=dev)
        return b

    entry_parity = {}
    for label, rk in (("dense", None), (f"routed_k{M}", M)):
        out_plain = serve(mk_plain(), "scene0", route_k=rk)
        out_prior = serve(mk_prior(), "scene0", route_k=rk)
        fence(dev)
        keys_cmp = [k for k in ("rvec", "tvec", "expert", "inlier_frac", "gating_probs",
                                "scores") if k in out_plain and k in out_prior]
        entry_parity[label] = {
            "bitwise_equal": all(torch.equal(out_prior[k], out_plain[k]) for k in keys_cmp),
            "keys_compared": keys_cmp,
            "prior_hit_any": bool(out_prior["prior_hit"].any()),
        }

    # ---- leg 1b: dispatcher-level parity + the flap drill ----
    slo = SLOPolicy(deadline_ms=120_000.0, watchdog_ms=600_000.0)
    disp = reg.dispatcher(cfg, slo=slo, trace=True, start_worker=False)
    witness.attach_fleet(disp=disp)
    disp.start()

    def frame(i):
        return {"seed": np.int64(REQUEST_SEED + i), "image": image(i % 4, H)}

    # A never-tracking session: its frames ride the session lane (prior
    # leaves attached, all-invalid) at the FULL budget -- bitwise equal to
    # the plain lane is the dispatcher-level parity pin.
    cold = SessionRouter(disp, SessionPolicy(prior_slots=P, track_n_hyps=SESSIONS_TRACK_HYPS,
                                             track_loss_frac=0.5, track_enter_frac=0.999,
                                             max_sessions=64))
    cold.open("parity", scene="scene0", full_n_hyps=SESSIONS_FULL_HYPS)
    out_direct = disp.infer_one(frame(0), scene="scene0")
    out_session = cold.infer_frame("parity", frame(0))
    disp_parity = all(np.array_equal(np.asarray(out_session[k]), np.asarray(out_direct[k]))
                      for k in ("rvec", "tvec", "expert", "inlier_frac"))
    f_full = float(np.asarray(out_direct["inlier_frac"]))

    # Flap policy: the entry bar below the full-budget fraction, the loss
    # bar (almost surely) above the tracked-budget fraction -- each full
    # frame re-enters tracking, each tracked frame flaps to lost.  A
    # degenerate policy ON PURPOSE: it forces every tracked -> lost ->
    # recovered transition through the live dispatcher.
    enter = max(min(f_full * 0.5, 0.999), 1e-9)
    loss_bar = min(0.999, max(f_full * 2.0, 0.25))
    flap_policy = SessionPolicy(prior_slots=P, track_n_hyps=SESSIONS_TRACK_HYPS,
                                track_loss_frac=loss_bar, track_enter_frac=enter,
                                max_sessions=64)
    router = SessionRouter(disp, flap_policy)
    witness.attach_fleet(session_router=router)
    router.open("flap", scene="scene0", full_n_hyps=SESSIONS_FULL_HYPS)
    seeded = False
    if f_full <= 0.0:
        # Degenerate probe (zero soft-inlier mass): seed the tracked state
        # directly so the flap drill still runs the tracked lane.
        router.table.observe("flap", np.zeros(3, np.float32), np.zeros(3, np.float32), 1.0,
                             was_tracked=False)
        seeded = True
    compiled_before_flap = reg.compile_cache_size()
    transitions, tracked_flags = [], []
    for i in range(8):
        out = router.infer_frame("flap", frame(i))
        transitions.append(out["session_transition"])
        tracked_flags.append(bool(out["session_tracked"]))
    compiled_after_flap = reg.compile_cache_size()
    recovery_ok = all(not tracked_flags[i + 1]
                      for i in range(len(transitions) - 1) if transitions[i] == "lost")

    # ---- leg 1c: typed session errors + the track-loss trace event ----
    typed_errors = {}
    try:
        router.infer_frame("never-opened", frame(0))
    except SessionUnknownError as e:
        typed_errors["unknown"] = {"error": type(e).__name__, "wire_name": e.wire_name,
                                   "retryable": e.retryable}
    tiny = SessionRouter(disp, dataclasses.replace(flap_policy, max_sessions=1))
    tiny.open("a", scene="scene0", full_n_hyps=SESSIONS_FULL_HYPS)
    tiny.open("b", scene="scene0", full_n_hyps=SESSIONS_FULL_HYPS)
    try:
        tiny.infer_frame("a", frame(0))
    except SessionEvictedError as e:
        typed_errors["evicted"] = {"error": type(e).__name__, "wire_name": e.wire_name,
                                   "retryable": e.retryable, "is_shed": isinstance(e, ShedError)}
        outcome_witness.observe("SessionEvictedError", "shed")
    snap_a = disp.obs.snapshot()
    # Count over the FULL retained ring: tracked (lost) dispatches run the
    # shrunken budget, so track-loss traces are the fast ones.
    loss_events = sum(1 for t in disp._trace_store.traces() for s in list(t.spans)
                      if s.name == "session:track_loss")
    disp.close()

    leg_parity = {
        "prewarm_compiled_programs": compiled_prewarm,
        "entry": entry_parity,
        "dispatcher_bitwise": bool(disp_parity),
        "probe_inlier_frac_full": f_full,
        "flap_policy": {"enter_frac": enter, "loss_frac": loss_bar, "seeded_tracked": seeded},
        "transitions": transitions,
        "tracked_dispatches": tracked_flags,
        "track_losses": int(router.table.track_losses),
        "recovery_full_budget_next_frame": bool(recovery_ok),
        "hot_path_recompiles": compiled_after_flap - compiled_prewarm,
        "recompiles_during_flap": compiled_after_flap - compiled_before_flap,
        "typed_errors": typed_errors,
        "track_loss_trace_events": loss_events,
    }

    # ---- leg 2: continuous-trajectory sequence throughput ----
    SH, SW, stride = 96, 128, 8
    F = seq_frames
    ds = SyntheticScene("synth0", split="trajectory", n_frames=F, height=SH, width=SW,
                        coord_stride=stride, device=dev)
    pixels = output_pixel_grid(SH, SW, stride, device=dev)
    N = int(pixels.shape[0])
    focal = torch.tensor(ds.focal, device=dev)
    center = torch.tensor([SW / 2.0, SH / 2.0], device=dev)
    rng = np.random.default_rng(20)
    gts = [ds[i].coords_gt.reshape(N, 3).cpu().numpy() for i in range(F)]

    def expert_coords(i, wrecked=False):
        """Imperfect-expert model over the ground-truth geometry: Gaussian
        noise + shuffled-correspondence outliers (expert 0), a fully
        shuffled junk map (expert 1); ``wrecked`` shuffles expert 0 too."""
        gt = gts[i]
        noisy = gt + rng.normal(0.0, 0.01, gt.shape).astype(np.float32)
        mask = rng.random(N) < (1.0 if wrecked else 0.25)
        noisy[mask] = gt[rng.permutation(N)][mask]
        junk = gt[rng.permutation(N)] + rng.normal(0.0, 0.05, gt.shape).astype(np.float32)
        return np.stack([noisy, junk])  # (M=2, N, 3)

    coords_seq = [expert_coords(i) for i in range(F)]
    logits = torch.tensor([2.0, -2.0], device=dev)
    cfg_full = RansacConfig(n_hyps=SESSIONS_SEQ_FULL, refine_iters=4, polish_iters=2)
    cfg_track = dataclasses.replace(cfg_full, n_hyps=SESSIONS_SEQ_TRACK)
    seq_policy = SessionPolicy(prior_slots=P, track_n_hyps=SESSIONS_SEQ_TRACK,
                               track_loss_frac=0.10, track_enter_frac=0.25, max_sessions=8)

    def run_frame(i, coords, p_rv, p_tv, p_valid, cfg_i):
        gen = torch.Generator(device=dev).manual_seed(33_000 + i)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = esac_infer_prior(gen, logits, torch.from_numpy(coords).to(dev), pixels, focal,
                                   center, p_rv, p_tv, p_valid, cfg_i, device=dev)
        fence(dev)
        dt = time.perf_counter() - t0
        r_err, t_err = pose_errors(rodrigues(out["rvec"]), out["tvec"], rodrigues(ds[i].rvec),
                                   ds[i].tvec)
        return out, dt, float(r_err), float(t_err)

    no_rv = np.zeros((P, 3), np.float32)
    no_valid = np.zeros((P,), bool)
    # Warm both budgets off the timed loops.
    for cfg_w in (cfg_full, cfg_track):
        run_frame(0, coords_seq[0], no_rv, no_rv, no_valid, cfg_w)

    def session_pass(coords_by_frame):
        table = SessionTable(seq_policy)
        table.open("seq", scene=None, full_n_hyps=SESSIONS_SEQ_FULL)
        per = []
        for i in range(F):
            _, _, _, p_rv, p_tv, p_valid, tracked = table.plan("seq")
            out, dt, r_err, t_err = run_frame(i, coords_by_frame[i], p_rv, p_tv, p_valid,
                                              cfg_track if tracked else cfg_full)
            transition = table.observe("seq", out["rvec"].cpu().numpy(),
                                       out["tvec"].cpu().numpy(),
                                       float(out["inlier_frac"]), tracked)
            per.append({"dt": dt, "tracked": tracked, "transition": transition,
                        "rot_deg": r_err, "trans_m": t_err,
                        "prior_hit": bool(out["prior_hit"])})
        return per, table

    def baseline_pass(coords_by_frame):
        per = []
        for i in range(F):
            _, dt, r_err, t_err = run_frame(i, coords_by_frame[i], no_rv, no_rv, no_valid,
                                            cfg_full)
            per.append({"dt": dt, "rot_deg": r_err, "trans_m": t_err})
        return per

    def med(xs):
        return float(np.median(xs)) if xs else None

    base = baseline_pass(coords_seq)
    sess, seq_table = session_pass(coords_seq)
    t_idx = [i for i, p in enumerate(sess) if p["tracked"]]
    tracked_ms = med([sess[i]["dt"] * 1e3 for i in t_idx])
    full_ms = med([p["dt"] * 1e3 for p in base])
    speedup = (full_ms / tracked_ms) if tracked_ms else None
    rot_t, rot_f = med([sess[i]["rot_deg"] for i in t_idx]), med([base[i]["rot_deg"]
                                                                 for i in t_idx])
    trans_t, trans_f = med([sess[i]["trans_m"] for i in t_idx]), med([base[i]["trans_m"]
                                                                     for i in t_idx])
    accuracy_matched = t_idx != [] and rot_t <= rot_f + 0.5 and trans_t <= trans_f + 0.02
    sequence = {
        "frames": F, "n_cells": N,
        "full_n_hyps": SESSIONS_SEQ_FULL,
        "track_n_hyps": SESSIONS_SEQ_TRACK,
        "prior_slots": P,
        "tracked_frames": len(t_idx),
        "tracked_frac": round(len(t_idx) / F, 4),
        "prior_hit_frac_tracked": (round(float(np.mean([sess[i]["prior_hit"] for i in t_idx])),
                                         4) if t_idx else None),
        "tracked_ms_median": round(tracked_ms, 3) if tracked_ms else None,
        "full_ms_median": round(full_ms, 3),
        "tracked_fps": round(1e3 / tracked_ms, 2) if tracked_ms else None,
        "full_fps": round(1e3 / full_ms, 2),
        "tracked_speedup_x": round(speedup, 2) if speedup else None,
        "pose_accuracy": {
            "tracked_median_rot_deg": rot_t,
            "full_median_rot_deg": rot_f,
            "tracked_median_trans_m": trans_t,
            "full_median_trans_m": trans_f,
        },
        "accuracy_matched": bool(accuracy_matched),
        "budget_saved_hyps": seq_table.stats()["budget_saved_hyps"],
        "transitions": [p["transition"] for p in sess],
    }

    # ---- leg 3: recovery after loss (mid-sequence corruption) ----
    j = F // 2
    coords_bad = list(coords_seq)
    coords_bad[j] = expert_coords(j, wrecked=True)
    wrecked, wreck_table = session_pass(coords_bad)
    lost_at_j = wrecked[j]["transition"] == "lost"
    fallback_full = not wrecked[j + 1]["tracked"]
    recovered = wrecked[j + 1]["rot_deg"] < 5.0 and wrecked[j + 1]["trans_m"] < 0.05
    recovery = {
        "corrupted_frame": j,
        "tracked_at_corruption": bool(wrecked[j]["tracked"]),
        "loss_transition_at_corruption": bool(lost_at_j),
        "track_losses_accounted": wreck_table.stats()["track_losses"],
        "fallback_full_budget_next_frame": bool(fallback_full),
        "next_frame_rot_deg": wrecked[j + 1]["rot_deg"],
        "next_frame_trans_m": wrecked[j + 1]["trans_m"],
        "recovered_within_one_frame": bool(lost_at_j and fallback_full and recovered),
        "retracked_after_recovery": "tracked" in [p["transition"] for p in wrecked[j + 1:]],
    }

    # ---- leg 4: sessions as the unit of offered load ----
    load_policy = SessionPolicy(prior_slots=P, track_n_hyps=SESSIONS_TRACK_HYPS,
                                track_loss_frac=1e-6, track_enter_frac=enter, max_sessions=64)
    points = []
    for S in sorted(SESSIONS_LOAD_SESSIONS):
        disp_l = reg.dispatcher(cfg, slo=SLOPolicy(deadline_ms=60_000.0, watchdog_ms=600_000.0),
                                start_worker=False)
        router_l = SessionRouter(disp_l, load_policy)
        witness.attach_fleet(disp=disp_l, session_router=router_l)
        disp_l.start()
        counts = collections.Counter()
        mu = threading.Lock()

        def stream(sid, router_l=router_l, counts=counts, mu=mu):
            for i in range(load_frames):
                try:
                    router_l.infer_frame(sid, frame(i), 60.0)
                    with mu:
                        counts["served"] += 1
                except ServeError as e:  # typed outcome accounting
                    with mu:
                        counts[getattr(e, "wire_name", type(e).__name__)] += 1

        for s in range(S):
            router_l.open(f"s{s}", scene="scene0", full_n_hyps=SESSIONS_FULL_HYPS)
        threads = [threading.Thread(target=stream, args=(f"s{s}",), daemon=True)
                   for s in range(S)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600.0)
        wall = time.perf_counter() - t0
        stats = router_l.table.stats()
        offered = S * load_frames
        snap_l = disp_l.obs.snapshot()
        disp_l.close()
        points.append({
            "sessions": S,
            "frames_per_session": load_frames,
            "offered": offered,
            "outcomes": dict(counts),
            "sums_to_offered": sum(counts.values()) == offered,
            "wall_s": round(wall, 3),
            "frames_per_s": round(offered / wall, 2),
            "tracked_frac": stats["tracked_frac"],
            "track_entries": stats["track_entries"],
            "budget_saved_hyps": stats["budget_saved_hyps"],
            "session_collector_rendered": "session" in snap_l.get("collectors", {}),
            "compiled_programs": reg.compile_cache_size(),
        })
    loadtest = {"points": points,
                "hot_path_recompiles": points[-1]["compiled_programs"] - compiled_prewarm}

    # ---- witnesses: observed lock order + fault flow vs committed ----
    lock_witness, witness_snap = lock_witness_block(witness)
    lock_witness["session_lock_observed"] = any("SessionTable._lock" in str(k)
                                                for k in witness_snap["holds"])
    fault_taxonomy = outcome_witness.snapshot()
    outcome_witness.assert_consistent()

    return {
        "prior_slots": P,
        "scene": {"hw": [H, H], "num_experts": M, "full_n_hyps": SESSIONS_FULL_HYPS,
                  "track_n_hyps": SESSIONS_TRACK_HYPS},
        "parity": leg_parity,
        "sequence": sequence,
        "recovery": recovery,
        "loadtest": loadtest,
        "lock_witness": lock_witness,
        "fault_taxonomy": fault_taxonomy,
        "obs_snapshot": snap_a,
        "note": (
            "leg 1 pins the parity contract (all-invalid prior mask bitwise == plain "
            "dense AND routed, entry-level and through a live dispatcher) and no new "
            "batch signature across tracked/lost/recovered flaps on an untrained "
            "registry scene; leg 2 measures the warm-start lever on a continuous "
            "trajectory at coords level (imperfect-expert noise model; the SPEEDUP "
            "RATIO is the measurement, not absolute fps); leg 3 corrupts one "
            "mid-sequence frame and requires full-budget recovery within one frame; "
            "leg 4 streams concurrent sessions closed-loop with exact typed outcome "
            "accounting under the committed lock-graph and fault-taxonomy witnesses"
        ),
    }


def sessions_headline(sessions: dict) -> dict:
    seq = sessions["sequence"]
    par = sessions["parity"]
    return {
        "metric": "session_tracked_speedup_x",
        "value": seq["tracked_speedup_x"],
        "unit": "x",
        "vs_baseline": None,
        "tracked_frac": seq["tracked_frac"],
        "accuracy_matched": seq["accuracy_matched"],
        "parity_bitwise_entry": all(leg["bitwise_equal"] for leg in par["entry"].values()),
        "parity_bitwise_dispatcher": par["dispatcher_bitwise"],
        "hot_path_recompiles": max(par["hot_path_recompiles"],
                                   sessions["loadtest"]["hot_path_recompiles"]),
        "recovered_within_one_frame": sessions["recovery"]["recovered_within_one_frame"],
        "accounting_exact": all(p["sums_to_offered"] for p in sessions["loadtest"]["points"]),
    }
