#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (esac_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--out results/chip_smoke.json]

Phases, each printed as it runs; any failure exits non-zero with no result:

1. device     -- torch's device name and nvidia-smi's name and power limit;
2. build      -- nvcc builds every kernel from esac_tpu_torch/csrc (seconds,
                 ptxas report);
3. kernels    -- each CUDA kernel against its plain PyTorch version on the
                 card, at the serving shapes (P = 4 frames x 7 experts,
                 H = 256, N = 4800), at the 16-frame and 1-frame serving
                 buckets (P = 112, P = 7), at the training shape of phase 6
                 (P = 14), at ragged shapes (H = 40, N = 300), at the routed
                 K = 2 shape (P = 4 frames x 2 maps, H = 896) and at the
                 prior-slot shape (P = 28, H = 4 poses): scores
                 allclose (rtol 1e-5, atol 1e-3: the same float32 formula
                 summed in another order), winner index equal where the top
                 two plain scores are further apart than that tolerance,
                 crafted ties resolving to the first index through both
                 kernels, the winner's pose row bit-equal to its input row,
                 two calls of each kernel bit-identical, and the scoring
                 kernel's scores at the select kernel's winner bit-equal to
                 its best score, with its argmax equal to that winner (the
                 two share one partial pass); CUDA-event times of each
                 wrapper, of each kernel's launch alone on operands packed
                 once, and of the plain version;
4. recovery   -- synthetic frames built here from --seed (GT pose, cell
                 coordinates back-projected at random depths, 2 cm noise,
                 30% outliers) through dsac_infer and esac_infer_frames
                 (7 maps, one true) under "fused_select": the refined pose is
                 within 5 cm / 5 deg and the true map wins; then
                 esac_infer_frames_prior with 4 hypotheses a map under
                 "fused_select" and "pallas": a valid prior at the GT pose
                 wins (prior_hit, its slot, not the invalid copy in another
                 slot, the pose within 5 cm / 5 deg) and an all-invalid
                 slate leaves the sampled stream the winner;
5. serving    -- the full-width 7-expert preset at 640x480 (ref widths,
                 bf16 CNNs, weights from the port's own init at --seed)
                 answers requests of 1, 3, 5 and 16 frames, planned and padded
                 into the (1, 4, 16, 64) buckets, under "fused_select" and
                 "pallas" on the same seeds, and under the plain "errmap"
                 path; "pallas" and "fused_select" give bit-equal winning
                 scores and experts, "errmap" agrees within the tolerance.
                 Across buckets: one set of synthetic coordinates and seeds
                 through esac_infer_frames at 2, 4 and 16 lanes must be bit-
                 identical (the RANSAC stage); every frame of the requests
                 served alone is compared with its row in the 4- and 16-lane
                 dispatches end to end, and the CNN stage alone (max |diff|
                 reported).  Routed (make_routed_scene_bucket_fn) on the same
                 dispatches: K = 7 bit-equal to make_scene_bucket_fn; K = 2
                 "pallas" and "fused_select" bit-equal winners, "errmap"
                 within the tolerance on one dispatch, each frame alone
                 bit-equal to its row in a larger bucket on every output but
                 gating_probs (reported apart); an overflow dispatch
                 (capacity 2, 4 copies of one image): frames 2-3 evaluate the
                 sentinel 7 in every slot with finite poses and -inf scores,
                 frames 0-1 bit-equal to a 2-frame dispatch; a prior batch (4
                 slots, all invalid) through both bucket functions bit-equal
                 to the plain dispatch; stage times of a routed K = 2
                 dispatch at 4 and 16 lanes;
6. training   -- (a) both kernels' autograd Functions at P = 2 frames x 7
                 experts, H = 256, N = 4800: the forwards against the plain
                 versions (the tolerance of phase 3) and against a second
                 call (bit-identical); gradients with respect to Rs, ts and
                 coords against autograd of the plain versions on the card
                 (max |err| <= 1e-5 of the largest entry: the same plain
                 formula, the shared coords gradient summed in another
                 order), the select's zero outside the winners' rows;
                 CUDA-event times of the kernel forward, the Function's
                 backward (the plain recompute) and the plain forward +
                 backward.  (b) 3 full-width training steps
                 (make_esac_train_step: the phase-5 preset in train mode,
                 2 synthetic frames a step, n_hyps 256, one refine round,
                 alpha 0.5, Adam at lr 3e-6 after a clip to norm 1.0) under
                 "pallas" and under "errmap" from the same weights and
                 seeds: finite losses, finite gradients, a non-zero
                 gradient on every expert and on the gating net, first-step
                 losses of the two impls within rtol 1e-3; the step time,
                 its split into stages (CUDA events recorded by the step's
                 own stage hook), peak memory, and one "pallas" step under
                 torch.profiler (device busy time, idle share, the ops
                 with the most device time);
7. workflow   -- the three training stages and the evaluation through the
                 scripts' own main(argv) (esac_tpu_torch/scripts), in a
                 temporary directory, at the --size ref widths and 640x480
                 on seven synthetic scenes (synth0-synth6, config #2's
                 M = 7) of 8 frames: train_expert for each scene (3
                 iterations, batch 2), train_gating over the seven (3
                 iterations), train_esac under "pallas" (256 hypotheses,
                 batch 2, 4 iterations run as --stop-after 2, then
                 --resume), test_esac under "pallas" (256 hypotheses,
                 --eval-batch 4, --limit 2, --json) dense and with
                 --topk 2.  Every main returns 0, every checkpoint reloads
                 into its modules, the resumed run starts at iteration 2 with
                 Adam's step count 2 and ends at 4, every printed loss is
                 finite, the JSON has every key of the JAX script's, and the
                 kernels launch exactly as WORKFLOW_LAUNCHES says;
8. server     -- the serving front end (esac_tpu_torch.serve.dispatcher,
                 esac_tpu_torch.registry.serving.SceneRegistry) on phase 5's
                 preset under "fused_select": four random-init scene versions
                 (a v1, a v2, b v1 and a v3 with NaN expert weights) written
                 as registry checkpoints in a temporary directory, checksummed
                 (compute_entry_checksums), served by
                 SceneRegistry(manifest, budget of 1.5 scenes' bytes)
                 .dispatcher(cfg) after prewarm_programs.  (1) infer_many of
                 21 frames follows plan_dispatches and each frame is bit-equal
                 to the registry's bucket function on the same padded batch;
                 (2) 24 infer_one calls from 8 threads are all served, finite,
                 in fewer dispatches than requests, the outcome counts summing
                 to offered; (3) the closed-loop rate (infer_many of 64 frames),
                 then 200 Poisson requests at half of it through
                 run_open_loop (every one served; p50 / p99 / goodput), then
                 an overload drill of 100 requests at twice it with an
                 SLOPolicy (queue of 16, 250 ms deadline): sheds and expiries
                 typed, outcomes summing to offered, done within its settle
                 time; (4) a promoted to v2 while requests run: results after
                 it bit-equal to v2's bucket function, batch signatures
                 unchanged; (5) serving b evicts a (torch.cuda.memory_allocated
                 drops by at least 90% of a's bytes) and a reloads bit-equal;
                 (6) route_k = 2 through the registry bit-equal to
                 make_routed_scene_bucket_fn; (7) promoting the NaN version
                 trips its breaker from the deferred probes and rolls back to
                 v2, served bit-equal; (8) every check's select launches equal
                 the dispatches the dispatcher's counters record, no score
                 launch.

Around every call of an entry point in phases 4-6 the kernels' launch
counters are set to 0 just before and read just after: a "fused_select"
call must launch the select kernel exactly once and the scoring kernel
never, a "pallas" call the reverse, an "errmap" call neither -- routed
calls too; a prior-slot "pallas" call launches the scoring kernel twice
(sampled stream, then priors), a prior-slot "fused_select" call the select
kernel once (the priors take the plain error-map math, as in the
reference); a training step counts as one call (its backward launches
nothing).

Before the last line it prints one JSON line {"training": {...}}, one JSON
line {"workflow": {...}}, one JSON line {"server": {...}}, one JSON line
{"kernels": [...]} and the
nvidia-smi name/power-limit line; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SCORE_TOL = dict(rtol=1e-5, atol=1e-3)
# Published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores and HBM3 bandwidth.  The special-function-unit rate
# (16 per SM per clock x 132 SMs x 1.98 GHz boost) is not in that table; the
# SFU bound it gives goes to --out only, beside the measured numbers.
FP32_PEAK = 67e12
HBM_BPS = 3.35e12
SFU_PEAK = 16 * 132 * 1.98e9
# FP32 operations per (hypothesis, cell) pair of the scoring function itself
# (the plain formula, as the TPU kernel computes it), not of one kernel's
# instruction mix: R X + t (9 mul + 9 add), max, 2 mul by f, 2 divisions,
# 4 add/sub of c and the pixel, du^2 + dv^2 + eps (4), sqrt, compare +
# select of the penalty (2), beta * (tau - err) (2), negate, exp, 1 + e,
# reciprocal, the running sum.  Of these, 2 divisions, sqrt, exp and the
# reciprocal (5) go through the special function units.
OPS_PER_PAIR = 41
SFU_PER_PAIR = 5


KERNEL_SHAPES = {  # label: (frames, maps, hypotheses, height, width)
    "serving": (4, 7, 256, 480, 640),
    "frames16": (16, 7, 256, 480, 640),
    # Phase 8's closed and open loops fill the largest frame bucket.
    "frames64": (64, 7, 256, 480, 640),
    "frames1": (1, 7, 256, 480, 640),
    "train": (2, 7, 256, 480, 640),
    "ragged": (3, 1, 40, 120, 160),
    # Routed K = 2 of M = 7: 4 frames x 2 maps x 7 * 256 // 2 hypotheses.
    "routed_k2": (4, 2, 896, 480, 640),
    # The other routed K = 2 buckets phase 8's prewarm_programs runs (a
    # 1-frame bucket stages 2 lanes).
    "routed_k2_lanes2": (2, 2, 896, 480, 640),
    "routed_k2_frames16": (16, 2, 896, 480, 640),
    "routed_k2_frames64": (64, 2, 896, 480, 640),
    # Phase 7's `test_esac --topk 2 --eval-batch 4`: the 4 x 2 gathered maps
    # at the configured 256 hypotheses.
    "eval_topk2": (4, 2, 256, 480, 640),
    # A prior-slot batch: 4 frames x 7 maps x 4 prior poses (launch-bound).
    "prior": (4, 7, 4, 480, 640),
}
SERVING_SIZE = dict(height=480, width=640, arch="ref")
# Phase 6: the Functions' shape (frames, maps, hypotheses, height, width)
# and the training run (BASELINE config #2 at full width, as
# train_esac.py:139-141 configures RANSAC, with its fine-tune recipe).
TRAIN_FUNCTION_SHAPE = (2, 7, 256, 480, 640)
TRAIN_SIZE = dict(height=480, width=640, arch="ref", experts=7, frames=2, steps=3,
                  n_hyps=256, lr=3e-6, clip_norm=1.0)
GRAD_RTOL = 1e-5
STEP_LOSS_RTOL = 1e-3
# Phase 7: the workflow at full width (config #2's seven scenes).
WORKFLOW = dict(size="ref", height=480, width=640, scenes=7, frames=8, batch=2,
                expert_iterations=3, gating_iterations=3, esac_iterations=4, stop_after=2,
                hypotheses=256, eval_batch=4, limit=2, topk=2)


def log(*parts) -> None:
    print(*parts, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps=20, warmup=3) -> float:
    """Mean milliseconds per call: CUDA events around ``reps`` calls after
    ``warmup`` calls (host clock when rehearsing on the CPU)."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    sync(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync(device)
    return start.elapsed_time(end) / reps


def synth_frame(rng, f, c, height, width, noise=0.02, outlier_frac=0.3):
    """One correspondence frame on the stride-8 grid: a GT pose looking into
    a room, cell coordinates back-projected at random depths, Gaussian noise
    and a fraction of cells replaced by uniform room points.  numpy."""
    from esac_tpu_torch.data.synthetic import output_pixel_grid

    pixels = output_pixel_grid(height, width).numpy().astype(np.float64)
    rvec = rng.uniform(-0.3, 0.3, 3)
    theta = np.linalg.norm(rvec)
    K = np.array([[0, -rvec[2], rvec[1]], [rvec[2], 0, -rvec[0]], [-rvec[1], rvec[0], 0]])
    R = np.eye(3) + np.sin(theta) / theta * K + (1 - np.cos(theta)) / theta ** 2 * K @ K
    center = rng.uniform([2.0, 1.5, 1.0], [4.0, 2.5, 2.0])
    t = -R @ center
    depth = rng.uniform(1.0, 6.0, len(pixels))
    Y = np.concatenate([(pixels - c) / f, np.ones((len(pixels), 1))], 1) * depth[:, None]
    X = (Y - t) @ R  # R^T (Y - t), row form
    X = X + noise * rng.normal(size=X.shape)
    out = rng.uniform(size=len(X)) < outlier_frac
    X[out] = rng.uniform([0, 0, 0], [6, 4, 3], (int(out.sum()), 3))
    return X.astype(np.float32), pixels.astype(np.float32), rvec.astype(np.float32), \
        t.astype(np.float32)


# ----------------------------------------------------------------- phases


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU to drive")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device 0 of {torch.cuda.device_count()}: {name}")
    return dev, name, smi.splitlines()[0]


def phase_build():
    from esac_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    for stem, path in libs.items():
        log(f"[build] {stem}: {path.name} ({secs:.1f} s for all sources)")
        report = path.with_suffix(".so.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if any(k in line.lower() for k in ("entry function", "registers", "spill",
                                                    "error")):
                    log(f"[build]   {line.strip()}")
    return secs


def _scoring_inputs(dev, seed, B, M, H, height, width):
    """Hypotheses from the port's own sampler + P3P on synthetic frames:
    B frames x M maps (map 0 true, the rest cell-scrambled decoys)."""
    import torch

    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.kernel import frame_generators, generate_hypotheses
    from esac_tpu_torch.ransac.sampling import sample_correspondence_sets

    rng = np.random.default_rng(seed)
    f, c = 525.0 * width / 640.0, np.array([width / 2.0, height / 2.0])
    coords = []
    for _ in range(B):
        X, pixels, _, _ = synth_frame(rng, f, c, height, width)
        coords.append([X] + [X[rng.permutation(len(X))] for _ in range(M - 1)])
    coords = torch.as_tensor(np.array(coords), device=dev)
    pixels = torch.as_tensor(pixels, device=dev)
    fB = torch.full((B, M), f, device=dev)
    cT = torch.as_tensor(c, dtype=torch.float32, device=dev)
    gens = frame_generators(range(seed, seed + B), dev)
    idx = torch.stack([sample_correspondence_sets(g, H, coords.shape[2], (M,)) for g in gens])
    rv, tv = generate_hypotheses(None, coords, pixels, fB, cT, RansacConfig(n_hyps=H), idx=idx)
    return rodrigues(rv), tv, coords, pixels, fB, cT


# Launches each scoring_impl makes per call of an entry point on the card:
# one launch covers all (frame, expert) problems of the call.  On the CPU
# the wrappers take their plain versions and launch nothing.
KERNELS = ("soft_inlier_scores", "soft_inlier_select")
LAUNCHES_PER_CALL = {
    "fused_select": {"soft_inlier_scores": 0, "soft_inlier_select": 1},
    "pallas": {"soft_inlier_scores": 1, "soft_inlier_select": 0},
    "errmap": {"soft_inlier_scores": 0, "soft_inlier_select": 0},
}
# A prior-slot dispatch scores its priors through the training path's
# scoring entry, as the reference does: one more scoring launch under
# "pallas", the plain error-map math under "fused_select".
PRIOR_LAUNCHES = {
    "fused_select": {"soft_inlier_scores": 0, "soft_inlier_select": 1},
    "pallas": {"soft_inlier_scores": 2, "soft_inlier_select": 0},
    "errmap": {"soft_inlier_scores": 0, "soft_inlier_select": 0},
}
# Phase 7's scripts under --scoring-impl pallas: one scoring launch per
# train_esac step and per test_esac batch, dense and top-k alike (top-k
# scores its k maps in the same single call); stages 1-2 launch nothing.
WORKFLOW_LAUNCHES = {
    "train_expert": {"soft_inlier_scores": 0, "soft_inlier_select": 0},  # per call
    "train_gating": {"soft_inlier_scores": 0, "soft_inlier_select": 0},  # per call
    "train_esac": {"soft_inlier_scores": 1, "soft_inlier_select": 0},    # per step
    "test_esac": {"soft_inlier_scores": 1, "soft_inlier_select": 0},     # per batch
}
ROUTED_K = 2  # the routed serving checks' top-k (and K = M = 7)
PRIOR_SLOTS = 4  # esac_tpu/serve/session.py SessionPolicy.prior_slots


def _wrappers():
    from esac_tpu_torch.ransac import fused_scoring as fs

    return {"soft_inlier_scores": fs.soft_inlier_scores_kernel,
            "soft_inlier_select": fs.soft_inlier_score_select}


def counted(dev, impl, what, fn, prior=False):
    """Run ``fn()`` with every launch counter set to 0 just before and read
    just after; fail unless the counts are exactly ``impl``'s per call (a
    prior-slot call's with ``prior``).  Returns ``(fn's result, counts)``."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    got = {name: w.launches for name, w in wrappers.items()}
    per_call = PRIOR_LAUNCHES if prior else LAUNCHES_PER_CALL
    want = per_call[impl] if dev.type == "cuda" else dict.fromkeys(KERNELS, 0)
    if got != want:
        raise AssertionError(f"{what} under {impl!r}: kernel launches {got}, expected {want}")
    return out, got


def _bound(P, H, N, G, out_bytes):
    """The least time for the scoring function on P problems: each input
    read once (poses, coords, G pixel groups, f, c), ``out_bytes`` written
    once, OPS_PER_PAIR operations per (hypothesis, cell) pair."""
    pairs = P * H * N
    nbytes = P * H * 48 + P * N * 12 + G * N * 8 + P * 4 + 8 + out_bytes
    ops_ms = OPS_PER_PAIR * pairs / FP32_PEAK * 1e3
    bytes_ms = nbytes / HBM_BPS * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                sfu_bound_ms=SFU_PER_PAIR * pairs / SFU_PEAK * 1e3, pairs=pairs,
                bytes=nbytes)


def _launch_ms(dev, fs, args):
    """CUDA-event times of each kernel's launch helper alone, on operands
    packed and buffers (scratch included) allocated once: the kernel without
    its wrapper's packing, allocation and checks; and each kernel's cell
    split.  Nothing to launch on the CPU."""
    if dev.type != "cuda":
        return {"score_kernel": float("nan"), "select_kernel": float("nan")}, {}
    *tensors, tau, beta = args
    op = fs._kernel_operands(*tensors)
    score_buf, select_buf = fs._score_buffers(op, dev), fs._select_buffers(op, dev)
    stream = fs._stream(dev)
    resident, tile = fs._partial_shape(dev.index)
    tiles = -(-op["H"] // tile)
    split = dict(tile=tile, tiles=tiles, resident_blocks=resident, **{
        kernel: dict(S=buf["S"], cells=buf["cells"], blocks=op["P"] * tiles * buf["S"])
        for kernel, buf in (("score", score_buf), ("select", select_buf))})
    return {"score_kernel": time_ms(
                lambda: fs._launch_scores(op, score_buf, tau, beta, stream), dev),
            "select_kernel": time_ms(
                lambda: fs._launch_select(op, select_buf, tau, beta, stream), dev)}, split


def phase_kernels(dev, seed):
    import torch

    from esac_tpu_torch.ransac import fused_scoring as fs

    results = {}
    for label, (B, M, H, height, width) in KERNEL_SHAPES.items():
        Rs, ts, coords, pixels, f, c = _scoring_inputs(dev, seed, B, M, H, height, width)
        args = (Rs, ts, coords, pixels, f, c, 10.0, 0.5)
        P, N = B * M, coords.shape[2]

        k_scores = fs.soft_inlier_scores_kernel(*args)
        p_scores = fs._scores_plain(*args)
        sync(dev)
        err_scores = float((k_scores - p_scores).abs().max())
        if not torch.allclose(k_scores, p_scores, **SCORE_TOL):
            raise AssertionError(f"{label}: scoring kernel vs plain max |err| {err_scores}")
        if not torch.equal(k_scores, fs.soft_inlier_scores_kernel(*args)):
            raise AssertionError(f"{label}: two scoring calls on the same inputs differ")

        k_i, k_s, k_pose = fs.soft_inlier_score_select(*args)
        p_i, p_s, _ = fs._select_plain(*args)
        top2 = p_scores.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > (SCORE_TOL["atol"] + SCORE_TOL["rtol"] * top2[..., 0])
        if not torch.equal(k_i[clear], p_i[clear]):
            raise AssertionError(f"{label}: select winner differs on a fixture without near ties")
        if not torch.allclose(k_s, p_s, **SCORE_TOL):
            raise AssertionError(f"{label}: select score vs plain")
        want_pose = torch.cat([Rs.reshape(B, M, H, 9), ts], -1)[
            torch.arange(B)[:, None], torch.arange(M)[None], k_i]
        if not torch.equal(k_pose, want_pose):
            raise AssertionError(f"{label}: winner pose row is not bit-equal to its input row")
        err_select = float((k_s - p_s).abs().max())

        k_i2, k_s2, _ = fs.soft_inlier_score_select(*args)
        if not (torch.equal(k_i, k_i2) and torch.equal(k_s, k_s2)):
            raise AssertionError(f"{label}: two select calls on the same inputs differ")
        # One partial pass, partials summed in one order: the scoring
        # kernel's scores at the select winner are the select kernel's best
        # scores bit for bit, and their first max is that winner.
        if not torch.equal(k_scores.gather(-1, k_i[..., None])[..., 0], k_s):
            raise AssertionError(f"{label}: scores at the select winner != its best score")
        if not torch.equal(torch.argmax(k_scores, dim=-1), k_i):
            raise AssertionError(f"{label}: argmax of the scoring kernel != select winner")

        # Crafted ties: each problem's winner duplicated at a later index
        # (the next row, across an 8-row group, on both sides of the
        # 128-hypothesis tile boundary, the last row) must not displace the
        # first.
        for dup in sorted({d for d in (1, 9, 127, 128, H - 1) if d < H}):
            Rt, tt = Rs.clone(), ts.clone()
            w = torch.zeros_like(k_i)  # put the winner at 0, duplicate it later
            bi, mi = torch.meshgrid(torch.arange(B), torch.arange(M), indexing="ij")
            Rt[bi, mi, w] = Rs[bi, mi, k_i]
            tt[bi, mi, w] = ts[bi, mi, k_i]
            Rt[bi, mi, w + dup] = Rs[bi, mi, k_i]
            tt[bi, mi, w + dup] = ts[bi, mi, k_i]
            ti, _, _ = fs.soft_inlier_score_select(Rt, tt, coords, pixels, f, c, 10.0, 0.5)
            if not bool((ti == 0).all()):
                raise AssertionError(f"{label}: tie at +{dup} did not resolve to the first index")
            tie_scores = fs.soft_inlier_scores_kernel(Rt, tt, coords, pixels, f, c, 10.0, 0.5)
            if not bool((torch.argmax(tie_scores, dim=-1) == 0).all()):
                raise AssertionError(f"{label}: tie at +{dup}: argmax of the scoring kernel "
                                     "is not the first index")

        ms = {
            "score": time_ms(lambda: fs.soft_inlier_scores_kernel(*args), dev),
            "score_plain": time_ms(lambda: fs._scores_plain(*args), dev, reps=5),
            "select": time_ms(lambda: fs.soft_inlier_score_select(*args), dev),
            "select_plain": time_ms(lambda: fs._select_plain(*args), dev, reps=5),
        }
        kernel_ms, split = _launch_ms(dev, fs, args)
        ms.update(kernel_ms)
        bound = {"score": _bound(P, H, N, 1, P * H * 4),
                 "select": _bound(P, H, N, 1, P * (4 + 4 + 48))}
        results[label] = dict(P=P, H=H, N=N, err_scores=err_scores, err_select=err_select,
                              clear_winners=int(clear.sum()), ms=ms, cell_split=split,
                              bound=bound)
        log(f"[kernels] {label}: P={P} H={H} N={N}  scores max|err| {err_scores:.3g}  "
            f"select max|err| {err_select:.3g}  winners checked {int(clear.sum())}/{P}  "
            f"ties ok through both  pose rows bit-equal  scores at the select winner "
            f"bit-equal  (tolerance rtol 1e-5, atol 1e-3)")
        log(f"[kernels] {label}: score kernel {ms['score_kernel']:.4f} ms, wrapper "
            f"{ms['score']:.4f} (plain {ms['score_plain']:.4f})  select kernel "
            f"{ms['select_kernel']:.4f} ms, wrapper {ms['select']:.4f} "
            f"(plain {ms['select_plain']:.4f})  bound {bound['score']['bound_ms']:.4g} / "
            f"{bound['select']['bound_ms']:.4g} ms by {bound['score']['bound_by']}  "
            f"(SFU bound {bound['score']['sfu_bound_ms']:.4g} ms at the data-sheet SFU rate)")
        if split:
            log(f"[kernels] {label}: partial pass P x {split['tiles']} tiles x S chunks; "
                + "; ".join(f"{k} kernel S={split[k]['S']} chunks of {split[k]['cells']} "
                            f"cells, {split[k]['blocks']} blocks" for k in ("score", "select"))
                + f"; {split['resident_blocks']} resident on the card")
    return results


def phase_recovery(dev, seed):
    import torch

    from esac_tpu_torch.geometry.camera import pose_errors
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import esac_infer_frames, esac_infer_frames_prior
    from esac_tpu_torch.ransac.kernel import dsac_infer, frame_generators

    rng = np.random.default_rng(seed + 1)
    f, c = 525.0, np.array([320.0, 240.0], np.float32)
    cfg = RansacConfig(scoring_impl="fused_select")
    B, M, true_m = 3, 7, 4
    frames = [synth_frame(rng, f, c, 480, 640) for _ in range(B)]

    def check(rvec, tvec, gt, what):
        rot, trans = pose_errors(rodrigues(rvec), tvec,
                                 rodrigues(torch.as_tensor(gt[2], device=dev)),
                                 torch.as_tensor(gt[3], device=dev))
        log(f"[recovery] {what}: {float(rot):.3f} deg, {float(trans) * 100:.2f} cm")
        if not (float(rot) < 5.0 and float(trans) < 0.05):
            raise AssertionError(f"{what}: pose not within 5 cm / 5 deg")

    out, n = counted(dev, cfg.scoring_impl, "dsac_infer", lambda: dsac_infer(
        frame_generators([seed], dev)[0], frames[0][0], frames[0][1], f, c, cfg, device=dev))
    log(f"[recovery] dsac_infer launches {n}")
    check(out["rvec"], out["tvec"], frames[0], "dsac_infer")
    coords = []
    for X, _, _, _ in frames:
        maps = [X[rng.permutation(len(X))] for _ in range(M)]
        maps[true_m] = X
        coords.append(maps)
    out, n = counted(dev, cfg.scoring_impl, "esac_infer_frames", lambda: esac_infer_frames(
        frame_generators(range(B), dev), np.zeros((B, M), np.float32), np.array(coords),
        frames[0][1], np.full(B, f, np.float32), c, cfg, device=dev))
    log(f"[recovery] esac_infer_frames launches {n}")
    if out["expert"].tolist() != [true_m] * B:
        raise AssertionError(f"esac_infer_frames picked experts {out['expert'].tolist()}")
    for b in range(B):
        check(out["rvec"][b], out["tvec"][b], frames[b], f"esac_infer_frames frame {b}")

    # The prior slot wins: 4 hypotheses a map, and frame 0's slot 2 holds
    # its GT pose (slot 1 too, but invalid; slot 0 a valid decoy 20 deg off);
    # frame 1's slots are all invalid, so its sampled stream must win.
    prv = np.zeros((2, PRIOR_SLOTS, 3), np.float32)
    ptv = np.zeros((2, PRIOR_SLOTS, 3), np.float32)
    valid = np.zeros((2, PRIOR_SLOTS), bool)
    prv[0, 1] = prv[0, 2] = frames[0][2]
    ptv[0, 1] = ptv[0, 2] = frames[0][3]
    prv[0, 0], ptv[0, 0] = frames[0][2] + np.float32([0.35, 0, 0]), frames[0][3]
    valid[0, [0, 2]] = True
    for impl in ("fused_select", "pallas"):
        cfg4 = RansacConfig(n_hyps=4, scoring_impl=impl)
        out, n = counted(dev, impl, "esac_infer_frames_prior", lambda: esac_infer_frames_prior(
            frame_generators([seed, seed + 1], dev), np.zeros((2, M), np.float32),
            np.array(coords[:2]), frames[0][1], np.full(2, f, np.float32), c, prv, ptv, valid,
            cfg4, device=dev), prior=True)
        hits, slots = out["prior_hit"].tolist(), out["prior_slot"].tolist()
        log(f"[recovery] esac_infer_frames_prior under {impl} (n_hyps 4): prior_hit {hits}, "
            f"prior_slot {slots}, experts {out['expert'].tolist()}, launches {n}")
        if hits != [True, False] or slots != [2, PRIOR_SLOTS] or int(out["expert"][0]) != true_m:
            raise AssertionError(f"prior slot under {impl}: hit {hits}, slot {slots}")
        check(out["rvec"][0], out["tvec"][0], frames[0], f"prior slot under {impl}")


def _serving_preset():
    from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
    from esac_tpu_torch.registry.manifest import ScenePreset

    height, width, arch = SERVING_SIZE["height"], SERVING_SIZE["width"], SERVING_SIZE["arch"]
    return ScenePreset(height=height, width=width, num_experts=7,
                       gating_channels=GATING_PRESETS[arch]["channels"],
                       compute_dtype="bfloat16", **EXPERT_PRESETS[arch])


def _plan(requests, buckets, seed0):
    """Every dispatch of ``requests`` as the serving front end plans it:
    (request index, first frame, valid frames, bucket, padded batch), each
    frame with its own seed (frame i of the whole run gets seed0 + i)."""
    from esac_tpu_torch.serve.batching import pad_batch, pick_bucket, plan_dispatches

    plan, next_seed = [], seed0
    for r, images in enumerate(requests):
        start = 0
        for n in plan_dispatches(len(images), buckets):
            bucket = pick_bucket(n, buckets)
            batch, n_valid = pad_batch({"image": images[start:start + n],
                                        "seed": np.arange(next_seed, next_seed + n)}, bucket)
            plan.append((r, start, n_valid, bucket, batch))
            start, next_seed = start + n, next_seed + n
    return plan


def _dispatch_all(dev, fns, params, plan, what, prior=False):
    """Every planned dispatch through every function of ``fns`` (launches
    counted per call); returns per dispatch {impl: out}, {impl: ms} and the
    summed launches by impl."""
    launches = {impl: dict.fromkeys(KERNELS, 0) for impl in fns}
    outs, times = [], []
    for r, start, n_valid, bucket, batch in plan:
        got, ms = {}, {}
        for impl, fn in fns.items():
            sync(dev)
            t0 = time.perf_counter()
            got[impl], n = counted(dev, impl, f"{what}: a {n_valid}-frame dispatch",
                                   lambda: fn(params, batch), prior=prior)
            sync(dev)
            ms[impl] = (time.perf_counter() - t0) * 1e3
            for name, k in n.items():
                launches[impl][name] += k
        outs.append(got)
        times.append(ms)
    return outs, times, launches


def _check_dispatch(outs, lanes, what):
    """Shapes and finiteness of one dispatch's outputs; "pallas" and
    "fused_select" (one partial pass, one summation order) give bit-equal
    winning scores and experts, "errmap" agrees within SCORE_TOL."""
    import torch

    sel = outs["fused_select"]
    for key, shape in (("rvec", (lanes, 3)), ("tvec", (lanes, 3)), ("expert", (lanes,)),
                       ("score", (lanes,))):
        if tuple(sel[key].shape) != shape:
            raise AssertionError(f"{what}: {key} shape {tuple(sel[key].shape)} != {shape}")
    for out in outs.values():
        for key in ("rvec", "tvec"):
            if not _finite(out[key]):
                raise AssertionError(f"{what}: non-finite {key}")
    pose_bit_equal = None
    if "pallas" in outs:
        pal = outs["pallas"]
        if not torch.equal(sel["score"], pal["scores"].flatten(1).amax(1)):
            raise AssertionError(f"{what}: fused_select and pallas winning scores differ")
        if not torch.equal(sel["expert"], pal["expert"]):
            raise AssertionError(f"{what}: fused_select and pallas experts differ")
        if not (torch.allclose(sel["rvec"], pal["rvec"])
                and torch.allclose(sel["tvec"], pal["tvec"])):
            raise AssertionError(f"{what}: fused_select and pallas refined poses differ")
        pose_bit_equal = bool(torch.equal(sel["rvec"], pal["rvec"])
                              and torch.equal(sel["tvec"], pal["tvec"]))
    if "errmap" in outs:
        ref = outs["errmap"]["scores"].flatten(1).amax(1)
        live = torch.isfinite(ref)
        if not (torch.equal(live, torch.isfinite(sel["score"]))
                and torch.allclose(sel["score"][live], ref[live], **SCORE_TOL)):
            raise AssertionError(f"{what}: fused_select and errmap winning scores differ")
    return pose_bit_equal


def _row(out, b):
    return {k: v[b] for k, v in out.items()}


def _diff(a, b) -> float:
    """max |a - b| over finite entries, 0 where both are the same infinity;
    inf where a non-finite entry differs."""
    import torch

    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    return float((a - b)[~same].abs().max())


def _cross_bucket(fn, params, plan, outs, keys, what):
    """Each real frame of every dispatch of more than 2 lanes served again
    alone (bucket 1: 2 lanes) and compared with its row in the larger
    dispatch: max |difference| per key (0 where bit-equal) by lanes."""
    from esac_tpu_torch.serve.batching import pad_batch

    worst = {}
    for (r, start, n_valid, bucket, batch), out in zip(plan, outs):
        lanes = len(batch["image"])
        if lanes <= 2:
            continue
        for b in range(n_valid):
            one, _ = pad_batch({k: v[b:b + 1] for k, v in batch.items()}, 1)
            alone = _row(fn(params, one), 0)
            for key in keys:
                d = _diff(alone[key], out[key][b])
                worst.setdefault(lanes, {}).setdefault(key, 0.0)
                worst[lanes][key] = max(worst[lanes][key], d)
    log(f"[serving] {what}: each frame alone (2 lanes) against its row at "
        + "; ".join(f"{lanes} lanes max |diff| " + ", ".join(
            f"{k} {v:.3g}" for k, v in d.items()) for lanes, d in sorted(worst.items())))
    return worst


def _cnn_cross_bucket(dev, params, images):
    """The CNN stage alone: scene_forward over ``images`` at once against
    each image alone (padded to 2): max |diff| of coordinates and logits."""
    import torch

    from esac_tpu_torch.registry.serving import scene_forward

    with torch.inference_mode():
        imgs = torch.as_tensor(images, device=dev)
        coords, logits = scene_forward(params, imgs)
        worst = {"coords": 0.0, "logits": 0.0}
        for b in range(len(imgs)):
            c1, l1 = scene_forward(params, imgs[[b, b]])
            worst["coords"] = max(worst["coords"], _diff(c1[0], coords[b]))
            worst["logits"] = max(worst["logits"], _diff(l1[0], logits[b]))
    return worst


def _ransac_cross_bucket(dev, seed):
    """The RANSAC stage alone, across buckets: one set of synthetic
    coordinates (64 frames x 7 maps at the serving size) and per-frame
    seeds through esac_infer_frames at 2, 4, 16 and 64 lanes must give
    every frame's outputs bit for bit, under every scoring_impl.  On a
    difference it names the first stage that differs (hypotheses,
    per-map winners, else the refine)."""
    import torch

    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import _per_expert_winners, esac_infer_frames
    from esac_tpu_torch.ransac.kernel import frame_generators

    rng = np.random.default_rng(seed + 4)
    height, width = SERVING_SIZE["height"], SERVING_SIZE["width"]
    f, c = 525.0 * width / 640.0, np.array([width / 2.0, height / 2.0], np.float32)
    B, M, lanes_all = 64, 7, (2, 4, 16, 64)
    coords = []
    for b in range(B):
        X, pixels, _, _ = synth_frame(rng, f, c, height, width)
        maps = [X[rng.permutation(len(X))] for _ in range(M)]
        maps[b % M] = X
        coords.append(maps)
    coords = torch.as_tensor(np.array(coords), device=dev)
    pixels = torch.as_tensor(pixels, device=dev)
    cT = torch.as_tensor(c, device=dev)
    seeds = np.arange(B) + 100 * seed
    fB = torch.full((B,), f, device=dev)

    def run(fn, lanes):
        rows = [fn(s, s + lanes) for s in range(0, B, lanes)]
        if isinstance(rows[0], dict):
            return {k: torch.cat([o[k] for o in rows]) for k in rows[0]}
        return [torch.cat([o[i] for o in rows]) for i in range(4)]

    for impl in ("fused_select", "pallas", "errmap"):
        cfg = RansacConfig(scoring_impl=impl)
        full = {lanes: run(lambda a, b: esac_infer_frames(
            frame_generators(seeds[a:b], dev), torch.zeros((b - a, M), device=dev),
            coords[a:b], pixels, fB[a:b], cT, cfg, device=dev), lanes) for lanes in lanes_all}
        for lanes in lanes_all[1:]:
            bad = [k for k in full[2] if not torch.equal(full[2][k], full[lanes][k])]
            if not bad:
                continue
            stages = {n: run(lambda a, b: _per_expert_winners(
                frame_generators(seeds[a:b], dev), coords[a:b], pixels, fB[a:b], cT,
                cfg)[:4], n) for n in (2, lanes)}
            first = next((name for name, i in (("hypotheses (P3P + polish)", 0),
                                                ("per-map winners (scoring)", 3))
                          if not torch.equal(stages[2][i], stages[lanes][i])), "refine")
            raise AssertionError(
                f"RANSAC stage under {impl!r}: 2 lanes vs {lanes} lanes differ on {bad} "
                f"(max |diff| {[_diff(full[2][k], full[lanes][k]) for k in bad]}); first "
                f"stage that differs: {first}")
    log(f"[serving] RANSAC stage across buckets: {B} frames x {M} maps through "
        f"esac_infer_frames at {', '.join(map(str, lanes_all))} lanes bit-identical on every "
        "output, under fused_select, pallas and errmap")
    return True


def phase_serving(dev, seed):
    import torch

    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.serving import (
        init_scene_params,
        make_routed_scene_bucket_fn,
        make_scene_bucket_fn,
    )
    from esac_tpu_torch.ransac.esac import routed_serve_capacity

    preset = _serving_preset()
    M, height, width = preset.num_experts, preset.height, preset.width
    params = init_scene_params(preset, seed=seed, device=dev)
    buckets = RansacConfig().frame_buckets
    impls = ("fused_select", "pallas", "errmap")
    dense = {impl: make_scene_bucket_fn(preset, RansacConfig(scoring_impl=impl), device=dev)
             for impl in impls}
    routed = {k: {impl: make_routed_scene_bucket_fn(preset, RansacConfig(scoring_impl=impl),
                                                    k, device=dev)
                  for impl in (impls if k == ROUTED_K else impls[:2])}
              for k in (M, ROUTED_K)}
    rng = np.random.default_rng(seed + 2)
    requests = [rng.uniform(0, 1, (n, height, width, 3)).astype(np.float32)
                for n in (1, 3, 5, 16)]
    plan = _plan(requests, buckets, 1000 * seed)

    # Warm-up of every bucket shape (cuDNN algorithm choice, allocator) off
    # the measured dispatches; the kernels' counts are zeroed after it.
    for lanes in (1, 4, 16):
        batch, _ = pad_batch_warm(requests[0][:1], lanes)
        for fn in [*dense.values(), *routed[M].values(), *routed[ROUTED_K].values()]:
            fn(params, batch)
    sync(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    outs, times, launches = _dispatch_all(dev, dense, params, plan, "dense")
    dispatches = []
    for (r, start, n_valid, bucket, batch), got, ms in zip(plan, outs, times):
        lanes = len(batch["image"])
        pose_bit_equal = _check_dispatch(got, lanes, f"dense {n_valid}-frame dispatch")
        sel = got["fused_select"]
        dispatches.append(dict(frames=n_valid, lanes=lanes, ms=ms,
                               score=sel["score"][:n_valid].tolist(),
                               expert=sel["expert"][:n_valid].tolist(),
                               pallas_pose_bit_equal=pose_bit_equal))
        log(f"[serving] request of {len(requests[r])}: dispatch {n_valid} frames in bucket "
            f"{bucket} ({lanes} lanes): " + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
            + f"; winners {sel['expert'][:n_valid].tolist()}; pallas pose "
            + ("bit-equal" if pose_bit_equal else "allclose, not bit-equal"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"[serving] launches by scoring_impl over {len(dispatches)} dispatches {launches}; "
        f"peak memory {peak / 2**30:.2f} GiB")

    # Across buckets: the RANSAC stage alone must be bit-identical; end to
    # end, the CNN stage runs at each bucket's width.
    cross = {"ransac_stage_bit_identical": _ransac_cross_bucket(dev, seed)}
    keys = ("rvec", "tvec", "expert", "score", "inlier_frac", "gating_probs")
    cross["dense"] = _cross_bucket(dense["fused_select"], params, plan,
                                   [o["fused_select"] for o in outs], keys,
                                   "dense fused_select end to end")
    cross["dense_cnn"] = _cnn_cross_bucket(dev, params, requests[-1])
    log(f"[serving] dense CNN stage: 16 images at once against each alone (2 lanes): "
        f"max |diff| coords {cross['dense_cnn']['coords']:.3g}, logits "
        f"{cross['dense_cnn']['logits']:.3g}")

    routed_res = _routed_checks(dev, params, preset, plan, outs, routed, requests)
    routed_res["cross_bucket"] = _cross_bucket(
        routed[ROUTED_K]["fused_select"], params, plan,
        [o["fused_select"] for o in routed_res.pop("outs")], keys + ("experts_evaluated",),
        f"routed K={ROUTED_K} fused_select end to end")
    bad = {lanes: {k: v for k, v in d.items() if v != 0 and k != "gating_probs"}
           for lanes, d in routed_res["cross_bucket"].items()}
    if any(bad.values()):
        raise AssertionError(f"routed K={ROUTED_K}: a frame alone differs from its row in a "
                             f"larger bucket: {bad}")
    routed_res["prior"] = _prior_checks(dev, params, requests, routed, dense)
    routed_res["capacity"] = routed_serve_capacity(RansacConfig(), ROUTED_K, M)

    stages, busy = {}, {}
    for lanes in (4, 16):
        stages[lanes] = _stage_breakdown(dev, params, preset, requests[-1][:lanes])
        stages[f"routed_k{ROUTED_K}_{lanes}"] = _routed_stage_breakdown(
            dev, params, preset, requests[-1][:lanes], ROUTED_K)
        if dev.type == "cuda":
            batch = {"image": requests[-1][:lanes], "seed": np.arange(lanes)}
            busy[lanes] = _device_busy(
                dev, lambda: dense["fused_select"](params, batch),
                f"[serving] profiled {lanes}-lane fused_select dispatch")
    return dict(dispatches=dispatches, launches=launches, peak_bytes=peak,
                stages=stages, device_busy=busy, cross_bucket=cross, routed=routed_res)


def pad_batch_warm(images, lanes):
    from esac_tpu_torch.serve.batching import pad_batch

    return pad_batch({"image": images, "seed": np.zeros(len(images), np.int64)}, lanes)


def _bit_equal(a: dict, b: dict, keys, what):
    import torch

    for key in keys:
        if not torch.equal(a[key], b[key]):
            raise AssertionError(f"{what}: {key} differs (max |diff| {_diff(a[key], b[key])})")


def _routed_checks(dev, params, preset, plan, dense_outs, routed, requests):
    """Routed serving on the planned dispatches: K = M bit-equal to the
    dense bucket function on the same seeds; K = ROUTED_K "pallas" and
    "fused_select" bit-equal winners, "errmap" within tolerance on the
    first dispatch; the overflow dispatch's accounting."""
    import torch

    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.serving import make_routed_scene_bucket_fn

    M = preset.num_experts
    res = {}
    outs7, _, launches7 = _dispatch_all(dev, routed[M], params, plan, f"routed K={M}")
    for (r, start, n_valid, bucket, batch), got, want in zip(plan, outs7, dense_outs):
        lanes = len(batch["image"])
        for impl in ("fused_select", "pallas"):
            _bit_equal(got[impl], want[impl], want[impl].keys(),
                       f"routed K={M} vs dense, {impl}, {lanes} lanes")
            if not torch.equal(got[impl]["experts_evaluated"].cpu(),
                               torch.arange(M).expand(lanes, M)):
                raise AssertionError(f"routed K={M}: experts_evaluated is not 0..{M - 1}")
    log(f"[serving] routed K={M}: {len(plan)} dispatches bit-equal to make_scene_bucket_fn "
        f"on every output, fused_select and pallas; launches {launches7}")

    fns = routed[ROUTED_K]
    two = {k: v for k, v in fns.items() if k != "errmap"}
    outs2, times2, launches2 = _dispatch_all(dev, two, params, plan, f"routed K={ROUTED_K}")
    outs2[0]["errmap"], _ = counted(dev, "errmap", f"routed K={ROUTED_K} errmap",
                                    lambda: fns["errmap"](params, plan[0][4]))
    res["dispatches"] = []
    for (r, start, n_valid, bucket, batch), got, ms in zip(plan, outs2, times2):
        lanes = len(batch["image"])
        _check_dispatch(got, lanes, f"routed K={ROUTED_K} {n_valid}-frame dispatch")
        ev = got["fused_select"]["experts_evaluated"]
        if tuple(ev.shape) != (lanes, ROUTED_K):
            raise AssertionError(f"routed experts_evaluated shape {tuple(ev.shape)}")
        res["dispatches"].append(dict(frames=n_valid, lanes=lanes, ms=ms,
                                      experts_evaluated=ev[:n_valid].tolist(),
                                      expert=got["fused_select"]["expert"][:n_valid].tolist()))
        log(f"[serving] routed K={ROUTED_K}: dispatch {n_valid} frames ({lanes} lanes): "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
            + f"; evaluated {ev[:n_valid].tolist()}")
    res["launches"] = {"k7": launches7, f"k{ROUTED_K}": launches2}
    res["outs"] = outs2

    # Overflow: capacity 2, four copies of one image (identical gating, so
    # every frame contends for the same experts): frames 2-3 drop everything.
    over = {impl: make_routed_scene_bucket_fn(
        preset, RansacConfig(scoring_impl=impl, serve_capacity=2), ROUTED_K, device=dev)
        for impl in ("fused_select", "pallas")}
    img = np.repeat(requests[1][:1], 4, axis=0)
    four = {"image": img, "seed": np.arange(4) + 77}
    twin = {"image": img[:2], "seed": np.arange(2) + 77}
    for impl, fn in over.items():
        got, _ = counted(dev, impl, "overflow dispatch", lambda: fn(params, four))
        pair, _ = counted(dev, impl, "2-frame dispatch", lambda: fn(params, twin))
        if not bool((got["experts_evaluated"][2:] == M).all()):
            raise AssertionError(f"overflow: frames 2-3 evaluated {got['experts_evaluated']}")
        if not (_finite(got["rvec"]) and _finite(got["tvec"])):
            raise AssertionError("overflow: non-finite poses")
        if impl == "pallas" and not bool(torch.isneginf(got["scores"][2:]).all()):
            raise AssertionError("overflow: a dropped frame's scores are not all -inf")
        if not bool(torch.isneginf(got["inlier_frac"][2:]).all()):
            raise AssertionError("overflow: a dropped frame's inlier_frac is not -inf")
        # gating_probs apart: the gating CNN runs at the dispatch's width.
        _bit_equal({k: v[:2] for k, v in got.items()}, pair,
                   [k for k in pair if k != "gating_probs"],
                   f"overflow {impl}: frames 0-1 against a 2-frame dispatch")
    log(f"[serving] routed overflow (capacity 2, 4 copies of one image): frames 2-3 "
        f"evaluated the sentinel {M} in every slot, finite poses, -inf scores under "
        f"pallas; frames 0-1 bit-equal to a 2-frame dispatch")
    return res


def _prior_checks(dev, params, requests, routed, dense):
    """A prior-slot batch (PRIOR_SLOTS poses a frame) through the dense and
    the routed K = ROUTED_K bucket functions: with an all-invalid mask every
    output equals the plain dispatch's bit for bit; launches per call as
    PRIOR_LAUNCHES says."""
    rng = np.random.default_rng(5)
    lanes = 4
    plain = {"image": requests[-1][:lanes], "seed": np.arange(lanes) + 500}
    prior = dict(plain, prior_rvec=rng.uniform(-0.3, 0.3, (lanes, PRIOR_SLOTS, 3)).astype(
        np.float32), prior_tvec=rng.uniform(-1, 1, (lanes, PRIOR_SLOTS, 3)).astype(np.float32),
        prior_valid=np.zeros((lanes, PRIOR_SLOTS), bool))
    launches = {}
    for name, fns in (("dense", dense), (f"routed_k{ROUTED_K}", routed[ROUTED_K])):
        for impl, fn in fns.items():
            want, _ = counted(dev, impl, f"{name} plain", lambda: fn(params, plain))
            got, n = counted(dev, impl, f"{name} prior batch", lambda: fn(params, prior),
                             prior=True)
            launches[f"{name} {impl}"] = n
            _bit_equal(got, want, want.keys(), f"{name} {impl}: an all-invalid prior")
            if bool(got["prior_hit"].any()) or not bool((got["prior_slot"] == PRIOR_SLOTS).all()):
                raise AssertionError(f"{name} {impl}: an invalid prior won")
    log(f"[serving] prior batch ({PRIOR_SLOTS} slots, all invalid) bit-equal to the plain "
        f"dispatch through the dense and routed K={ROUTED_K} bucket functions; launches "
        f"per prior dispatch {launches}")
    return launches


def _device_busy(dev, run, label, top=6):
    """One call of ``run()`` under torch.profiler (after one unprofiled
    call): the union of its device-activity intervals over the (profiled)
    wall time, and the ops with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:  # union of intervals
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    ops = sorted((k for k in prof.key_averages() if k.key.startswith("aten::")),
                 key=lambda k: -k.device_time_total)
    heavy = {k.key: round(k.device_time_total / 1e3, 3) for k in ops[:top]}
    log(f"{label}: device busy {busy_us / 1e3:.2f} of {wall_us / 1e3:.2f} ms wall "
        f"(idle share {1 - busy_us / wall_us:.3f}); device ms by op {heavy}")
    return dict(busy_ms=busy_us / 1e3, wall_ms=wall_us / 1e3,
                idle_share=1 - busy_us / wall_us, device_ms_by_op=heavy)


def _stage_breakdown(dev, params, preset, images):
    """Host-clock times (synchronized) of each stage of one "fused_select"
    dispatch of ``images``, in the order make_scene_bucket_fn runs them."""
    import torch

    from esac_tpu_torch.data.synthetic import output_pixel_grid
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.kernel import _infer_winner, _take, frame_generators
    from esac_tpu_torch.ransac.kernel import generate_hypotheses
    from esac_tpu_torch.ransac.refine import refine_soft_inliers
    from esac_tpu_torch.ransac.sampling import sample_correspondence_sets

    cfg = RansacConfig(scoring_impl="fused_select")
    B, M = len(images), preset.num_experts
    imgs = torch.as_tensor(images, device=dev)
    pixels = output_pixel_grid(preset.height, preset.width, device=dev)
    f = params["f"].expand(B)
    stages = {}

    def stage(name, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept (warm)
            coords = stage("expert_cnns", lambda: torch.stack(
                [net(imgs) for net in params["expert"]], 1).reshape(B, M, -1, 3)
                + params["centers"][None, :, None])
            stage("gating_cnn", lambda: params["gating"](imgs))
            gens = frame_generators(range(B), dev)
            idx = stage("sampling", lambda: torch.stack(
                [sample_correspondence_sets(g, cfg.n_hyps, coords.shape[2], (M,))
                 for g in gens]))
            fBM = f[:, None].expand(B, M)
            rv, tv = stage("p3p_polish", lambda: generate_hypotheses(
                None, coords, pixels, fBM, params["c"], cfg, idx=idx))
            best_j, best_s, _ = stage("score_select", lambda: _infer_winner(
                rv, tv, coords, pixels, fBM, params["c"], cfg))
            m = torch.argmax(best_s, 1)
            j = _take(best_j, m)
            stage("refine", lambda: refine_soft_inliers(
                _take(_take(rv, m), j), _take(_take(tv, m), j), _take(coords, m), pixels,
                f, params["c"], cfg.tau, cfg.beta, iters=cfg.refine_iters))
    log(f"[serving] stages of one {B}-lane fused_select dispatch (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    return stages


def _routed_stage_breakdown(dev, params, preset, images, k):
    """Host-clock times (synchronized) of each stage of one routed
    "fused_select" dispatch of ``images`` at top-``k``, in the order
    make_routed_scene_bucket_fn runs them: the expert CNNs run over
    M blocks of routed_serve_capacity frames whatever the bucket."""
    import dataclasses

    import torch

    from esac_tpu_torch.data.synthetic import output_pixel_grid
    from esac_tpu_torch.parallel.esac_sharded import route_frames_to_experts
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import (_routed_sets, routed_serve_capacity,
                                            select_topk_experts)
    from esac_tpu_torch.ransac.kernel import (_infer_winner, _take, frame_generators,
                                              generate_hypotheses)
    from esac_tpu_torch.ransac.refine import refine_soft_inliers

    B, M = len(images), preset.num_experts
    cfg = RansacConfig(scoring_impl="fused_select")
    cap = routed_serve_capacity(cfg, k, M)
    cfg_k = dataclasses.replace(cfg, n_hyps=cfg.n_hyps * M // k)
    imgs = torch.as_tensor(images, device=dev)
    pixels = output_pixel_grid(preset.height, preset.width, device=dev)
    f = params["f"].expand(B)
    stages = {}

    def stage(name, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept (warm)
            logits = stage("gating_cnn", lambda: params["gating"](imgs))
            sel = select_topk_experts(logits, k)
            kept, pos, slot_frame, _ = route_frames_to_experts(sel, M, cap)
            blocks = stage("expert_cnn_blocks", lambda: torch.stack(
                [net(imgs[slot_frame[m]]) for m, net in enumerate(params["expert"])]))
            coords = (blocks.reshape(M, cap, -1, 3) + params["centers"][:, None, None])[
                sel, pos.clamp(max=cap - 1)]
            gens = frame_generators(range(B), dev)
            idx = stage("sampling", lambda: _routed_sets(gens, cfg_k.n_hyps, coords.shape[2],
                                                         M, sel))
            fBK = f[:, None].expand(B, k)
            rv, tv = stage("p3p_polish", lambda: generate_hypotheses(
                None, coords, pixels, fBK, params["c"], cfg_k, idx=idx))
            best_j, best_s, _ = stage("score_select", lambda: _infer_winner(
                rv, tv, coords, pixels, fBK, params["c"], cfg_k))
            m = torch.argmax(torch.where(kept, best_s, -torch.inf), 1)
            j = _take(best_j, m)
            stage("refine", lambda: refine_soft_inliers(
                _take(_take(rv, m), j), _take(_take(tv, m), j), _take(coords, m), pixels,
                f, params["c"], cfg.tau, cfg.beta, iters=cfg.refine_iters))
    log(f"[serving] stages of one {B}-lane routed K={k} fused_select dispatch ({M} x {cap} "
        f"expert-CNN images, {cfg_k.n_hyps} hypotheses a map; ms): "
        + ", ".join(f"{name} {v:.2f}" for name, v in stages.items()))
    return stages


def _grads_agree(got, want, what):
    """max |got - want| <= GRAD_RTOL of max |want|, per tensor; returns the
    largest relative error."""
    worst = 0.0
    for name, a, b in zip(("Rs", "ts", "coords"), got, want):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if not (err <= GRAD_RTOL and _finite(a)):
            raise AssertionError(f"{what}: {name} gradient off the plain version by {err:.3g} "
                                 f"of its largest entry (tolerance {GRAD_RTOL})")
        worst = max(worst, err)
    return worst


def _finite(x) -> bool:
    import torch

    return bool(torch.isfinite(x).all())


def _train_functions(dev, seed):
    """Phase 6 (a): SoftInlierScores and SoftInlierScoreSelect on the card
    against autograd of the plain versions, and their times."""
    import torch

    from esac_tpu_torch.ransac import fused_scoring as fs

    B, M, H, height, width = TRAIN_FUNCTION_SHAPE
    Rs, ts, coords, pixels, f, c = _scoring_inputs(dev, seed, B, M, H, height, width)
    tau, beta = 10.0, 0.5
    gen = torch.Generator(device=dev).manual_seed(seed)
    cot = torch.randn(Rs.shape[:-2], generator=gen, device=dev)

    def leaves():
        return [x.detach().clone().requires_grad_(True) for x in (Rs, ts, coords)]

    # Each forward launches its kernel once; a backward, the plain
    # recompute, launches nothing (counted as an "errmap" call).
    a = leaves()
    scores, n_fwd = counted(dev, "pallas", "SoftInlierScores forward", lambda: (
        fs.soft_inlier_scores_kernel(*a, pixels, f, c, tau, beta)))
    if type(scores.grad_fn).__name__ != "SoftInlierScoresBackward":
        raise AssertionError(f"scores on inputs that require grad: grad_fn {scores.grad_fn}")
    # The forward is the kernel at the training shape: held against the
    # plain version and against itself, as phase 3 holds it.
    p_scores = fs._scores_plain(Rs, ts, coords, pixels, f, c, tau, beta)
    err_fwd = float((scores.detach() - p_scores).abs().max())
    if not torch.allclose(scores.detach(), p_scores, **SCORE_TOL):
        raise AssertionError(f"SoftInlierScores forward vs plain max |err| {err_fwd}")
    if not torch.equal(scores.detach(), fs.soft_inlier_scores_kernel(*leaves(), pixels, f, c,
                                                                     tau, beta).detach()):
        raise AssertionError("two SoftInlierScores forwards on the same inputs differ")
    loss = torch.sum(scores * cot)
    g_fn, n_bwd = counted(dev, "errmap", "SoftInlierScores backward",
                          lambda: torch.autograd.grad(loss, a, retain_graph=True))
    b = leaves()
    g_plain = torch.autograd.grad(torch.sum(fs._scores_plain(*b, pixels, f, c, tau, beta)
                                            * cot), b)
    err_scores = _grads_agree(g_fn, g_plain, "SoftInlierScores")

    a2 = leaves()
    (best, best_s, _), n_sel = counted(dev, "fused_select", "SoftInlierScoreSelect forward",
                                       lambda: fs.soft_inlier_score_select(
                                           *a2, pixels, f, c, tau, beta))
    p_best, p_best_s, _ = fs._select_plain(Rs, ts, coords, pixels, f, c, tau, beta)
    top2 = p_scores.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > (SCORE_TOL["atol"] + SCORE_TOL["rtol"] * top2[..., 0])
    if not (torch.equal(best[clear], p_best[clear])
            and torch.allclose(best_s.detach(), p_best_s, **SCORE_TOL)):
        raise AssertionError("SoftInlierScoreSelect forward: winner or best score vs plain")
    if not torch.equal(scores.detach().gather(-1, best[..., None])[..., 0], best_s.detach()):
        raise AssertionError("SoftInlierScoreSelect best score != the scoring kernel's "
                             "score at its winner")
    loss_sel = torch.sum(best_s * cot[..., 0])
    g_sel, _ = counted(dev, "errmap", "SoftInlierScoreSelect backward",
                       lambda: torch.autograd.grad(loss_sel, a2, retain_graph=True))
    b2 = leaves()
    plain_best = fs._scores_plain(*b2, pixels, f, c, tau, beta).gather(-1, best[..., None])
    g_sel_plain = torch.autograd.grad(torch.sum(plain_best[..., 0] * cot[..., 0]), b2)
    err_select = _grads_agree(g_sel, g_sel_plain, "SoftInlierScoreSelect")
    rows = g_sel[0].abs().sum((-1, -2)) + g_sel[1].abs().sum(-1)  # (B, M, H)
    winner = torch.zeros_like(rows, dtype=torch.bool).scatter_(-1, best[..., None], True)
    if bool((rows[~winner] != 0).any()):
        raise AssertionError("SoftInlierScoreSelect: a gradient outside the winners' rows")

    ms = {
        "scores_kernel_forward": time_ms(
            lambda: fs.soft_inlier_scores_kernel(Rs, ts, coords, pixels, f, c, tau, beta), dev),
        "scores_function_backward": time_ms(
            lambda: torch.autograd.grad(loss, a, retain_graph=True), dev, reps=5),
        "scores_plain_forward_backward": time_ms(
            lambda: torch.autograd.grad(torch.sum(
                fs._scores_plain(*b, pixels, f, c, tau, beta) * cot), b), dev, reps=5),
        "select_kernel_forward": time_ms(
            lambda: fs.soft_inlier_score_select(Rs, ts, coords, pixels, f, c, tau, beta), dev),
        "select_function_backward": time_ms(
            lambda: torch.autograd.grad(loss_sel, a2, retain_graph=True), dev, reps=5),
    }
    log(f"[training] Functions at P={B * M} H={H} N={coords.shape[-2]}: forward launches "
        f"{n_fwd} / {n_sel}, backward launches {n_bwd}; forward scores max |err| vs plain "
        f"{err_fwd:.3g} (rtol 1e-5, atol 1e-3), two forwards bit-identical, select winners "
        f"checked {int(clear.sum())}/{B * M}; gradient max |err| vs autograd of "
        f"the plain version {err_scores:.3g} (scores), {err_select:.3g} (select, winner rows "
        f"only) of the largest entry (tolerance {GRAD_RTOL})")
    log("[training] Function times (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return dict(P=B * M, H=H, N=coords.shape[-2], err_forward=err_fwd,
                err_scores=err_scores, err_select=err_select, ms=ms)


def _train_frames(dev, rng, steps, frames, height, width):
    """Synthetic training batches from ``rng``: uniform images and GT poses
    with random rotations whose camera centres lie within 5 cm of the
    origin, the scenes' (zero) centre, where the random-init experts'
    coordinate clouds sit -- so some hypotheses' pose losses fall under the
    clamp and every net gets a gradient."""
    import torch

    from esac_tpu_torch.geometry.rotations import rodrigues

    images = rng.uniform(0, 1, (steps, frames, height, width, 3)).astype(np.float32)
    axis = rng.normal(size=(steps, frames, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    rvecs = axis * rng.uniform(0, np.pi, (steps, frames, 1))
    R = rodrigues(torch.as_tensor(rvecs, dtype=torch.float32, device=dev))
    centers = torch.as_tensor(rng.uniform(-0.05, 0.05, (steps, frames, 3)),
                              dtype=torch.float32, device=dev)
    t = -torch.einsum("...ij,...j->...i", R, centers)
    return torch.as_tensor(images, device=dev), R, t


class StageClock:
    """The training step's stage hook: a CUDA event at ``start()`` and as
    each stage of the step has been issued, so the step runs as it always
    does (no synchronization inside it).  ``ms()`` gives each stage's time
    on the device's stream, from the end of the stage before it (host clock
    when rehearsing on the CPU)."""

    def __init__(self, dev):
        self.dev, self.marks = dev, []

    def _now(self):
        import torch

        if self.dev.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def start(self):
        self.marks = [("start", self._now())]

    def __call__(self, name):
        self.marks.append((name, self._now()))

    def ms(self):
        sync(self.dev)
        cuda = self.dev.type == "cuda"
        return {name: a.elapsed_time(b) if cuda else (b - a) * 1e3
                for (_, a), (name, b) in zip(self.marks, self.marks[1:])}


def phase_training(dev, seed):
    import torch

    from esac_tpu_torch.data.synthetic import output_pixel_grid
    from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.manifest import ScenePreset
    from esac_tpu_torch.registry.serving import init_scene_params
    from esac_tpu_torch.train import make_esac_train_step

    functions = _train_functions(dev, seed)
    size = TRAIN_SIZE
    height, width, steps = size["height"], size["width"], size["steps"]
    preset = ScenePreset(height=height, width=width, num_experts=size["experts"],
                         gating_channels=GATING_PRESETS[size["arch"]]["channels"],
                         compute_dtype="bfloat16", **EXPERT_PRESETS[size["arch"]])
    pixels = output_pixel_grid(height, width, preset.stride, device=dev)
    images, R_gts, t_gts = _train_frames(dev, np.random.default_rng(seed + 3), steps,
                                         size["frames"], height, width)
    runs = {}
    for impl in ("pallas", "errmap"):
        cfg = RansacConfig(n_hyps=size["n_hyps"], train_refine_iters=1, alpha=0.5,
                           scoring_impl=impl)
        params = init_scene_params(preset, seed=seed, device=dev)
        params["expert"].train()
        params["gating"].train()
        opt = torch.optim.Adam(list(params["expert"].parameters())
                               + list(params["gating"].parameters()), lr=size["lr"])
        step = make_esac_train_step(params, opt, cfg, pixels, clip_norm=size["clip_norm"],
                                    device=dev)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms, launches, stages_ms = [], [], [], []
        clock = StageClock(dev)
        for k in range(steps):
            sync(dev)
            t0 = time.perf_counter()
            clock.start()
            loss, n = counted(dev, impl, f"training step {k} under {impl!r}",
                              lambda k=k: step(seed * 7919 + k, images[k], R_gts[k], t_gts[k],
                                               on_stage=clock))
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            stages_ms.append(clock.ms())
            launches.append(n)
            losses.append(float(loss))
            if not np.isfinite(losses[-1]):
                raise AssertionError(f"{impl} step {k}: loss {losses[-1]}")
            for name, net in [(f"expert {m}", e) for m, e in enumerate(params["expert"])] + [
                    ("gating", params["gating"])]:
                grads = [p.grad for p in net.parameters()]
                if any(g is None or not _finite(g) for g in grads):
                    raise AssertionError(f"{impl} step {k}: non-finite gradient on {name}")
                if not any(bool((g != 0).any()) for g in grads):
                    raise AssertionError(f"{impl} step {k}: zero gradient on {name}")
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        run = dict(losses=losses, step_ms=step_ms, launches=launches, peak_bytes=peak,
                   stages_ms=stages_ms)
        if impl == "pallas":
            if dev.type == "cuda":
                run["device_busy"] = _device_busy(
                    dev, lambda: step(seed * 7919, images[0], R_gts[0], t_gts[0]),
                    "[training] profiled pallas step", top=8)
        runs[impl] = run
        log(f"[training] {impl}: {steps} steps of {size['frames']} frames x "
            f"{size['experts']} experts x {size['n_hyps']} hypotheses at {width}x{height}: "
            f"losses {[round(x, 4) for x in losses]}, step ms "
            f"{[round(x, 1) for x in step_ms]}, launches per step {launches}, "
            f"peak memory {peak / 2**30:.2f} GiB")
    first = [runs[i]["losses"][0] for i in ("pallas", "errmap")]
    rel = abs(first[0] - first[1]) / abs(first[1])
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"first-step losses pallas {first[0]} vs errmap {first[1]}: "
                             f"relative {rel:.3g} > {STEP_LOSS_RTOL}")
    log(f"[training] first-step losses agree to {rel:.3g} (tolerance {STEP_LOSS_RTOL})")
    for impl, run in runs.items():
        stages = run["stages_ms"][-1]  # the last step: warm
        log(f"[training] stages of the last {impl} step (ms, device stream): "
            + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
            + f" (sum {sum(stages.values()):.1f}; step {run['step_ms'][-1]:.1f} ms wall)")
    return dict(functions=functions, runs=runs, first_step_rel_diff=rel)


def _script(dev, label, module, argv, calls, timer=None):
    """``module.main(argv)`` (with ``timer`` for the trainers) with the
    launch counters set to 0 just before and read just after, its standard
    output captured and logged.  Fails unless it returns 0 and launched
    exactly ``WORKFLOW_LAUNCHES[script] x calls`` (nothing on the CPU).
    Returns (output, wall seconds, launches, peak bytes)."""
    import torch

    name = module.__name__.rsplit(".", 1)[1]
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv) if timer is None else module.main(argv, timer=timer)
    sync(dev)
    wall = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    for line in buf.getvalue().splitlines():
        log(f"[workflow]   {line}")
    if rc != 0:
        raise AssertionError(f"{label}: exit code {rc}")
    want = ({k: n * calls for k, n in WORKFLOW_LAUNCHES[name].items()}
            if dev.type == "cuda" else dict.fromkeys(KERNELS, 0))
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected {want}")
    log(f"[workflow] {label}: {wall:.2f} s, launches {got}, "
        f"peak {peak / 2**30:.2f} GiB")
    return buf.getvalue(), wall, got, peak


def _losses(text, what):
    """Every loss a trainer printed ("iter ..." and "final ..." lines); fails
    on none, or on one that is not finite."""
    found = [float(m) for m in re.findall(
        r"(?:coord L1|init L1|reproj px|CE|E\[pose loss\]) (\S+)", text)]
    if not found or not np.isfinite(found).all():
        raise AssertionError(f"{what}: printed losses {found}")
    return found


def _adam_steps(opt_state) -> set:
    return {float(s["step"]) for s in opt_state["state"].values()}


def _warm_ms(timers) -> float:
    """Mean iteration time past each run's first (warm-up) iteration."""
    warm = [t for timer in timers for t in timer.calls["iteration"][1:]]
    return 1e3 * sum(warm) / len(warm)


def phase_workflow(dev, seed, size=WORKFLOW):
    """Phase 7 (module docstring): the workflow every user runs, through the
    four scripts' main(argv) in a temporary directory."""
    from esac_tpu_torch.cli import load_esac_scene
    from esac_tpu_torch.scripts import test_esac, train_esac, train_expert, train_gating
    from esac_tpu_torch.utils.checkpoint import load_checkpoint, load_train_state
    from esac_tpu_torch.utils.profiling import StageTimer

    where = [] if dev.type == "cuda" else ["--cpu"]
    common = [*where, "--size", size["size"], "--res", str(size["height"]), str(size["width"]),
              "--frames", str(size["frames"]), "--batch", str(size["batch"]),
              "--seed", str(seed)]
    scenes = [f"synth{m}" for m in range(size["scenes"])]
    walls, peaks, launches, timers, stage_s = {}, {}, {}, {}, {}

    def record(key, *args):
        text, walls[key], launches[key], peaks[key] = _script(dev, key, *args)
        if len(args) == 4:  # a trainer, with its timer
            stage_s[key] = args[3].totals
        return text

    with tempfile.TemporaryDirectory(prefix="esac_workflow_") as tmp:
        d = pathlib.Path(tmp)
        experts = [str(d / f"expert_{s}") for s in scenes]
        timers["train_expert"] = []
        for s, out in zip(scenes, experts):
            timers["train_expert"].append(StageTimer())
            text = record(f"train_expert {s}", train_expert,
                          [s, *common, "--iterations", str(size["expert_iterations"]),
                           "--output", out], 1, timers["train_expert"][-1])
            _losses(text, f"train_expert {s}")
            _, _, cfg, it = load_train_state(out)
            if it != size["expert_iterations"] or not np.isfinite(cfg["final_loss"]):
                raise AssertionError(f"{out}: iteration {it}, final loss {cfg['final_loss']}")
        gating = str(d / "gating")
        timers["train_gating"] = [StageTimer()]
        _losses(record("train_gating", train_gating,
                       [*scenes, *common, "--iterations", str(size["gating_iterations"]),
                        "--output", gating], 1, timers["train_gating"][0]), "train_gating")
        if load_train_state(gating)[3] != size["gating_iterations"]:
            raise AssertionError(f"{gating}: wrong iteration")
        # The stage-1/2 checkpoints reload into their modules (strict).
        load_esac_scene(experts, gating, 1.0, (0.0, 0.0), dev)

        esac = str(d / "esac")
        stage3 = [*scenes, *common, "--iterations", str(size["esac_iterations"]),
                  "--hypotheses", str(size["hypotheses"]), "--scoring-impl", "pallas",
                  "--experts", *experts, "--gating", gating, "--output", esac]
        timers["train_esac"] = [StageTimer(), StageTimer()]
        stop = size["stop_after"]
        _losses(record("train_esac stop", train_esac, stage3 + ["--stop-after", str(stop)], stop,
                       timers["train_esac"][0]), "train_esac --stop-after")
        _, opt_state, _, it = load_train_state(f"{esac}_state")
        if it != stop or _adam_steps(opt_state) != {float(stop)}:
            raise AssertionError(f"stopped state: iteration {it}, Adam steps "
                                 f"{_adam_steps(opt_state)}, expected {stop}")
        rest = size["esac_iterations"] - stop
        text = record("train_esac resume", train_esac, stage3 + ["--resume"], rest,
                      timers["train_esac"][1])
        if f"resumed {esac}_state at iteration {stop}" not in text:
            raise AssertionError(f"the resumed run did not start at iteration {stop}")
        losses = _losses(text, "train_esac --resume")
        t0 = time.perf_counter()
        _, opt_state, _, it = load_train_state(f"{esac}_state")
        state_load_s = time.perf_counter() - t0
        state_bytes = sum(f.stat().st_size for f in pathlib.Path(f"{esac}_state").iterdir())
        # A fresh optimizer would count `rest` steps: the state came back.
        if it != size["esac_iterations"] or _adam_steps(opt_state) != {float(it)}:
            raise AssertionError(f"resumed state: iteration {it}, Adam steps "
                                 f"{_adam_steps(opt_state)}")
        final = ([f"{esac}_expert{m}" for m in range(len(scenes))], f"{esac}_gating")
        for ck in final[0] + [final[1]]:
            if not load_checkpoint(ck)[1].get("e2e"):
                raise AssertionError(f"{ck}: not a stage-3 checkpoint")
        load_esac_scene(*final, 1.0, (0.0, 0.0), dev)

        n_frames = size["limit"] * len(scenes)
        batches = -(-n_frames // size["eval_batch"])
        evals = {}
        for mode, extra in (("dense", []), (f"topk{size['topk']}", ["--topk", str(size["topk"])])):
            path = d / f"eval_{mode}.json"
            record(f"test_esac {mode}", test_esac,
                   [*scenes, *where, "--size", size["size"], "--res", str(size["height"]),
                    str(size["width"]), "--frames", str(size["frames"]), "--hypotheses",
                    str(size["hypotheses"]), "--scoring-impl", "pallas", "--eval-batch",
                    str(size["eval_batch"]), "--limit", str(size["limit"]),
                    "--experts", *final[0], "--gating", final[1], "--json", str(path),
                    *extra], batches)
            rec = json.loads(path.read_text())
            if (tuple(rec) != test_esac.JSON_KEYS
                    or tuple(rec["per_frame"]) != test_esac.PER_FRAME_KEYS):
                raise AssertionError(f"test_esac {mode}: JSON keys {list(rec)}")
            if rec["frames"] != n_frames or not all(
                    np.isfinite(rec["per_frame"][k]).all()
                    for k in ("rot_err_deg", "trans_err_cm")):
                raise AssertionError(f"test_esac {mode}: {rec['frames']} frames, errors "
                                     f"{rec['per_frame']}")
            evals[mode] = rec

    totals = {k: sum(n[k] for n in launches.values()) for k in KERNELS}
    result = dict(
        script_s=walls, stage_s=stage_s,
        iteration_ms_warm={name: _warm_ms(ts) for name, ts in timers.items()},
        frame_ms={mode: rec["median_ms_per_frame"] for mode, rec in evals.items()},
        hyploop_frame_ms={mode: rec["median_hyploop_ms_per_frame"]
                          for mode, rec in evals.items()},
        peak_gib={k: v / 2**30 for k, v in peaks.items()},
        launches=launches, launch_totals=totals, final_esac_loss=losses[-1],
        esac_state_bytes=state_bytes, esac_state_load_s=state_load_s,
        accuracy={mode: {k: rec[k] for k in ("pct_5cm5deg", "expert_accuracy_pct",
                                             "gating_top1_pct", "evaluated_recall_pct")}
                  for mode, rec in evals.items()},
        eval_batches=batches)
    log(f"[workflow] {len(scenes)} scenes x {size['frames']} frames at {size['width']}x"
        f"{size['height']}, --size {size['size']}: warm ms/iteration "
        + ", ".join(f"{k} {v:.1f}" for k, v in result["iteration_ms_warm"].items())
        + f"; ms/frame {result['frame_ms']}; script s "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f"; launches {totals}; stage-3 train state {state_bytes / 2**20:.0f} MiB on disk, "
        f"read in {state_load_s:.2f} s; stage 3 stop / resume s by stage "
        f"{stage_s['train_esac stop']} / {stage_s['train_esac resume']}")
    return result


# Phase 8: the server.  Request counts of its checks (the overload drill's
# deadline in ms); SERVER_SEED offsets its frames' seeds from phase 5's.
SERVER = dict(many=21, threads=8, per_thread=3, closed_loop=64, open_loop=200,
              open_load=0.5, overload=100, overload_load=2.0, overload_queue=16,
              deadline_ms=250.0, swap_requests=12, compare=4, nan_frames=16)
SERVER_SEED = 50_000


def _launches(fn):
    """``fn()`` with the launch counters set to 0 just before and read just
    after: (result, {kernel: launches})."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


def _dispatches(disp) -> int:
    return sum(disp.dispatch_totals().values())


def _same_rows(got: list, ref: dict, lo: int, what: str):
    """Each frame's host result bit-equal to its row of a bucket function's
    output on the same padded batch."""
    for j, row in enumerate(got):
        for key, v in ref.items():
            if not np.array_equal(row[key], v[lo + j].cpu().numpy()):
                raise AssertionError(f"{what}: frame {j} {key} differs from the bucket "
                                     "function on the same batch")


def _direct(reg, entry, frames, buckets, route_k=None):
    """The registry's own bucket function on each planned, padded batch of
    ``frames``: (rows, [(bucket, n_valid)])."""
    from esac_tpu_torch.serve.batching import pad_batch, pick_bucket, plan_dispatches, stack_frames

    fn, params = reg._fn_for(entry, route_k), reg.cache.get(entry)
    rows, plan, lo = [], [], 0
    for n in plan_dispatches(len(frames), buckets):
        bucket = pick_bucket(n, buckets)
        out = fn(params, pad_batch(stack_frames(frames[lo:lo + n]), bucket)[0])
        rows.append((lo, n, out))
        plan.append((bucket, n))
        lo += n
    return rows, plan


def _hold(reg, entry, got, frames, buckets, what, route_k=None):
    rows, plan = _direct(reg, entry, frames, buckets, route_k)
    for lo, n, out in rows:
        _same_rows(got[lo:lo + n], {k: v[:n] for k, v in out.items()}, 0, what)
    return plan


def _expect_launches(dev, counts, dispatches, what):
    """One select launch per "fused_select" dispatch, no score launch (none
    on the CPU)."""
    want = {"soft_inlier_scores": 0,
            "soft_inlier_select": dispatches if dev.type == "cuda" else 0}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} for "
                             f"{dispatches} dispatches")


def _stage_ms(hist, stage) -> dict:
    """A span stage's count, mean, p50, p99 and max in ms."""
    sm = hist.summary(quantiles=(0.5, 0.99), stage=stage)
    return dict(count=sm["count"], mean=1e3 * sm["sum"] / max(1, sm["count"]),
                p50=1e3 * sm["p50"], p99=1e3 * sm["p99"],
                max=None if sm["max"] is None else 1e3 * sm["max"])


def _all_served(res, what):
    if res["outcomes"]["served"] != res["offered"]:
        raise AssertionError(f"{what}: outcomes {res['outcomes']}")


def _finite_rows(rows, what):
    for r in rows:
        if not all(np.isfinite(r[k]).all() for k in ("rvec", "tvec")):
            raise AssertionError(f"{what}: a non-finite pose")


def phase_server(dev, seed, preset=None, size=SERVER):
    """Phase 8 (module docstring): the serving front end on the card -- a
    manifest of three random-init scene versions (and a NaN one) in
    registry checkpoints, SceneRegistry(...).dispatcher(cfg), requests."""
    import dataclasses
    import threading

    import torch

    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.cache import tree_nbytes
    from esac_tpu_torch.registry.health import HealthPolicy
    from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest
    from esac_tpu_torch.registry.serving import (
        SceneRegistry,
        compute_entry_checksums,
        init_scene_params,
        load_scene_params,
        save_scene_params,
    )
    from esac_tpu_torch.serve.batching import plan_dispatches
    from esac_tpu_torch.serve.loadgen import poisson_arrivals, run_open_loop
    from esac_tpu_torch.serve.slo import SLOPolicy

    t_phase = time.perf_counter()
    preset = preset or _serving_preset()
    scene_cfg = RansacConfig(scoring_impl="fused_select")
    cfg = RansacConfig()
    buckets = cfg.frame_buckets
    rng = np.random.default_rng(seed + 8)
    images = rng.uniform(0, 1, (size["closed_loop"], preset.height, preset.width, 3)) \
        .astype(np.float32)

    def frames(n, first=0):
        return [{"image": images[(first + i) % len(images)],
                 "seed": np.int64(SERVER_SEED + first + i)} for i in range(n)]

    launches = dict.fromkeys(KERNELS, 0)

    def served(fn):
        out, n = _launches(fn)
        for k, v in n.items():
            launches[k] += v
        return out, n

    result = {}
    with tempfile.TemporaryDirectory(prefix="esac_server_") as tmp:
        t0 = time.perf_counter()
        root, entries = pathlib.Path(tmp), {}
        for (name, v, s, nan) in (("a", 1, 1, False), ("a", 2, 2, False), ("b", 1, 3, False),
                                  ("a", 3, 4, True)):
            params = init_scene_params(preset, seed=seed + s, device=dev)
            if nan:
                with torch.no_grad():
                    for p_ in params["expert"].parameters():
                        p_.fill_(float("nan"))
            d = root / f"{name}{v}"
            save_scene_params(params, preset, d / "expert", d / "gating")
            del params
            entries[(name, v)] = compute_entry_checksums(SceneEntry(
                scene_id=name, version=v, expert_ckpt=str(d / "expert"),
                gating_ckpt=str(d / "gating"), preset=preset, ransac=scene_cfg))
        manifest = SceneManifest()
        for key in (("a", 1), ("b", 1), ("a", 2), ("a", 3)):
            manifest.add(entries[key], activate=False)
        scene_bytes = tree_nbytes(load_scene_params(entries[("a", 1)]))
        budget = int(1.5 * scene_bytes)
        reg = SceneRegistry(manifest, budget_bytes=budget, device=dev,
                            health=HealthPolicy())
        signatures = reg.prewarm_programs("a", buckets, route_ks=(None, ROUTED_K))
        sync(dev)
        result["setup_s"] = time.perf_counter() - t0
        log(f"[server] 4 scene versions written, checksummed and the registry prewarmed in "
            f"{result['setup_s']:.1f} s; one scene {scene_bytes} bytes (tree_nbytes), cache "
            f"budget {budget} bytes; {signatures} batch signatures")
        # Traced: each request's span chain (admitted -> coalesced -> staged
        # -> dispatched -> device -> sliced -> served) lands in the
        # serve_stage_seconds histogram; the stamps reuse the path's own
        # clock reads and its one synchronization.
        # warm_frame: the staging pools of every bucket exist before the
        # first request, in this thread and in the worker.
        disp = reg.dispatcher(cfg, start_worker=False, trace=True, warm_frame=frames(1)[0])
        stage_hist = disp.obs.get("serve_stage_seconds")

        # 1. the dispatcher adds nothing to the numbers
        n0 = _dispatches(disp)
        many_frames = frames(size["many"])
        got, counts = served(lambda: disp.infer_many(many_frames, scene="a"))
        plan = [(b, n) for b, n in list(disp.dispatch_log)[-len(plan_dispatches(
            size["many"], buckets)):]]
        _expect_launches(dev, counts, _dispatches(disp) - n0, "check 1")
        want_plan = _hold(reg, manifest.resolve("a"), got, many_frames, buckets,
                          "check 1 (infer_many)")
        if plan != want_plan:
            raise AssertionError(f"check 1: dispatches {plan} != plan {want_plan}")
        _finite_rows(got, "check 1")
        log(f"[server] check 1: infer_many of {size['many']} frames rode {plan}, each frame "
            "bit-equal to the bucket function on the same padded batch")

        # 2. coalescing under concurrent requests
        disp.start()
        n0, outs, errors = _dispatches(disp), [], []

        def client(t):
            try:
                for i in range(size["per_thread"]):
                    outs.append(disp.infer_one(frames(1, 100 + t * 10 + i)[0], scene="a",
                                               timeout=120.0))
            except Exception as e:  # noqa: BLE001 -- reported below, then the run fails
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(t,)) for t in range(size["threads"])]
        _, counts = served(lambda: [t.start() for t in threads]
                           + [t.join(180.0) for t in threads])
        n_req = size["threads"] * size["per_thread"]
        n_disp = _dispatches(disp) - n0
        if errors or any(t.is_alive() for t in threads) or len(outs) != n_req:
            raise AssertionError(f"check 2: {len(outs)} of {n_req} served, errors {errors}")
        _finite_rows(outs, "check 2")
        totals = disp.slo_totals()
        if not n_disp < n_req or sum(totals[o] for o in ("served", "shed", "expired",
                                                         "degraded", "failed", "pending")) \
                != totals["offered"]:
            raise AssertionError(f"check 2: {n_disp} dispatches for {n_req} requests, "
                                 f"totals {totals}")
        _expect_launches(dev, counts, n_disp, "check 2")
        result["concurrent"] = dict(requests=n_req, dispatches=n_disp,
                                    buckets=list(disp.dispatch_log)[-n_disp:])
        log(f"[server] check 2: {n_req} requests from {size['threads']} threads served in "
            f"{n_disp} dispatches {result['concurrent']['buckets']}")

        # 3. open-loop traffic
        closed = frames(size["closed_loop"], 500)
        t0 = time.perf_counter()
        _, counts = served(lambda: disp.infer_many(closed, scene="a"))
        fps = size["closed_loop"] / (time.perf_counter() - t0)

        def request(i):
            return frames(1, 1000 + i)[0], "a", None

        arrivals = poisson_arrivals(size["open_load"] * fps, size["open_loop"], seed=seed)
        n0 = _dispatches(disp)
        stage_hist.reset()
        res, counts = served(lambda: run_open_loop(disp, request, arrivals, settle_s=120.0))
        _all_served(res, "check 3 open loop")
        _expect_launches(dev, counts, _dispatches(disp) - n0, "check 3")
        open_loop = {k: res[k] for k in ("offered", "offered_rps_target",
                                         "offered_rps_achieved", "served_rps", "p50_ms",
                                         "p99_ms", "span_s", "outcomes", "gc")}
        open_loop["dispatches"] = _dispatches(disp) - n0
        open_loop["buckets"] = list(disp.dispatch_log)[-open_loop["dispatches"]:]
        # Per-request stage durations (ms): where a request's latency went.
        open_loop["stages_ms"] = {stage: _stage_ms(stage_hist, stage) for stage in (
            "coalesced", "staged", "dispatched", "device", "sliced", "served")}
        log(f"[server] check 3: closed loop {fps:.1f} frames/s ({size['closed_loop']} "
            f"frames in one dispatch); open loop at {size['open_load']:.0%} of it: "
            f"{res['offered']} Poisson requests at {res['offered_rps_achieved']} req/s, "
            f"p50 {res['p50_ms']} ms, p99 {res['p99_ms']} ms, goodput {res['served_rps']} "
            f"req/s in {open_loop['dispatches']} dispatches {open_loop['buckets']}")
        log("[server] check 3: open-loop stage means (ms): " + ", ".join(
            f"{k} {v['mean']:.2f}" for k, v in open_loop["stages_ms"].items()))
        drill = reg.dispatcher(dataclasses.replace(cfg, serve_queue_depth=size["overload_queue"]),
                               slo=SLOPolicy(deadline_ms=size["deadline_ms"],
                                             watchdog_ms=30_000.0),
                               warm_frame=frames(1)[0])
        drill_arrivals = poisson_arrivals(size["overload_load"] * fps, size["overload"],
                                          seed=seed + 1)
        try:
            settle = 60.0
            t0 = time.perf_counter()
            res, counts = served(lambda: run_open_loop(
                drill, request, drill_arrivals, deadline_ms=size["deadline_ms"],
                settle_s=settle))
            drill_s = time.perf_counter() - t0
        finally:
            drill.close()
        t = drill.slo_totals()
        kinds = {o: sorted({e for e, oo in zip(res["per_request_error_types"],
                                               res["per_request_outcomes"]) if oo == o})
                 for o in ("shed", "expired", "failed")}
        if (res["outcomes"]["lost"] or sum(res["outcomes"][o] for o in (
                "served", "degraded", "shed", "expired", "failed")) != res["offered"]
                or any(res["outcomes"][o] != t[o] for o in ("served", "shed", "expired"))
                or res["outcomes"]["failed"] or t["pending"]
                or not set(kinds["shed"]) <= {"ShedError"}
                or not set(kinds["expired"]) <= {"DeadlineExceededError"}
                or drill_s > drill_arrivals[-1] + settle):
            raise AssertionError(f"check 3 overload drill: {res['outcomes']}, totals {t}, "
                                 f"error types {kinds}, {drill_s:.1f} s")
        overload = {k: res[k] for k in ("offered", "offered_rps_achieved", "served_rps",
                                         "p50_ms", "p99_ms", "outcomes")}
        overload.update(seconds=drill_s, dispatches=_dispatches(drill))
        log(f"[server] check 3: overload drill at {size['overload_load']:.0%}: {res['offered']} "
            f"requests at {res['offered_rps_achieved']} req/s, outcomes {res['outcomes']}, "
            f"served p50 {res['p50_ms']} ms p99 {res['p99_ms']} ms ({drill_s:.1f} s)")

        # 4. hot swap while traffic runs
        n0, swap_out, swap_err = _dispatches(disp), [], []
        first = threading.Event()

        def traffic():
            try:
                for i in range(size["swap_requests"]):
                    swap_out.append(disp.infer_one(frames(1, 2000 + i)[0], scene="a",
                                                   timeout=120.0))
                    first.set()
            except Exception as e:  # noqa: BLE001 -- reported below, then the run fails
                swap_err.append(repr(e))
                first.set()

        before = reg.compile_cache_size()
        cmp_frames = frames(size["compare"], 3000)

        def swap():
            th = threading.Thread(target=traffic)
            th.start()
            first.wait(120.0)
            reg.promote("a", 2)
            th.join(180.0)
            if th.is_alive():
                raise AssertionError("check 4: traffic did not finish")
            return disp.infer_many(cmp_frames, scene="a")

        post, counts = served(swap)
        if swap_err or len(swap_out) != size["swap_requests"]:
            raise AssertionError(f"check 4: {len(swap_out)} served, errors {swap_err}")
        _finite_rows(swap_out + post, "check 4")
        _expect_launches(dev, counts, _dispatches(disp) - n0, "check 4")
        entry_a2 = manifest.resolve("a")
        if entry_a2.version != 2:
            raise AssertionError(f"check 4: scene a serves v{entry_a2.version}")
        _hold(reg, entry_a2, post, cmp_frames, buckets, "check 4 (after the swap)")
        if reg.compile_cache_size() != before:
            raise AssertionError(f"check 4: signatures {before} -> {reg.compile_cache_size()}")
        log(f"[server] check 4: promoted a to v2 under traffic ({size['swap_requests']} "
            f"requests); after it, results bit-equal to v2's bucket function; signatures "
            f"{before} before and after")

        # 5. the weight cache in device memory
        a_bytes = tree_nbytes(reg.cache.get(entry_a2))
        sync(dev)
        mem = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        _, counts = served(lambda: disp.infer_many(frames(1, 4000), scene="b"))
        b_bytes = tree_nbytes(reg.cache.get(manifest.resolve("b")))
        sync(dev)
        mem_after = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        if ("a", 2) not in reg.cache.evictions or ("a", 2) in reg.cache:
            raise AssertionError(f"check 5: evictions {list(reg.cache.evictions)}")
        freed = None if mem is None else mem + b_bytes - mem_after
        if freed is not None and freed < 0.9 * a_bytes:
            raise AssertionError(f"check 5: serving b freed {freed} bytes, a holds {a_bytes}")
        loads = reg.cache.stats()["disk_loads"]
        again, counts = served(lambda: disp.infer_many(cmp_frames, scene="a"))
        if reg.cache.stats()["disk_loads"] != loads + 1:
            raise AssertionError("check 5: scene a was not reloaded")
        for g, w in zip(again, post):
            for key in w:
                if not np.array_equal(g[key], w[key]):
                    raise AssertionError(f"check 5: reloaded a's {key} differs")
        result["cache"] = dict(scene_bytes=a_bytes, b_bytes=b_bytes, budget_bytes=budget,
                               allocated_before=mem, allocated_after=mem_after,
                               freed_bytes=freed, evictions=[list(k) for k in
                                                             reg.cache.evictions],
                               stats=reg.cache.stats())
        log(f"[server] check 5: serving b evicted a v2 ({a_bytes} bytes); memory_allocated "
            f"{mem} -> {mem_after} (freed {freed} bytes beyond b's {b_bytes}); a reloaded "
            "bit-equal")

        # 6. a routed lane
        n0 = _dispatches(disp)
        routed, counts = served(lambda: disp.infer_many(cmp_frames, scene="a",
                                                        route_k=ROUTED_K))
        _expect_launches(dev, counts, _dispatches(disp) - n0, "check 6")
        _hold(reg, entry_a2, routed, cmp_frames, buckets, f"check 6 (route_k={ROUTED_K})",
              route_k=ROUTED_K)
        log(f"[server] check 6: route_k={ROUTED_K} through the registry bit-equal to "
            "make_routed_scene_bucket_fn on the same batch")

        # 7. health on the card
        reg.promote("a", 3)
        bad, _ = served(lambda: disp.infer_many(frames(size["nan_frames"], 5000), scene="a"))
        if all(np.isfinite(r["rvec"]).all() for r in bad):
            raise AssertionError("check 7: the NaN version served finite poses")
        back, _ = served(lambda: disp.infer_many(cmp_frames, scene="a"))
        events = [e["event"] for e in reg.health()["events"]]
        if events != ["auto_rollback"] or manifest.active_version("a") != 2 \
                or ("a", 3) in reg.cache:
            raise AssertionError(f"check 7: events {events}, active "
                                 f"v{manifest.active_version('a')}")
        for g, w in zip(back, post):
            for key in w:
                if not np.array_equal(g[key], w[key]):
                    raise AssertionError(f"check 7: after the rollback {key} differs from v2")
        log(f"[server] check 7: the NaN version tripped its breaker from the deferred probes "
            f"({size['nan_frames']} frames) and rolled back to v2; served bit-equal to v2")
        disp.close()
        totals = disp.slo_totals()
        if totals["served"] != totals["offered"]:
            raise AssertionError(f"a request outside the drill was not served: {totals}")
        result.update(
            closed_loop_fps=fps, open_loop=open_loop, overload=overload,
            many_plan=plan, totals=totals, dispatch_totals={
                f"{s}/{k}": n for (s, k), n in disp.dispatch_totals().items()},
            signatures=reg.compile_cache_size(), launches=launches,
            health=reg.health()["events"], seconds=time.perf_counter() - t_phase)
    log(f"[server] 8 checks passed in {result['seconds']:.1f} s; launches {launches}")
    return result



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every measurement here (JSON)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    try:
        import esac_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 2
    try:
        dev, name, smi = phase_device()
        build_s = phase_build()
        kernels = phase_kernels(dev, args.seed)
        phase_recovery(dev, args.seed)
        serving = phase_serving(dev, args.seed)
        training = phase_training(dev, args.seed)
        workflow = phase_workflow(dev, args.seed)
        server = phase_server(dev, args.seed)
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        return 1

    import torch

    k = kernels["serving"]
    train_launches = {name: sum(n[name] for run in training["runs"].values()
                                for n in run["launches"]) for name in KERNELS}
    routed = serving["routed"]
    routed_launches = {name: sum(by_impl[name] for launches in routed["launches"].values()
                                 for by_impl in launches.values()) for name in KERNELS}
    prior_launches = {name: sum(n[name] for n in routed["prior"].values()) for name in KERNELS}

    def entry(name, short, replaces, impl):
        err = "err_select" if short == "select" else "err_scores"
        return {
            "name": name, "route": "cuda", "source": "esac_tpu_torch/csrc/soft_inlier.cu",
            "replaces": replaces, "launches": serving["launches"][impl][name],
            "max_abs_err": k[err],
            "ms": k["ms"][short], "kernel_ms": k["ms"][f"{short}_kernel"],
            "wrapper_ms": k["ms"][short], "plain_ms": k["ms"][f"{short}_plain"],
            "bound_ms": k["bound"][short]["bound_ms"],
            "bound_by": k["bound"][short]["bound_by"], "library_ms": None,
            "training_launches": train_launches[name],
            "routed_launches": routed_launches[name], "prior_launches": prior_launches[name],
            "workflow_launches": workflow["launch_totals"][name],
            "server_launches": server["launches"][name],
            "shapes": {label: {"P": r["P"], "H": r["H"], "N": r["N"],
                               "kernel_ms": r["ms"][f"{short}_kernel"],
                               "wrapper_ms": r["ms"][short],
                               "plain_ms": r["ms"][f"{short}_plain"],
                               "bound_ms": r["bound"][short]["bound_ms"],
                               "bound_by": r["bound"][short]["bound_by"],
                               "max_abs_err": r[err]}
                       for label, r in kernels.items()},
        }

    line = {"kernels": [
        entry("soft_inlier_scores", "score", "esac_tpu/ransac/pallas_scoring.py:94", "pallas"),
        entry("soft_inlier_select", "select", "esac_tpu/ransac/pallas_scoring.py:301",
              "fused_select"),
    ]}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(device=name, nvidia_smi=smi, build_s=build_s,
                                       kernels=kernels, serving=serving, training=training,
                                       workflow=workflow, server=server),
                                  indent=1))
    runs = training["runs"]
    print(json.dumps({"training": {
        "device": name, "nvidia_smi": smi,
        "step_ms": {impl: run["step_ms"] for impl, run in runs.items()},
        "losses": {impl: run["losses"] for impl, run in runs.items()},
        "stages_ms": {impl: run["stages_ms"][-1] for impl, run in runs.items()},
        "peak_gib": {impl: run["peak_bytes"] / 2**30 for impl, run in runs.items()},
        "launches_per_step": {impl: run["launches"] for impl, run in runs.items()},
        "device_busy": runs["pallas"].get("device_busy"),
        "functions_ms": training["functions"]["ms"],
        "functions_forward_max_abs_err": training["functions"]["err_forward"],
        "functions_max_rel_err": {"scores": training["functions"]["err_scores"],
                                  "select": training["functions"]["err_select"]}}}))
    print(json.dumps({"workflow": {"device": name, "nvidia_smi": smi, **workflow}}))
    print(json.dumps({"server": {"device": name, "nvidia_smi": smi, **server}}))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
