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
                 prior-slot shape (P = 28, H = 4 poses), at the session
                 lane's H = 32 (P = 7, 14, 28, 112): scores
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
                 once, and of the plain version.  Then the nan_planted
                 shape (P = 28, H = 256, N = 4800) with NaN planted in t:
                 a NaN depth before the finite winner and a NaN t_x after
                 it, a NaN t_x after it only, every hypothesis NaN, none:
                 both kernels follow torch.argmax as their plain versions
                 do (the first NaN wins with score NaN; all NaN -> index 0),
                 NaN scores where the plain scores are NaN, the rest within
                 the tolerance;
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
                 to the plain dispatch.  The served chain's stage times
                 come from the program's own stage spans, read by the
                 benchmark (python3 benchmark/run.py --workload NAME
                 --trace 1);
5b. graphs    -- the served RANSAC chain's CUDA graphs (registry/graphs.py)
                 at the phase-5 preset under "fused_select": dense, routed
                 K = 2 and prior-slot (4 slots) bucket functions at 1, 4, 16
                 and 64 frames (2, 4, 16, 64 lanes), four calls each on new
                 frames, alternating two scenes of other weights, centers,
                 focal length and principal point (one bucket function
                 serves both): the first call runs eagerly, the second
                 captures, the others replay; each call's rvec, tvec,
                 expert, score and inlier_frac (and the lane's
                 experts_evaluated or prior_hit / prior_slot) bit-equal to
                 a fresh bucket function's eager run of the same batch, one
                 select launch a call (replays included), one capture and
                 two replays a signature and stage; host ms of each call
                 (synchronized) beside the eager run's;
5c. epilogue  -- the CNNs' fused convolutions (models.expert.conv_epilogue)
                 at the benchmark's esac7_vga widths and 640x480: one
                 ExpertNet forward of 16 images on the separate-op path
                 (autograd on, parameters frozen) under torch.profiler with
                 record_shapes, each device kernel of the glue named by the
                 aten op that launched it; then per distinct convolution
                 shape of the expert and the gating net at batches 16 and 8
                 (the dense bucket, a routed block) the convolution and its
                 separate bias / residual / ReLU against the fused call
                 (CUDA events), the bound (bf16 FLOPs at 989e12 or bytes at
                 3.35e12, the larger), the fused call's kernels and whether
                 benchmark/reduce.py's CONV_KERNELS classifies its longest
                 one as a convolution, the
                 largest |fused - separate| relative to the separate
                 output's largest value, and the fused call bit-equal when
                 its output lands on a block filled with NaN.  Then one
                 expert of the benchmark's scene weights and its gating
                 net over 16 benchmark frames, fused against separate: the
                 largest |difference| of the scene coordinates in cm, both
                 forwards' times, and the convolutions counted fused;
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
                 kernels launch exactly as WORKFLOW_LAUNCHES says.  The
                 --backend cpp leg (the C++ hypothesis loop of esac_cpp/,
                 built by g++ into esac_tpu_torch/build/, its seconds
                 printed): test_esac --backend cpp on the stage-3
                 checkpoints (the seven scenes at --limit 2, as the dense
                 evaluation: the gating net needs all seven experts) and
                 train_esac --backend cpp for 2 iterations from the stage-1/2
                 checkpoints with --loss-clamp 1000 (WORKFLOW's note): no
                 kernel launch in either, the JAX script's JSON keys, finite
                 poses and losses, the first frame's expert losses equal to
                 a direct esac_train_cpp call on the same coordinates and
                 sets (rtol 1e-6), every expert and the gating net moved by
                 Adam (a non-zero gradient); ms a frame of the CNNs and of
                 the host loop, s an iteration.  Last, the three dataset
                 scripts (setup_7scenes, setup_12scenes, setup_aachen) on
                 fabricated trees whose images are raw bytes;
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
                 launch;
9. fleet      -- the fleet tier on phase 8's preset ("fused_select"): three
                 random-init scenes a, b, c (~302 MB each) in registry
                 checkpoints; two replicas, each SceneRegistry(manifest,
                 device budget of 1 scene, host_tier=HostWeightTier("bf16",
                 3 payloads)) prewarmed at buckets 1/4/16 x n_hyps 256/32 x
                 plain/4 prior slots, its serve function inside a
                 FaultInjector, behind MicroBatchDispatcher(SLOPolicy) and a
                 FleetRouter.  (a) 24 requests from 6 threads over a and b:
                 all served, each scene has a home, affinity routes
                 counted, every result bit-equal to its row of the recorded
                 dispatch and every dispatch bit-equal to its replica's
                 bucket function on the same batch, books summing to
                 offered; (b) every injector armed alike so that only a's
                 home stalls: the home is quarantined (wedge, typed), the
                 request is served by the survivor inside its deadline,
                 bit-equal to the survivor dispatched directly, counted
                 once; after release_replica the home serves again; (c) a ->
                 b -> c -> a on one replica: each demotion lands in the host
                 tier and frees >= 0.9 of a scene of memory_allocated, the
                 second a is a host hit with no disk load, the promoted
                 weights are the bf16-rounded originals (EXACT_KEYS byte-
                 exact), results bit-equal to a registry loaded from the
                 bf16-rounded tree; disk cold load, host-tier promote and
                 warm hit in ms; (d) a prefetcher on one replica and four b
                 requests to each a: b is back on the card before each of
                 its next demands (a device hit); issued / hits / wasted;
                 (e) a SessionRouter over the FleetRouter streams two
                 sessions of 12 frames: tracked frames on the n_hyps = 32
                 lane with 4 prior slots, typed transitions, no new batch
                 signature; then a SyntheticScene trajectory of 48 frames
                 at full width (one good map, six junk) planned by
                 SessionTable through esac_infer_prior at 256 / 32
                 hypotheses beside a full-budget pass: tracked fraction,
                 prior hits, median ms, pose errors; (f) RetrievalFront over
                 a random-init retriever at 640x480 with a and b enrolled
                 from rendered views, top_k 2, min_confidence 0: 8
                 infer_image calls served, books summing to offered, no new
                 retriever signature, each winner bit-equal to the frame
                 dispatched to its scene; the retriever forward in ms.
                 Every leg's select launches equal the serve calls that
                 returned (the dispatches, and the stalled dispatch of (b),
                 which runs once released); no score launch.  The router
                 carries a timeline (0.25 s windows) and the default health
                 rules for the whole phase (phase 10 e);
10. parallel  -- the expert-parallel path (esac_tpu_torch.parallel) under
                 "fused_select" for serving and "pallas" for training.
                 (a) one NCCL rank in this process: sharded coords-level
                 frames at config #2's shape (7 experts, N = 4800, 256
                 hypotheses) in buckets of 1 and 4 frames bit-identical to
                 esac_infer_frames (winner, expert, score, pose), and
                 make_sharded_serve_fn behind a dispatcher likewise;
                 (b) 2 gloo ranks spawned here, both on the one card (NCCL
                 refuses two ranks on one device): MAX, MIN and SUM
                 all-reduces of CUDA tensors checked first; config #4's 50
                 full-width bf16 experts, 25 on each rank (~1.07 GiB of f32
                 weights a rank): 4 frames of coords-level serving (a
                 first and a warm dispatch) through a dispatcher on rank 0
                 (the other rank following)
                 bit-identical to esac_infer_frames; routed-sharded top-2
                 serving from images (routed_serve_capacity) with winners
                 and evaluated sets equal to make_routed_scene_bucket_fn's
                 and poses within ROUTED_POSE_ATOL; 7 experts padded to 8,
                 the pad a copy of the true expert, never winning; exactly
                 one select launch per rank per dispatch; (c) on the same
                 ranks, 2 training steps at config #2's shape padded to 8
                 experts, 2 frames, dense and capacity 2: losses within
                 rtol 1e-3 of the single-device step (dense) and of the
                 single-device loss truncated to the same selection
                 (capacity, first step), finite gradients, non-zero on
                 every real local expert (dense) and on the gating net,
                 exactly one score launch per rank per step; (d) phase 7's
                 test_esac --sharded at world size 1 reports the dense
                 evaluation's numbers; (e) phase 9's router ticked at least
                 two timeline windows and the Prometheus page of its
                 snapshot names every registered collector.  Times of legs
                 b and c are of two processes sharing one card through
                 gloo's host staging: they measure no interconnect;
11. lint      -- the port's lint witnesses (esac_tpu_torch.lint) on the card.
                 (a) the degenerate-input gradient witness
                 (gradcheck.run_gradcheck(device="cuda")): 10 witnesses x the
                 8 committed corpus cases (1 problem, 4 hypotheses, 16 cells:
                 below one 32-cell chunk), every output and every gradient
                 finite, exactly 8 score and 8 select launches (one forward a
                 case each; the backwards are plain), the scoring kernel's
                 scores and the select's winner against their plain versions
                 on each case's own inputs (phase 3's NaN-aware tolerance;
                 winners equal where the plain top two are clear, a plain
                 near-maximum otherwise), tie_scores won by index 0, and the
                 select's backward (SoftInlierScoreSelect) run on every case;
                 the sweep's ms.  (b) a LockWitness attached to phase 8's
                 overload drill and hot swap and phase 9's failover leg (and
                 the legs after it; never the timed closed and open loops):
                 every observed edge inside the committed lock_graph.json
                 order, every observed lock one of its nodes.  (c) an
                 OutcomeWitness on the same legs: every observed error type a
                 member of fault_taxonomy.json, every (type, outcome) pair on
                 a committed edge.  Phase 3 holds both kernels at the corpus
                 shape (lint_corpus).
12. bench     -- the port's bench (esac_tpu_torch.bench) on the card: the
                 headline and streaming lines and every named mode of
                 bench.py (serve, registry, routed, loadtest, scoring, chaos,
                 obs, prefetch, fleet, hostpath, city, sessions) through
                 esac_tpu_torch.bench.run, in process, at the modes' own
                 shapes; only repeats, open-loop windows, request counts and
                 city's retriever steps are cut (BENCH states each cut).
                 Each mode prints exactly one JSON line with bench.py's
                 metric name and platform "gpu", and writes its artifact (to
                 a temporary directory); its launches are counted from 0:
                 the scoring sweep launches the select kernel exactly once
                 per fused_select call, warm-ups included (P = 16 frames,
                 H = 64 / 256 / 1024, N = 4800: phase 3's bench_scoring_*
                 shapes), every other mode scores with RansacConfig's
                 default "errmap" and launches nothing.  The invariants
                 the modes record hold: outcome accounting exact, no new
                 batch signature on the hot path, routed K = M bit-equal to
                 dense, the session lane's all-invalid prior bit-equal to
                 the plain lane, the spans telescoping, the rollback and
                 the breaker restore bit-identical.  The scoring sweep's
                 winner agreement (fused_select against errmap: two float32
                 formulas) is recorded, with any disagreeing frame's
                 indices and score gap, not asserted.  City runs at
                 bench.py's 500 ms watchdog floor with its prefetchers
                 cycling: every registry serve call is timed with a
                 synchronize, and the phase fails if the watchdog abandons
                 a dispatch, if any serve call takes longer than the
                 drill's watchdog, or if a replica is quarantined by
                 anything but the drill's last probe (its injected
                 SceneLoadError);
13. experiments -- the counterparts of experiments/profile_stages.py,
                 experiments/generalization.py and tools/routed_train_bench.py
                 (esac_tpu_torch.experiments.*, esac_tpu_torch.tools.
                 routed_train_bench) at their scripts' shapes: the stage
                 profile at config #1 (16 frames x 256 hypotheses x 4800
                 cells, 20 repeats) under "errmap", "fused" and "pallas" (the
                 scoring kernel: one launch per call of the stage, exactly),
                 the three impls' scores agreeing within the kernels'
                 tolerance; then the scoring kernel held against its plain
                 version on the profile's own hypotheses (P = 16, H = 256,
                 N = 4800; rtol 1e-5, atol 1e-3), timed beside it and its
                 bound.  generalization at one round-1 row cut to fit (GEN:
                 1024 frames, noaug, 3000 steps): finite loss, the median
                 coordinate error under 20 cm.  routed_train_bench at M = 48
                 on 2 gloo ranks sharing the card, its loss clamp raised to
                 1e6 (at the script's 100 random weights saturate it: both
                 losses read exactly 100, their equality says nothing and
                 the backward is all zeros): neither loss at the clamp,
                 finite losses, dense == routed within rtol 1e-4 (else its
                 ratio must not be quoted), the structural counts by the JAX
                 script's formulas.

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
{"fleet": {...}}, one JSON line {"parallel": {...}}, one JSON line
{"lint": {...}}, one JSON line {"bench": {...}}, one JSON line
{"experiments": {...}}, one JSON line {"kernels": [...]} and the nvidia-smi
name/power-limit line; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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
    # Phase 9's tracked session lane at SessionPolicy.track_n_hyps = 32 (its
    # prewarmed buckets; a 1-frame bucket stages 2 lanes) and the sequence
    # leg's single tracked frame.
    "session_lanes2": (2, 7, 32, 480, 640),
    "session_frames4": (4, 7, 32, 480, 640),
    "session_frames16": (16, 7, 32, 480, 640),
    "session_frame1": (1, 7, 32, 480, 640),
    # Phase 10 (expert-parallel, 2 ranks): each rank's select launches --
    # config #4's 25 local experts x 4 frames; routed top-2 of 50 experts
    # (4 frames x 2 slots x 256 * 50 // 2 hypotheses); 4 frames x 4 padded
    # slots -- and its score launches in sharded training (2 frames x the 8
    # gathered experts dense, 2 frames x 2 at capacity 2).
    "sharded_local25": (4, 25, 256, 480, 640),
    "sharded_routed_k2": (4, 2, 6400, 480, 640),
    "sharded_padded": (4, 4, 256, 480, 640),
    "sharded_train_dense": (2, 8, 256, 480, 640),
    "sharded_train_capacity2": (2, 2, 256, 480, 640),
    # Phase 11's gradient witness: the degenerate corpus's one problem of
    # 4 hypotheses over 16 cells (a 32 x 32 frame on the stride-8 grid),
    # below one 32-cell chunk of fused_scoring.cell_chunks.
    "lint_corpus": (1, 1, 4, 32, 32),
    # Phase 12's scoring sweep: dsac_infer_frames over 16 frames of one map
    # under "fused_select" at each n_hyps of bench.py's SCORING_SWEEP.
    "bench_scoring_64": (16, 1, 64, 480, 640),
    "bench_scoring_256": (16, 1, 256, 480, 640),
    "bench_scoring_1024": (16, 1, 1024, 480, 640),
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
                hypotheses=256, eval_batch=4, limit=2, topk=2, cpp_iterations=2,
                cpp_loss_clamp=1000.0)
# The cpp leg trains with --loss-clamp 1000: the stage-1 experts of 3
# iterations put every hypothesis past the default clamp of 100 (1 m), where
# the clamped loss has no gradient, so the check that the extension's
# gradient reaches every expert and the gating net would see none (a CPU
# rehearsal at the test size: E[pose loss] 100.000 on every step; 218.9 and
# 182.5 with the clamp at 1000).  Rotation errors stay below 180, so the
# clamp binds only past 10 m.
# The --backend cpp leg's launches: the hypothesis loop is C++ on the host.
NO_LAUNCHES = {"soft_inlier_scores": 0, "soft_inlier_select": 0}
# Phase 12: every bench mode at its own shapes; what is cut, against the
# bench's defaults (esac_tpu_torch/bench/constants.py): repeats (headline
# 20 -> 3, streaming 5 -> 1, scoring / serve / routed 5 -> 1, registry 7 ->
# 2, obs 9 -> 1), open-loop windows (loadtest 2.5 s -> 0.25 s a point,
# chaos 2.0 -> 0.25 s a phase, fleet 1.5 -> 0.2 s a point), request counts
# (prefetch 240 -> 48 a leg, obs 24 -> 8 a pass, hostpath 300 -> 30,
# sessions 16 -> 4 frames a session) and city's retriever fit (200 -> 100
# steps).
BENCH = {
    "headline": dict(repeats=3),
    "streaming": dict(repeats=1),
    "scoring": dict(repeats=1),
    "serve": dict(repeats=1),
    "routed": dict(repeats=1),
    "registry": dict(repeats=2),
    "prefetch": dict(n_requests=48),
    "loadtest": dict(seconds=0.25),
    "chaos": dict(seconds=0.25),
    "obs": dict(n_frames=8, repeats=1),
    "fleet": dict(seconds=0.2),
    "hostpath": dict(n_requests=30),
    "city": dict(train_steps=100),
    "sessions": dict(load_frames=4),
}
# bench.py's metric of each mode at these shapes.
BENCH_METRICS = {
    "headline": "pose_hypotheses_per_sec_per_chip",
    "streaming": "streaming_hypotheses_per_sec_per_chip",
    "serve": "serve_hyps_per_sec_frame_batch_64",
    "registry": "registry_hot_swap_p50_ms",
    "routed": "routed_serve_speedup_x_at_k_m4",
    "loadtest": "serve_loadtest_knee_sustained_hyps_per_s",
    "scoring": "scoring_fused_select_hyps_per_s_at_1024",
    "chaos": "chaos_healthy_scene_goodput_retention",
    "obs": "obs_tracing_overhead_pct",
    "prefetch": "weight_tier_served_p99_cut_x",
    "fleet": "fleet_healthy_goodput_retention_under_wedge",
    "hostpath": "hostpath_per_replica_capacity_rps",
    "city": "city_recall_at_2",
    "sessions": "session_tracked_speedup_x",
}


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
    results["nan_planted"] = _nan_planted(dev, seed)
    return results


# Phase 3's planted-NaN shape (frames, maps, hypotheses, height, width): the
# serving bucket's P = 28, H = 256, N = 4800.
NAN_PLANTED = (4, 7, 256, 480, 640)


def _same_or_both_nan(a, b) -> bool:
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _nan_planted(dev, seed):
    """Both kernels on poses with NaN planted in t, held against their
    plain versions: torch.argmax's order, where NaN is greater than every
    number.  Problems cycle through four kinds: a NaN depth (t_z) at the
    hypothesis before the finite winner and a NaN t_x after it (the first
    wins); a NaN t_x after the winner only (it wins); every t NaN (index 0,
    score NaN); none planted (as the other shapes)."""
    import torch

    from esac_tpu_torch.ransac import fused_scoring as fs

    B, M, H, height, width = NAN_PLANTED
    Rs, ts, coords, pixels, f, c = _scoring_inputs(dev, seed + 7, B, M, H, height, width)
    P, N = B * M, coords.shape[2]
    w = torch.argmax(fs._scores_plain(Rs, ts, coords, pixels, f, c, 10.0, 0.5), dim=-1)
    ts = ts.clone()
    flat_t, flat_w = ts.view(P, H, 3), w.reshape(P).tolist()
    want = []
    for p, wp in enumerate(flat_w):
        kind = p % 4
        if kind == 0:
            flat_t[p, max(wp - 1, 0), 2] = float("nan")
            flat_t[p, min(wp + 1, H - 1), 0] = float("nan")
            want.append(max(wp - 1, 0))
        elif kind == 1:
            flat_t[p, min(wp + 1, H - 1), 0] = float("nan")
            want.append(min(wp + 1, H - 1))
        elif kind == 2:
            flat_t[p] = float("nan")
            want.append(0)
        else:
            want.append(wp)
    args = (Rs, ts, coords, pixels, f, c, 10.0, 0.5)
    planted = torch.tensor([p % 4 != 3 for p in range(P)], device=dev).reshape(B, M)

    k_scores = fs.soft_inlier_scores_kernel(*args)
    p_scores = fs._scores_plain(*args)
    k_i, k_s, k_pose = fs.soft_inlier_score_select(*args)
    p_i, p_s, p_pose = fs._select_plain(*args)
    sync(dev)
    if not torch.equal(torch.isnan(k_scores), torch.isnan(p_scores)):
        raise AssertionError("nan_planted: the scoring kernel's NaN scores differ from plain")
    if not torch.allclose(k_scores, p_scores, equal_nan=True, **SCORE_TOL):
        raise AssertionError("nan_planted: scoring kernel vs plain on the finite scores")
    if p_i.reshape(P).tolist() != want:
        raise AssertionError(f"nan_planted: plain winners {p_i.reshape(P).tolist()} != {want}")
    top2 = p_scores.nan_to_num(nan=float("inf")).topk(2, dim=-1).values
    clear = planted | ((top2[..., 0] - top2[..., 1])
                       > (SCORE_TOL["atol"] + SCORE_TOL["rtol"] * top2[..., 0]))
    if not torch.equal(k_i[clear], p_i[clear]):
        raise AssertionError(f"nan_planted: select winners {k_i.reshape(P).tolist()} != plain "
                             f"{p_i.reshape(P).tolist()}")
    if not torch.equal(torch.isnan(k_s), torch.isnan(p_s)) or not torch.isnan(k_s[planted]).all():
        raise AssertionError("nan_planted: the select kernel's NaN scores differ from plain")
    if not torch.allclose(k_s, p_s, equal_nan=True, **SCORE_TOL):
        raise AssertionError("nan_planted: select score vs plain")
    want_pose = torch.cat([Rs.reshape(B, M, H, 9), ts], -1)[
        torch.arange(B)[:, None], torch.arange(M)[None], k_i]
    if not _same_or_both_nan(k_pose, want_pose):
        raise AssertionError("nan_planted: winner pose row is not its input row")
    if not torch.equal(torch.argmax(k_scores, dim=-1), k_i):
        raise AssertionError("nan_planted: argmax of the scoring kernel != select winner")
    if not _same_or_both_nan(k_scores.gather(-1, k_i[..., None])[..., 0], k_s):
        raise AssertionError("nan_planted: scores at the select winner != its best score")

    def finite_err(a, b):
        both = torch.isfinite(a) & torch.isfinite(b)
        return float((a - b)[both].abs().max())

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
    out = dict(P=P, H=H, N=N, err_scores=finite_err(k_scores, p_scores),
               err_select=finite_err(k_s, p_s), clear_winners=int(clear.sum()), ms=ms,
               cell_split=split, bound=bound, planted=int(planted.sum()),
               winners=k_i.reshape(P).tolist())
    log(f"[kernels] nan_planted: P={P} H={H} N={N}  {out['planted']} problems with NaN "
        f"planted in t (before / after the finite winner, every hypothesis): the first NaN "
        f"wins with score NaN through both kernels, as in the plain versions; winners "
        f"checked {out['clear_winners']}/{P}; finite scores max|err| {out['err_scores']:.3g} "
        f"/ {out['err_select']:.3g}; score kernel {ms['score_kernel']:.4f} ms, select kernel "
        f"{ms['select_kernel']:.4f} ms")
    return out


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


EPILOGUE = dict(config="esac7_open_single", cfg={}, batches=(16, 8), reps=20, frames=16)
BF16_PEAK = 989e12


def _conv_sites(net, prefix, height, width) -> list[tuple]:
    """(label, conv, proj, input (C, H, W), residual (C, H, W) or None) of
    every convolution call of an ExpertNet or GatingNet but the coordinate
    head, in call order."""
    out, h, w, c = [], height, width, 3

    def step(conv, h, w):
        s, p, k = conv.stride[0], conv.padding[0], conv.kernel_size[0]
        return (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1

    convs = list(net.stem) if hasattr(net, "stem") else list(net.convs)
    for i, conv in enumerate(convs):
        out.append((f"{prefix}.{i}", conv, None, (c, h, w), None))
        (h, w), c = step(conv, h, w), conv.out_channels
    for b, block in enumerate(getattr(net, "head", [])):
        out.append((f"{prefix}.head{b}.conv3", block["conv3"], None, (c, h, w), None))
        proj = block["proj"] if "proj" in block else None
        cc = block["conv3"].out_channels
        out.append((f"{prefix}.head{b}.conv1", block["conv1"], proj, (cc, h, w), (c, h, w)))
        c = cc
    return out


def _site_bound(conv, proj, B, inp, res) -> dict:
    """FLOPs and bytes of one site's call at batch B (bf16 in and out, each
    read or written once) and the least time they allow."""
    C, H, W = inp
    k, s = conv.kernel_size[0], conv.stride[0]
    Ho, Wo = (H + 2 * conv.padding[0] - k) // s + 1, (W + 2 * conv.padding[0] - k) // s + 1
    flops = 2 * B * Ho * Wo * conv.out_channels * C * k * k
    nbytes = 2 * (B * C * H * W + conv.weight.numel() + B * conv.out_channels * Ho * Wo)
    if res is not None:
        nbytes += 2 * B * res[0] * res[1] * res[2]
        if proj is not None:
            flops += 2 * B * Ho * Wo * proj.out_channels * res[0]
            nbytes += 2 * proj.weight.numel()
    least = max(flops / BF16_PEAK, nbytes / HBM_BPS)
    return {"gflop": flops / 1e9, "mb": nbytes / 1e6, "bound_ms": least * 1e3,
            "bound_by": "flops" if flops / BF16_PEAK >= nbytes / HBM_BPS else "bytes"}


def _cuda_kernels(dev, fn) -> dict:
    """Device us by name of the kernels one call of ``fn`` launches,
    longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] = us.get(e.name, 0.0) + e.device_time
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))


def _glue_attribution(dev, net, x) -> list[dict]:
    """One separate-op forward of ``net`` over ``x`` under torch.profiler
    (record_shapes): per (kernel, launching aten op, its input shapes) the
    launches and device ms, the kernels that are not convolutions first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.reduce import kind_of

    with torch.enable_grad():
        net(x)
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            net(x)
            sync(dev)
    rows = {}
    for e in prof.events():
        if not e.kernels:
            continue
        ops, op = [], e  # the aten ops around the launch, innermost first
        while op is not None:
            if op.name.startswith("aten::"):
                ops.append(op)
            op = op.cpu_parent
        inner = ops[0] if ops else e
        outer = ops[-1].name if ops else e.name
        for k in e.kernels:
            key = (k.name[:90], outer, inner.name, str(inner.input_shapes)[:120])
            r = rows.setdefault(key, {"kernel": key[0], "op": key[1], "inner_op": key[2],
                                      "shapes": key[3], "kind": kind_of(k.name),
                                      "launches": 0, "ms": 0.0})
            r["launches"] += 1
            r["ms"] += k.duration / 1e3
    return sorted(rows.values(), key=lambda r: (r["kind"] == "conv", -r["ms"]))


def _nan_block_equal(dev, fn, out) -> bool:
    """``fn()`` bit-equal to ``out`` when the caching allocator hands it a
    block just filled with NaN (an output the fused op never wrote would
    show)."""
    import torch

    junk = torch.full_like(out, float("nan"))
    del junk
    again = fn()
    sync(dev)
    return bool(torch.equal(again, out))


def phase_epilogue(dev, seed, size=EPILOGUE):
    """Phase 5c (module docstring): the CNNs' fused convolutions against
    their separate ops."""
    import torch

    from benchmark import scene, spec
    from benchmark.reduce import kind_of
    from esac_tpu_torch.models.expert import ExpertNet, conv_epilogue, fuses
    from esac_tpu_torch.models.gating import GatingNet
    from esac_tpu_torch.obs.trace import StageClock, stage_scope

    cfg = dict(spec.load(size["config"]).cfg, **size["cfg"])
    experts, gating = scene.make_weights(cfg, seed, dev)
    expert = ExpertNet(stem_channels=cfg["stem_channels"], head_channels=cfg["head_channels"],
                       head_depth=cfg["head_depth"]).to(dev)
    expert.load_state_dict({k: v[0] for k, v in experts.items()})
    gnet = GatingNet(cfg["num_experts"], channels=cfg["gating_channels"]).to(dev)
    gnet.load_state_dict(gating)
    for net in (expert, gnet):
        net.eval().requires_grad_(False)
    frames = scene.make_frames(cfg, seed, size["frames"], dev)["images"]
    del experts, gating

    attribution = _glue_attribution(dev, expert, frames)
    for r in attribution[:12]:
        log(f"[epilogue] glue {r['kind']:<5} {r['ms']:8.3f} ms x{r['launches']:<3} "
            f"{r['op']}/{r['inner_op']} {r['kernel'][:60]} {r['shapes'][:60]}")

    g = torch.Generator(device=dev).manual_seed(seed)
    sites, seen = [], set()
    for label, conv, proj, inp, res in (_conv_sites(expert, "expert", cfg["height"], cfg["width"])
                                        + _conv_sites(gnet, "gating", cfg["height"],
                                                      cfg["width"])):
        key = (conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, inp, res,
               proj is not None)
        if key in seen:
            continue
        seen.add(key)
        for B in size["batches"]:
            x = torch.randn((B,) + inp, generator=g, device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            r = None if res is None else torch.randn((B,) + res, generator=g, device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)

            def separate(x=x, r=r, conv=conv, proj=proj):
                with torch.enable_grad():
                    return conv_epilogue(conv, x, r, proj)

            def fused(x=x, r=r, conv=conv, proj=proj):
                with torch.inference_mode():
                    return conv_epilogue(conv, x, r, proj)

            with torch.inference_mode():
                is_fused = fuses(x)
            want, got = separate(), fused()
            sync(dev)
            scale = want.float().abs().max().item()
            row = {"site": label, "batch": B, "in": list(inp), "cout": conv.out_channels,
                   "k": conv.kernel_size[0], "stride": conv.stride[0],
                   "residual": r is not None, "proj": proj is not None, "fused": is_fused,
                   "separate_ms": time_ms(separate, dev, reps=size["reps"]),
                   "fused_ms": time_ms(fused, dev, reps=size["reps"]),
                   "max_rel_diff": (got.float() - want.float()).abs().max().item() / scale,
                   **_site_bound(conv, proj, B, inp, res)}
            row["fused_kernels"] = _cuda_kernels(dev, fused)
            row["separate_kernels"] = _cuda_kernels(dev, separate)
            main = next(iter(row["fused_kernels"]), "")
            # the fused call's longest kernel, and whether CONV_KERNELS
            # classifies it as a convolution
            row["fused_main"], row["fused_main_kind"] = main[:120], kind_of(main)
            if is_fused:
                row["nan_block_equal"] = _nan_block_equal(dev, fused, got)
                if not row["nan_block_equal"]:
                    raise AssertionError(f"{label} at {B}: the fused output depends on "
                                         "the memory it was given")
            sites.append(row)
            log(f"[epilogue] {label:<22} B={B:<3} fused={is_fused!s:<5} "
                f"separate {row['separate_ms']:.4f} ms fused {row['fused_ms']:.4f} ms "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']}) rel {row['max_rel_diff']:.2e} "
                f"{row['fused_main_kind']} {main[:50]}")
            del x, r, want, got

    def forward_pair(net):
        def separate():
            with torch.enable_grad():
                return net(frames)

        def fused():
            with torch.inference_mode():
                return net(frames)

        return separate, fused

    whole = {}
    for name, net in {"expert": expert, "gating": gnet}.items():
        separate, fused = forward_pair(net)
        want = separate()
        clock = StageClock(time.perf_counter, dev)
        with stage_scope(clock):
            got = fused()
        sync(dev)
        counts = dict(clock.conv_stages())
        whole[name] = {"separate_ms": time_ms(separate, dev, reps=10),
                       "fused_ms": time_ms(fused, dev, reps=10),
                       "convs": counts["cnn.convs"], "fused_convs": counts["cnn.fused_convs"]}
        if name == "expert":
            whole[name]["coord_max_cm"] = 100.0 * (got - want).abs().max().item()
            whole[name]["coord_mean_cm"] = 100.0 * (got - want).abs().mean().item()
        else:
            whole[name]["logit_max_diff"] = (got - want).abs().max().item()
        log(f"[epilogue] {name} forward of {size['frames']}: {whole[name]}")
    if not whole["expert"]["coord_max_cm"] < 5.0:
        raise AssertionError(f"fused coordinates {whole['expert']['coord_max_cm']:.3f} cm "
                             "from the separate ops")
    return {"attribution": attribution[:40], "sites": sites, "forward": whole,
            "frames": size["frames"]}


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

    return dict(dispatches=dispatches, launches=launches, peak_bytes=peak,
                cross_bucket=cross, routed=routed_res)


GRAPHS = dict(buckets=(1, 4, 16, 64), calls=4)
GRAPH_STAGES = ("hypotheses", "scoring", "refine")


def phase_graphs(dev, seed, size=GRAPHS):
    """Phase 5b (module docstring): CUDA-graph replays of the served chain
    against the eager path, bit for bit."""
    import torch

    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.serving import (
        init_scene_params,
        make_routed_scene_bucket_fn,
        make_scene_bucket_fn,
    )

    preset = _serving_preset()
    scenes = [init_scene_params(preset, seed=seed + s, device=dev) for s in (0, 1)]
    scenes[1]["f"] = scenes[1]["f"] * 1.1
    scenes[1]["c"] = scenes[1]["c"] + torch.tensor([3.0, -2.0], device=dev)
    scenes[1]["centers"] = scenes[1]["centers"] + 0.5
    cfg = RansacConfig(scoring_impl="fused_select")
    makers = {"dense": lambda: make_scene_bucket_fn(preset, cfg, dev),
              "routed": lambda: make_routed_scene_bucket_fn(preset, cfg, ROUTED_K, dev),
              "prior": lambda: make_scene_bucket_fn(preset, cfg, dev)}
    keys = ("rvec", "tvec", "expert", "score", "inlier_frac")
    extra = {"dense": (), "routed": ("experts_evaluated",),
             "prior": ("prior_hit", "prior_slot")}
    rng = np.random.default_rng(seed + 7)
    out = {}
    for lane, make in makers.items():
        fn = make()
        for bucket in size["buckets"]:
            lanes = max(bucket, 2)
            ms, eager_ms, hits = [], [], 0
            for call in range(size["calls"]):
                batch = {"image": rng.uniform(0, 1, (lanes, preset.height, preset.width, 3))
                         .astype(np.float32),
                         "seed": rng.integers(0, 2 ** 62, lanes)}
                if lane == "prior":
                    batch.update(
                        prior_rvec=rng.normal(0, 0.2, (lanes, PRIOR_SLOTS, 3)).astype(np.float32),
                        prior_tvec=rng.normal(0, 1.0, (lanes, PRIOR_SLOTS, 3)).astype(np.float32),
                        prior_valid=rng.uniform(size=(lanes, PRIOR_SLOTS)) < 0.5)
                params = scenes[call % 2]
                what = f"[graphs] {lane} {lanes} lanes, call {call}"
                sync(dev)
                t0 = time.perf_counter()
                got, _ = counted(dev, "fused_select", what, lambda: fn(params, batch),
                                 prior=lane == "prior")
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                want = make()(params, batch)  # a new function's first call runs eagerly
                sync(dev)
                eager_ms.append((time.perf_counter() - t0) * 1e3)
                _bit_equal(got, want, keys + extra[lane], what)
                if lane == "prior":
                    hits += int(want["prior_hit"].sum())
            out[f"{lane}_{lanes}"] = dict(eager_ms=eager_ms, first_ms=ms[0], capture_ms=ms[1],
                                          replay_ms=ms[2:], prior_hits=hits)
            log(f"[graphs] {lane} {lanes} lanes: eager {min(eager_ms):.1f} ms, first call "
                f"{ms[0]:.1f}, capture {ms[1]:.1f}, replays "
                + ", ".join(f"{v:.1f}" for v in ms[2:]) + " ms; bit-equal"
                + (f"; {hits} prior hits" if lane == "prior" else ""))
        g = fn.graphs
        n = g.signatures()
        counts = {stage: (g.captures.get(stage=stage), g.replays.get(stage=stage))
                  for stage in GRAPH_STAGES}
        # CPU tensors run the chain eagerly: no signature is kept there.
        want_n = len(size["buckets"]) if dev.type == "cuda" else 0
        want_counts = (want_n, want_n * (size["calls"] - 2))
        if n != want_n or any(c != want_counts for c in counts.values()):
            raise AssertionError(f"[graphs] {lane}: {n} signatures, captures and replays "
                                 f"{counts}, expected {want_counts} a stage")
        out[f"{lane}_counts"] = dict(signatures=n, by_stage=counts)
    return out


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


def _script(dev, label, module, argv, calls, timer=None, per_call=None):
    """``module.main(argv)`` (with ``timer`` for the trainers) with the
    launch counters set to 0 just before and read just after, its standard
    output captured and logged.  Fails unless it returns 0 and launched
    exactly ``per_call`` (by default ``WORKFLOW_LAUNCHES[script]``) x
    ``calls`` (nothing on the CPU).  Returns (output, wall seconds,
    launches, peak bytes)."""
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
    per_call = WORKFLOW_LAUNCHES[name] if per_call is None else per_call
    want = ({k: n * calls for k, n in per_call.items()}
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

    def record(key, *args, **kw):
        text, walls[key], launches[key], peaks[key] = _script(dev, key, *args, **kw)
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
        # Phase 10 (d): the dense evaluation through --sharded at world size
        # 1 (one rank in this process: NCCL on the card, gloo on the CPU).
        path = d / "eval_sharded.json"
        record("test_esac sharded", test_esac,
               [*scenes, *where, "--size", size["size"], "--res", str(size["height"]),
                str(size["width"]), "--frames", str(size["frames"]), "--hypotheses",
                str(size["hypotheses"]), "--scoring-impl", "pallas", "--eval-batch",
                str(size["eval_batch"]), "--limit", str(size["limit"]),
                "--experts", *final[0], "--gating", final[1], "--json", str(path),
                "--sharded"], batches)
        sharded = json.loads(path.read_text())
        dense = evals["dense"]
        same = ("frames", "median_rot_deg", "median_trans_cm", "pct_5cm5deg",
                "expert_accuracy_pct", "gating_top1_pct", "evaluated_recall_pct",
                "hypotheses_total")
        for k in same:
            if sharded[k] != dense[k]:
                raise AssertionError(f"test_esac --sharded: {k} {sharded[k]} != {dense[k]}")
        for k in ("expert", "rot_err_deg", "trans_err_cm", "winner_score"):
            if sharded["per_frame"][k] != dense["per_frame"][k]:
                raise AssertionError(f"test_esac --sharded: per-frame {k} differs")
        if not (sharded["sharded"] and sharded["devices"] == 1
                and sharded["experts_total"] == len(scenes)):
            raise AssertionError(f"test_esac --sharded: {sharded}")
        sharded_eval = dict(frames=sharded["frames"], winners=sharded["per_frame"]["expert"],
                            equal_keys=list(same), frame_ms=sharded["median_ms_per_frame"],
                            dense_frame_ms=dense["median_ms_per_frame"],
                            script_s=walls["test_esac sharded"],
                            launches=launches["test_esac sharded"])
        cpp = _cpp_leg(dev, d, size, scenes, (experts, gating), final, common, where, batches,
                       record)
        setup_scripts = _setup_scripts(d)

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
        eval_batches=batches, sharded_eval=sharded_eval, cpp=cpp, setup_scripts=setup_scripts)
    log(f"[workflow] {len(scenes)} scenes x {size['frames']} frames at {size['width']}x"
        f"{size['height']}, --size {size['size']}: warm ms/iteration "
        + ", ".join(f"{k} {v:.1f}" for k, v in result["iteration_ms_warm"].items())
        + f"; ms/frame {result['frame_ms']}; script s "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f"; launches {totals}; stage-3 train state {state_bytes / 2**20:.0f} MiB on disk, "
        f"read in {state_load_s:.2f} s; stage 3 stop / resume s by stage "
        f"{stage_s['train_esac stop']} / {stage_s['train_esac resume']}")
    return result


class _BridgeRecorder:
    """For one script call, ``backends.train_bridge.make_cpp_expert_losses``
    wrapped: each frame's host call timed (the C++ forward and its
    finite-difference backward, the copies to and from the host included),
    the first frame's inputs and returned losses kept as host copies, with
    the bridge's own arguments."""

    def __enter__(self):
        from esac_tpu_torch.backends import train_bridge

        self.module, self.real = train_bridge, train_bridge.make_cpp_expert_losses
        self.calls, self.seconds, self.first, self.bridge_args = 0, 0.0, None, None

        def make(pixels, f, c, cfg):
            fn = self.real(pixels, f, c, cfg)
            self.bridge_args = (pixels.cpu().numpy(), float(f), (float(c[0]), float(c[1])), cfg)

            def timed(coords_all, R_gt, t_gt, idx):
                t0 = time.perf_counter()
                E = fn(coords_all, R_gt, t_gt, idx)
                sync(E.device)
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                if self.first is None:
                    self.first = {k: v.detach().cpu().numpy() for k, v in dict(
                        coords=coords_all, R=R_gt, t=t_gt, idx=idx, E=E).items()}
                return E

            return timed

        train_bridge.make_cpp_expert_losses = make
        return self

    def __exit__(self, *exc):
        self.module.make_cpp_expert_losses = self.real


def _moved(before: dict, after: dict) -> bool:
    """Whether any parameter of a module changed (Adam moves a parameter
    exactly when a step's gradient of it is non-zero somewhere)."""
    import torch

    return any(not torch.equal(before[k].float(), after[k].float()) for k in before)


def _cpp_leg(dev, d, size, scenes, stage2, final, common, where, batches, record):
    """Phase 7's --backend cpp leg (module docstring): the C++ library's
    build, test_esac --backend cpp on the stage-3 checkpoints and train_esac
    --backend cpp from the stage-1/2 ones, with no kernel launch."""
    from esac_tpu_torch import _build
    from esac_tpu_torch.backends.cpp import esac_train_cpp
    from esac_tpu_torch.scripts import test_esac, train_esac
    from esac_tpu_torch.utils.checkpoint import load_checkpoint
    from esac_tpu_torch.utils.profiling import StageTimer

    built = not _build._host_target(_build.HOST_SRC).exists()
    t0 = time.perf_counter()
    _build.build_host()
    build_s = time.perf_counter() - t0

    path = d / "eval_cpp.json"
    record("test_esac cpp", test_esac,
           [*scenes, *where, "--size", size["size"], "--res", str(size["height"]),
            str(size["width"]), "--frames", str(size["frames"]), "--hypotheses",
            str(size["hypotheses"]), "--backend", "cpp", "--eval-batch",
            str(size["eval_batch"]), "--limit", str(size["limit"]), "--experts", *final[0],
            "--gating", final[1], "--json", str(path)], batches, per_call=NO_LAUNCHES)
    rec = json.loads(path.read_text())
    if (tuple(rec) != test_esac.JSON_KEYS or rec["backend"] != "cpp"
            or rec["evaluated_recall_pct"] is not None
            or rec["frames"] != size["limit"] * len(scenes)
            or not all(np.isfinite(rec["per_frame"][k]).all()
                       for k in ("rot_err_deg", "trans_err_cm"))):
        raise AssertionError(f"test_esac --backend cpp: {rec}")
    frame_ms, loop_ms = rec["median_ms_per_frame"], rec["median_hyploop_ms_per_frame"]

    out = str(d / "esac_cpp")
    timer = StageTimer()
    with _BridgeRecorder() as bridge:
        text = record("train_esac cpp", train_esac,
                      [*scenes, *common, "--iterations", str(size["cpp_iterations"]),
                       "--hypotheses", str(size["hypotheses"]), "--backend", "cpp",
                       "--loss-clamp", str(size["cpp_loss_clamp"]),
                       "--experts", *stage2[0], "--gating", stage2[1], "--output", out],
                      size["cpp_iterations"], timer, per_call=NO_LAUNCHES)
    losses = _losses(text, "train_esac --backend cpp")
    frames = size["cpp_iterations"] * size["batch"]
    if bridge.calls != frames:
        raise AssertionError(f"train_esac --backend cpp: {bridge.calls} host calls, "
                             f"expected {frames}")
    # The first step's expert losses are the extension's on the same
    # coordinates and sets.
    first = bridge.first
    px, f, c, cfg = bridge.bridge_args
    direct_out = esac_train_cpp(first["coords"], px, first["idx"], f, c, first["R"],
                                first["t"], tau=cfg.tau, beta=cfg.beta, alpha=cfg.alpha,
                                train_refine_iters=cfg.train_refine_iters,
                                trans_scale=cfg.trans_scale, loss_clamp=cfg.loss_clamp,
                                want_grad=False)
    direct = direct_out["expert_losses"].astype(np.float32)
    if not np.allclose(first["E"], direct, rtol=1e-6, atol=0):
        raise AssertionError(f"first step's expert losses {first['E']} != direct {direct}")
    # A non-zero gradient on every expert and on the gating net.
    nets = [(f"expert {m}", stage2[0][m], f"{out}_expert{m}") for m in range(len(scenes))]
    nets.append(("gating", stage2[1], f"{out}_gating"))
    still = [name for name, a, b in nets
             if not _moved(load_checkpoint(a)[0], load_checkpoint(b)[0])]
    if still:
        raise AssertionError(f"train_esac --backend cpp: no gradient reached {still} "
                             f"(losses {losses}, first expert losses {first['E']})")
    iteration_s = timer.calls["iteration"]
    result = dict(build_s=build_s, built=built, frames=rec["frames"], frame_ms=frame_ms,
                  host_loop_frame_ms=loop_ms, cnn_frame_ms=frame_ms - loop_ms,
                  accuracy={k: rec[k] for k in ("pct_5cm5deg", "expert_accuracy_pct",
                                                "gating_top1_pct")},
                  iteration_s=iteration_s, train_host_frame_ms=1e3 * bridge.seconds / frames,
                  losses=losses, first_expert_losses=first["E"].tolist(),
                  first_direct_max_rel=float(np.max(np.abs(first["E"] - direct)
                                                    / np.maximum(np.abs(direct), 1e-30))),
                  first_solved_frac=float(direct_out["valid"].mean()))
    log(f"[workflow] cpp: library {'built' if built else 'found'} in {build_s:.2f} s; "
        f"test_esac --backend cpp {rec['frames']} frames: {frame_ms:.2f} ms a frame, "
        f"CNNs {frame_ms - loop_ms:.2f}, host loop {loop_ms:.2f}; train_esac --backend cpp "
        f"iterations {', '.join(f'{t:.2f}' for t in iteration_s)} s, host calls "
        f"{result['train_host_frame_ms']:.1f} ms a frame (clean minimal solves, "
        f"esac_train_cpp's valid, on the first frame: {result['first_solved_frac']:.3f}); "
        f"losses {losses}; first step's "
        f"expert losses equal a direct esac_train_cpp call (max rel "
        f"{result['first_direct_max_rel']:.3g}); every expert and the gating net moved; "
        f"no kernel launch")
    return result


def _setup_scripts(d):
    """The port's three dataset scripts on fabricated source trees in
    ``d``: 7-Scenes (two sequences, one without depth), 12-Scenes (5 frames,
    2 for test) and Aachen (9 images around three places, 3 clusters).
    Image files are raw bytes: the scripts link files, never decode them.
    Returns the files each wrote."""
    from esac_tpu_torch.scripts import setup_7scenes, setup_12scenes, setup_aachen

    raw, pose = b"not decoded", "\n".join(" ".join(["1", "0", "0", "0"]) for _ in range(4))
    src = d / "raw7" / "chess"
    for seq in (1, 2):
        for i in range(2):
            stem = src / f"seq-{seq:02d}" / f"frame-{i:06d}"
            stem.parent.mkdir(parents=True, exist_ok=True)
            pathlib.Path(f"{stem}.color.png").write_bytes(raw)
            pathlib.Path(f"{stem}.pose.txt").write_text(pose)
            if seq == 1:
                pathlib.Path(f"{stem}.depth.png").write_bytes(raw)
    (src / "TrainSplit.txt").write_text("sequence1\n")
    (src / "TestSplit.txt").write_text("sequence2\n")
    data = d / "raw12" / "apt1" / "kitchen" / "data"
    data.mkdir(parents=True)
    for i in range(5):
        (data / f"frame-{i:06d}.color.jpg").write_bytes(raw)
        (data / f"frame-{i:06d}.pose.txt").write_text(pose)
    rng = np.random.default_rng(3)
    lines = []
    (d / "aachen_images" / "db").mkdir(parents=True)
    for b, loc in enumerate([(0, 0, 0), (50, 0, 0), (0, 50, 0)]):
        for i in range(3):
            (d / "aachen_images" / "db" / f"im{b}_{i}.jpg").write_bytes(raw)
            q = rng.normal(size=4)
            c = np.asarray(loc) + rng.normal(0, 0.5, 3)
            lines.append(f"db/im{b}_{i}.jpg {' '.join(map(str, q))} "
                         f"{c[0]} {c[1]} {c[2]} 800.0")
    (d / "aachen_poses.txt").write_text("\n".join(lines))
    runs = {
        "setup_7scenes": (setup_7scenes, ["--source", str(d / "raw7"), "--dest",
                                          str(d / "7scenes"), "--scenes", "chess"]),
        "setup_12scenes": (setup_12scenes, ["--source", str(d / "raw12"), "--dest",
                                            str(d / "12scenes"), "--scenes", "apt1/kitchen",
                                            "--test-frames", "2"]),
        "setup_aachen": (setup_aachen, ["--images", str(d / "aachen_images"), "--poses",
                                        str(d / "aachen_poses.txt"), "--dest",
                                        str(d / "aachen"), "--clusters", "3"]),
    }
    files = {}
    for name, (module, argv) in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = module.main(argv)
        if rc != 0:
            raise AssertionError(f"{name}: exit code {rc}: {buf.getvalue()}")
        dest = pathlib.Path(argv[argv.index("--dest") + 1])
        files[name] = sum(1 for p in dest.rglob("*") if p.is_file())
        log(f"[workflow] {name}: {buf.getvalue().strip()}; {files[name]} files")
    want = {"setup_7scenes": 4 * 3 + 2, "setup_12scenes": 5 * 3, "setup_aachen": 9 * 3 + 1}
    if files != want:
        raise AssertionError(f"setup scripts wrote {files} files, expected {want}")
    meta = json.loads((d / "aachen" / "clusters.json").read_text())
    if sorted(meta["sizes"]) != [3, 3, 3]:
        raise AssertionError(f"setup_aachen clusters {meta}")
    for pose_file in (d / "aachen").rglob("poses/*.txt"):
        T = np.loadtxt(pose_file)
        R = T[:3, :3]
        if not (np.allclose(R @ R.T, np.eye(3), atol=1e-5) and np.allclose(T[3], [0, 0, 0, 1])):
            raise AssertionError(f"{pose_file}: not a rigid camera-to-world pose")
    if (d / "7scenes" / "chess" / "training" / "rgb" / "seq01-frame-000000.png").read_bytes() \
            != raw:
        raise AssertionError("setup_7scenes: the linked image differs from its source")
    return files


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


def phase_server(dev, seed, preset=None, size=SERVER, witness=None):
    """Phase 8 (module docstring): the serving front end on the card -- a
    manifest of three random-init scene versions (and a NaN one) in
    registry checkpoints, SceneRegistry(...).dispatcher(cfg), requests.
    ``witness`` (phase 11's lock and outcome witnesses) rides the overload
    drill and the hot swap."""
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
                               start_worker=False, warm_frame=frames(1)[0])
        if witness is not None:
            # Before the drill's worker starts; the registry's locks are
            # plain locks, wrapped while the (idle) main dispatcher runs.
            witness["lock"].attach_fleet(disp=drill, registry=reg)
        drill.start()
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
        if witness is not None:
            witness["outcome"].observe_run(res)
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

        if witness is not None:
            # The main dispatcher's own lock stays unwrapped: its worker
            # waits on a Condition over it (rebuilding that Condition would
            # strand the worker).  Its instruments are plain locks.
            witness["lock"].attach_obs(disp.obs)
        post, counts = served(swap)
        if swap_err or len(swap_out) != size["swap_requests"]:
            raise AssertionError(f"check 4: {len(swap_out)} served, errors {swap_err}")
        if witness is not None:
            for _ in swap_out + post:  # infer_one / infer_many raise on an error
                witness["outcome"].observe(None, "served")
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


# Phase 9: the fleet.  Request counts of its legs; FLEET_SEED offsets its
# frames' seeds from phases 5 and 8.
FLEET = dict(buckets=(1, 4, 16), requests=24, threads=6, watchdog_ms=2000.0,
             prefetch_rounds=4, prefetch_share=0.8, session_frames=12,
             track_loss_frac=1e-5, seq_frames=48, seq_full=256, image_requests=8,
             enroll_frames=4)
FLEET_SEED = 90_000
FLEET_WINDOW_S = 0.25  # the fleet router's timeline window (phase 10 e)
TRACK_N_HYPS = 32  # esac_tpu/serve/session.py SessionPolicy.track_n_hyps


class _Recorder:
    """A replica's serve function with a count of the calls that returned
    (each one launched the select kernel once) and, while ``log`` is a
    list, every call's (scene, n_hyps, device batch, output)."""

    def __init__(self, serve):
        import threading

        self._serve = serve
        self._lock = threading.Lock()
        self.calls = 0
        self.log = None

    def __call__(self, batch, scene, route_k=None, n_hyps=None):
        out = self._serve(batch, scene, route_k, n_hyps)
        with self._lock:
            self.calls += 1
            if self.log is not None:  # a copy: staged leaves may be reused buffers
                self.log.append((scene, n_hyps, {k: v.clone() for k, v in batch.items()}, out))
        return out


def _wait_calls(recs, want, what, timeout_s=60.0):
    """Until the replicas' serve calls that returned reach ``want`` (a
    released stalled dispatch finishes on its own thread)."""
    t_end = time.perf_counter() + timeout_s
    while sum(r.calls for r in recs) < want:
        if time.perf_counter() > t_end:
            raise AssertionError(f"{what}: {sum(r.calls for r in recs)} serve calls "
                                 f"returned, expected {want}")
        time.sleep(0.01)


def _rows_of(log, results, seeds, what):
    """Each result bit-equal to its row of the one recorded dispatch that
    carried its seed (padding lanes repeat the last frame, so the first
    occurrence is the frame's own row)."""
    for seed, res in zip(seeds, results):
        hits = [(out, batch["seed"].tolist().index(seed)) for _, _, batch, out in log
                if seed in batch["seed"].tolist()]
        if len(hits) != 1:
            raise AssertionError(f"{what}: seed {seed} rode {len(hits)} dispatches")
        out, j = hits[0]
        for key in res:
            if key in out and not np.array_equal(res[key], out[key][j].cpu().numpy()):
                raise AssertionError(f"{what}: seed {seed} {key} differs from its dispatch row")


def _redo(reg, log, what):
    """Every recorded dispatch bit-equal to the replica registry's bucket
    function on the same device batch."""
    import torch

    for scene, n_hyps, batch, out in log:
        entry = reg.manifest.resolve(scene)
        again = reg._fn_for(entry, None, n_hyps)(reg.cache.get(entry), batch)
        for key, v in out.items():
            if not torch.equal(v, again[key]):
                raise AssertionError(f"{what}: {scene} dispatch {key} differs from the "
                                     "bucket function on the same batch")


def _cuda_mem(dev):
    import torch

    sync(dev)
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


def _timed_get(dev, cache, entry):
    t0 = time.perf_counter()
    tree = cache.get(entry)
    sync(dev)
    return tree, (time.perf_counter() - t0) * 1e3


def _sequence_leg(dev, seed, size):
    """The session lane on a continuous trajectory at full width: one good
    expert map and six junk maps per frame, planned by SessionTable, served
    by esac_infer_prior at the full and the tracked budget; a full-budget
    baseline pass on the same maps.  Returns (result, select calls)."""
    import dataclasses

    import torch

    from esac_tpu_torch.data.datasets import SyntheticScene
    from esac_tpu_torch.data.synthetic import output_pixel_grid
    from esac_tpu_torch.geometry.camera import pose_errors
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import esac_infer_prior
    from esac_tpu_torch.ransac.kernel import frame_generators
    from esac_tpu_torch.serve.session import SessionPolicy, SessionTable

    height, width, M, F = size["height"], size["width"], 7, size["seq_frames"]
    ds = SyntheticScene("synth0", split="trajectory", n_frames=F, height=height, width=width,
                        coord_stride=8, device=dev)
    pixels = output_pixel_grid(height, width, 8, device=dev)
    N = pixels.shape[0]
    rng = np.random.default_rng(seed + 20)
    coords = []
    for i in range(F):
        gt = ds[i].coords_gt.reshape(N, 3).cpu().numpy()
        good = gt + rng.normal(0.0, 0.01, gt.shape).astype(np.float32)
        out = rng.random(N) < 0.25
        good[out] = gt[rng.permutation(N)][out]
        junk = [gt[rng.permutation(N)] + rng.normal(0.0, 0.05, gt.shape).astype(np.float32)
                for _ in range(M - 1)]
        coords.append(torch.as_tensor(np.stack([good] + junk), device=dev))
    logits = torch.tensor([2.0] + [-2.0] * (M - 1), device=dev)
    c = torch.tensor([width / 2.0, height / 2.0], device=dev)
    full = RansacConfig(n_hyps=size["seq_full"], refine_iters=4, polish_iters=2,
                        scoring_impl="fused_select")
    track = dataclasses.replace(full, n_hyps=TRACK_N_HYPS)
    policy = SessionPolicy(prior_slots=PRIOR_SLOTS, track_n_hyps=TRACK_N_HYPS,
                           track_loss_frac=0.10, track_enter_frac=0.25, max_sessions=8)
    none_rv, none_valid = np.zeros((PRIOR_SLOTS, 3), np.float32), np.zeros(PRIOR_SLOTS, bool)
    calls = [0]

    def run(i, p_rv, p_tv, p_valid, cfg):
        t0 = time.perf_counter()
        out = esac_infer_prior(frame_generators([FLEET_SEED + i], dev)[0], logits, coords[i],
                               pixels, ds.focal, c, p_rv, p_tv, p_valid, cfg, device=dev)
        sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        calls[0] += 1
        r_err, t_err = pose_errors(rodrigues(out["rvec"]), out["tvec"],
                                   rodrigues(ds[i].rvec), ds[i].tvec)
        return out, dt, float(r_err), float(t_err)

    for cfg in (full, track):  # warm both budgets off the timed loops
        run(0, none_rv, none_rv, none_valid, cfg)
    base = [run(i, none_rv, none_rv, none_valid, full) for i in range(F)]
    table = SessionTable(policy)
    table.open("seq", scene=None, full_n_hyps=full.n_hyps)
    sess = []
    for i in range(F):
        _, _, _, p_rv, p_tv, p_valid, tracked = table.plan("seq")
        out, dt, r_err, t_err = run(i, p_rv, p_tv, p_valid, track if tracked else full)
        transition = table.observe("seq", out["rvec"].cpu().numpy(), out["tvec"].cpu().numpy(),
                                   float(out["inlier_frac"]), tracked)
        sess.append(dict(tracked=tracked, transition=transition, ms=dt, rot_deg=r_err,
                         trans_m=t_err, prior_hit=bool(out["prior_hit"])))
    t_idx = [i for i, s in enumerate(sess) if s["tracked"]]
    if not t_idx:
        raise AssertionError("sequence leg: no frame was tracked")

    def med(xs):
        return float(np.median(xs)) if xs else None

    tracked_ms, full_ms = med([sess[i]["ms"] for i in t_idx]), med([b[1] for b in base])
    result = dict(
        frames=F, n_cells=int(N), full_n_hyps=full.n_hyps, track_n_hyps=TRACK_N_HYPS,
        tracked_frames=len(t_idx), tracked_frac=len(t_idx) / F,
        prior_hit_frac_tracked=float(np.mean([sess[i]["prior_hit"] for i in t_idx])),
        tracked_ms_median=tracked_ms, full_ms_median=full_ms,
        session_full_ms_median=med([s["ms"] for s in sess if not s["tracked"]]),
        tracked_over_full=tracked_ms / full_ms,
        tracked_median_rot_deg=med([sess[i]["rot_deg"] for i in t_idx]),
        full_median_rot_deg=med([base[i][2] for i in t_idx]),
        tracked_median_trans_m=med([sess[i]["trans_m"] for i in t_idx]),
        full_median_trans_m=med([base[i][3] for i in t_idx]),
        transitions={t: sum(s["transition"] == t for s in sess)
                     for t in ("tracked", "lost", "cold")},
        table=table.stats())
    return result, calls[0]


def _witness_fleet(lock_witness, router, reps, injs):
    """Attach phase 11's lock witness to a running fleet: the router's lock
    and obs, each replica's registry (manifest, weight cache, host tier, a
    prefetcher not yet started, its obs) and dispatcher instruments, and
    the fault injectors.  The dispatchers' own locks stay unwrapped: their
    workers wait on Conditions over them."""
    lock_witness.attach(router, "_lock")
    lock_witness.attach_obs(router.obs)
    for rep in reps:
        if rep.registry is not None:
            lock_witness.attach_fleet(registry=rep.registry)
        lock_witness.attach_obs(rep.dispatcher.obs)
    for inj in injs.values():
        lock_witness.attach(inj, "_lock")


def _observe_request(outcome_witness, req, what):
    """One finished request (a dispatcher's or the fleet router's) into the
    outcome witness: (its error type or None, its outcome)."""
    if not req.event.wait(120.0):
        raise AssertionError(f"{what}: a request never finished")
    outcome_witness.observe(None if req.error is None else type(req.error).__name__,
                            req.outcome)


def phase_fleet(dev, seed, preset=None, size=FLEET, witness=None):
    """Phase 9 (module docstring): the fleet tier on the card -- two
    replicas of phase 8's server behind a FleetRouter, host weight tiers,
    the prefetcher, sessions and image-only requests.  ``witness`` (phase
    11's lock and outcome witnesses) rides the failover leg and the legs
    after it."""
    import threading

    import torch

    from esac_tpu_torch.data.datasets import SyntheticScene
    from esac_tpu_torch.fleet import FleetPolicy, FleetRouter, Replica
    from esac_tpu_torch.obs import render_prometheus
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.cache import tree_nbytes
    from esac_tpu_torch.registry.hosttier import EXACT_KEYS, HostWeightTier, compress_tree
    from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest
    from esac_tpu_torch.registry.prefetch import PrefetchPolicy
    from esac_tpu_torch.registry.serving import (
        SceneRegistry,
        init_scene_params,
        load_scene_params,
        save_scene_params,
    )
    from esac_tpu_torch.retrieval import (
        RetrievalConfig,
        RetrievalFront,
        RetrievalPolicy,
        SceneIndex,
        build_retriever,
        make_retrieval_fn,
    )
    from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
    from esac_tpu_torch.serve.session import SessionPolicy, SessionRouter
    from esac_tpu_torch.serve.slo import FaultInjector, SLOPolicy

    t_phase = time.perf_counter()
    preset = preset or _serving_preset()
    scene_cfg = RansacConfig(scoring_impl="fused_select")
    cfg = RansacConfig(frame_buckets=size["buckets"])
    rng = np.random.default_rng(seed + 9)
    images = rng.uniform(0, 1, (16, preset.height, preset.width, 3)).astype(np.float32)
    counter = [FLEET_SEED]

    def frames(n):
        out = []
        for _ in range(n):
            out.append({"image": images[counter[0] % len(images)], "seed": np.int64(counter[0])})
            counter[0] += 1
        return out

    launches = dict.fromkeys(KERNELS, 0)
    result, legs = {}, {}
    with tempfile.TemporaryDirectory(prefix="esac_fleet_") as tmp:
        t0 = time.perf_counter()
        root, entries = pathlib.Path(tmp), {}
        for s, name in enumerate("abc"):
            params = init_scene_params(preset, seed=seed + 20 + s, device=dev)
            save_scene_params(params, preset, root / name / "expert", root / name / "gating")
            del params
            entries[name] = SceneEntry(scene_id=name, version=1,
                                       expert_ckpt=str(root / name / "expert"),
                                       gating_ckpt=str(root / name / "gating"), preset=preset,
                                       ransac=scene_cfg)
        manifest = SceneManifest()
        for e in entries.values():
            manifest.add(e)
        host_a = load_scene_params(entries["a"])
        scene_bytes = tree_nbytes(host_a)
        payload_bytes = compress_tree(host_a, "bf16")["nbytes"]
        regs, recs, injs, reps = [], [], {}, []
        for i in range(2):
            reg = SceneRegistry(manifest, budget_bytes=scene_bytes, device=dev,
                                host_tier=HostWeightTier(budget_bytes=3 * payload_bytes,
                                                         compression="bf16"))
            reg.prewarm_programs("a", size["buckets"], n_hyps_overrides=(None, TRACK_N_HYPS),
                                 prior_slots=PRIOR_SLOTS)
            pf = reg.attach_prefetcher(PrefetchPolicy(interval_ms=10.0, halflife_s=1.0,
                                                      device_scenes=1,
                                                      repromote_cooldown_s=0.05),
                                       start=False) \
                if i == 0 else None
            rec = _Recorder(reg.infer_fn())
            inj = FaultInjector(rec, tag=f"r{i}")
            disp = MicroBatchDispatcher(
                inj, cfg, slo=SLOPolicy(watchdog_ms=size["watchdog_ms"], watchdog_poll_ms=20.0),
                device=dev, warm_frame=frames(1)[0],
                arrival_sink=None if pf is None else pf.observe)
            reg.bind_obs(disp.obs)
            regs.append(reg)
            recs.append(rec)
            injs[f"r{i}"] = inj
            reps.append(Replica(f"r{i}", disp, registry=reg))
        signatures = [reg.compile_cache_size() for reg in regs]
        router = FleetRouter(reps, FleetPolicy(poll_ms=2.0))
        # Phase 10 (e): the router's loop ticks this timeline and evaluates
        # the default rules between polls for the whole phase.
        timeline = router.obs.attach_timeline(window_s=FLEET_WINDOW_S)
        rules = router.obs.attach_health_rules()
        disps = [rep.dispatcher for rep in reps]
        sync(dev)
        result["setup_s"] = time.perf_counter() - t0
        log(f"[fleet] 3 scenes written ({scene_bytes} bytes each, bf16 payload "
            f"{payload_bytes}); 2 replicas (device budget 1 scene, host tier 3 payloads) "
            f"prewarmed at buckets {size['buckets']} x n_hyps (256, {TRACK_N_HYPS}) x "
            f"(plain, {PRIOR_SLOTS} prior slots): {signatures} batch signatures; "
            f"{result['setup_s']:.1f} s")

        def counted_leg(fn, what, extra_calls=0):
            """``fn()`` between zeroed and read launch counters; select launches
            must equal the replicas' serve calls, which equal their recorded
            dispatches plus ``extra_calls`` (abandoned stalled dispatches)."""
            calls0 = sum(r.calls for r in recs)
            disp0 = sum(_dispatches(d) for d in disps)
            out, n = _launches(fn)
            dispatches = sum(_dispatches(d) for d in disps) - disp0
            calls = sum(r.calls for r in recs) - calls0
            if calls != dispatches + extra_calls:
                raise AssertionError(f"{what}: {calls} serve calls for {dispatches} "
                                     f"dispatches (+{extra_calls} abandoned)")
            _expect_launches(dev, n, calls, what)
            for k, v in n.items():
                launches[k] += v
            return out, dispatches

        # a. scene-affinity routing over two replicas
        t_leg = time.perf_counter()
        for r in recs:
            r.log = []
        outs, errors = {}, []
        plan = [frames(1)[0] for _ in range(size["requests"])]

        def client(t):
            try:
                for k in range(t, size["requests"], size["threads"]):
                    outs[k] = router.infer_one(plan[k], scene="ab"[k % 2], timeout=120.0)
            except Exception as e:  # noqa: BLE001 -- reported below, then the run fails
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(t,)) for t in range(size["threads"])]
        _, n_disp = counted_leg(lambda: [t.start() for t in threads]
                                + [t.join(180.0) for t in threads], "leg a")
        if errors or len(outs) != size["requests"]:
            raise AssertionError(f"leg a: {len(outs)} of {size['requests']} served: {errors}")
        homes = router.scene_homes()
        aff = router.affinity_stats()
        books = router.fleet_totals()
        if set(homes) != {"a", "b"} or aff["affinity"] < 1 or books["served"] != \
                books["offered"] or sum(books[o] for o in ("served", "shed", "expired",
                                                            "degraded", "failed",
                                                            "pending")) != books["offered"]:
            raise AssertionError(f"leg a: homes {homes}, affinity {aff}, books {books}")
        _rows_of(recs[0].log + recs[1].log, [outs[k] for k in range(size["requests"])],
                 [int(f["seed"]) for f in plan], "leg a")
        for reg, rec in zip(regs, recs):
            _redo(reg, rec.log, "leg a")
            rec.log = None
        _finite_rows(list(outs.values()), "leg a")
        leg_s = time.perf_counter() - t_leg
        legs["fleet"] = dict(seconds=leg_s, requests=size["requests"], dispatches=n_disp,
                             homes=homes,
                             affinity=aff, books=books)
        log(f"[fleet] leg a: {size['requests']} requests from {size['threads']} threads over "
            f"2 replicas in {n_disp} dispatches; homes {homes}; routes {aff}; every result "
            "bit-equal to its replica's bucket function on the same batch")

        # b. failover: scene a's home stalls
        t_leg = time.perf_counter()
        home = homes["a"][0]
        survivor = "r1" if home == "r0" else "r0"
        release = threading.Event()
        if witness is not None:
            _witness_fleet(witness["lock"], router, reps, injs)
        for inj in injs.values():
            inj.stall_once(release, match=lambda ctx, t=home: ctx["tag"] == t)
        fo_frame = frames(1)[0]
        t0 = time.perf_counter()
        home_reqs = []

        def failover():
            req = router.submit(fo_frame, scene="a", deadline_ms=60_000.0)
            home_reqs.append(req.ureq)  # the home replica's own request
            return req, req.get(90.0)

        (req, fo_out), _ = counted_leg(failover, "leg b (before release)")
        fo_ms = (time.perf_counter() - t0) * 1e3
        quarantined = router.quarantined_replicas()
        if (req.outcome != "served" or req.failover_from != [home] or req.replica != survivor
                or set(quarantined) != {home} or "wedge" not in quarantined[home]):
            raise AssertionError(f"leg b: outcome {req.outcome}, from {req.failover_from}, "
                                 f"replica {req.replica}, quarantined {quarantined}")
        sdisp = disps[int(survivor[1])]
        direct, _ = counted_leg(lambda: sdisp.infer_one(fo_frame, scene="a", timeout=120.0),
                                "leg b (direct)")
        for key in direct:
            if not np.array_equal(direct[key], fo_out[key]):
                raise AssertionError(f"leg b: failed-over {key} differs from the survivor "
                                     "dispatched directly")

        def release_and_serve():
            calls0 = sum(r.calls for r in recs)
            release.set()
            _wait_calls(recs, calls0 + 1, "leg b (the released stall)")
            router.release_replica(home)
            hdisp = disps[int(home[1])]
            hdisp.release_lane("a")
            back = router.submit(frames(1)[0], scene="a", deadline_ms=60_000.0)
            return back, back.get(90.0)

        (back, back_out), _ = counted_leg(release_and_serve, "leg b (after release)",
                                          extra_calls=1)
        books = router.fleet_totals()
        if back.outcome != "served" or back.replica != home or router.quarantined_replicas() \
                or books["served"] != books["offered"]:
            raise AssertionError(f"leg b: after release outcome {back.outcome} on "
                                 f"{back.replica}, books {books}")
        if witness is not None:
            # The fleet request, the survivor served directly, the request
            # after the release, and the home replica's stalled request.
            for r_ in (req, back) + tuple(u for u in home_reqs if u is not None):
                _observe_request(witness["outcome"], r_, "leg b")
            witness["outcome"].observe(None, "served")
        leg_s = time.perf_counter() - t_leg
        legs["failover"] = dict(seconds=leg_s, home=home, survivor=survivor,
                                quarantine=quarantined[home],
                                failover_ms=fo_ms, books=books,
                                injectors={n: i.stats() for n, i in injs.items()})
        log(f"[fleet] leg b: {home} stalled -> quarantined ({quarantined[home][:60]}...); the "
            f"request failed over to {survivor} in {fo_ms:.0f} ms (watchdog "
            f"{size['watchdog_ms']:.0f} ms), bit-equal to {survivor} directly, counted once; "
            f"released, {home} serves again")

        # c. the host tier: a -> b -> c -> a on one replica
        t_leg = time.perf_counter()
        reg, disp = regs[int(home[1])], disps[int(home[1])]
        cmp_frames = frames(2)
        tier_ms, freed, order = {}, [], []
        stats0 = reg.cache.stats()

        def tier_walk():
            outs_c, tree = {}, None
            for step, name in enumerate(("a", "b", "c", "a")):
                entry = entries[name]
                old = reg.cache.keys()
                source = ("device" if entry.key in reg.cache else
                          "host" if entry.key in reg.host_tier else "disk")
                tree = None
                before = _cuda_mem(dev)
                tree, ms = _timed_get(dev, reg.cache, entry)
                after = _cuda_mem(dev)
                order.append((name, source))
                tier_ms.setdefault(source, ms)
                for key in old:
                    if key == entry.key:
                        continue
                    gone = None if before is None else before + tree_nbytes(tree) - after
                    freed.append(dict(demoted=list(key), freed=gone))
                    if key not in reg.host_tier or key in reg.cache:
                        raise AssertionError(f"leg c: {key} was not demoted to the host tier")
                    if gone is not None and gone < 0.9 * scene_bytes:
                        raise AssertionError(f"leg c: demoting {key} freed {gone} bytes of "
                                             f"{scene_bytes}")
                outs_c[step] = disp.infer_many(cmp_frames, scene=name)
            _, ms = _timed_get(dev, reg.cache, entries["a"])
            tier_ms["warm"] = ms
            return outs_c

        outs_c, _ = counted_leg(tier_walk, "leg c")
        st = reg.cache.stats()
        if order[-1] != ("a", "host") or ("c", "disk") not in order or \
                st["disk_loads"] - stats0["disk_loads"] != sum(s == "disk" for _, s in order):
            raise AssertionError(f"leg c: sources {order}, cache {st}")
        # The promoted weights: bf16-rounded CNNs, byte-exact geometry leaves.
        staged = reg.cache.get(entries["a"])
        w = staged["expert"][0].state_dict()
        for k, v in host_a["expert"].items():
            if not torch.equal(w[k].cpu(), v[0].to(torch.bfloat16).float()):
                raise AssertionError(f"leg c: promoted expert leaf {k} is not the bf16-rounded "
                                     "original")
        for k in EXACT_KEYS:
            if not torch.equal(staged[k].cpu(), host_a[k]):
                raise AssertionError(f"leg c: promoted {k} is not byte-exact")

        def rounded(entry):
            tree = load_scene_params(entry)
            for sub in ("expert", "gating"):
                tree[sub] = {k: v.to(torch.bfloat16).float() for k, v in tree[sub].items()}
            return tree

        plain = SceneRegistry(manifest, loader=rounded, device=dev)
        rows, _ = _direct(plain, entries["a"], cmp_frames, size["buckets"])
        for lo, n, out in rows:
            _same_rows(outs_c[3][lo:lo + n], {k: v[:n] for k, v in out.items()}, 0,
                       "leg c (after the promote, against the bf16-rounded tree)")
        del plain, rows
        leg_s = time.perf_counter() - t_leg
        legs["host_tier"] = dict(seconds=leg_s, sources=order, ms=tier_ms, freed=freed, cache=st,
                                 tier=reg.host_tier.stats())
        log(f"[fleet] leg c: a -> b -> c -> a on {home}: sources {order}; disk cold load "
            f"{tier_ms['disk']:.1f} ms, host-tier promote {tier_ms['host']:.1f} ms, warm hit "
            f"{tier_ms['warm']:.3f} ms; each demotion freed >= 0.9 of a scene; promoted "
            "weights bf16-rounded (geometry exact), results bit-equal to the rounded tree")

        # d. the prefetcher on replica 0, four requests for b to each for a
        t_leg = time.perf_counter()
        reg0, disp0, pf = regs[0], disps[0], regs[0]._prefetcher
        n_b = int(round(size["prefetch_share"] / (1 - size["prefetch_share"])))
        pf.run_cycle()  # fold the arrivals of legs a-c
        pf.start()
        ahead = []

        def skewed():
            for _ in range(size["prefetch_rounds"]):
                for _ in range(n_b):
                    disp0.infer_one(frames(1)[0], scene="b", timeout=120.0)
                disp0.infer_one(frames(1)[0], scene="a", timeout=120.0)  # demotes b
                time.sleep(0.15)  # prefetch cycles run (10 ms apart)
                before = reg0.cache.stats()
                resident = entries["b"].key in reg0.cache
                disp0.infer_one(frames(1)[0], scene="b", timeout=120.0)
                after = reg0.cache.stats()
                ahead.append(resident and after["hits"] == before["hits"] + 1
                             and after["host_hits"] == before["host_hits"]
                             and after["disk_loads"] == before["disk_loads"])

        counted_leg(skewed, "leg d")
        pf.close()
        pst = pf.stats()
        if not all(ahead) or pst["issued_device"] < size["prefetch_rounds"]:
            raise AssertionError(f"leg d: b promoted ahead of its demand {ahead}, prefetch {pst}")
        leg_s = time.perf_counter() - t_leg
        legs["prefetch"] = dict(seconds=leg_s, ahead=ahead, stats=pst, cache=reg0.cache.stats())
        log(f"[fleet] leg d: b ({n_b} requests to each of a) was promoted back to the card "
            f"before each "
            f"of its {len(ahead)} next demands; prefetcher issued {pst['issued_device']} device "
            f"+ {pst['issued_host']} host, {pst['hits']} hits, {pst['wasted']} wasted")

        # e. sessions over the fleet, then the sequence leg
        t_leg = time.perf_counter()
        for r in recs:
            r.log = []
        sigs0 = [reg.compile_cache_size() for reg in regs]
        sessions = SessionRouter(router, SessionPolicy(prior_slots=PRIOR_SLOTS,
                                                       track_n_hyps=TRACK_N_HYPS,
                                                       track_loss_frac=size["track_loss_frac"]))
        sess_out, sess_err = {}, []

        def stream(name, scene):
            try:
                sessions.open(name, scene=scene, full_n_hyps=scene_cfg.n_hyps)
                sess_out[name] = [sessions.infer_frame(name, f, timeout=120.0)
                                  for f in frames(size["session_frames"])]
            except Exception as e:  # noqa: BLE001 -- reported below, then the run fails
                sess_err.append(repr(e))

        def run_sessions():
            ths = [threading.Thread(target=stream, args=(f"s{s}", s)) for s in "ab"]
            for th in ths:
                th.start()
            for th in ths:
                th.join(300.0)

        counted_leg(run_sessions, "leg e(1)")
        lanes = [(n_hyps, tuple(batch["prior_valid"].shape)) for r in recs
                 for _, n_hyps, batch, _ in r.log]
        for r in recs:
            r.log = None
        transitions = [o["session_transition"] for outs_s in sess_out.values() for o in outs_s]
        tracked = [o for outs_s in sess_out.values() for o in outs_s if o["session_tracked"]]
        fracs = [float(o["inlier_frac"]) for outs_s in sess_out.values() for o in outs_s]
        sigs1 = [reg.compile_cache_size() for reg in regs]
        if (sess_err or len(transitions) != 2 * size["session_frames"] or not tracked
                or not set(transitions) <= {"tracked", "lost", "cold"}
                or any(n == TRACK_N_HYPS and shape[1] != PRIOR_SLOTS for n, shape in lanes)
                or sum(n == TRACK_N_HYPS for n, _ in lanes) < 1 or sigs1 != sigs0):
            raise AssertionError(f"leg e(1): errors {sess_err}, transitions {transitions}, "
                                 f"inlier fractions {fracs}, lanes {lanes}, signatures "
                                 f"{sigs0} -> {sigs1}")
        _finite_rows([o for outs_s in sess_out.values() for o in outs_s], "leg e(1)")
        (seq, calls), n = _launches(lambda: _sequence_leg(dev, seed, dict(
            size, height=preset.height, width=preset.width)))
        _expect_launches(dev, n, calls, "leg e(2)")
        for k, v in n.items():
            launches[k] += v
        leg_s = time.perf_counter() - t_leg
        legs["sessions"] = dict(seconds=leg_s, frames=2 * size["session_frames"],
                                transitions={t: transitions.count(t)
                                             for t in ("tracked", "lost", "cold")},
                                tracked_lane_dispatches=sum(n == TRACK_N_HYPS for n, _ in lanes),
                                inlier_frac_median=float(np.median(fracs)),
                                table=sessions.table.stats(), signatures=sigs1, sequence=seq)
        log(f"[fleet] leg e: 2 sessions x {size['session_frames']} frames over the fleet, "
            f"transitions {legs['sessions']['transitions']}, "
            f"{legs['sessions']['tracked_lane_dispatches']} dispatches on the n_hyps="
            f"{TRACK_N_HYPS} lane with {PRIOR_SLOTS} prior slots, no new batch signature "
            f"{sigs1}")
        log(f"[fleet] leg e: sequence of {seq['frames']} frames at {preset.width}x"
            f"{preset.height}: tracked {seq['tracked_frac']:.2f}, prior hits "
            f"{seq['prior_hit_frac_tracked']:.2f} of tracked, median tracked "
            f"{seq['tracked_ms_median']:.2f} ms vs full {seq['full_ms_median']:.2f} ms "
            f"(ratio {seq['tracked_over_full']:.3f}); tracked median error "
            f"{seq['tracked_median_rot_deg']:.3f} deg / {seq['tracked_median_trans_m']:.4f} m "
            f"vs full {seq['full_median_rot_deg']:.3f} deg / "
            f"{seq['full_median_trans_m']:.4f} m")

        # f. image-only requests
        t_leg = time.perf_counter()
        rcfg = RetrievalConfig(height=preset.height, width=preset.width)
        net = build_retriever(rcfg, seed=seed, device=dev)
        fn = make_retrieval_fn(rcfg, device=dev)
        index = SceneIndex(rcfg.max_scenes, rcfg.embed_dim)
        looks = {}
        for name, synth in (("a", "synth0"), ("b", "synth1")):
            sc = SyntheticScene(synth, "test", n_frames=size["enroll_frames"] + 4,
                                height=preset.height, width=preset.width, device=dev)
            looks[name] = [sc[i].image.float().cpu().numpy()
                           for i in range(size["enroll_frames"] + 4)]
            protos, mask, _ = index.snapshot()
            emb = fn(net, protos, mask, np.stack(looks[name][:size["enroll_frames"]]))
            index.enroll(name, emb["embedding"].cpu().numpy())
        front = RetrievalFront(fn, net, index, RetrievalPolicy(top_k=2, min_confidence=0.0))
        router.attach_retrieval(front)
        protos, mask, _ = index.snapshot()
        probe = looks["a"][-1][None]
        retr_ms = time_ms(lambda: fn(net, protos, mask, probe), dev, reps=10)
        sig = fn._cache_size()
        queries = [{"image": looks["ab"[i % 2]][size["enroll_frames"] + i // 2],
                    "seed": np.int64(FLEET_SEED + 10_000 + i)}
                   for i in range(size["image_requests"])]
        img_out, _ = counted_leg(lambda: [router.infer_image(q, timeout=120.0)
                                          for q in queries], "leg f")
        for q, out in zip(queries, img_out):
            win = out["retrieval"]["scene"]
            direct = router.infer_one(q, scene=win, timeout=120.0)
            for key in direct:
                if not np.array_equal(direct[key], out[key]):
                    raise AssertionError(f"leg f: the winner's {key} differs from the frame "
                                         f"dispatched directly to scene {win}")
        fst = front.stats()
        if (fst["served"] != size["image_requests"] or fst["pending"]
                or sum(fst[o] for o in ("served", "shed", "expired", "degraded", "failed"))
                != fst["offered"] or fn._cache_size() != sig):
            raise AssertionError(f"leg f: front {fst}, signatures {sig} -> {fn._cache_size()}")
        leg_s = time.perf_counter() - t_leg
        legs["images"] = dict(seconds=leg_s, requests=size["image_requests"], retriever_ms=retr_ms,
                              winners=[o["retrieval"]["scene"] for o in img_out],
                              top1_p=[o["retrieval"]["top1_p"] for o in img_out],
                              front={k: v for k, v in fst.items() if k != "error_types"})
        log(f"[fleet] leg f: {size['image_requests']} image-only requests served (winners "
            f"{legs['images']['winners']}), each bit-equal to the frame dispatched to its "
            f"winning scene; retriever forward {retr_ms:.3f} ms at batch 1; retriever "
            f"signatures {fn._cache_size()} (enrollment batch, batch 1), none new")

        text = render_prometheus(router.obs.snapshot())
        collectors = sorted(router.obs.tables()[1])
        missing = [name for name in collectors if f"# COLLECTOR {name} (" not in text]
        ticks, windows = timeline.ticks, len(timeline.windows())
        if ticks < 3 or windows < 2 or missing or rules.snapshot()["eval_errors"]:
            raise AssertionError(f"fleet obs: {ticks} ticks, {windows} windows, collectors "
                                 f"missing from the page {missing}, {rules.snapshot()}")
        router.close()
        books = router.fleet_totals()
        if books["served"] != books["offered"]:
            raise AssertionError(f"fleet books {books}")
        alerts = rules.snapshot()
        result["obs"] = dict(ticks=ticks, windows=windows, window_s=FLEET_WINDOW_S,
                             collectors=collectors, rules=alerts["rules"],
                             alert_events=len(alerts["events"]),
                             active=sorted(alerts["active"]),
                             prometheus_lines=len(text.splitlines()))
        log(f"[fleet] obs: the router's loop ticked {ticks} windows of {FLEET_WINDOW_S} s and "
            f"evaluated {alerts['rules']} ({len(alerts['events'])} alert events, active "
            f"{sorted(alerts['active'])}); the Prometheus page ({len(text.splitlines())} "
            f"lines) names all {len(collectors)} collectors")
        result.update(legs=legs, books=books, launches=launches,
                      seconds=time.perf_counter() - t_phase)
    log(f"[fleet] 6 legs passed in {result['seconds']:.1f} s; launches {launches}")
    return result


# Phase 10: the expert-parallel path (esac_tpu_torch.parallel).  Leg a runs
# in this process (one NCCL rank); legs b and c in 2 spawned gloo ranks that
# share the card.  Shapes: config #2 (7 experts) for a and c, config #4 (50
# experts) for b, all at the serving width.
PARALLEL = dict(height=480, width=640, arch="ref", n_hyps=256, experts_a=7, buckets_a=(1, 4),
                experts_b=50, frames_b=4, routed_k=2, pad_experts=7, pad_capacity=4,
                train_experts=7, train_frames=2, train_steps=2, capacity=2, reps=10)
PARALLEL_SEED = 130_000
# Routed-sharded poses against the single-device routed entry (radians,
# meters): the two run the same expert CNNs over the same capacity blocks,
# but the CNN stage is not promised bit for bit across processes (cuDNN).
ROUTED_POSE_ATOL = 1e-4
RANKS = 2


def _preset(size, num_experts):
    from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
    from esac_tpu_torch.registry.manifest import ScenePreset

    return ScenePreset(height=size["height"], width=size["width"], num_experts=num_experts,
                       gating_channels=GATING_PRESETS[size["arch"]]["channels"],
                       compute_dtype="bfloat16", **EXPERT_PRESETS[size["arch"]])


def _expert_nets(preset, seed, ids, dev):
    """Experts ``ids`` of a random-init scene, each initialized on the
    device from its own seed (seed * 1000 + global index), so any rank that
    builds expert m builds the same one."""
    import torch

    from esac_tpu_torch.models.expert import ExpertNet

    nets = []
    for m in ids:
        torch.manual_seed(seed * 1000 + m)
        with torch.device(dev):
            nets.append(ExpertNet(stem_channels=preset.stem_channels,
                                  head_channels=preset.head_channels,
                                  head_depth=preset.head_depth,
                                  compute_dtype=torch.bfloat16).eval())
    return nets


def _synth_maps(rng, B, M, height, width, true_of):
    """B frames x M maps: map ``true_of(b)`` frame b's coordinates, the
    others cell-scrambled decoys (numpy).  Returns coords (B, M, N, 3),
    pixels (N, 2), focals (B,), c (2,)."""
    f, c = 525.0 * width / 640.0, np.array([width / 2.0, height / 2.0], np.float32)
    N = (height // 8) * (width // 8)
    coords = np.empty((B, M, N, 3), np.float32)
    for b in range(B):
        X, pixels, _, _ = synth_frame(rng, f, c, height, width)
        for m in range(M):
            coords[b, m] = X if m == true_of(b) else X[rng.permutation(N)]
    return coords, pixels, np.full(B, f, np.float32), c


def _launch_counts():
    return {name: w.launches for name, w in _wrappers().items()}


def _zero_launches():
    for w in _wrappers().values():
        w.launches = 0


def _expect(dev, got, want, what, total=None):
    """Fail unless the launch counts ``got`` are ``want`` (0 off the card);
    add them to ``total`` (the leg's sharded launches)."""
    want = want if dev.type == "cuda" else dict.fromkeys(KERNELS, 0)
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
    if total is not None:
        for k, v in got.items():
            total[k] += v


def _host_ms(dev, fn, reps, warmup=1):
    """Mean host milliseconds of ``fn()`` over ``reps`` calls after
    ``warmup`` calls, synchronized before the first timed call and after
    the last (collectives: every rank calls)."""
    for _ in range(warmup):
        fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _bit_rows(got: dict, want: dict, keys, what):
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {k} differs from the unsharded entry")


def _winner_ms(dev, mesh, B, reps):
    """Host ms of one argmax all-reduce (MAX, MIN, SUM) over B frames."""
    import torch

    from esac_tpu_torch.parallel.esac_sharded import _winner_allreduce
    from esac_tpu_torch.parallel.mesh import axis_group

    score = torch.rand(B, device=dev)
    g = torch.arange(B, device=dev)
    pose = torch.rand(B, 3, device=dev)
    group = axis_group(mesh, "expert")
    return _host_ms(dev, lambda: _winner_allreduce(score, g, pose, pose, 64, group), reps)


def _leg_a(dev, seed, size):
    """World size 1 (NCCL on the card): the sharded coords-level frames at
    config #2's shape, buckets of 1 and 4 frames, bit-identical to
    esac_infer_frames; and make_sharded_serve_fn behind a dispatcher."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from esac_tpu_torch.parallel import esac_infer_sharded_frames, initialize_multihost, make_mesh
    from esac_tpu_torch.parallel.multihost import free_port
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import esac_infer_frames
    from esac_tpu_torch.ransac.kernel import frame_generators
    from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher, make_sharded_serve_fn

    H, W, M = size["height"], size["width"], size["experts_a"]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend, dev)
    out = {"backend": backend, "world": 1, "buckets": {}}
    launches = dict.fromkeys(KERNELS, 0)
    try:
        mesh = make_mesh(1, 1)
        cfg = RansacConfig(n_hyps=size["n_hyps"], scoring_impl="fused_select")
        rng = np.random.default_rng(seed + PARALLEL_SEED)
        for B in size["buckets_a"]:
            coords, pixels, f, c = _synth_maps(rng, B, M, H, W, lambda b: b % M)
            seeds = np.arange(B) + seed + PARALLEL_SEED + 100 * B
            args = [torch.as_tensor(x, device=dev) for x in (coords, pixels, f, c)]
            got, n = counted(dev, "fused_select", f"leg a sharded B={B}",
                             lambda: esac_infer_sharded_frames(mesh, seeds, *args[:3], args[3],
                                                               cfg, device=dev))
            for k, v in n.items():
                launches[k] += v
            want, _ = counted(dev, "fused_select", f"leg a unsharded B={B}",
                              lambda: esac_infer_frames(frame_generators(seeds, dev),
                                                        torch.zeros((B, M), device=dev),
                                                        *args, cfg, device=dev))
            _bit_rows({k: v.cpu() for k, v in got.items()},
                      {k: want[k].cpu() for k in got}, ("rvec", "tvec", "expert", "score"),
                      f"leg a B={B}")
            if got["expert"].cpu().tolist() != [b % M for b in range(B)]:
                raise AssertionError(f"leg a B={B}: winners {got['expert'].tolist()}")
            out["buckets"][B] = dict(
                sharded_ms=_host_ms(dev, lambda: esac_infer_sharded_frames(
                    mesh, seeds, *args[:3], args[3], cfg, device=dev), 3),
                unsharded_ms=_host_ms(dev, lambda: esac_infer_frames(
                    frame_generators(seeds, dev), torch.zeros((B, M), device=dev), *args, cfg,
                    device=dev), 3),
                collectives_ms=_winner_ms(dev, mesh, B, size["reps"]))
        # The serve function behind a dispatcher (world 1: nothing to lead).
        B = max(size["buckets_a"])
        disp_cfg = dataclasses.replace(cfg, frame_buckets=(B,))
        frames = [{"seed": np.int64(seeds[b]), "coords_all": coords[b], "pixels": pixels,
                   "f": np.float32(f[b])} for b in range(B)]
        disp = MicroBatchDispatcher(make_sharded_serve_fn(mesh, c, disp_cfg, device=dev),
                                    disp_cfg, start_worker=False, device=dev)
        out["dispatch_ms"] = []  # the first dispatch, then a warm one
        for _ in range(2):
            _zero_launches()
            t0 = time.perf_counter()
            rows = disp.infer_many(frames)
            out["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
            _expect(dev, _launch_counts(), LAUNCHES_PER_CALL["fused_select"],
                    "leg a dispatcher", launches)
            for b, row in enumerate(rows):
                _bit_rows(row, {k: want[k][b].cpu() for k in ("rvec", "tvec", "expert", "score")},
                          ("rvec", "tvec", "expert", "score"), f"leg a dispatcher frame {b}")
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 \
            if dev.type == "cuda" else 0.0
        out["launches"] = launches  # the direct sharded calls and the dispatches
    finally:
        dist.destroy_process_group()
    log(f"[parallel] a: world 1 ({backend}): sharded frames bit-identical to esac_infer_frames "
        f"at buckets {list(size['buckets_a'])} and through the dispatcher; " + "; ".join(
            f"B={B} sharded {r['sharded_ms']:.2f} ms, unsharded {r['unsharded_ms']:.2f} ms, "
            f"winner all-reduce {r['collectives_ms']:.4f} ms" for B, r in out["buckets"].items())
        + f"; dispatcher {out['dispatch_ms'][0]:.1f} ms first, "
          f"{out['dispatch_ms'][1]:.1f} ms warm")
    return out


def _check_collectives(dev, rank):
    """MAX, MIN and SUM all-reduces of float32 and int64 tensors on this
    rank's device (gloo carries CUDA tensors through host memory) against
    their known results, before anything relies on them."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    want = {"max": [world - 1.0, 0.0], "min": [0.0, -(world - 1.0)],
            "sum": [world * (world - 1) / 2.0, -world * (world - 1) / 2.0]}
    for name, op in (("max", dist.ReduceOp.MAX), ("min", dist.ReduceOp.MIN),
                     ("sum", dist.ReduceOp.SUM)):
        for dtype in (torch.float32, torch.int64):
            x = torch.tensor([rank, -rank], dtype=dtype, device=dev)
            dist.all_reduce(x, op=op)
            if [float(v) for v in x.tolist()] != want[name]:
                raise AssertionError(f"rank {rank}: {name} all-reduce of {dtype} on {dev} "
                                     f"gave {x.tolist()}, expected {want[name]}")
    return sorted(want)


def _map_expert(coords, grid):
    """An expert whose output IS one coordinate map, whatever the image."""
    return lambda images: coords.reshape(1, *grid, 3).expand(images.shape[0], *grid, 3)


def _rank_leg_b(rank, mesh, dev, seed, size):
    """Config #4 over the ranks: 50 experts, half on each; coords-level
    sharded serving behind a dispatcher on rank 0 (the other rank
    following), routed-sharded top-2 serving, and 7 experts padded to 8."""
    import torch
    from torch import nn

    from esac_tpu_torch.models.gating import GatingNet
    from esac_tpu_torch.parallel import (
        esac_infer_routed, esac_infer_sharded_frames, follow,
        make_esac_infer_routed_frames_sharded, make_esac_infer_sharded_frames,
        pad_experts_for_mesh, pad_gating_logits,
    )
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import esac_infer_frames
    from esac_tpu_torch.ransac.kernel import frame_generators
    from esac_tpu_torch.registry.serving import make_routed_scene_bucket_fn
    from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher, make_sharded_serve_fn

    H, W, M, B = size["height"], size["width"], size["experts_b"], size["frames_b"]
    preset = _preset(size, M)
    m = M // RANKS
    lo = rank * m
    local = _expert_nets(preset, seed, range(lo, lo + m), dev)
    cfg = RansacConfig(n_hyps=size["n_hyps"], scoring_impl="fused_select")
    rng = np.random.default_rng(seed + PARALLEL_SEED + 7)  # the same on every rank
    coords, pixels, f, c = _synth_maps(rng, B, M, H, W, lambda b: (13 * b + 3) % M)
    seeds = np.arange(B) + seed + PARALLEL_SEED + 1000
    out = {"experts_local": m, "weights_bytes_local": sum(
        p.numel() * 4 for net in local for p in net.parameters())}
    sel = LAUNCHES_PER_CALL["fused_select"]
    launches = dict.fromkeys(KERNELS, 0)

    # (1) Coords-level sharded serving: the dispatcher on rank 0 leads.
    frames = [{"seed": np.int64(seeds[b]), "coords_all": coords[b], "pixels": pixels,
               "f": np.float32(f[b])} for b in range(B)]
    _zero_launches()
    if rank == 0:  # a first dispatch, then a warm one
        fn = make_sharded_serve_fn(mesh, c, cfg, device=dev)
        disp = MicroBatchDispatcher(fn, cfg, start_worker=False, device=dev)
        out["coords_dispatch_ms"] = []
        for _ in range(2):
            t0 = time.perf_counter()
            rows = disp.infer_many(frames)
            out["coords_dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        fn.stop()
    else:
        follow(make_esac_infer_sharded_frames(mesh, c, cfg, as_tree=True, device=dev), dev)
    _expect(dev, _launch_counts(), {k: 2 * n for k, n in sel.items()},
            f"rank {rank} coords-level dispatches", launches)
    args = [torch.as_tensor(x, device=dev) for x in (coords, pixels, f, c)]
    out["coords_sharded_ms"] = _host_ms(dev, lambda: esac_infer_sharded_frames(
        mesh, seeds, *args[:3], args[3], cfg, device=dev), 3)
    out["collectives_ms"] = _winner_ms(dev, mesh, B, size["reps"])
    if rank == 0:
        want = esac_infer_frames(frame_generators(seeds, dev), torch.zeros((B, M), device=dev),
                                 *args, cfg, device=dev)
        for b, row in enumerate(rows):
            _bit_rows(row, {k: want[k][b].cpu() for k in ("rvec", "tvec", "expert", "score")},
                      ("rvec", "tvec", "expert", "score"), f"leg b coords frame {b}")
        if want["expert"].cpu().tolist() != [(13 * b + 3) % M for b in range(B)]:
            raise AssertionError(f"leg b: winners {want['expert'].tolist()}")
        out["coords_unsharded_ms"] = _host_ms(dev, lambda: esac_infer_frames(
            frame_generators(seeds, dev), torch.zeros((B, M), device=dev), *args, cfg,
            device=dev), 3)

    # (2) Routed-sharded top-k serving from images.
    torch.manual_seed(seed * 1000 + 999)
    with torch.device(dev):
        gating = GatingNet(M, preset.gating_channels, compute_dtype=torch.bfloat16).eval()
    images = torch.as_tensor(rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32), device=dev)
    with torch.inference_mode():
        logits = gating(images)
    centers = torch.zeros((M, 3), device=dev)
    seeds2 = seeds + 100
    routed = make_esac_infer_routed_frames_sharded(mesh, local, centers, cfg,
                                                   k=size["routed_k"], device=dev)
    _zero_launches()
    got = routed(seeds2, logits, images, args[2], args[1], args[3])
    _expect(dev, _launch_counts(), sel, f"rank {rank} routed-sharded dispatch", launches)
    out["routed_sharded_ms"] = _host_ms(dev, lambda: routed(seeds2, logits, images, args[2],
                                                            args[1], args[3]), 2)
    if rank == 0:
        others = _expert_nets(preset, seed, range(m, M), dev)
        params = {"expert": nn.ModuleList(local + others), "gating": gating, "centers": centers,
                  "f": torch.tensor(float(f[0]), device=dev), "c": args[3]}
        single = make_routed_scene_bucket_fn(preset, cfg, size["routed_k"], dev)
        batch = {"image": images, "seed": seeds2}
        want = single(params, batch)
        for k in ("expert", "experts_evaluated"):
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"leg b routed: {k} {got[k].tolist()} != single-device "
                                     f"{want[k].tolist()}")
        diff = {k: float((got[k] - want[k]).abs().max()) for k in ("rvec", "tvec")}
        diff["score"] = float((got["score"] - want["score"]).abs().max())
        if max(diff["rvec"], diff["tvec"]) > ROUTED_POSE_ATOL:
            raise AssertionError(f"leg b routed: pose max |diff| {diff} > {ROUTED_POSE_ATOL}")
        out["routed_max_abs_diff"] = diff
        out["routed_bit_equal"] = all(torch.equal(got[k], want[k])
                                      for k in ("rvec", "tvec", "score"))
        out["routed_single_ms"] = _host_ms(dev, lambda: single(params, batch), 2)
        out["routed_experts_evaluated"] = got["experts_evaluated"].tolist()
        del others, params

    # (3) Padding: 7 experts padded to 8, the true map at expert 0 and the
    # pad a copy of it: only its -inf logit keeps it from winning.
    P = size["pad_experts"]
    pc, ppx, pf, pcc = _synth_maps(np.random.default_rng(seed + PARALLEL_SEED + 9), 1, P, H, W,
                                   lambda b: 0)
    grid = (H // 8, W // 8)
    maps = torch.as_tensor(pc[0], device=dev)
    experts, pcenters, M_pad = pad_experts_for_mesh([_map_expert(x, grid) for x in maps],
                                                    torch.zeros((P, 3), device=dev), RANKS)
    padded = esac_infer_routed(mesh, experts, pcenters, size["pad_capacity"], cfg, device=dev)
    _zero_launches()
    pout = padded(seeds + 200, pad_gating_logits(torch.zeros((B, P), device=dev), M_pad),
                  torch.zeros((B, 1, 1, 3), device=dev), torch.full((B,), float(pf[0]), device=dev),
                  torch.as_tensor(ppx, device=dev), torch.as_tensor(pcc, device=dev))
    _expect(dev, _launch_counts(), sel, f"rank {rank} padded dispatch", launches)
    if pout["expert"].tolist() != [0] * B or not bool(
            (pout["experts_evaluated"] == M_pad - 1).any(1).all()):
        raise AssertionError(f"leg b padding: winners {pout['expert'].tolist()}, evaluated "
                             f"{pout['experts_evaluated'].tolist()}")
    out["padded"] = dict(M=P, M_pad=M_pad, winners=pout["expert"].tolist())
    out["launches"] = launches
    return out


def _truncated_loss(aux, m_rank, capacity):
    """Dense per-expert losses truncated to each rank's top-``capacity``
    local experts by gating mass, per frame, averaged over the frames:
    the routed loss on the single-device loss's own terms."""
    import torch

    from esac_tpu_torch.ransac.esac import _top_experts

    g, L = aux["gating_probs"], aux["per_expert_loss"]
    keep = torch.zeros_like(g, dtype=torch.bool)
    for lo in range(0, g.shape[1], m_rank):
        top = lo + _top_experts(g[:, lo:lo + m_rank], capacity)
        keep.scatter_(1, top, True)
    return float(torch.where(keep, g * L, 0.0).sum(1).mean().detach())


def _rank_leg_c(rank, mesh, dev, seed, size):
    """Sharded training at config #2's shape, padded to 8 experts: dense
    and capacity 2, two steps each, against the single-device step."""
    import copy

    import torch

    from esac_tpu_torch.data.synthetic import output_pixel_grid
    from esac_tpu_torch.parallel import (
        make_sharded_esac_train_step, pad_experts_for_mesh, shard_esac_params,
    )
    from esac_tpu_torch.parallel.esac_sharded import PaddedGating
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.esac import esac_train_loss_frames
    from esac_tpu_torch.registry.serving import init_scene_params, scene_forward
    from esac_tpu_torch.train import make_esac_train_step, step_generators

    H, W, steps, B = size["height"], size["width"], size["train_steps"], size["train_frames"]
    params = init_scene_params(_preset(size, size["train_experts"]), seed=seed, device=dev)
    experts, centers, M_pad = pad_experts_for_mesh(params["expert"], params["centers"], RANKS)
    pristine = (experts, PaddedGating(params["gating"], M_pad))
    m = M_pad // RANKS
    lo = rank * m
    images, R_gts, t_gts = _train_frames(dev, np.random.default_rng(seed + PARALLEL_SEED + 11),
                                         steps, B, H, W)
    pixels = output_pixel_grid(H, W, 8, device=dev)
    cfg = RansacConfig(n_hyps=size["n_hyps"], train_refine_iters=1, alpha=0.5,
                       scoring_impl="pallas")
    step_seed = seed * 7919
    out = {"M": size["train_experts"], "M_pad": M_pad, "runs": {}}
    launches = dict.fromkeys(KERNELS, 0)
    for mode, capacity in (("dense", None), (f"capacity{size['capacity']}", size["capacity"])):
        ex, ga = copy.deepcopy(pristine)
        ex.train()
        ga.train()
        mine, _ = shard_esac_params(mesh, ex, ga)  # Adam over this rank's experts and gating
        opt = torch.optim.Adam(list(mine.parameters()) + list(ga.parameters()),
                               lr=TRAIN_SIZE["lr"])
        step = make_sharded_esac_train_step(mesh, ex, ga, centers, opt, cfg, pixels, params["f"],
                                            params["c"], capacity=capacity,
                                            clip_norm=TRAIN_SIZE["clip_norm"], device=dev)
        losses, step_ms, grads_nonzero = [], [], []
        for k in range(steps):
            _zero_launches()
            sync(dev)
            t0 = time.perf_counter()
            loss = float(step(step_seed + k, images[k], R_gts[k], t_gts[k]))
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            _expect(dev, _launch_counts(), LAUNCHES_PER_CALL["pallas"],
                    f"rank {rank} {mode} step {k}", launches)
            if not np.isfinite(loss):
                raise AssertionError(f"rank {rank} {mode} step {k}: loss {loss}")
            nets = [(f"expert {i}", ex[i]) for i in range(lo, lo + m) if i < out["M"]]
            nonzero = []
            for name, net in nets + [("gating", ga)]:
                # An expert no frame routed to has no gradient.
                grads = [p.grad for p in net.parameters() if p.grad is not None]
                if any(not _finite(g) for g in grads):
                    raise AssertionError(f"rank {rank} {mode} step {k}: non-finite gradient "
                                         f"on {name}")
                if any(bool((g != 0).any()) for g in grads):
                    nonzero.append(name)
            # Dense: every real local net has a gradient; routed: the gating
            # net and the experts some frame selected.
            if mode == "dense" and len(nonzero) != len(nets) + 1 or "gating" not in nonzero:
                raise AssertionError(f"rank {rank} {mode} step {k}: zero gradient; non-zero "
                                     f"on {nonzero}")
            grads_nonzero.append(nonzero)
            losses.append(loss)
        out["runs"][mode] = dict(losses=losses, step_ms=step_ms, grads_nonzero=grads_nonzero)
    # The collectives of a dense step, timed apart: the coordinate gather
    # and the gating-gradient all-reduce.
    from esac_tpu_torch.parallel.mesh import axis_group
    from esac_tpu_torch.parallel.train_sharded import _GatherExperts, _allreduce_grads

    local_coords = torch.zeros((B, m, (H // 8) * (W // 8), 3), device=dev)
    with torch.no_grad():
        out["gather_ms"] = _host_ms(dev, lambda: _GatherExperts.apply(
            local_coords, lo, M_pad, axis_group(mesh, "expert")), size["reps"])
    gating_params = list(pristine[1].parameters())
    for p in gating_params:
        p.grad = torch.zeros_like(p)
    out["gating_grad_allreduce_ms"] = _host_ms(dev, lambda: _allreduce_grads(gating_params, None),
                                               size["reps"])
    if rank == 0:
        ex, ga = copy.deepcopy(pristine)
        ex.train()
        ga.train()
        scene = {"expert": ex, "gating": ga, "centers": centers, "f": params["f"],
                 "c": params["c"]}
        opt = torch.optim.Adam(list(ex.parameters()) + list(ga.parameters()), lr=TRAIN_SIZE["lr"])
        single = make_esac_train_step(scene, opt, cfg, pixels,
                                      clip_norm=TRAIN_SIZE["clip_norm"], device=dev)
        ref = [float(single(step_seed + k, images[k], R_gts[k], t_gts[k])) for k in range(steps)]
        ex, ga = copy.deepcopy(pristine)
        coords, logits = scene_forward({"expert": ex, "gating": ga, "centers": centers}, images[0])
        _, aux = esac_train_loss_frames(step_generators(step_seed, B, dev), logits, coords,
                                        pixels, params["f"].expand(B), params["c"], R_gts[0],
                                        t_gts[0], cfg, device=dev)
        ref_routed = _truncated_loss(aux, m, size["capacity"])
        rel = {"dense": [abs(a - b) / abs(b) for a, b in zip(out["runs"]["dense"]["losses"], ref)],
               f"capacity{size['capacity']}": [
                   abs(out["runs"][f"capacity{size['capacity']}"]["losses"][0] - ref_routed)
                   / abs(ref_routed)]}
        if max(max(v) for v in rel.values()) > STEP_LOSS_RTOL:
            raise AssertionError(f"leg c: sharded losses vs single device {rel} > "
                                 f"{STEP_LOSS_RTOL}")
        out.update(single_losses=ref, single_routed_loss=ref_routed, loss_rel_diff=rel)
    out["launches"] = launches
    return out


def _parallel_rank(rank, workdir, seed, size, device):
    """One of the spawned ranks of legs b and c (its gloo group initialized
    on ``device``); writes its results to ``workdir``."""
    import torch

    from esac_tpu_torch.parallel import make_mesh

    dev = torch.device(device)
    out = {"rank": rank, "collectives_checked": _check_collectives(dev, rank)}
    mesh = make_mesh(1, RANKS)
    for leg, fn in (("b", _rank_leg_b), ("c", _rank_leg_c)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out[leg] = fn(rank, mesh, dev, seed, size)
        out[leg]["seconds"] = time.perf_counter() - t0
        out[leg]["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                                if dev.type == "cuda" else 0.0)
    (pathlib.Path(workdir) / f"rank{rank}.json").write_text(json.dumps(out))


def phase_parallel(dev, seed, workflow, fleet, size=PARALLEL):
    """Phase 10 (module docstring): legs a-c here; d and e were run inside
    phases 7 and 9 (the sharded evaluation, the fleet's timeline and rules)
    and are checked and reported here."""
    from esac_tpu_torch.parallel import spawn_ranks

    t_phase = time.perf_counter()
    legs = {"a": _leg_a(dev, seed, size)}
    device = "cuda:0" if dev.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory(prefix="esac_parallel_") as tmp:
        t0 = time.perf_counter()
        spawn_ranks(_parallel_rank, RANKS, args=(tmp, seed, size, device), backend="gloo",
                    device=device)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(RANKS)]
    for leg in ("b", "c"):
        legs[leg] = dict(world=RANKS, backend="gloo", device=device,
                         ranks=[r[leg] for r in ranks])
    legs["b"]["collectives_checked"] = ranks[0]["collectives_checked"]
    legs["d"] = workflow["sharded_eval"]
    legs["e"] = fleet["obs"]
    launches = {k: legs["a"]["launches"][k] + sum(r[leg]["launches"][k] for r in ranks
                                                  for leg in ("b", "c"))
                for k in KERNELS}
    b0, c0 = ranks[0]["b"], ranks[0]["c"]
    log(f"[parallel] b: 2 gloo ranks on {device}: {size['experts_b']} experts, "
        f"{b0['experts_local']} a rank ({b0['weights_bytes_local'] / 2**30:.2f} GiB of f32 "
        f"weights each); MAX/MIN/SUM all-reduces checked; coords-level dispatch "
        f"{b0['coords_dispatch_ms'][0]:.1f} ms first, {b0['coords_dispatch_ms'][1]:.1f} ms "
        f"warm, bit-identical to esac_infer_frames "
        f"({b0['coords_unsharded_ms']:.1f} ms unsharded, {b0['coords_sharded_ms']:.1f} ms "
        f"sharded direct); routed top-{size['routed_k']} {b0['routed_sharded_ms']:.1f} ms "
        f"(single device {b0['routed_single_ms']:.1f} ms), winners and evaluated sets equal, "
        f"max |diff| {b0['routed_max_abs_diff']}, bit-equal {b0['routed_bit_equal']}; "
        f"padded {b0['padded']}; winner all-reduce {b0['collectives_ms']:.3f} ms; peak GiB "
        f"{[round(r['b']['peak_gib'], 2) for r in ranks]}; ranks up and done in {spawn_s:.1f} s")
    log(f"[parallel] c: sharded training {c0['M']} experts padded to {c0['M_pad']}: "
        + "; ".join(f"{mode} losses {run['losses']} step ms "
                    f"{[round(x, 1) for x in run['step_ms']]}"
                    for mode, run in c0["runs"].items())
        + f"; single device {c0['single_losses']} (routed truncation "
        f"{c0['single_routed_loss']:.4f}), relative {c0['loss_rel_diff']}; gather "
        f"{c0['gather_ms']:.3f} ms, gating-gradient all-reduce "
        f"{c0['gating_grad_allreduce_ms']:.3f} ms; peak GiB "
        f"{[round(r['c']['peak_gib'], 2) for r in ranks]}")
    log(f"[parallel] d: test_esac --sharded at world size 1 = the dense evaluation "
        f"({legs['d']['frames']} frames, winners {legs['d']['winners']}); e: the fleet's "
        f"timeline ticked {legs['e']['ticks']} windows, rules {legs['e']['rules']}, "
        f"{len(legs['e']['collectors'])} collectors all on the Prometheus page; sharded "
        f"launches {launches}")
    return dict(legs=legs, launches=launches, spawn_s=spawn_s,
                seconds=time.perf_counter() - t_phase)


def _lint_witnesses():
    """Phase 11's runtime witnesses, attached by phases 8 and 9: a
    LockWitness and an OutcomeWitness over the committed fault taxonomy."""
    from esac_tpu_torch.lint.witness import LockWitness, OutcomeWitness

    return {"lock": LockWitness(), "outcome": OutcomeWitness.from_repo(ROOT)}


def phase_lint(dev, kernels, witness):
    """Phase 11 (module docstring): the gradient witness on the card, the
    kernels held against their plain versions on its scoring cases, and
    the lock and outcome witnesses of phases 8 and 9 held against the
    committed artifacts."""
    import torch

    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.lint import gradcheck
    from esac_tpu_torch.lint.lockgraph import LOCK_GRAPH_NAME, load_graph
    from esac_tpu_torch.ransac import fused_scoring as fs

    t_phase = time.perf_counter()
    corpus = gradcheck.load_corpus(ROOT / gradcheck.GRAD_CORPUS_NAME)
    if corpus != gradcheck.default_corpus():
        raise AssertionError("lint: the committed grad corpus differs from default_corpus()")
    cases = sorted(corpus["cases"])

    # (a) every witness on every case, the launches counted exactly.
    record = {}
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    verdicts = gradcheck.run_gradcheck(corpus, device=dev, record=record)
    sync(dev)
    sweep_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: w.launches for name, w in wrappers.items()}
    want = {k: len(cases) * sum(per[k] for per in gradcheck.KERNEL_WITNESSES.values())
            for k in KERNELS} if dev.type == "cuda" else dict.fromkeys(KERNELS, 0)
    if launches != want:
        raise AssertionError(f"lint: gradient witness launches {launches}, expected {want}")
    bad = {name: [c for c, v in per.items() if not (v["outputs_finite"] and v["grads_finite"])]
           for name, per in verdicts.items() if name != "clean"}
    bad = {k: v for k, v in bad.items() if v}
    if bad or not verdicts["clean"]:
        raise AssertionError(f"lint: non-finite outputs or gradients {bad}")
    n_runs = sum(len(per) for name, per in verdicts.items() if name != "clean")

    # The kernels against their plain versions on the witnesses' own
    # inputs (NaN-aware, phase 3's tolerance), the select's backward run.
    err = {"scores": 0.0, "select": 0.0}
    winners, clear_winners = {}, 0
    for case in cases:
        out, _, arrays = record[("scoring_pallas_grad", case)]
        rvecs, tvecs = gradcheck.hypothesis_poses(arrays["rvec"], arrays["tvec"],
                                                  arrays["offs"])
        args = (rodrigues(rvecs), tvecs, arrays["coords"][None], arrays["pixels"],
                arrays["f"][None], arrays["c"], 10.0, 0.5)
        with torch.no_grad():
            p_scores = fs._scores_plain(*args)[0]
            p_i, p_s, p_pose = fs._select_plain(*args)
        k_scores = out["scores"].detach()
        if not (torch.equal(torch.isnan(k_scores), torch.isnan(p_scores))
                and torch.allclose(k_scores, p_scores, equal_nan=True, **SCORE_TOL)):
            raise AssertionError(f"lint {case}: scoring kernel {k_scores.tolist()} vs plain "
                                 f"{p_scores.tolist()}")
        sel, sel_grads, _ = record[("scoring_fused_select_grad", case)]
        k_i, k_s = int(sel["best_idx"]), sel["best_score"].detach()
        # Phase 3's rule: the winners are equal where the plain top two are
        # further apart than the tolerance; within it, the kernel's winner
        # must be one of the plain near-maxima.
        top2 = p_scores.nan_to_num(nan=float("inf")).topk(2).values
        clear = bool(top2[0] - top2[1] > SCORE_TOL["atol"] + SCORE_TOL["rtol"] * abs(top2[0]))
        near = bool(p_scores[k_i].nan_to_num(nan=float("inf"))
                    >= top2[0] - SCORE_TOL["atol"] - SCORE_TOL["rtol"] * abs(top2[0]))
        if (clear and k_i != int(p_i[0])) or not near:
            raise AssertionError(f"lint {case}: select winner {k_i} != plain {int(p_i[0])} "
                                 f"(plain scores {p_scores.tolist()})")
        clear_winners += clear
        if not (torch.allclose(k_s, p_s[0], equal_nan=True, **SCORE_TOL)
                and bool(torch.isnan(k_s)) == bool(torch.isnan(p_s[0]))):
            raise AssertionError(f"lint {case}: select score {float(k_s)} vs plain "
                                 f"{float(p_s[0])}")
        if not _same_or_both_nan(k_scores[k_i], k_s):
            raise AssertionError(f"lint {case}: scores at the select winner != its best score")
        if any(sel_grads[k] is None for k in ("coords", "rvecs", "tvecs")):
            raise AssertionError(f"lint {case}: the select's backward reached no input "
                                 f"({[k for k, g in sel_grads.items() if g is None]})")
        both = torch.isfinite(k_scores) & torch.isfinite(p_scores)
        err["scores"] = max(err["scores"], float((k_scores - p_scores)[both].abs().max()))
        if bool(torch.isfinite(k_s)) and bool(torch.isfinite(p_s[0])):
            err["select"] = max(err["select"], float((k_s - p_s[0]).abs()))
        winners[case] = k_i
    if winners["tie_scores"] != 0:
        raise AssertionError(f"lint tie_scores: winner {winners['tie_scores']}, not the first")

    # (b, c) the lock and outcome witnesses of phases 8 and 9.
    graph = load_graph(ROOT / LOCK_GRAPH_NAME)
    lock_violations = witness["lock"].violations(graph)
    held = set(witness["lock"].hold_summary())
    unknown = sorted(held - set(graph["nodes"]))
    if lock_violations or unknown or not held:
        raise AssertionError(f"lint lock witness: violations {lock_violations}, locks not in "
                             f"the committed nodes {unknown}, {len(held)} locks observed")
    outcome = witness["outcome"].snapshot()
    if outcome["violations"] or not (outcome["observed"] or outcome["error_free_outcomes"]):
        raise AssertionError(f"lint outcome witness: {outcome}")
    edges = {f"{s}->{d}": n for (s, d), n in sorted(witness["lock"].edges().items())}
    k = kernels["lint_corpus"]
    result = dict(
        verdicts={name: all(v["outputs_finite"] and v["grads_finite"] for v in per.values())
                  for name, per in verdicts.items() if name != "clean"},
        clean=verdicts["clean"], witnesses=len(verdicts) - 1, cases=len(cases), runs=n_runs,
        launches=launches, sweep_ms=sweep_ms, winners=winners, clear_winners=clear_winners,
        max_abs_err=err,
        kernel_ms={"score": k["ms"]["score_kernel"], "select": k["ms"]["select_kernel"]},
        wrapper_ms={"score": k["ms"]["score"], "select": k["ms"]["select"]},
        shape={"P": k["P"], "H": k["H"], "N": k["N"]},
        lock_edges=edges, locks_observed=len(held),
        blocked_while_held=len(witness["lock"].blocked_events()),
        outcomes=outcome["observed"], error_free_outcomes=outcome["error_free_outcomes"],
        seconds=time.perf_counter() - t_phase)
    log(f"[lint] gradient witness: {result['witnesses']} witnesses x {len(cases)} cases on "
        f"{dev}, every output and gradient finite, in {sweep_ms:.1f} ms; launches "
        f"{launches}; the kernels' scores equal the plain versions' on every case (max "
        f"|err| {err['scores']:.3g} / {err['select']:.3g}), winners on the {clear_winners} "
        f"cases with a clear winner and a plain near-maximum on the rest, tie_scores keeps "
        f"index 0; the select's backward ran on every case")
    log(f"[lint] lock witness: {len(held)} locks, edges {edges}, all inside the committed "
        f"order; outcome witness: {outcome['observed']} + error-free "
        f"{outcome['error_free_outcomes']}, all on committed edges")
    return result


def _bench_invariants(mode, line) -> list[str]:
    """The invariants a bench mode's line records, by the bench's own keys:
    the names of those that do not hold (phase 12 fails on any)."""
    checks = {
        "headline": lambda: {"vs_baseline_measured": line["vs_baseline"] is not None},
        "registry": lambda: {
            "one_signature": line["registry"]["compiled_programs_after_all_swaps"] == 1},
        "routed": lambda: {"k_eq_m_bitwise": line["k_eq_m_bitwise"]},
        "loadtest": lambda: {"accounting_exact": all(
            sum(p["outcomes"].values()) == p["offered"]
            for leg in line["loadtest"]["legs"] for p in leg["points"])},
        "chaos": lambda: {"accounting_exact": line["accounting_exact"],
                          "post_rollback_bit_identical": line["post_rollback_bit_identical"],
                          "no_new_signature": line["hot_path_recompiles"] == 0},
        "obs": lambda: {"spans_telescope": line["span_sums_match_e2e"],
                        "fleet_spans_telescope": bool(line["fleet_telescoping_ok"]),
                        "no_new_signature": line["jit_cache_misses_added"] == 0
                        and line["fleet_jit_cache_misses_added"] == 0,
                        "snapshot_json_ok": line["snapshot_json_ok"]},
        "prefetch": lambda: {"accounting_exact": line["accounting_exact"],
                             "no_new_signature": line["recompiles"] == 0},
        "fleet": lambda: {"accounting_exact": line["accounting_exact"],
                          "no_new_signature": line["hot_path_recompiles"] == 0,
                          "failover_bit_identical": line["failover_bit_identical"] is not False},
        "hostpath": lambda: {"accounting_exact": line["accounting_exact"],
                             "no_new_signature": line["hot_path_recompiles"] == 0},
        "city": lambda: {"accounting_exact": line["accounting_exact"],
                         "no_new_signature": line["hot_path_recompiles"] == 0,
                         "breaker_bit_identical_restore": line["breaker_bit_identical_restore"]},
        "sessions": lambda: {"accounting_exact": line["accounting_exact"],
                             "no_new_signature": line["hot_path_recompiles"] == 0,
                             "parity_bitwise_entry": line["parity_bitwise_entry"],
                             "parity_bitwise_dispatcher": line["parity_bitwise_dispatcher"]},
    }.get(mode, dict)()
    return [name for name, ok in checks.items() if not ok]


@contextlib.contextmanager
def _city_watch(dev):
    """Phase 12's watch over the city drill: every registry serve call's
    seconds (synchronized), each watchdog abandonment, each replica
    quarantine with its error type."""
    import torch

    from esac_tpu_torch.fleet.router import FleetRouter
    from esac_tpu_torch.registry.serving import SceneRegistry
    from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher

    rec = {"serve_s": [], "abandoned": 0, "quarantines": []}
    infer_fn = SceneRegistry.infer_fn
    abandon = MicroBatchDispatcher._abandon_inflight
    note = FleetRouter._note_replica_fault

    def timed_infer_fn(self):
        fn = infer_fn(self)

        def serve(batch, scene, route_k=None, n_hyps=None):
            t0 = time.perf_counter()
            out = fn(batch, scene, route_k, n_hyps)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            rec["serve_s"].append(time.perf_counter() - t0)
            return out

        serve._cache_size = fn._cache_size
        return serve

    def counted_abandon(self, infl, now):
        rec["abandoned"] += 1
        return abandon(self, infl, now)

    def noted(self, name, err):
        before = set(self.quarantined_replicas())
        note(self, name, err)
        if name in set(self.quarantined_replicas()) - before:
            rec["quarantines"].append((name, type(err).__name__))

    SceneRegistry.infer_fn = timed_infer_fn
    MicroBatchDispatcher._abandon_inflight = counted_abandon
    FleetRouter._note_replica_fault = noted
    try:
        yield rec
    finally:
        SceneRegistry.infer_fn = infer_fn
        MicroBatchDispatcher._abandon_inflight = abandon
        FleetRouter._note_replica_fault = note


def _city_checks(rec, watchdog_ms) -> dict:
    """Phase 12's city verdict: no abandoned dispatch, no serve call past
    the watchdog, no replica quarantined but by the drill's last probe
    (its injected SceneLoadError)."""
    ms = sorted(1e3 * x for x in rec["serve_s"])
    stray = [q for q in rec["quarantines"] if q[1] != "SceneLoadError"]
    if rec["abandoned"] or not ms or ms[-1] >= watchdog_ms or stray:
        raise AssertionError(f"bench city at the {watchdog_ms:.0f} ms watchdog: "
                             f"{rec['abandoned']} dispatches abandoned, slowest serve call "
                             f"{ms[-1] if ms else None} ms, quarantines {rec['quarantines']}")
    return dict(watchdog_ms=watchdog_ms, serve_calls=len(ms), abandoned=rec["abandoned"],
                quarantines=rec["quarantines"],
                serve_ms={q: ms[min(len(ms) - 1, int(q * len(ms)))] for q in (0.5, 0.9, 0.99)}
                | {"max": ms[-1]})


def phase_bench(dev, size=BENCH, metrics=BENCH_METRICS):
    """Phase 12 (module docstring): every bench mode through
    ``esac_tpu_torch.bench.run`` on ``dev``, its one line checked, its
    launches counted exactly, its invariants held."""
    from esac_tpu_torch import bench
    from esac_tpu_torch.bench import scaffold, scoring

    t_phase = time.perf_counter()
    wrappers = _wrappers()
    results, launches, evidence = {}, dict.fromkeys(KERNELS, 0), []
    saved_dir = scaffold.ARTIFACT_DIR
    # What one full collection over the earlier phases' heap costs.
    t0 = time.perf_counter()
    gc.collect()
    heap = dict(objects=len(gc.get_objects()), full_collection_ms=(time.perf_counter() - t0) * 1e3)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as d:
        scaffold.ARTIFACT_DIR = pathlib.Path(d)
        try:
            for mode, kwargs in size.items():
                kwargs = dict(kwargs)
                if mode == "scoring":
                    kwargs["disagreements"] = evidence
                for w in wrappers.values():
                    w.launches = 0
                # The earlier phases leave ~271k objects alive; a full
                # collection over them holds the GIL 214-241 ms on the H100's
                # host (the phase logs it), as long as a warm-up's 300 ms
                # deadline or obs's 250 ms watchdog allow.  Frozen, they stay
                # out of the collector's sight.  Per mode: run_open_loop,
                # city, fleet and hostpath unfreeze the heap on their way out.
                gc.collect()
                gc.freeze()
                buf = io.StringIO()
                t0 = time.perf_counter()
                watch = _city_watch(dev) if mode == "city" else contextlib.nullcontext()
                with watch as city_rec, contextlib.redirect_stdout(buf):
                    bench.run(None if mode == "headline" else mode, dev, **kwargs)
                secs = time.perf_counter() - t0
                got = {name: w.launches for name, w in wrappers.items()}
                lines = buf.getvalue().strip().splitlines()
                if len(lines) != 1:
                    raise AssertionError(f"bench {mode}: {len(lines)} lines, not one")
                line = json.loads(lines[0])
                artifact = json.loads((pathlib.Path(d) / f"{mode}.json").read_text())
                if line["metric"] != metrics[mode] or artifact["metric"] != metrics[mode]:
                    raise AssertionError(f"bench {mode}: metric {line['metric']!r}, expected "
                                         f"{metrics[mode]!r}")
                want_platform = "gpu" if dev.type == "cuda" else "cpu"
                if line["platform"] != want_platform or artifact["platform"] != want_platform:
                    raise AssertionError(f"bench {mode}: platform {line['platform']!r}")
                sweep = kwargs.get("n_hyps_sweep", scoring.SCORING_SWEEP)
                want = dict.fromkeys(KERNELS, 0)
                if mode == "scoring" and dev.type == "cuda":
                    want["soft_inlier_select"] = scoring.select_launches(
                        sweep, kwargs.get("repeats", scoring.SCORING_REPEATS))
                if got != want:
                    raise AssertionError(f"bench {mode}: kernel launches {got}, expected {want}")
                bad = _bench_invariants(mode, line)
                if bad:
                    raise AssertionError(f"bench {mode}: invariants do not hold: {bad}")
                for k in KERNELS:
                    launches[k] += got[k]
                results[mode] = dict(metric=line["metric"], value=line["value"],
                                     unit=line["unit"], seconds=secs, launches=got,
                                     vs_baseline=line.get("vs_baseline"))
                if mode == "scoring":
                    results[mode]["winner_bit_identical_all"] = line["winner_bit_identical_all"]
                    results[mode]["winner_disagreements"] = evidence
                    results[mode]["points"] = {
                        p["n_hyps"]: {impl: v["dispatch_ms"] for impl, v in p["impls"].items()}
                        for p in line["scoring"]["curve"]}
                if mode == "streaming":
                    results[mode]["max_memory_allocated_bytes"] = \
                        artifact["max_memory_allocated_bytes"]
                if mode == "city":
                    results[mode]["watch"] = _city_checks(city_rec,
                                                          artifact["city"]["watchdog_ms"])
                    w = results[mode]["watch"]
                    log(f"[bench] city: {w['serve_calls']} serve calls at the "
                        f"{w['watchdog_ms']:.0f} ms watchdog, p50 / p99 / max "
                        f"{w['serve_ms'][0.5]:.1f} / {w['serve_ms'][0.99]:.1f} / "
                        f"{w['serve_ms']['max']:.1f} ms; none abandoned; quarantines "
                        f"{w['quarantines']} (the last probe's injected faults only)")
                log(f"[bench] {mode}: {line['metric']} = {line['value']} {line['unit']} "
                    f"({secs:.1f} s, launches {got})")
        finally:
            gc.unfreeze()
            scaffold.ARTIFACT_DIR = saved_dir
    if evidence:
        flips = [r for r in evidence if r["errmap_best"] != r["fused_select_best"]]
        gap = max(abs(r["errmap_score_at_errmap_best"] - r["fused_select_score"])
                  for r in evidence)
        log(f"[bench] scoring: fused_select differs from errmap on {len(evidence)} "
            f"frame-points ({len(flips)} with another winning index, the rest in "
            f"inlier_frac alone; max |score diff| {gap:.3g}); the list rides the bench line")
    log(f"[bench] before phase 12 the heap held {heap['objects']} objects; one full "
        f"collection over them took {heap['full_collection_ms']:.1f} ms")
    return dict(modes=results, launches=launches, heap=heap,
                seconds=time.perf_counter() - t_phase)


# Phase 13: the three scripts at their own shapes; generalization at the
# round-1 row frames=1024 noaug (experiments/generalization.py's record),
# cut from 8000 steps to 3000.
EXPERIMENTS = dict(profile=dict(batch=16, n_hyps=256, repeats=20),
                   generalization=dict(n_frames=1024, augment=False, iters=3000),
                   routed=dict(experts=48, ranks=None, repeats=3, loss_clamp=1e6))
ROUTED_LOSS_RTOL = 1e-4
GEN_COORD_CM_MAX = 20.0  # an untrained expert sits near 100 cm


def phase_experiments(dev, size=EXPERIMENTS):
    """Phase 13 (module docstring): profile_stages, generalization and
    routed_train_bench on ``dev``, launches counted from 0 around each,
    the scoring kernel held against its plain version on the profile's
    hypotheses."""
    import torch

    from esac_tpu_torch.experiments import generalization, profile_stages
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac import fused_scoring as fs
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.tools import routed_train_bench

    t_phase = time.perf_counter()
    wrappers = _wrappers()
    launches, out = {}, {}

    def run(name, fn):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = fn()
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        out[name] = {"seconds": time.perf_counter() - t0}
        return res

    # a. the stage profile: one launch per call of the "pallas" stage (the
    # outputs' call, the warm call, the repeats), none elsewhere.
    prof = size["profile"]
    line, stages = run("profile_stages", lambda: profile_stages.profile(dev, **prof))
    want = dict.fromkeys(KERNELS, 0)
    if dev.type == "cuda":
        want["soft_inlier_scores"] = 2 + prof["repeats"]
    if launches["profile_stages"] != want:
        raise AssertionError(f"profile_stages: launches {launches['profile_stages']}, "
                             f"expected {want}")
    impls = profile_stages.impls_for(dev)
    for impl in impls:
        if not torch.allclose(stages[f"scores_{impl}"], stages["scores_errmap"], **SCORE_TOL):
            raise AssertionError(f"profile_stages: {impl} scores differ from errmap's")
    keys = {"sample_solve_ms", "refine_ms", "full_ms", "score_ms"} | {
        f"score_ms_{impl}" for impl in impls}
    if not all(np.isfinite(line[k]) and line[k] > 0 for k in keys):
        raise AssertionError(f"profile_stages: {line}")
    out["profile_stages"]["line"] = line
    # The kernel against its plain version on the profile's own hypotheses
    # (after the count was read: these launches are comparisons).
    cfg = RansacConfig()
    with torch.inference_mode():
        inp = profile_stages.frames(prof["batch"], dev)
        args = (rodrigues(stages["rvecs"]), stages["tvecs"], inp["coords"], inp["pixels"],
                inp["f"], inp["c"], cfg.tau, cfg.beta)
        k_scores = fs.soft_inlier_scores_kernel(*args)
        p_scores = fs._scores_plain(*args)
        sync(dev)
        err = float((k_scores - p_scores).abs().max())
        if not torch.allclose(k_scores, p_scores, **SCORE_TOL):
            raise AssertionError(f"profile_stages shape: scoring kernel vs plain max |err| {err}")
        P, H, N = prof["batch"], prof["n_hyps"], inp["coords"].shape[1]
        ms = {"score": time_ms(lambda: fs.soft_inlier_scores_kernel(*args), dev),
              "score_plain": time_ms(lambda: fs._scores_plain(*args), dev, reps=5)}
        ms.update(_launch_ms(dev, fs, args)[0])
    out["profile_stages"]["kernel"] = dict(P=P, H=H, N=N, max_abs_err=err, ms=ms,
                                           bound=_bound(P, H, N, 1, P * H * 4))
    log(f"[experiments] profile_stages (P={P} H={H} N={N}, {prof['repeats']} repeats): "
        f"sample+solve {line['sample_solve_ms']:.2f} ms, score "
        + ", ".join(f"{impl} {line[f'score_ms_{impl}']:.3f}" for impl in impls)
        + f" ms, refine {line['refine_ms']:.2f} ms, full {line['full_ms']:.2f} ms; launches "
        f"{launches['profile_stages']}; scoring kernel vs plain max |err| {err:.3g} (rtol 1e-5, "
        f"atol 1e-3), kernel {ms['score_kernel']:.4f} ms, wrapper {ms['score']:.4f} ms, plain "
        f"{ms['score_plain']:.4f} ms, bound "
        f"{out['profile_stages']['kernel']['bound']['bound_ms']:.4g} ms")

    # b. generalization at one round-1 row.
    g = size["generalization"]
    gl = run("generalization", lambda: generalization.run(g["n_frames"], g["augment"],
                                                          g["iters"], dev))
    if launches["generalization"] != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"generalization: launches {launches['generalization']}")
    if not (np.isfinite(gl["train_loss"]) and gl["coord_med_cm"] < GEN_COORD_CM_MAX):
        raise AssertionError(f"generalization: {gl['line']}")
    out["generalization"]["line"] = gl
    log(f"[experiments] generalization: {gl['line']}")

    # c. the routed-training bench at M = 48.
    r = size["routed"]
    doc = run("routed_train_bench", lambda: routed_train_bench.measure(dev, **r))
    loss = doc["loss"]
    if any(doc["loss_saturated"].values()):
        raise AssertionError(f"routed_train_bench: losses {loss} at the clamp "
                             f"{doc['loss_clamp']}: dense == routed would say nothing")
    if not (np.isfinite(loss["dense"]) and np.isfinite(loss["routed"])
            and abs(loss["dense"] - loss["routed"]) <= ROUTED_LOSS_RTOL * abs(loss["dense"])):
        raise AssertionError(f"routed_train_bench: losses {loss} differ: the ratio compares "
                             "different work")
    cells = (routed_train_bench.H // 8) * (routed_train_bench.W // 8)
    if doc["structural"] != {
            "expert_forwards_per_frame": {"dense": r["experts"],
                                          "routed": doc["ranks"] * routed_train_bench.CAP},
            "ep_collective_bytes_per_frame": {"dense": r["experts"] * cells * 3 * 4,
                                              "routed": 4}}:
        raise AssertionError(f"routed_train_bench: structural {doc['structural']}")
    out["routed_train_bench"]["doc"] = doc
    log(f"[experiments] routed_train_bench: {doc['config']}: dense {doc['dense_step_ms']:.1f} "
        f"ms, routed {doc['routed_step_ms']:.1f} ms a step ({doc['routed_over_dense']:.3f}x), "
        f"losses {loss} under the clamp {doc['loss_clamp']:g} (saturated: "
        f"{doc['loss_saturated']})")
    total = {k: sum(v[k] for v in launches.values()) for k in KERNELS}
    return dict(runs=out, launches_by_run=launches, launches=total,
                seconds=time.perf_counter() - t_phase)


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
        graphs = phase_graphs(dev, args.seed)
        epilogue = phase_epilogue(dev, args.seed)
        training = phase_training(dev, args.seed)
        workflow = phase_workflow(dev, args.seed)
        witness = _lint_witnesses()
        server = phase_server(dev, args.seed, witness=witness)
        fleet = phase_fleet(dev, args.seed, witness=witness)
        parallel = phase_parallel(dev, args.seed, workflow, fleet)
        lint = phase_lint(dev, kernels, witness)
        bench = phase_bench(dev)
        experiments = phase_experiments(dev)
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
            "fleet_launches": fleet["launches"][name],
            "sharded_launches": parallel["launches"][name],
            "lint_launches": lint["launches"][name],
            "bench_launches": bench["launches"][name],
            "experiments_launches": experiments["launches"][name],
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
    # Phase 13's hold of the scoring kernel at profile_stages' shape.
    pk = experiments["runs"]["profile_stages"]["kernel"]
    line["kernels"][0]["shapes"]["profile_stages"] = {
        "P": pk["P"], "H": pk["H"], "N": pk["N"], "kernel_ms": pk["ms"]["score_kernel"],
        "wrapper_ms": pk["ms"]["score"], "plain_ms": pk["ms"]["score_plain"],
        "bound_ms": pk["bound"]["bound_ms"], "bound_by": pk["bound"]["bound_by"],
        "max_abs_err": pk["max_abs_err"]}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(device=name, nvidia_smi=smi, build_s=build_s,
                                       kernels=kernels, serving=serving, graphs=graphs,
                                       epilogue=epilogue,
                                       training=training,
                                       workflow=workflow, server=server, fleet=fleet,
                                       parallel=parallel, lint=lint, bench=bench,
                                       experiments=experiments),
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
    print(json.dumps({"graphs": {"device": name, "nvidia_smi": smi, **graphs}}))
    print(json.dumps({"epilogue": {"device": name, "nvidia_smi": smi,
                                   "forward": epilogue["forward"]}}))
    print(json.dumps({"workflow": {"device": name, "nvidia_smi": smi, **workflow}}))
    print(json.dumps({"server": {"device": name, "nvidia_smi": smi, **server}}))
    print(json.dumps({"fleet": {"device": name, "nvidia_smi": smi, **fleet}}))
    print(json.dumps({"parallel": {"device": name, "nvidia_smi": smi, **parallel}}))
    print(json.dumps({"lint": {"device": name, "nvidia_smi": smi, **lint}}))
    print(json.dumps({"bench": {"device": name, "nvidia_smi": smi, **bench}}))
    print(json.dumps({"experiments": {"device": name, "nvidia_smi": smi, **experiments}}))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
