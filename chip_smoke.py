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
                 buckets (P = 112, P = 7) and at ragged shapes (H = 40,
                 N = 300): scores
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
                 within 5 cm / 5 deg and the true map wins;
5. serving    -- the full-width 7-expert preset at 640x480 (ref widths,
                 bf16 CNNs, weights from the port's own init at --seed)
                 answers requests of 1, 3, 5 and 16 frames, planned and padded
                 into the (1, 4, 16, 64) buckets, under "fused_select" and
                 "pallas" on the same seeds, and under the plain "errmap"
                 path; "pallas" and "fused_select" give bit-equal winning
                 scores and experts, "errmap" agrees within the tolerance.

Around every call of an entry point in phases 4 and 5 the kernels' launch
counters are set to 0 just before and read just after: a "fused_select"
call must launch the select kernel exactly once and the scoring kernel
never, a "pallas" call the reverse, an "errmap" call neither.

Before the last line it prints one JSON line {"kernels": [...]} and the
nvidia-smi name/power-limit line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
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
    "frames1": (1, 7, 256, 480, 640),
    "ragged": (3, 1, 40, 120, 160),
}
SERVING_SIZE = dict(height=480, width=640, arch="ref")


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


def _wrappers():
    from esac_tpu_torch.ransac import fused_scoring as fs

    return {"soft_inlier_scores": fs.soft_inlier_scores_kernel,
            "soft_inlier_select": fs.soft_inlier_score_select}


def counted(dev, impl, what, fn):
    """Run ``fn()`` with every launch counter set to 0 just before and read
    just after; fail unless the counts are exactly ``impl``'s per call.
    Returns ``(fn's result, counts)``."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    got = {name: w.launches for name, w in wrappers.items()}
    want = LAUNCHES_PER_CALL[impl] if dev.type == "cuda" else dict.fromkeys(KERNELS, 0)
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
    from esac_tpu_torch.ransac.esac import esac_infer_frames
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


def phase_serving(dev, seed):
    import torch

    from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.manifest import ScenePreset
    from esac_tpu_torch.registry.serving import init_scene_params, make_scene_bucket_fn
    from esac_tpu_torch.serve.batching import pad_batch, pick_bucket, plan_dispatches

    height, width, arch = SERVING_SIZE["height"], SERVING_SIZE["width"], SERVING_SIZE["arch"]
    preset = ScenePreset(height=height, width=width, num_experts=7,
                         gating_channels=GATING_PRESETS[arch]["channels"],
                         compute_dtype="bfloat16", **EXPERT_PRESETS[arch])
    params = init_scene_params(preset, seed=seed, device=dev)
    buckets = RansacConfig().frame_buckets
    fns = {impl: make_scene_bucket_fn(preset, RansacConfig(scoring_impl=impl), device=dev)
           for impl in ("fused_select", "pallas", "errmap")}
    rng = np.random.default_rng(seed + 2)
    requests = [rng.uniform(0, 1, (n, height, width, 3)).astype(np.float32)
                for n in (1, 3, 5, 16)]

    # Warm-up of every bucket shape (cuDNN algorithm choice, allocator) off
    # the measured dispatches; the kernels' counts are zeroed after it.
    for lanes in (1, 4, 16):
        batch, _ = pad_batch({"image": requests[0][:1], "seed": np.zeros(1, np.int64)}, lanes)
        for fn in fns.values():
            fn(params, batch)
    sync(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches = {impl: dict.fromkeys(KERNELS, 0) for impl in fns}
    dispatches, next_seed = [], 1000 * seed
    for images in requests:
        start = 0
        for n in plan_dispatches(len(images), buckets):
            bucket = pick_bucket(n, buckets)
            batch, n_valid = pad_batch(
                {"image": images[start:start + n],
                 "seed": np.arange(next_seed, next_seed + n)}, bucket)
            start, next_seed = start + n, next_seed + n
            outs, times = {}, {}
            for impl, fn in fns.items():
                sync(dev)
                t0 = time.perf_counter()
                outs[impl], n = counted(dev, impl, f"a {n_valid}-frame dispatch",
                                        lambda: fn(params, batch))
                sync(dev)
                times[impl] = (time.perf_counter() - t0) * 1e3
                for name, k in n.items():
                    launches[impl][name] += k
            sel, pal, ref = outs["fused_select"], outs["pallas"], outs["errmap"]
            lanes = len(batch["image"])
            for key, shape in (("rvec", (lanes, 3)), ("tvec", (lanes, 3)),
                               ("expert", (lanes,)), ("score", (lanes,))):
                if tuple(sel[key].shape) != shape:
                    raise AssertionError(f"{key} shape {tuple(sel[key].shape)} != {shape}")
            for out in outs.values():
                for key in ("rvec", "tvec", "inlier_frac"):
                    if not bool(torch.isfinite(out[key]).all()):
                        raise AssertionError(f"non-finite {key}")
            # The two kernels share one partial pass and one summation order,
            # so "pallas" and "fused_select" pick bit-equal winners.
            if not torch.equal(sel["score"], pal["scores"].amax(dim=(1, 2))):
                raise AssertionError("fused_select and pallas winning scores differ")
            if not torch.equal(sel["expert"], pal["expert"]):
                raise AssertionError("fused_select and pallas experts differ")
            if not (torch.allclose(sel["rvec"], pal["rvec"])
                    and torch.allclose(sel["tvec"], pal["tvec"])):
                raise AssertionError("fused_select and pallas refined poses differ")
            pose_bit_equal = bool(torch.equal(sel["rvec"], pal["rvec"])
                                  and torch.equal(sel["tvec"], pal["tvec"]))
            if not torch.allclose(sel["score"], ref["scores"].amax(dim=(1, 2)), **SCORE_TOL):
                raise AssertionError("fused_select and errmap winning scores differ")
            dispatches.append(dict(frames=n_valid, lanes=lanes, ms=times,
                                   score=sel["score"][:n_valid].tolist(),
                                   expert=sel["expert"][:n_valid].tolist(),
                                   pallas_pose_bit_equal=pose_bit_equal))
            log(f"[serving] request of {len(images)}: dispatch {n_valid} frames in bucket "
                f"{bucket} ({lanes} lanes): " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in times.items())
                + f"; winners {sel['expert'][:n_valid].tolist()}; pallas pose "
                + ("bit-equal" if pose_bit_equal else "allclose, not bit-equal"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"[serving] launches by scoring_impl over {len(dispatches)} dispatches {launches}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    stages, busy = {}, {}
    for lanes in (4, 16):
        stages[lanes] = _stage_breakdown(dev, params, preset, requests[-1][:lanes])
        if dev.type == "cuda":
            busy[lanes] = _device_busy(dev, fns["fused_select"], params, {
                "image": requests[-1][:lanes], "seed": np.arange(lanes)})
    return dict(dispatches=dispatches, launches=launches, peak_bytes=peak,
                stages=stages, device_busy=busy)


def _device_busy(dev, fn, params, batch, top=6):
    """One dispatch under torch.profiler: the union of its device-activity
    intervals over the (profiled) wall time, and the ops with the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(params, batch)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(params, batch)
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
    lanes = len(batch["image"])
    log(f"[serving] profiled {lanes}-lane fused_select dispatch: device busy "
        f"{busy_us / 1e3:.2f} of {wall_us / 1e3:.2f} ms wall "
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
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        return 1

    import torch

    k = kernels["serving"]
    line = {"kernels": [
        {"name": "soft_inlier_scores", "route": "cuda",
         "source": "esac_tpu_torch/csrc/soft_inlier.cu",
         "replaces": "esac_tpu/ransac/pallas_scoring.py:94",
         "launches": serving["launches"]["pallas"]["soft_inlier_scores"],
         "max_abs_err": k["err_scores"], "ms": k["ms"]["score"],
         "kernel_ms": k["ms"]["score_kernel"], "wrapper_ms": k["ms"]["score"],
         "plain_ms": k["ms"]["score_plain"], "bound_ms": k["bound"]["score"]["bound_ms"],
         "bound_by": k["bound"]["score"]["bound_by"], "library_ms": None},
        {"name": "soft_inlier_select", "route": "cuda",
         "source": "esac_tpu_torch/csrc/soft_inlier.cu",
         "replaces": "esac_tpu/ransac/pallas_scoring.py:301",
         "launches": serving["launches"]["fused_select"]["soft_inlier_select"],
         "max_abs_err": k["err_select"], "ms": k["ms"]["select"],
         "kernel_ms": k["ms"]["select_kernel"], "wrapper_ms": k["ms"]["select"],
         "plain_ms": k["ms"]["select_plain"], "bound_ms": k["bound"]["select"]["bound_ms"],
         "bound_by": k["bound"]["select"]["bound_by"], "library_ms": None},
    ]}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(device=name, nvidia_smi=smi, build_s=build_s,
                                       kernels=kernels, serving=serving), indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
