"""Evaluate ESAC: median pose errors, % within 5cm/5deg, per-frame timing
(the port's counterpart of the root ``test_esac.py``).

    python -m esac_tpu_torch.scripts.test_esac synth0 synth1 --size test \\
        --experts ckpt_expert_synth0 ckpt_expert_synth1 --gating ckpt_gating

Frames are evaluated in batches of --eval-batch (the last one padded with
its edge frame): the gating and expert CNNs, then ``esac_infer_frames``
(or ``esac_infer_topk_frames`` with --topk), which under
``--scoring-impl pallas`` launches the CUDA scoring kernel once per batch.
Per-frame times cover the whole pipeline, synchronized before each clock
read, with the first batch dropped as warm-up.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from esac_tpu_torch.cli import (
    add_scoring_impl_arg, common_parser, device_of, load_esac_scene, open_scene, scene_kwargs,
)
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.geometry.camera import pose_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import esac_infer_frames, esac_infer_topk_frames
from esac_tpu_torch.ransac.kernel import frame_generators
from esac_tpu_torch.registry.serving import scene_forward
from esac_tpu_torch.utils.profiling import wait_for

# The keys of the --json file: the JAX package's script's (without its
# --sharded extras), and of its "per_frame" record.
JSON_KEYS = (
    "scenes", "backend", "frames", "median_rot_deg", "median_trans_cm", "pct_5cm5deg",
    "expert_accuracy_pct", "gating_top1_pct", "evaluated_recall_pct", "median_ms_per_frame",
    "timing_scope", "median_hyploop_ms_per_frame", "hypotheses_total", "refine_iters",
    "per_frame",
)
PER_FRAME_KEYS = ("expert", "rot_err_deg", "trans_err_cm", "winner_score", "winner_margin")


def main(argv=None) -> int:
    p = common_parser(__doc__)
    add_scoring_impl_arg(p)
    p.add_argument("scenes", nargs="+")
    p.add_argument("--experts", nargs="+", required=True)
    p.add_argument("--gating", required=True)
    p.add_argument("--hypotheses", type=int, default=256)
    p.add_argument("--refine-iters", type=int, default=0,
                   help="IRLS rounds refining the winning pose (0 = the "
                        "RansacConfig default)")
    p.add_argument("--limit", type=int, default=0, help="max frames per scene (0 = all)")
    p.add_argument("--topk", type=int, default=0,
                   help="evaluate only the top-k gating experts (0 = all, dense)")
    p.add_argument("--eval-batch", type=int, default=16,
                   help="frames per batch of the CNNs and the hypothesis loop")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the metrics as a JSON file")
    args = p.parse_args(argv)
    if len(args.experts) != len(args.scenes):
        p.error("need one --experts checkpoint per scene")
    dev = device_of(args)
    backend = f"torch-{dev.type}"

    datasets = [open_scene(args.root, s, "test", expert=i, device=dev, **scene_kwargs(args))
                for i, s in enumerate(args.scenes)]
    M = len(datasets)
    f0 = datasets[0][0]
    H, W = f0.image.shape[:2]
    cx = torch.tensor([W / 2.0, H / 2.0], device=dev)
    scene, _, _ = load_esac_scene(args.experts, args.gating, f0.focal, cx, dev)
    scene["expert"].eval()
    scene["gating"].eval()
    pixels = output_pixel_grid(H, W, 8, device=dev)
    cfg = RansacConfig(n_hyps=args.hypotheses, scoring_impl=args.scoring_impl,
                       **({"refine_iters": args.refine_iters} if args.refine_iters > 0 else {}))

    # Every evaluated frame on the device once; batches index it there.
    frames = []
    for ds in datasets:
        n = len(ds) if args.limit == 0 else min(args.limit, len(ds))
        frames.extend(ds[i] for i in range(n))
    n_total = len(frames)
    images_d = torch.stack([f.image for f in frames])
    focals_d = torch.as_tensor([f.focal for f in frames], dtype=torch.float32, device=dev)
    labels_h = np.asarray([f.expert for f in frames])
    R_gts = rodrigues(torch.stack([f.rvec for f in frames]))
    t_gts = torch.stack([f.tvec for f in frames])

    rot_errs, trans_errs, times, hyp_times, ok, expert_ok = [], [], [], [], 0, 0
    winners: list[int] = []
    # The winning expert's best soft-inlier score, and its margin over the
    # runner-up expert's best: a near-zero margin makes the consensus
    # argmax a coin flip between experts.
    winner_scores: list = []
    winner_margins: list = []
    # Gating quality apart from the consensus winner: top-1, and recall of
    # the evaluated set (did the true expert's CNN run: 100% when dense).
    gate_top1 = 0
    recall_hits = 0
    B = max(1, args.eval_batch)
    for start in range(0, n_total, B):
        sel = np.arange(start, min(start + B, n_total))
        pad_h = np.pad(sel, (0, B - len(sel)), mode="edge")  # a fixed batch shape
        pad = torch.as_tensor(pad_h, device=dev)
        with torch.inference_mode():
            t_full = time.perf_counter()
            coords_all, logits = scene_forward(scene, images_d[pad])
            wait_for(coords_all)
            t0 = time.perf_counter()
            gens = frame_generators(pad_h, dev)  # seeded by frame index
            if args.topk > 0:
                out = esac_infer_topk_frames(gens, logits, coords_all, pixels, focals_d[pad], cx,
                                             cfg, k=args.topk, device=dev)
            else:
                out = esac_infer_frames(gens, logits, coords_all, pixels, focals_d[pad], cx,
                                        cfg, device=dev)
            wait_for(out["rvec"])
            now = time.perf_counter()
            r_errs, t_errs = pose_errors(rodrigues(out["rvec"]), out["tvec"], R_gts[pad],
                                         t_gts[pad])
        dt = (now - t_full) / len(pad)
        dt_hyp = (now - t0) / len(pad)
        experts = out["expert"].cpu().numpy()
        ev_sets = out["experts_evaluated"].cpu().numpy() if args.topk > 0 else None
        per_exp = out["scores"].double().amax(-1).cpu().numpy()  # (B, K)
        b_scores = per_exp.max(-1)
        if per_exp.shape[1] > 1:
            top2 = np.sort(per_exp, axis=-1)[:, -2:]
            b_margins = top2[:, 1] - top2[:, 0]
        else:
            b_margins = np.full(len(pad), np.nan)
        r_errs, t_errs = r_errs.cpu().numpy(), t_errs.cpu().numpy()
        logits_np = logits.cpu().numpy()
        for j, gi in enumerate(sel):
            r_err, t_err = float(r_errs[j]), float(t_errs[j])
            rot_errs.append(r_err)
            trans_errs.append(t_err)
            ok += bool(r_err < 5.0 and t_err < 0.05)
            label = int(labels_h[gi])
            expert_ok += int(experts[j]) == label
            gate_top1 += int(np.argmax(logits_np[j])) == label
            recall_hits += 1 if ev_sets is None else label in ev_sets[j]
            winners.append(int(experts[j]))
            winner_scores.append(None if np.isnan(b_scores[j]) else round(float(b_scores[j]), 3))
            winner_margins.append(
                None if np.isnan(b_margins[j]) else round(float(b_margins[j]), 3))
            times.append(dt)
            hyp_times.append(dt_hyp)

    rot = np.asarray(rot_errs)
    tr = np.asarray(trans_errs)

    def _drop_warmup(xs):
        # Every frame of the first batch shares its warm-up dispatch time.
        return np.asarray(xs[B:] if len(xs) > B else xs)

    tm = _drop_warmup(times)
    n_hyp_experts = min(args.topk, M) if args.topk > 0 else M
    print(f"frames: {n_total}")
    print(f"median rot err:   {np.median(rot):.2f} deg")
    print(f"median trans err: {100 * np.median(tr):.2f} cm")
    print(f"5cm/5deg:         {100.0 * ok / n_total:.1f}%")
    print(f"expert accuracy:  {100.0 * expert_ok / n_total:.1f}%")
    print(f"gating top-1:     {100.0 * gate_top1 / n_total:.1f}%")
    print(f"evaluated recall: {100.0 * recall_hits / n_total:.1f}%  (true expert's CNN ran)")
    print(f"median time:      {1e3 * np.median(tm):.1f} ms/frame full pipeline "
          f"({args.hypotheses * n_hyp_experts} hyps, backend={backend})")
    if args.json:
        record = {
            "scenes": args.scenes,
            "backend": backend,
            "frames": n_total,
            "median_rot_deg": round(float(np.median(rot)), 4),
            "median_trans_cm": round(100 * float(np.median(tr)), 3),
            "pct_5cm5deg": round(100.0 * ok / n_total, 2),
            "expert_accuracy_pct": round(100.0 * expert_ok / n_total, 2),
            "gating_top1_pct": round(100.0 * gate_top1 / n_total, 2),
            "evaluated_recall_pct": round(100.0 * recall_hits / n_total, 2),
            "median_ms_per_frame": round(1e3 * float(np.median(tm)), 2),
            "timing_scope": "full pipeline: gating + expert CNN forwards + hypothesis "
                            "loop (median_hyploop_ms_per_frame is the hypothesis loop "
                            "alone); synchronized, first batch dropped",
            "median_hyploop_ms_per_frame": round(
                1e3 * float(np.median(_drop_warmup(hyp_times))), 2),
            "hypotheses_total": args.hypotheses * n_hyp_experts,
            "refine_iters": cfg.refine_iters,
            # Per-frame records, so two runs over the same frames compare
            # frame by frame.
            "per_frame": {
                "expert": winners,
                "rot_err_deg": [round(x, 3) for x in rot_errs],
                "trans_err_cm": [round(100 * x, 2) for x in trans_errs],
                "winner_score": winner_scores,
                "winner_margin": winner_margins,
            },
        }
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=2)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
