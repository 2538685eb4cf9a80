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

``--backend cpp`` runs the hypothesis loop in C++ on the host
(``backends.esac_infer_gated_cpp``), once a frame on host copies of the
CNNs' output, with the frame's index as its seed and hypotheses x M
hypotheses drawn over the experts from the gating distribution; the CNNs
stay on the device.  That loop draws its experts per hypothesis, so no
evaluated set exists (no recall) and it reports no scores (score and margin
null).

``--sharded`` runs config #4's gating-routed path over ``torch.distributed``
ranks (``parallel.esac_infer_routed``; ``cli.run_sharded`` starts the
ranks): the experts padded to a multiple of the rank count, each rank
running the CNNs of its top --capacity local experts per frame (all of
them by default), the winner chosen by the cross-rank argmax all-reduce.
Hypotheses are drawn per frame by global expert index, so one rank with
every expert evaluates as the dense path does.

    python -m esac_tpu_torch.scripts.test_esac synth0 synth1 --sharded --cpu --devices 2 ...
    torchrun --nproc-per-node 2 -m esac_tpu_torch.scripts.test_esac ... --sharded
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from esac_tpu_torch.cli import (
    add_scoring_impl_arg, add_sharded_args, check_sharded_devices, common_parser, device_of,
    load_esac_scene, open_scene, run_sharded, scene_kwargs,
)
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.geometry.camera import pose_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import esac_infer_frames, esac_infer_topk_frames
from esac_tpu_torch.ransac.kernel import frame_generators
from esac_tpu_torch.registry.serving import scene_forward
from esac_tpu_torch.utils.profiling import wait_for

# The keys of the --json file: the JAX package's script's (--sharded adds
# SHARDED_KEYS), and of its "per_frame" record.
JSON_KEYS = (
    "scenes", "backend", "frames", "median_rot_deg", "median_trans_cm", "pct_5cm5deg",
    "expert_accuracy_pct", "gating_top1_pct", "evaluated_recall_pct", "median_ms_per_frame",
    "timing_scope", "median_hyploop_ms_per_frame", "hypotheses_total", "refine_iters",
    "per_frame",
)
PER_FRAME_KEYS = ("expert", "rot_err_deg", "trans_err_cm", "winner_score", "winner_margin")
SHARDED_KEYS = ("sharded", "devices", "capacity", "experts_evaluated_per_frame",
                "experts_total")
MODULE = "esac_tpu_torch.scripts.test_esac"


def _parser():
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
    add_sharded_args(p, train=False)
    p.add_argument("--eval-batch", type=int, default=16,
                   help="frames per batch of the CNNs and the hypothesis loop")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the metrics as a JSON file")
    return p


def _args(argv):
    p = _parser()
    args = p.parse_args(argv)
    if len(args.experts) != len(args.scenes):
        p.error("need one --experts checkpoint per scene")
    if args.sharded and args.backend != "jax":
        p.error("--sharded is a jax-backend mode")
    if args.sharded and args.topk:
        p.error("--sharded and --topk are mutually exclusive; use --capacity "
                "for gating-pruned compute on the mesh")
    if args.sharded:
        check_sharded_devices(p, args)
    return args


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    if args.sharded:
        return run_sharded(args, MODULE, argv)
    return _evaluate(args, device_of(args))


def sharded_rank(argv) -> int:
    """One rank of a --sharded run (its process group initialized)."""
    import torch.distributed as dist

    from esac_tpu_torch.parallel import make_mesh

    args = _args(argv)
    dev = device_of(args)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return _evaluate(args, dev, make_mesh(n_data=1, n_expert=dist.get_world_size()))


def _evaluate(args, dev, mesh=None) -> int:
    """The evaluation; ``mesh`` for --sharded (rank 0 prints and writes)."""
    backend = "cpp" if args.backend == "cpp" else f"torch-{dev.type}"
    writer = mesh is None or mesh.get_rank() == 0

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
    routed = None
    if mesh is not None:
        from esac_tpu_torch.parallel import (
            esac_infer_routed, pad_experts_for_mesh, pad_gating_logits,
        )

        n_dev = mesh.size()
        experts_p, centers_p, M_pad = pad_experts_for_mesh(scene["expert"], scene["centers"],
                                                           n_dev)
        m_local = M_pad // n_dev
        cap = min(args.capacity, m_local) if args.capacity > 0 else m_local
        # Padding slots run a (wasted) forward but are not real experts.
        n_evaluated = min(n_dev * cap, M)
        routed = esac_infer_routed(mesh, experts_p, centers_p, capacity=cap, cfg=cfg,
                                   device=dev)

    # Every evaluated frame on the device once; batches index it there.
    frames = []
    for ds in datasets:
        n = len(ds) if args.limit == 0 else min(args.limit, len(ds))
        frames.extend(ds[i] for i in range(n))
    n_total = len(frames)
    images_d = torch.stack([f.image for f in frames])
    focals_d = torch.as_tensor([f.focal for f in frames], dtype=torch.float32, device=dev)
    labels_h = np.asarray([f.expert for f in frames])
    focals_h = focals_d.cpu().numpy()
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
    # The cpp loop draws experts per hypothesis: no fixed evaluated set.
    recall_defined = args.backend != "cpp"
    B = max(1, args.eval_batch)
    for start in range(0, n_total, B):
        sel = np.arange(start, min(start + B, n_total))
        pad_h = np.pad(sel, (0, B - len(sel)), mode="edge")  # a fixed batch shape
        pad = torch.as_tensor(pad_h, device=dev)
        dt_hyp = None
        with torch.inference_mode():
            t_full = time.perf_counter()
            gens = frame_generators(pad_h, dev)  # seeded by frame index
            if routed is not None:
                # The expert CNNs run inside the routed call.
                logits = scene["gating"](images_d[pad])
                out = routed(gens, pad_gating_logits(logits, M_pad), images_d[pad],
                             focals_d[pad], pixels, cx)
            else:
                coords_all, logits = scene_forward(scene, images_d[pad])
                wait_for(coords_all)
                t0 = time.perf_counter()
                if args.backend == "cpp":
                    out = _infer_gated_cpp(coords_all, logits, pixels, focals_h[pad_h],
                                           (W / 2.0, H / 2.0), cfg, args.hypotheses * M,
                                           pad_h, dev)
                elif args.topk > 0:
                    out = esac_infer_topk_frames(gens, logits, coords_all, pixels,
                                                 focals_d[pad], cx, cfg, k=args.topk,
                                                 device=dev)
                else:
                    out = esac_infer_frames(gens, logits, coords_all, pixels, focals_d[pad],
                                            cx, cfg, device=dev)
            wait_for(out["tvec"])
            now = time.perf_counter()
            R_b = out["R"] if "R" in out else rodrigues(out["rvec"])
            r_errs, t_errs = pose_errors(R_b, out["tvec"], R_gts[pad], t_gts[pad])
        if args.backend == "cpp":
            dt_hyp = (now - t0) / len(pad)
            ev_sets = None
            b_scores = b_margins = np.full(len(pad), np.nan)
        elif routed is not None:
            ev_sets = out["experts_evaluated"].cpu().numpy()
            b_scores = out["score"].double().cpu().numpy()
            b_margins = np.full(len(pad), np.nan)
        else:
            dt_hyp = (now - t0) / len(pad)
            ev_sets = out["experts_evaluated"].cpu().numpy() if args.topk > 0 else None
            per_exp = out["scores"].double().amax(-1).cpu().numpy()  # (B, K)
            b_scores = per_exp.max(-1)
            if per_exp.shape[1] > 1:
                top2 = np.sort(per_exp, axis=-1)[:, -2:]
                b_margins = top2[:, 1] - top2[:, 0]
            else:
                b_margins = np.full(len(pad), np.nan)
        dt = (now - t_full) / len(pad)
        experts = out["expert"].cpu().numpy()
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
            if recall_defined:
                recall_hits += 1 if ev_sets is None else label in ev_sets[j]
            winners.append(int(experts[j]))
            winner_scores.append(None if np.isnan(b_scores[j]) else round(float(b_scores[j]), 3))
            winner_margins.append(
                None if np.isnan(b_margins[j]) else round(float(b_margins[j]), 3))
            times.append(dt)
            if dt_hyp is not None:
                hyp_times.append(dt_hyp)

    rot = np.asarray(rot_errs)
    tr = np.asarray(trans_errs)

    def _drop_warmup(xs):
        # Every frame of the first batch shares its warm-up dispatch time.
        return np.asarray(xs[B:] if len(xs) > B else xs)

    if not writer:
        return 0
    tm = _drop_warmup(times)
    n_hyp_experts = (n_evaluated if routed is not None
                     else min(args.topk, M) if args.topk > 0 else M)
    mode = f", sharded routed ({n_evaluated}/{M} experts/frame)" if routed is not None else ""
    print(f"frames: {n_total}")
    print(f"median rot err:   {np.median(rot):.2f} deg")
    print(f"median trans err: {100 * np.median(tr):.2f} cm")
    print(f"5cm/5deg:         {100.0 * ok / n_total:.1f}%")
    print(f"expert accuracy:  {100.0 * expert_ok / n_total:.1f}%")
    print(f"gating top-1:     {100.0 * gate_top1 / n_total:.1f}%")
    if recall_defined:
        print(f"evaluated recall: {100.0 * recall_hits / n_total:.1f}%  (true expert's CNN ran)")
    print(f"median time:      {1e3 * np.median(tm):.1f} ms/frame full pipeline "
          f"({args.hypotheses * n_hyp_experts} hyps, backend={backend}{mode})")
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
            "evaluated_recall_pct": (round(100.0 * recall_hits / n_total, 2)
                                     if recall_defined else None),
            "median_ms_per_frame": round(1e3 * float(np.median(tm)), 2),
            "timing_scope": "full pipeline: gating + expert CNN forwards + hypothesis "
                            "loop (median_hyploop_ms_per_frame is the hypothesis loop "
                            "alone; null for --sharded, whose expert forwards run inside "
                            "the routed call); synchronized, first batch dropped",
            "median_hyploop_ms_per_frame": (
                round(1e3 * float(np.median(_drop_warmup(hyp_times))), 2)
                if hyp_times else None),
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
        if routed is not None:
            record.update(zip(SHARDED_KEYS, (True, mesh.size(), cap, n_evaluated, M)))
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=2)
        print(f"wrote {args.json}")
    return 0


def _infer_gated_cpp(coords_all, logits, pixels, focals, c, cfg, n_hyps, seeds, dev) -> dict:
    """The C++ gated loop on host copies of a batch's CNN output, one call a
    frame (seeded by the frame's index): the winners' R (B, 3, 3), tvec
    (B, 3) and expert (B,) on ``dev``."""
    from esac_tpu_torch.backends import esac_infer_gated_cpp

    co_np = coords_all.float().cpu().numpy()
    px_np = pixels.cpu().numpy()
    gating_np = torch.softmax(logits.float(), dim=-1).cpu().numpy()
    Rs, ts, experts = [], [], []
    for j, seed in enumerate(seeds):
        r = esac_infer_gated_cpp(co_np[j], px_np, gating_np[j], float(focals[j]), c,
                                 n_hyps=n_hyps, tau=cfg.tau, beta=cfg.beta,
                                 refine_iters=cfg.refine_iters, seed=int(seed))
        Rs.append(r["R"])
        ts.append(r["t"])
        experts.append(r["expert"])
    return {"R": torch.as_tensor(np.stack(Rs), dtype=torch.float32, device=dev),
            "tvec": torch.as_tensor(np.stack(ts), dtype=torch.float32, device=dev),
            "expert": torch.as_tensor(experts, device=dev)}


if __name__ == "__main__":
    sys.exit(main())
