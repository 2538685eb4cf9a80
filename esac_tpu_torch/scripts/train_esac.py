"""Stage 3: end-to-end ESAC training through the hypothesis loop (the
port's counterpart of the root ``train_esac.py``): loads the stage-1
expert checkpoints and the stage-2 gating checkpoint, then minimizes the
expected pose loss through sampling / P3P / scoring / selection /
refinement with ``train.make_esac_train_step``.

    python -m esac_tpu_torch.scripts.train_esac synth0 synth1 --size test --iterations 50 \\
        --experts ckpt_expert_synth0 ckpt_expert_synth1 --gating ckpt_gating

``--estimator dense`` (default) weighs every expert's expected loss by its
gating probability; ``sampled`` is the reference-parity REINFORCE
estimator.  Under ``--scoring-impl pallas`` each step launches the CUDA
scoring kernel once.  Fine-tune recipe from a strong stage-1/2 baseline:
``--clip-norm 1.0 --learningrate 3e-6 --alpha-start 0.1``.

Writes ``<output>_state`` (resume-capable: experts, gating, Adam) and, at
the end, ``<output>_expert{m}`` / ``<output>_gating``.

``--backend cpp`` trains through the C++ extension, as the reference
does: the CNNs run on the device, and each frame's expected losses of
every expert come from ``esac_train_cpp`` on host copies of its
coordinates (``backends.train_bridge``), whose coordinate gradients go
back into the autograd backward; the frame's loss is
``sum(softmax(logits) * E)`` (``--estimator dense`` only).

``--sharded`` trains with the experts split over ``torch.distributed``
ranks (``parallel.make_sharded_esac_train_step``; ``cli.run_sharded``
starts the ranks): the experts padded to a multiple of the rank count by
copies of expert 0 whose gating logits are -inf (zero mass, so zero loss
and zero gradients), each rank running its local experts, dense (the
coordinate gather) or with ``--capacity k`` gating-routed.  A rank's Adam
holds its local experts (``parallel.shard_esac_params``) and the gating
net; before each save rank 0 gathers the other ranks' experts and their
moments and writes the unsharded layout (every expert, then gating).  The
padded stack is in the train state, so ``--sharded --resume`` needs the
original rank count; each rank then loads its experts' slice of the state.

    python -m esac_tpu_torch.scripts.train_esac ... --sharded --cpu --devices 2
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from esac_tpu_torch.cli import (
    add_scoring_impl_arg, add_sharded_args, batch_frames, check_sharded_devices, common_parser,
    device_of, load_esac_scene, open_scene, resume_train_state, run_sharded, scene_kwargs,
    train_loop,
)
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.train import make_esac_train_step
from esac_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint

MODULE = "esac_tpu_torch.scripts.train_esac"


def _parser():
    p = common_parser(__doc__)
    add_scoring_impl_arg(p)
    p.add_argument("scenes", nargs="+")
    p.add_argument("--experts", nargs="+", required=True,
                   help="stage-1 expert checkpoint dirs, one per scene")
    p.add_argument("--gating", required=True, help="stage-2 gating checkpoint")
    p.add_argument("--hypotheses", type=int, default=256)
    p.add_argument("--estimator", choices=("dense", "sampled"), default="dense")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="softmax selection temperature over hypothesis scores")
    p.add_argument("--alpha-start", type=float, default=None,
                   help="two-phase selection-sharpness anneal: use this alpha "
                        "for the first half of training, then switch to --alpha")
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off); the pose-loss "
                        "gradient through IRLS refinement can spike on "
                        "near-degenerate hypotheses")
    p.add_argument("--loss-clamp", type=float, default=100.0,
                   help="per-hypothesis pose-loss clamp (deg-equivalent)")
    add_sharded_args(p, train=True)
    p.add_argument("--output", default="ckpts/ckpt_esac")
    return p


def _args(argv):
    p = _parser()
    args = p.parse_args(argv)
    if len(args.experts) != len(args.scenes):
        p.error("need one --experts checkpoint per scene")
    if not args.sharded and (args.capacity or args.devices):
        p.error("--capacity/--devices only apply with --sharded (without "
                "it this would silently train the plain dense path)")
    if args.capacity < 0:
        p.error("--capacity must be >= 0")
    if args.sharded:
        if args.backend != "jax":
            p.error("--sharded is a jax-backend mode")
        if args.estimator != "dense":
            p.error("--sharded trains the dense estimator (the sampled/"
                    "REINFORCE draw has no per-device top-k structure)")
        if args.alpha_start is not None:
            p.error("--alpha-start with --sharded is not supported yet")
        check_sharded_devices(p, args)
    if args.alpha_start is not None and args.backend == "cpp":
        p.error("--alpha-start is a jax-backend option")
    if args.backend == "cpp" and args.estimator != "dense":
        p.error("--backend cpp supports --estimator dense only "
                "(the extension implements the dense expectation)")
    return p, args


def main(argv=None, timer=None) -> int:
    """``timer``: as ``train_expert.main``'s."""
    argv = sys.argv[1:] if argv is None else list(argv)
    p, args = _args(argv)
    if args.sharded:
        return run_sharded(args, MODULE, argv)
    return _train(p, args, device_of(args), timer)


def sharded_rank(argv) -> int:
    """One rank of a --sharded run (its process group initialized)."""
    import torch.distributed as dist

    from esac_tpu_torch.parallel import make_mesh

    p, args = _args(argv)
    dev = device_of(args)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return _train(p, args, dev, None, make_mesh(n_data=1, n_expert=dist.get_world_size()))


def _train(p, args, dev, timer, mesh=None) -> int:
    writer = mesh is None or mesh.get_rank() == 0

    datasets = [open_scene(args.root, s, "training", expert=i, device=dev, **scene_kwargs(args))
                for i, s in enumerate(args.scenes)]
    f0 = datasets[0][0]
    H, W = f0.image.shape[:2]
    scene, e_cfgs, g_cfg = load_esac_scene(args.experts, args.gating, f0.focal,
                                           (W / 2.0, H / 2.0), dev)
    M = len(e_cfgs)
    pixels = output_pixel_grid(H, W, 8, device=dev)
    cfg = RansacConfig(n_hyps=args.hypotheses, train_refine_iters=1, alpha=args.alpha,
                       loss_clamp=args.loss_clamp, scoring_impl=args.scoring_impl)
    before_save = None
    if mesh is not None:
        from esac_tpu_torch.parallel import pad_experts_for_mesh

        n_dev = mesh.size()
        scene["expert"], scene["centers"], M_pad = pad_experts_for_mesh(
            scene["expert"], scene["centers"], n_dev)
        if writer:
            print(f"sharded training: {n_dev} devices, M={M} (+{M_pad - M} pad), "
                  f"capacity={args.capacity or 'dense'}")
        if args.resume:
            saved = {k.split(".")[0] for k in
                     load_train_state(f"{args.output}_state")[0]["expert"]}
            if len(saved) != M_pad:
                p.error(f"resumed expert stack is {len(saved)} wide (padded for its "
                        f"original mesh) but this run pads to {M_pad}: --sharded --resume "
                        "requires the same device count as the original run")
    scene["expert"].train()
    scene["gating"].train()
    trained = scene["expert"]
    if mesh is not None:
        from esac_tpu_torch.parallel import shard_esac_params

        trained, _ = shard_esac_params(mesh, scene["expert"], scene["gating"])
    opt = torch.optim.Adam(list(trained.parameters()) + list(scene["gating"].parameters()),
                           lr=args.learningrate)
    # The train state's optimizer: the unsharded layout over a sharded run's
    # local optimizer (rank 0 gathers it before each save).
    saved_opt = opt if mesh is None else _ShardedAdamState(opt, mesh, scene["expert"], dev)

    nets = {"expert": scene["expert"], "gating": scene["gating"]}
    state = f"{args.output}_state"
    start_it = resume_train_state(args, state, nets, saved_opt, dev, timer, verbose=writer)

    clip = args.clip_norm if args.clip_norm > 0 else float("inf")
    cpp_losses = None
    if args.backend == "cpp":
        # The reference trains through its C++ extension: one host call a
        # frame, the extension's gradients injected into the backward.
        from esac_tpu_torch.backends.train_bridge import make_cpp_expert_losses

        cpp_losses = make_cpp_expert_losses(pixels, float(f0.focal), (W / 2.0, H / 2.0), cfg)

    def make_step(step_cfg):
        return make_esac_train_step(scene, opt, step_cfg, pixels, mode=args.estimator,
                                    clip_norm=clip, device=dev, expert_losses=cpp_losses)

    if mesh is not None:
        from esac_tpu_torch.parallel import make_sharded_esac_train_step
        from esac_tpu_torch.parallel.esac_sharded import PaddedGating

        def make_step(step_cfg):  # noqa: F811 -- the sharded step
            step = make_sharded_esac_train_step(
                mesh, scene["expert"], PaddedGating(scene["gating"], M_pad),
                scene["centers"], opt, step_cfg, pixels, scene["f"], scene["c"],
                capacity=args.capacity or None, clip_norm=clip, device=dev)
            return lambda seed, images, R_gts, t_gts: step(seed, images, R_gts, t_gts)

        before_save = saved_opt.gather

    esac_step = make_step(cfg)
    # Two-phase selection-sharpness anneal: a soft first half spreads the
    # selection gradient over more hypotheses, then --alpha takes over.
    alpha_switch_it = args.iterations // 2
    esac_step_early = (None if args.alpha_start is None
                       else make_step(dataclasses.replace(cfg, alpha=args.alpha_start)))

    # Every scene on the device once (see train_expert.py).
    staged = [batch_frames(d, np.arange(len(d)), device=dev) for d in datasets]
    images_d = torch.cat([b["images"] for b in staged])
    R_gts_d = rodrigues(torch.cat([b["rvecs"] for b in staged]))
    tvecs_d = torch.cat([b["tvecs"] for b in staged])

    def train_step(it, idx):
        step_fn = (esac_step_early
                   if esac_step_early is not None and it < alpha_switch_it else esac_step)
        # The step's seed depends on the iteration alone: resume-exact.
        return step_fn(args.seed * 7919 + it, images_d[idx], R_gts_d[idx], tvecs_d[idx])

    def finish():
        for m, cfg_d in enumerate(e_cfgs):
            save_checkpoint(f"{args.output}_expert{m}", scene["expert"][m].state_dict(),
                            {**cfg_d, "e2e": True})
        save_checkpoint(f"{args.output}_gating", scene["gating"].state_dict(),
                        {**g_cfg, "e2e": True})

    loss = train_loop(args, state, nets, saved_opt, lambda loss: _state_config(args),
                      images_d.shape[0], train_step,
                      lambda it, loss: f"E[pose loss] {float(loss):.3f}", dev, start_it, timer,
                      finish, width=6, before_save=before_save, writer=writer)
    if loss is not None and writer:
        print(f"saved {args.output}_expert*/{args.output}_gating  "
              f"final E[pose loss] {float(loss):.3f}")
    return 0


def _state_config(args) -> dict:
    return {"kind": "esac_state", "scenes": args.scenes}


class _ShardedAdamState:
    """The unsharded train state's Adam layout (every expert's parameters in
    order, then gating's) over a sharded rank's Adam, which holds its local
    experts [lo, lo + m) and gating.  ``load_state_dict`` loads this rank's
    slice of a saved state; :meth:`gather` (collective, every rank) sends each
    rank's experts -- parameters, buffers and moments -- to rank 0, which
    puts them into its expert modules and keeps the whole state for
    ``state_dict``.  The ranks of other data rows hold copies and send
    nothing."""

    def __init__(self, opt, mesh, experts, device):
        from esac_tpu_torch.parallel.mesh import axis_index, axis_size

        self.opt, self.mesh, self.experts = opt, mesh, experts
        self.m = len(experts) // axis_size(mesh, "expert")
        self.lo = axis_index(mesh, "expert") * self.m
        self.k = len(list(experts[0].parameters()))
        self.n_local = len(opt.param_groups[0]["params"])
        self.device = device
        self.full = None

    def _full_index(self, i: int) -> int:
        mk = self.m * self.k
        return self.lo * self.k + i if i < mk else len(self.experts) * self.k + i - mk

    def load_state_dict(self, full: dict) -> None:
        index = {self._full_index(i): i for i in range(self.n_local)}
        self.opt.load_state_dict({
            "state": {index[j]: s for j, s in full["state"].items() if j in index},
            "param_groups": [dict(full["param_groups"][0], params=list(range(self.n_local)))]})

    def state_dict(self) -> dict:
        return self.full

    def gather(self) -> None:
        import torch.distributed as dist

        from esac_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

        if axis_index(self.mesh, "data"):
            return
        # Each parameter with its two moments (zeros before its first step),
        # then the buffers; last, each parameter's step (0 before it).
        packed, steps = [], []
        for net in self.experts[self.lo:self.lo + self.m]:
            for p in net.parameters():
                st = self.opt.state.get(p, {})
                packed += [p, st.get("exp_avg", torch.zeros_like(p)),
                           st.get("exp_avg_sq", torch.zeros_like(p))]
                steps.append(float(st["step"]) if "step" in st else 0.0)
            packed += list(net.buffers())
        on = self.device if dist.get_backend() == "nccl" else torch.device("cpu")
        flat = torch.cat([t.detach().reshape(-1).float().to(on) for t in packed]
                         + [torch.tensor(steps, device=on)])
        root = dist.get_rank() == 0
        chunks = [torch.empty_like(flat) for _ in range(axis_size(self.mesh, "expert"))]
        dist.gather(flat, chunks if root else None, dst=0, group=axis_group(self.mesh, "expert"))
        if not root:
            return
        sd = self.opt.state_dict()
        n_exp = self.m * self.k
        state = {self._full_index(i): st for i, st in sd["state"].items() if i >= n_exp}
        with torch.no_grad():
            for r, chunk in enumerate(chunks):
                steps = chunk[-n_exp:].tolist()
                off = q = 0
                for net in self.experts[r * self.m:(r + 1) * self.m]:
                    for p in net.parameters():
                        n = p.numel()
                        value, avg, avg_sq = (chunk[off + i * n:off + (i + 1) * n].view(p.shape)
                                              for i in range(3))
                        p.copy_(value)
                        if steps[q]:
                            state[r * n_exp + q] = {"step": torch.tensor(steps[q]),
                                                    "exp_avg": avg.to(p.dtype).clone(),
                                                    "exp_avg_sq": avg_sq.to(p.dtype).clone()}
                        off, q = off + 3 * n, q + 1
                    for b in net.buffers():
                        b.copy_(chunk[off:off + b.numel()].view(b.shape))
                        off += b.numel()
        self.full = {"state": state, "param_groups": [
            dict(sd["param_groups"][0],
                 params=list(range(len(self.experts) * self.k + self.n_local - n_exp)))]}


if __name__ == "__main__":
    sys.exit(main())
