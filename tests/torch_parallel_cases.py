"""Rank-side cases of tests/test_torch_parallel.py and
tests/test_torch_parallel_train.py.

Each test file spawns one gloo group of 4 CPU ranks
(``esac_tpu_torch.parallel.spawn_ranks``) that runs one function of this
module: it reads the inputs the test wrote (numpy, some made by the JAX
package's fixtures in the test process), runs every case on the meshes
1x4, 2x2 and 4x1, computes the single-device references in the same
process, and saves its results for the test to compare.  This module
imports torch and the port only, so the ranks never load JAX.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch
from torch import nn

from esac_tpu_torch.parallel import (
    esac_infer_routed,
    esac_infer_sharded,
    esac_infer_sharded_frames,
    follow,
    make_esac_infer_routed_frames_sharded,
    make_esac_infer_sharded_frames,
    make_esac_infer_sharded_frames_dynamic,
    make_mesh,
    make_sharded_esac_loss,
    pad_experts_for_mesh,
    pad_gating_logits,
)
from esac_tpu_torch.parallel.esac_sharded import _winner_allreduce
from esac_tpu_torch.parallel.mesh import axis_group, batch_sharding
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import (
    esac_infer,
    esac_infer_frames,
    esac_infer_routed_frames,
    esac_train_loss_frames,
    routed_serve_capacity,
    select_topk_experts,
)
from esac_tpu_torch.ransac.kernel import dsac_infer_frames, frame_generators
from esac_tpu_torch.parallel.esac_sharded import route_frames_to_experts

CPU = torch.device("cpu")
GRID = (15, 20)  # the fixtures' output cells: 120 x 160 at stride 8


def map_expert(coords):
    """A test expert whose output IS its coordinate map, whatever the image
    (the JAX tests' ``_fake_expert_stack``)."""
    maps = torch.as_tensor(coords, dtype=torch.float32).reshape(1, *GRID, 3)
    return lambda images: maps.expand(images.shape[0], *GRID, 3)


class MapExpert(nn.Module):
    """Trainable :func:`map_expert`: the map is the parameter."""

    def __init__(self, coords):
        super().__init__()
        self.map = nn.Parameter(torch.as_tensor(coords, dtype=torch.float32).clone())

    def forward(self, images):
        return self.map.reshape(1, *GRID, 3).expand(images.shape[0], *GRID, 3)


class FixedGating(nn.Module):
    """Gating whose parameters ARE the logits, plus a fixed additive mask
    (the JAX tests' ``_fake_gating_net``)."""

    def __init__(self, mask):
        super().__init__()
        self.logits = nn.Parameter(torch.zeros(len(mask)))
        self.register_buffer("mask", torch.as_tensor(mask, dtype=torch.float32))

    def forward(self, images):
        return (self.logits + self.mask).expand(images.shape[0], len(self.mask))


def _meshes():
    return {"1x4": make_mesh(1, 4), "2x2": make_mesh(2, 2), "4x1": make_mesh(4, 1)}


def _cfg(d: dict) -> RansacConfig:
    return RansacConfig(**d)


def _np(out):
    if isinstance(out, dict):
        return {k: _np(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_np(v) for v in out)
    return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else out


def _save(workdir, rank, out):
    torch.save(out, pathlib.Path(workdir) / f"rank{rank}.pt")


# ------------------------------------------------------------- inference


def run_inference(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(pathlib.Path(workdir) / "inputs.pt", weights_only=False)
    meshes = _meshes()
    out = {}

    # The winner all-reduce on hand-made rows: rank r holds row r.
    war = inp["war"]
    out["war"] = _np(_winner_allreduce(
        torch.as_tensor(war["scores"][rank]), torch.as_tensor(war["g"][rank]),
        torch.as_tensor(war["rvec"][rank]), torch.as_tensor(war["tvec"][rank]), war["M"],
        axis_group(meshes["1x4"], "expert")))

    # Dense sharded frames against esac_infer_frames, at expert axes 4 and
    # 2, every scoring impl, generator-drawn and injected sets.
    d = inp["dense"]
    B, M = d["coords"].shape[:2]
    out["dense"] = {}
    for impl in ("errmap", "fused", "fused_select", "pallas"):
        cfg = dataclasses.replace(_cfg(d["cfg"]), scoring_impl=impl)
        ref_cfg = cfg
        for injected in (False, True):
            idx = d["idx"] if injected else None
            ref = esac_infer_frames(frame_generators(d["seeds"], CPU), np.zeros((B, M), np.float32),
                                    d["coords"], d["pixels"], d["f"], d["c"], ref_cfg,
                                    idx=idx, device=CPU)
            ref = {"rvec": ref["rvec"], "tvec": ref["tvec"], "expert": ref["expert"],
                   "score": ref["score"] if "score" in ref else ref["scores"].amax((1, 2))}
            for name in ("1x4", "2x2"):
                got = esac_infer_sharded_frames(meshes[name], d["seeds"], d["coords"],
                                                d["pixels"], d["f"], d["c"], cfg, idx=idx,
                                                device=CPU)
                out["dense"][(impl, injected, name)] = (_np(got), _np(ref))
    # One frame: esac_infer_sharded against esac_infer.
    cfg = _cfg(d["cfg"])
    one = esac_infer_sharded(meshes["1x4"], torch.Generator().manual_seed(5), d["coords"][0],
                             d["pixels"], d["f"][0], d["c"], cfg, device=CPU)
    ref = esac_infer(torch.Generator().manual_seed(5), np.zeros(M, np.float32), d["coords"][0],
                     d["pixels"], d["f"][0], d["c"], cfg, device=CPU)
    out["single"] = (_np(one), _np((ref["rvec"], ref["tvec"], ref["expert"],
                                    ref["scores"].amax())))

    # The JAX package's one-correct-expert fixture.
    fx = inp["fixture"]
    out["fixture"] = _np(esac_infer_sharded(
        meshes["1x4"], torch.Generator().manual_seed(7), fx["coords"], fx["pixels"], fx["f"],
        fx["c"], _cfg(fx["cfg"]), device=CPU))

    # Routed (per-rank capacity): overflow and padding fixtures.
    out["routed"] = {}
    for name, case in inp["routed"].items():
        maps = torch.as_tensor(case["maps"])
        experts, centers, M_pad = pad_experts_for_mesh(
            [map_expert(mp) for mp in maps], torch.zeros((len(maps), 3)), 4)
        infer = esac_infer_routed(meshes["1x4"], experts, centers, case["capacity"],
                                  _cfg(case["cfg"]), device=CPU)
        logits = pad_gating_logits(torch.as_tensor(case["logits"]), M_pad)
        out["routed"][name] = _np(infer(
            [3], logits, torch.zeros((1, 1, 1, 3)), torch.full((1,), float(case["f"])),
            case["pixels"], case["c"]))
        out["routed"][name]["M_pad"] = M_pad

    # Routed frames (global top-k) against the single-device routed entry.
    r = inp["routed_frames"]
    cfg = _cfg(r["cfg"])
    M = len(r["maps"])
    experts = [map_expert(mp) for mp in r["maps"]]
    out["routed_frames"] = {}
    for cap in (None, 2):
        for name in ("1x4", "2x2"):
            infer = make_esac_infer_routed_frames_sharded(meshes[name], experts, torch.zeros((M, 3)),
                                                          cfg, k=r["k"], capacity=cap, device=CPU)
            got = infer(r["seeds"], r["logits"], torch.zeros((len(r["seeds"]), 1, 1, 3)),
                        r["f"], r["pixels"], r["c"])
            cap_ = cap if cap is not None else routed_serve_capacity(cfg, r["k"], M)
            sel = select_topk_experts(torch.as_tensor(r["logits"]), r["k"])
            kept = route_frames_to_experts(sel, M, cap_)[0]
            ref = esac_infer_routed_frames(
                frame_generators(r["seeds"], CPU), r["logits"], torch.as_tensor(r["maps"])[sel],
                sel, kept, r["pixels"], r["f"], r["c"], cfg, device=CPU)
            out["routed_frames"][(cap, name)] = (_np(got), _np(ref))

    # Data parallel: a frame batch split over the data axis.
    dp = inp["dp"]
    cfg = _cfg(dp["cfg"])
    mesh = meshes["4x1"]
    mine = dsac_infer_frames(
        frame_generators(batch_sharding(mesh, torch.as_tensor(dp["seeds"])), CPU),
        batch_sharding(mesh, torch.as_tensor(dp["coords"])),
        batch_sharding(mesh, torch.as_tensor(dp["pixels"])), dp["f"], dp["c"], cfg, device=CPU)
    full = dsac_infer_frames(frame_generators(dp["seeds"], CPU), dp["coords"], dp["pixels"],
                             dp["f"], dp["c"], cfg, device=CPU)
    out["dp"] = (_np(mine), _np(full))

    # The sharded serve functions behind a dispatcher on rank 0.
    out["serve"] = _serve_cases(rank, meshes["1x4"], inp["serve"])
    _save(workdir, rank, out)


def _serve_cases(rank, mesh, s):
    from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest, ScenePreset
    from esac_tpu_torch.registry.serving import SceneRegistry, make_registry_sharded_serve_fn
    from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher, make_sharded_serve_fn

    cfg = _cfg(s["cfg"])
    frames = [{"seed": np.int64(s["seeds"][i]), "coords_all": s["coords"][i],
               "pixels": s["pixels"], "f": np.float32(s["f"][i])} for i in range(len(s["seeds"]))]
    if rank != 0:
        return {"calls": [follow(make_esac_infer_sharded_frames(mesh, s["c"]["a"], cfg,
                                                                as_tree=True, device=CPU), CPU),
                          follow(make_esac_infer_sharded_frames_dynamic(mesh, cfg, CPU), CPU),
                          follow(make_esac_infer_sharded_frames(mesh, s["c"]["a"], cfg,
                                                                as_tree=True, device=CPU), CPU)]}
    out = {}
    fn = make_sharded_serve_fn(mesh, s["c"]["a"], cfg, device=CPU)
    disp = MicroBatchDispatcher(fn, cfg, start_worker=False, device=CPU)
    out["plain"] = [_np(r) for r in disp.infer_many(frames)]
    out["plain_signatures"] = disp.cache_size()
    fn.stop()

    preset = ScenePreset(height=120, width=160, num_experts=s["coords"].shape[1], gated=False)
    man = SceneManifest()
    for sid in ("a", "b"):
        man.add(SceneEntry(scene_id=sid, version=1, expert_ckpt=f"/{sid}", preset=preset))
    reg = SceneRegistry(man, loader=lambda e: {"c": torch.as_tensor(s["c"][e.scene_id])},
                        device=CPU)
    reg.cache._stage = lambda entry, host: host
    serve = make_registry_sharded_serve_fn(mesh, reg, cfg, device=CPU)
    disp = MicroBatchDispatcher(serve, cfg, start_worker=False, device=CPU)
    out["registry"] = {sid: [_np(r) for r in disp.infer_many(frames, scene=sid)]
                       for sid in ("a", "b")}
    out["registry_signatures"] = disp.cache_size()
    serve.stop()
    out["concurrent"] = _concurrent_calls(mesh, s, cfg)
    out["ref"] = {}
    for sid in ("a", "b"):
        ref = esac_infer_frames(frame_generators(s["seeds"], CPU),
                                np.zeros(s["coords"].shape[:2], np.float32), s["coords"],
                                s["pixels"], s["f"], s["c"][sid], cfg, device=CPU)
        out["ref"][sid] = _np({"rvec": ref["rvec"], "tvec": ref["tvec"],
                               "expert": ref["expert"], "score": ref["scores"].amax((1, 2))})
    return out


def _concurrent_calls(mesh, s, cfg):
    """Two threads call one led serve function at once (a dispatcher's
    watchdog worker beside a stalled dispatch): rank 0 serializes the calls,
    so the followers replay them in the same order.  Returns each thread's
    frame indices and result."""
    import threading

    from esac_tpu_torch.serve.dispatcher import make_sharded_serve_fn

    fn = make_sharded_serve_fn(mesh, s["c"]["a"], cfg, device=CPU)
    B = len(s["seeds"])
    halves = [list(range(0, B, 2)), list(range(1, B, 2))]
    results = [None, None]
    start = threading.Barrier(2)

    def call(j):
        rows = halves[j]
        batch = {"seed": torch.as_tensor(s["seeds"][rows]),
                 "coords_all": torch.as_tensor(s["coords"][rows]),
                 "pixels": torch.as_tensor(s["pixels"]).expand(len(rows), *s["pixels"].shape),
                 "f": torch.as_tensor(s["f"][rows])}
        start.wait()
        results[j] = _np(fn(batch))

    threads = [threading.Thread(target=call, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fn.stop()
    return list(zip(halves, results))


# -------------------------------------------------------------- training


def _train_nets(t, mask, M_pad=None):
    experts = nn.ModuleList(MapExpert(mp) for mp in t["maps"])
    gating = FixedGating(mask)
    return experts, gating


def _grads(experts, gating):
    return ([None if e.map.grad is None else e.map.grad.clone() for e in experts],
            gating.logits.grad.clone())


def run_training(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(pathlib.Path(workdir) / "inputs.pt", weights_only=False)
    meshes = _meshes()
    t = inp["train"]
    out = {}
    B = len(t["R"])
    images = torch.zeros((B, 1, 1, 3))
    for case, c in t["cases"].items():
        cfg = _cfg(c["cfg"])
        M = len(t["maps"])
        mask = torch.as_tensor(c["mask"])
        # The single-device reference: esac_train_loss_frames on the whole
        # batch, the mean loss's gradients.
        experts, gating = _train_nets(t, mask)
        from esac_tpu_torch.train.e2e import step_generators

        coords = torch.stack([e(images) for e in experts], 1).reshape(B, M, -1, 3)
        losses, _ = esac_train_loss_frames(step_generators(2, B, CPU), gating(images), coords,
                                           t["pixels"], t["f"], t["c"], t["R"], t["t"], cfg,
                                           device=CPU)
        ref = losses.mean()
        ref.backward()
        out[(case, "ref")] = (float(ref), _np(_grads(experts, gating)))
        for name in c["meshes"]:
            mesh = meshes[name]
            for capacity in c["capacities"]:
                experts, gating = _train_nets(t, mask)
                loss_fn = make_sharded_esac_loss(mesh, experts, gating, torch.zeros((M, 3)),
                                                 t["pixels"], t["f"], t["c"], cfg,
                                                 capacity=capacity, device=CPU)
                loss = loss_fn(images, t["R"], t["t"], 2)
                loss.backward()
                loss_fn.reduce_grads()
                lo = M // mesh.size(1) * mesh.get_local_rank("expert")
                out[(case, name, capacity)] = (float(loss), _np(_grads(experts, gating)), lo,
                                               len(loss_fn.local_experts))
    _save(workdir, rank, out)
