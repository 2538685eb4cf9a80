"""Scene serving: the port's counterparts of ``make_scene_bucket_fn`` and
``make_routed_scene_bucket_fn`` (``esac_tpu/registry/serving.py``).

``make_scene_bucket_fn(preset, cfg)`` returns ``fn(params, batch)``: every
expert CNN over the batch plus its scene center, the gating CNN (or zero
logits for ungated presets), then frames-major multi-expert RANSAC
(``esac_infer_frames``).  Per-scene quantities -- weights, centers, focal,
principal point -- ride ``params``, so one bucket function serves every
scene of a preset.

``params`` is the dict :func:`init_scene_params` builds: ``expert`` (an
``nn.ModuleList`` of M ``ExpertNet``), ``gating`` (``GatingNet`` or None),
``centers`` (M, 3), ``f`` (), ``c`` (2,), all on the serving device;
``models.convert.load_scene`` fills it from the JAX package's
``load_scene_params`` tree.  ``batch`` holds ``image`` (B, H, W, 3), a
per-frame ``seed`` (B,) in place of the JAX package's PRNG keys, and
optionally ``idx`` (B, M, n_hyps, 4) injected correspondence sets; a
session lane's batch adds ``prior_rvec`` / ``prior_tvec`` (B, P, 3) and
``prior_valid`` (B, P), and is served through the prior-slot entries
(``esac_infer_frames_prior``, ``esac_infer_routed_frames_prior``).

``make_routed_scene_bucket_fn(preset, cfg, k)`` serves gating first: the
gating CNN, each frame's top-k experts, then each expert's CNN over ONE
fixed block of ``routed_serve_capacity(cfg, k, M)`` frames that selected
it (``parallel.esac_sharded.route_frames_to_experts``), and the routed
hypothesis loop with the budget reallocated over the k experts.  The
block width is one constant per (cfg, k), so a frame's expert CNNs run at
the same width in every frame bucket.  At k = M it runs the dense CNN
schedule and equals ``make_scene_bucket_fn`` bit for bit.  The registry,
its caches and the dispatcher wait for later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from esac_tpu_torch.data.synthetic import CAMERA_F, output_pixel_grid
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.parallel.esac_sharded import route_frames_to_experts
from esac_tpu_torch.ransac.esac import (
    esac_infer_frames,
    esac_infer_frames_prior,
    esac_infer_routed_frames,
    esac_infer_routed_frames_prior,
    routed_serve_capacity,
    select_topk_experts,
)
from esac_tpu_torch.ransac.kernel import as_f32, frame_generators
from esac_tpu_torch.registry.manifest import ManifestError, ScenePreset
from esac_tpu_torch.utils.precision import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_scene_params(preset: ScenePreset, seed: int = 0, device=None) -> dict:
    """A scene with the port's own random initialization from ``seed``
    (PyTorch's default layer init under a forked, seeded RNG; the global
    RNG is left as it was), zero centers and the default camera scaled to
    the preset's width.  Modules are in eval mode on ``device``."""
    dev = resolve_device(device)
    dtype = _DTYPES[preset.compute_dtype]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        experts = nn.ModuleList(
            ExpertNet(stem_channels=preset.stem_channels,
                      head_channels=preset.head_channels,
                      head_depth=preset.head_depth, compute_dtype=dtype)
            for _ in range(preset.num_experts)
        )
        gating = GatingNet(preset.num_experts, preset.gating_channels,
                           compute_dtype=dtype) if preset.gated else None
    return {
        "expert": experts.to(dev).eval(),
        "gating": None if gating is None else gating.to(dev).eval(),
        "centers": torch.zeros((preset.num_experts, 3), device=dev),
        "f": torch.tensor(CAMERA_F * preset.width / 640.0, device=dev),
        "c": torch.tensor([preset.width / 2.0, preset.height / 2.0], device=dev),
    }


def scene_forward(params: dict, imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every expert CNN over ``imgs`` (B, H, W, 3) plus its scene center,
    and the gating CNN (zero logits for an ungated preset).  Returns coords
    (B, M, n_cells, 3) and logits (B, M); differentiable where the modules
    are (the training step runs it under autograd)."""
    B, M = imgs.shape[0], len(params["expert"])
    coords = torch.stack([net(imgs) for net in params["expert"]], dim=1)
    coords = coords.reshape(B, M, -1, 3) + params["centers"][None, :, None, :]
    if params["gating"] is None:
        return coords, torch.zeros((B, M), device=imgs.device)
    return coords, params["gating"](imgs)


def make_scene_bucket_fn(preset: ScenePreset, cfg: RansacConfig, device=None):
    """The full pipeline for a (preset, cfg) bucket: ``fn(params, batch)``
    -> per-frame result dict (see the module docstring).  Runs under
    ``torch.inference_mode``; every tensor stays on ``device``."""
    dev = resolve_device(device)
    pixels = output_pixel_grid(preset.height, preset.width, preset.stride, device=dev)

    def run(params: dict, batch: dict) -> dict:
        with torch.inference_mode():
            imgs = as_f32(batch["image"], dev)
            B = imgs.shape[0]
            coords, logits = scene_forward(params, imgs)
            args = (frame_generators(batch["seed"], dev), logits, coords, pixels,
                    params["f"].expand(B), params["c"])
            if "prior_rvec" in batch:
                return esac_infer_frames_prior(*args, *_priors(batch), cfg,
                                               idx=batch.get("idx"), device=dev)
            return esac_infer_frames(*args, cfg, idx=batch.get("idx"), device=dev)

    return run


def _priors(batch: dict) -> tuple:
    return batch["prior_rvec"], batch["prior_tvec"], batch["prior_valid"]


def make_routed_scene_bucket_fn(preset: ScenePreset, cfg: RansacConfig, k: int,
                                device=None):
    """Gating-first routed serving for a (preset, cfg, k) bucket (the
    module docstring): ``fn(params, batch)`` -> per-frame result dict, with
    'experts_evaluated' (B, k) (sentinel M where capacity dropped the
    pair).  Raises ``ManifestError`` for k outside 1..M, or k < M on an
    ungated preset (every frame would ride one arbitrary subset)."""
    M = preset.num_experts
    if not 1 <= k <= M:
        raise ManifestError(f"routed top-k {k} outside 1..{M}")
    if k < M and not preset.gated:
        raise ManifestError("routed serving with k < num_experts needs a gated preset: "
                            "without a gating net every frame would ride the same "
                            "arbitrary expert subset")
    cap = routed_serve_capacity(cfg, k, M)
    dev = resolve_device(device)
    pixels = output_pixel_grid(preset.height, preset.width, preset.stride, device=dev)

    def run(params: dict, batch: dict) -> dict:
        with torch.inference_mode():
            imgs = as_f32(batch["image"], dev)
            B = imgs.shape[0]
            if k == M:  # identity routing: the dense CNN schedule
                coords, logits = scene_forward(params, imgs)
                selected = torch.arange(M, device=dev).expand(B, M)
                kept = torch.ones((B, M), dtype=torch.bool, device=dev)
            else:
                logits = params["gating"](imgs)
                selected = select_topk_experts(logits, k)
                kept, pos, slot_frame, _ = route_frames_to_experts(selected, M, cap)
                # One forward per expert over its fixed block of cap frames;
                # dropped pairs gather a clamped (wrong) row: finite garbage
                # that the hypothesis loop scores -inf.
                blocks = torch.stack([net(imgs[slot_frame[m]])
                                      for m, net in enumerate(params["expert"])])
                blocks = blocks.reshape(M, cap, -1, 3) + params["centers"][:, None, None, :]
                coords = blocks[selected, pos.clamp(max=cap - 1)]
            args = (frame_generators(batch["seed"], dev), logits, coords, selected, kept,
                    pixels, params["f"].expand(B), params["c"])
            if "prior_rvec" in batch:
                return esac_infer_routed_frames_prior(*args, *_priors(batch), cfg,
                                                      idx=batch.get("idx"), device=dev)
            return esac_infer_routed_frames(*args, cfg, idx=batch.get("idx"), device=dev)

    return run
