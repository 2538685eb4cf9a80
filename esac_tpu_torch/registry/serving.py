"""Scene serving: the port's counterpart of ``make_scene_bucket_fn``
(``esac_tpu/registry/serving.py``).

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
optionally ``idx`` (B, M, n_hyps, 4) injected correspondence sets.  The
session lanes' prior-slot batches, the registry, its caches and the
dispatcher wait for later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from esac_tpu_torch.data.synthetic import CAMERA_F, output_pixel_grid
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import esac_infer_frames
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


def make_scene_bucket_fn(preset: ScenePreset, cfg: RansacConfig, device=None):
    """The full pipeline for a (preset, cfg) bucket: ``fn(params, batch)``
    -> per-frame result dict (see the module docstring).  Runs under
    ``torch.inference_mode``; every tensor stays on ``device``."""
    dev = resolve_device(device)
    M = preset.num_experts
    pixels = output_pixel_grid(preset.height, preset.width, preset.stride, device=dev)

    def run(params: dict, batch: dict) -> dict:
        if "prior_rvec" in batch:
            raise ManifestError("prior-slot batches are not served by this slice")
        with torch.inference_mode():
            imgs = as_f32(batch["image"], dev)
            B = imgs.shape[0]
            coords = torch.stack([net(imgs) for net in params["expert"]], dim=1)
            coords = coords.reshape(B, M, -1, 3) + params["centers"][None, :, None, :]
            if params["gating"] is not None:
                logits = params["gating"](imgs)
            else:
                logits = torch.zeros((B, M), device=dev)
            return esac_infer_frames(
                frame_generators(batch["seed"], dev), logits, coords, pixels,
                params["f"].expand(B), params["c"], cfg, idx=batch.get("idx"),
                device=dev)

    return run
