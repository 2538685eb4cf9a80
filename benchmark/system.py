"""The system under test, built from a configuration file: a registry scene
whose checkpoint is written from the seed's weights, a ``SceneRegistry`` on
the card with its bucket functions warmed, and its dispatcher.  This is the
one module of the benchmark that imports the program.

The scene's ``RansacConfig`` takes every field of it that the
configuration file names, and the mix's frame buckets; so a file that
names ``serve_topk`` (and ``serve_capacity``) is served gating-first
routed, by the registry's own choice for such a scene."""

from __future__ import annotations

import dataclasses
import gc
import pathlib

import torch

from benchmark import scene


def ransac_config(cfg: dict, buckets):
    """The scene's ``RansacConfig``: every field the configuration names,
    and ``buckets`` as its frame buckets."""
    from esac_tpu_torch.ransac.config import RansacConfig

    named = {f.name: cfg[f.name] for f in dataclasses.fields(RansacConfig) if f.name in cfg}
    return RansacConfig(**dict(named, frame_buckets=tuple(buckets)))


@dataclasses.dataclass
class System:
    registry: object
    scene_id: str
    buckets: tuple
    serve_cfg: object

    def dispatcher(self, trace: bool, warm_frame: dict):
        return self.registry.dispatcher(self.serve_cfg, trace=trace, warm_frame=warm_frame)


def build(cfg: dict, mix: dict, seed: int, device, ckpt_dir: pathlib.Path) -> System:
    """Write the scene's checkpoint under ``ckpt_dir``, register it, load it
    into the registry's device cache and run every frame bucket of the mix
    once (the program's own ``prewarm_programs``)."""
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest, ScenePreset
    from esac_tpu_torch.registry.serving import SceneRegistry
    from esac_tpu_torch.utils.checkpoint import save_checkpoint

    experts, gating = scene.make_weights(cfg, seed, device)
    f, c = scene.camera_intrinsics(cfg)
    save_checkpoint(ckpt_dir / "expert", experts, {
        "stem_channels": list(cfg["stem_channels"]), "head_channels": cfg["head_channels"],
        "head_depth": cfg["head_depth"], "scene_centers": [[0.0] * 3] * cfg["num_experts"],
        "f": f, "c": list(c)})
    if gating is not None:
        save_checkpoint(ckpt_dir / "gating", gating, {"num_experts": cfg["num_experts"]})
    del experts, gating
    if torch.device(device).type == "cuda":
        # The peak the run reports is the program's, not the weight maker's.
        torch.cuda.reset_peak_memory_stats(device)
    buckets = tuple(mix["frame_buckets"])
    preset = ScenePreset(
        height=cfg["height"], width=cfg["width"], num_experts=cfg["num_experts"],
        stem_channels=tuple(cfg["stem_channels"]), head_channels=cfg["head_channels"],
        head_depth=cfg["head_depth"], gating_channels=tuple(cfg["gating_channels"]),
        compute_dtype=cfg["compute_dtype"], gated=cfg["gated"], stride=cfg["stride"])
    ransac = ransac_config(cfg, buckets)
    manifest = SceneManifest()
    scene_id = cfg["name"]
    manifest.add(SceneEntry(
        scene_id=scene_id, version=1, expert_ckpt=str(ckpt_dir / "expert"),
        gating_ckpt=str(ckpt_dir / "gating") if cfg["gated"] else None,
        preset=preset, ransac=ransac))
    registry = SceneRegistry(manifest, device=device)
    registry.prewarm_programs(scene_id, buckets)
    serve_cfg = RansacConfig(frame_buckets=buckets, **mix.get("serve", {}))
    return System(registry, scene_id, buckets, serve_cfg)


def release(system: System, device) -> None:
    """Drop the registry's device weights and every cached block."""
    system.registry.cache.clear()
    system.registry = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
