"""Scene presets (the ``ScenePreset`` subset of ``esac_tpu/registry/manifest.py``;
the versioned manifest itself waits for the registry slice)."""

from __future__ import annotations

import dataclasses


class ManifestError(ValueError):
    """A preset (or, later, a manifest entry) failed validation."""

    retryable = False
    wire_name = "manifest"


@dataclasses.dataclass(frozen=True)
class ScenePreset:
    """Shape/architecture signature of a scene: image size, expert count,
    net widths, compute dtype and gating presence.  Scenes with equal
    presets share one bucket function; their weights differ only as
    arguments."""

    height: int
    width: int
    num_experts: int
    stem_channels: tuple[int, ...] = (64, 128, 256)
    head_channels: int = 512
    head_depth: int = 4
    gating_channels: tuple[int, ...] = (32, 64, 128, 256)
    compute_dtype: str = "bfloat16"  # "bfloat16" | "float32"
    gated: bool = True
    # Fixed by the ExpertNet architecture (three stride-2 stages).
    stride: int = 8

    def __post_init__(self):
        if self.height % self.stride or self.width % self.stride:
            raise ManifestError(
                f"preset {self.height}x{self.width} not divisible by "
                f"stride {self.stride}"
            )
        if self.num_experts < 1:
            raise ManifestError(f"num_experts {self.num_experts} < 1")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ManifestError(f"unknown compute_dtype {self.compute_dtype!r}")
        object.__setattr__(self, "stem_channels", tuple(self.stem_channels))
        object.__setattr__(self, "gating_channels", tuple(self.gating_channels))

    @property
    def n_cells(self) -> int:
        return (self.height // self.stride) * (self.width // self.stride)
