"""Architecture presets (copy of the presets in ``esac_tpu/cli.py``): "ref"
is the reference-scale net, "test" is sized for CPU smoke runs."""

EXPERT_PRESETS = {
    "ref": dict(stem_channels=(64, 128, 256), head_channels=512, head_depth=4),
    "small": dict(stem_channels=(32, 64, 128), head_channels=256, head_depth=3),
    "test": dict(stem_channels=(16, 32, 64), head_channels=64, head_depth=2),
}
GATING_PRESETS = {
    "ref": dict(channels=(32, 64, 128, 256)),
    "small": dict(channels=(16, 32, 64)),
    "test": dict(channels=(8, 16)),
}
