"""Pytest settings of the benchmark's own tests (``python -m pytest
benchmark``): the ``card`` marker, and the fixture that decides, when a
test runs, whether a CUDA card is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with python -m pytest benchmark -m card")
    return torch.device("cuda", 0)


def tiny(name: str, **cfg_over):
    """A cell at a size the CPU holds: the ``test`` widths (3 experts where
    the configuration has more), 192 x 256 images, 32 hypotheses, a short
    window and a small sample."""
    from benchmark import spec

    wl = spec.load(name)
    cfg = dict(wl.cfg, height=192, width=256, stem_channels=[16, 32, 64], head_channels=64,
               head_depth=2, gating_channels=[8, 16], n_hyps=32)
    cfg.update(cfg_over)
    cfg["num_experts"] = min(cfg["num_experts"], 3)
    wl.cfg = cfg
    wl.mix = dict(wl.mix, image_pool=8, warm_bursts=[4, 1], warm_calls=1,
                  frames_per_call=min(wl.mix.get("frames_per_call", 8), 8),
                  frame_buckets=[b for b in wl.mix["frame_buckets"] if b <= 8] or [8])
    wl.cell = dict(wl.cell, rate_per_s=20.0, correct_sample=8, reference_block=4)
    return wl


@pytest.fixture
def tiny_cell():
    return tiny
