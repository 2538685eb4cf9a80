"""The plain reference against the program at the ``test`` widths on the
CPU: the CNNs layer for layer, the minimal solver on exact data, the
refinement's optimum, and a whole run in float32, where the two must agree
to rounding."""

import time

import pytest
import torch

from benchmark import harness, reference, scene, spec


def _port(cfg, experts, gating):
    from esac_tpu_torch.registry.manifest import ScenePreset
    from esac_tpu_torch.registry.serving import stage_scene_params

    preset = ScenePreset(height=cfg["height"], width=cfg["width"],
                         num_experts=cfg["num_experts"],
                         stem_channels=tuple(cfg["stem_channels"]),
                         head_channels=cfg["head_channels"], head_depth=cfg["head_depth"],
                         gating_channels=tuple(cfg["gating_channels"]),
                         compute_dtype="float32", gated=cfg["gated"])
    host = {"expert": experts, "gating": gating, "centers": torch.zeros(cfg["num_experts"], 3),
            "f": torch.tensor(100.0), "c": torch.tensor([64.0, 48.0])}
    return stage_scene_params(host, preset, "cpu")


def test_cnns_match_the_program(tiny_cell):
    from esac_tpu_torch.registry.serving import scene_forward

    cfg = tiny_cell("esac7_bulk_b16", compute_dtype="float32").cfg
    experts, gating = scene.make_weights(cfg, 11, "cpu")
    images = scene.make_frames(cfg, 11, 3, "cpu")["images"]
    with torch.inference_mode():
        coords, logits = scene_forward(_port(cfg, experts, gating), images)
    torch.testing.assert_close(reference.expert_coords(cfg, experts, images), coords,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(reference.gating_logits(cfg, gating, images), logits,
                               rtol=1e-4, atol=1e-5)


def test_p3p_recovers_exact_poses():
    g = torch.Generator().manual_seed(0)
    n = 500
    R = reference.expm_so3(0.5 * torch.randn(n, 3, generator=g, dtype=torch.float64))
    t = torch.randn(n, 3, generator=g, dtype=torch.float64)
    Xc = torch.stack([4 * torch.rand(n, 4, generator=g) - 2, 3 * torch.rand(n, 4, generator=g)
                      - 1.5, 4 * torch.rand(n, 4, generator=g) + 1], -1).double()
    X = (Xc - t[:, None]) @ R
    c = torch.tensor([320.0, 240.0], dtype=torch.float64)
    x = 525.0 * Xc[..., :2] / Xc[..., 2:] + c
    Rh, th = reference.p3p_grunert(X, x, 525.0, c)
    assert reference.rotation_angle_deg(Rh, R).max() < 1e-4
    assert (th - t).norm(dim=-1).max() < 1e-6


def test_refinement_reaches_one_optimum_from_any_good_start(tiny_cell):
    cfg = tiny_cell("esac7_bulk_b16").cfg
    experts, _ = scene.make_weights(cfg, 12, "cpu")
    fr = scene.make_frames(cfg, 12, 2, "cpu")
    X = reference.expert_coords(cfg, experts, fr["images"]).double()[torch.arange(2), fr["room"]]
    pix = reference.pixel_grid(cfg, "cpu")
    f, c = scene.camera_intrinsics(cfg)
    c = torch.tensor(c, dtype=torch.float64)
    R0, t0 = fr["R"].double(), fr["t"].double()
    kick = reference.expm_so3(torch.tensor([[0.02, -0.01, 0.015]] * 2, dtype=torch.float64))
    Ra, ta = reference.refine(R0, t0, X, pix, f, c, 10.0, 0.5, 30)
    Rb, tb = reference.refine(kick @ R0, t0 + 0.03, X, pix, f, c, 10.0, 0.5, 30)
    assert reference.rotation_angle_deg(Ra, Rb).max() < 1e-3
    assert (ta - tb).norm(dim=-1).max() < 1e-5


@pytest.mark.parametrize("workload", ["esac7_bulk_b16", "esac7_open_single"])
def test_a_float32_run_agrees_with_the_reference(tiny_cell, workload):
    """The program with float32 CNNs through the whole run (dispatcher,
    registry, bucket function) against the reference: far inside every
    limit.  The winning score may come from another of the near-tied best
    hypotheses (float32 P3P against float64), so it agrees to 2%; the
    refined poses, which converge to one optimum, to a tenth of a degree
    and a centimetre."""
    wl = tiny_cell(workload, compute_dtype="float32")
    res = harness.run_cell(wl, 2 ** 31 + 77, 1.0, False, "cpu", time.perf_counter())
    got = {k: v["value"] for k, v in res["compared"].items()}
    assert res["correct"], got
    assert got["score_gap"] < 0.02 and got["expert_gap"] == 0.0
    assert got["rot_gap_deg"] < 0.1 and got["trans_gap_cm"] < 1.0
    assert res["attempted"] > 0 and res["failed"] == 0
