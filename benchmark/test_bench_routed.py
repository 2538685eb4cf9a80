"""Gating-first routed configurations: a configuration file that names
``serve_topk`` is served routed by the registry, the scene's gating
routes by room, and the reference and the counts follow the routing;
while what the accepted cells read stays as it was."""

import hashlib
import json
import time

import pytest
import torch

from benchmark import compare, control, counts, harness, reference, scene, spec, system

# Digests of the accepted cells' weights, frames and reference answers at
# the ``conftest.tiny`` size, taken on the tree before routed
# configurations existed: (compute dtype, seed) -> (experts, gating, frames).
FROZEN = {
    ("bfloat16", 7): ("a3a36a0876178478", "18626a48667fcf7d", "18a92bbdc25d70e7"),
    ("bfloat16", 2 ** 31 + 77): ("43323e1851e0245a", "09db9133ea9a02a2", "f193f38407f8a97a"),
    ("float32", 7): ("4206488d622ffe77", "338d9eee91723b8e", "c6f83ad02a334361"),
    ("float32", 2 ** 31 + 77): ("b08db89b69d05389", "dc24107af6c51a10", "ca8c8af3cb6ac2b0"),
}
FROZEN_REFERENCE = "79e33a816f3d945e"


def digest(tree: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k].detach().contiguous().cpu()
        h.update(f"{k}{tuple(v.shape)}{v.dtype}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()[:16]


def routed(wl, k: int):
    """``wl`` with its configuration served top-``k`` over a scene whose
    gating routes by room."""
    wl.cfg = dict(wl.cfg, serve_topk=k, scene=dict(wl.cfg["scene"], gating="rooms"))
    return wl


def rooms_cfg(num_experts: int, **over) -> dict:
    """``esac7_vga`` at 96 x 128 (or as ``over`` says) with ``num_experts``
    rooms (extents made here, no two alike) whose gating routes by room."""
    cfg = dict(spec.load("esac7_open_single").cfg, height=96, width=128)
    cfg.update(over)
    ext = [[2.0 + 0.61 * i, 2.4 + 0.53 * ((5 * i) % num_experts), 2.5 + 0.13 * i]
           for i in range(num_experts)]
    cfg.update(num_experts=num_experts, scene=dict(cfg["scene"], room_extents_m=ext,
                                                   gating="rooms"))
    return cfg


@pytest.mark.parametrize("dtype, seed", sorted(FROZEN))
def test_the_accepted_cells_read_what_they_read(tiny_cell, dtype, seed):
    cfg = tiny_cell("esac7_bulk_b16", compute_dtype=dtype).cfg
    experts, gating = scene.make_weights(cfg, seed, "cpu")
    frames = scene.make_frames(cfg, seed, 4, "cpu")
    assert (digest(experts), digest(gating), digest(frames)) == FROZEN[(dtype, seed)]


def test_the_accepted_cells_reference_answers_what_it_answered(tiny_cell):
    cfg = tiny_cell("esac7_bulk_b16").cfg
    experts, gating = scene.make_weights(cfg, 2 ** 31 + 77, "cpu")
    images = scene.make_frames(cfg, 2 ** 31 + 77, 3, "cpu")["images"]
    with torch.no_grad():
        ans = reference.serve_frames(cfg, experts, gating, images, [5, 2 ** 40 + 3, 99])
    assert digest(ans) == FROZEN_REFERENCE


def test_the_accepted_configuration_is_served_as_before():
    from esac_tpu_torch.ransac.config import RansacConfig

    cfg = spec.load("esac7_open_single").cfg
    assert system.ransac_config(cfg, [1, 4, 16]) == RansacConfig(
        n_hyps=256, tau=10.0, beta=0.5, refine_iters=8, polish_iters=3,
        scoring_impl="fused_select", frame_buckets=(1, 4, 16))
    assert counts.served_experts(cfg) == 7 and counts.hyps_per_expert(cfg) == 256


def test_a_configuration_that_names_serve_topk_is_served_routed(tiny_cell):
    wl = routed(tiny_cell("esac7_bulk_b16"), 2)
    rc = system.ransac_config(dict(wl.cfg, serve_capacity=5), [4])
    assert (rc.serve_topk, rc.serve_capacity, rc.frame_buckets) == (2, 5, (4,))
    assert counts.served_experts(wl.cfg) == 2
    assert counts.hyps_per_expert(wl.cfg) == 32 * 3 // 2


@pytest.mark.parametrize("workload", ["esac7_bulk_b16", "esac7_open_single"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_routed_run_agrees_with_the_routed_reference(tiny_cell, workload, dtype):
    """Top 2 of 3 through the whole run (``system.build``, the registry's
    routed bucket function, the dispatcher) against the routed reference,
    within ``esac7_vga``'s limits, every served expert the reference's."""
    wl = routed(tiny_cell(workload, compute_dtype=dtype), 2)
    res = harness.run_cell(wl, 2 ** 31 + 78, 1.0, False, "cpu", time.perf_counter())
    got = {k: v["value"] for k, v in res["compared"].items()}
    assert res["correct"], got
    assert got["expert_gap"] == 0.0
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("shift", [1, 2])
def test_a_routed_run_that_serves_another_expert_is_not_correct(tiny_cell, shift):
    """Top 2 of 3: each frame's room r and r + 1 serve it.  A winner
    claimed for r + 1 (selected, wrong room) costs its deficit; one
    claimed for r + 2, which routing left out, reads as far off as a
    float can be (its reference best is -inf)."""
    wl = routed(tiny_cell("esac7_bulk_b16", compute_dtype="float32"), 2)
    res = harness.run_cell(wl, 31, 1.0, False, "cpu", time.perf_counter(),
                           fault=lambda out: dict(out, expert=(out["expert"] + shift) % 3))
    gap = res["compared"]["expert_gap"]["value"]
    assert not res["correct"] and gap > wl.cfg["limits"]["expert_gap"]
    assert (gap > 1e300) is (shift == 2)


def test_at_k_equal_m_the_routed_reference_and_counts_are_the_dense_ones(tiny_cell):
    cfg = tiny_cell("esac7_bulk_b16").cfg
    experts, gating = scene.make_weights(cfg, 5, "cpu")
    images = scene.make_frames(cfg, 5, 3, "cpu")["images"]
    with torch.no_grad():
        dense = reference.serve_frames(cfg, experts, gating, images, [1, 2, 2 ** 40])
        full = reference.serve_frames(dict(cfg, serve_topk=3), experts, gating, images,
                                      [1, 2, 2 ** 40])
    assert dense.keys() == full.keys()
    assert all(torch.equal(dense[k], full[k]) for k in dense)
    big = spec.load("esac7_bulk_b16").cfg
    at_m = dict(big, serve_topk=big["num_experts"])
    for fn in (counts.cnn_flops_per_frame, counts.score_pairs_per_frame):
        assert fn(at_m) == fn(big)
    assert counts.score_bytes(at_m, 16) == counts.score_bytes(big, 16)


def test_routed_counts_are_the_selected_pairs():
    big = spec.load("esac7_bulk_b16").cfg
    k2 = dict(big, serve_topk=2)
    expert = counts.expert_flops(480, 640, (64, 128, 256), 512, 4)
    gating = counts.gating_flops(480, 640, (32, 64, 128, 256), 7)
    assert counts.cnn_flops_per_frame(k2) == pytest.approx(2 * expert + gating)
    assert counts.score_pairs_per_frame(k2) == 2 * (256 * 7 // 2) * 4800
    n = 4800
    assert counts.score_bytes(k2, 16) == (32 * 896 * 48 + 32 * n * 12 + n * 8 + 32 * 4 + 8
                                          + 32 * 8)


def test_the_routed_reference_scores_only_the_selected_experts(tiny_cell):
    """Each frame's own room and the next one serve it; the other expert's
    best reads -inf, and the winner is the frame's own room."""
    wl = routed(tiny_cell("esac7_bulk_b16", compute_dtype="float32"), 2)
    cfg = wl.cfg
    experts, gating = scene.make_weights(cfg, 9, "cpu")
    fr = scene.make_frames(cfg, 9, 6, "cpu")
    with torch.no_grad():
        ans = reference.serve_frames(cfg, experts, gating, fr["images"], range(6))
    rows = torch.arange(6)
    assert torch.equal(ans["expert"], fr["room"])
    unselected = (fr["room"] + 2) % 3
    assert torch.isinf(ans["best"][rows, unselected]).all()
    assert torch.isfinite(ans["best"][rows, fr["room"]]).all()
    assert torch.equal(ans["best"].amax(-1), ans["score"])


@pytest.mark.parametrize("num_experts, k", [(12, 2), (7, 2), (3, 2)])
def test_the_routing_gating_picks_the_frames_room(num_experts, k):
    """On a 64-frame pool, with the reference's float32 gating: the frame's
    room is the top choice on at least 95% of frames and within the top k
    on at least 99% (by construction, on every frame)."""
    cfg = rooms_cfg(num_experts)
    _, gating = scene.make_weights(cfg, 21, "cpu")
    fr = scene.make_frames(cfg, 21, 64, "cpu")
    logits = reference.gating_logits(cfg, gating, fr["images"])
    top = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    top1 = (top[:, 0] == fr["room"]).float().mean()
    topk = (top[:, :k] == fr["room"][:, None]).any(-1).float().mean()
    assert top1 >= 0.95 and topk >= 0.99
    assert set(fr["room"].tolist()) == set(range(num_experts))


def test_the_programs_bfloat16_gating_keeps_the_reference_top_k():
    """The program's gating (bfloat16 convolutions) on the same frames:
    each frame's logits are the reference's times one factor (the pool's
    rounding; within 2 ** -7 of 1), so the top 2 of 12 are the same and
    consecutive choices stay ``ROUTING_MARGIN`` logits apart to rounding."""
    from esac_tpu_torch.models.gating import GatingNet

    cfg = rooms_cfg(12)
    _, gating = scene.make_weights(cfg, 22, "cpu")
    images = scene.make_frames(cfg, 22, 64, "cpu")["images"]
    net = GatingNet(12, cfg["gating_channels"], compute_dtype=torch.bfloat16)
    net.load_state_dict(gating)
    with torch.inference_mode():
        got = net(images)
    ref = reference.gating_logits(cfg, gating, images)
    assert torch.equal(reference.top_experts(got, 2), reference.top_experts(ref, 2))
    factor = got.amax(-1, keepdim=True) / ref.amax(-1, keepdim=True)
    assert ((factor - 1).abs() <= 2 ** -7).all()
    torch.testing.assert_close(got, factor * ref, rtol=0, atol=1e-5)
    ranked = torch.sort(got, -1, descending=True).values
    assert (ranked[:, :-1] - ranked[:, 1:]).amin() >= scene.ROUTING_MARGIN * (1 - 2 ** -7)


def test_the_routing_gating_needs_room_in_its_first_stage():
    with pytest.raises(ValueError, match="channels"):
        scene.make_weights(rooms_cfg(12, gating_channels=[8, 16]), 1, "cpu")


@pytest.mark.card
def test_on_the_card_a_routed_variant_is_correct(card):
    """``esac7_vga`` served top 2 of 7 over a scene that routes by room, at
    its widths and 640 x 480 under the ``open_single`` mix, traced: the
    run is correct on the cell's sample of 48 frames, and the control
    (the experts' head 3 x 3 convolutions in float8 in the program's
    place) is not.  Prints the compared numbers, the frames a dispatch and
    the stage times."""
    wl = routed(spec.load("esac7_open_single"), 2)
    res = harness.run_cell(wl, 19_000_001, 10.0, True, card, time.perf_counter())
    print(json.dumps({"routed_variant": {
        "correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
        "compared": res["compared"], "metrics": res["metrics"], "device": res["device"]}}))
    assert res["correct"], res["compared"]
    assert res["failed"] == 0
    nums = control.control_numbers(wl, 19_000_002, card, "head3_fp8")
    print(json.dumps({"routed_variant_control_head3_fp8": nums}))
    assert not compare.judge(nums, wl.cfg["limits"])[0], nums
