"""``esac12_routed_k2``: ESAC on 12-Scenes served gating-first top 2, and
its open-loop cell: the configuration keeps ``esac7_vga``'s widths, a
12-room run at the tiny size agrees with the routed reference through the
registry's routed path, the gating routes every frame to its own room,
and the five readers of the routing read what the spans and the profile
hold."""

import math
import time

import pytest
import torch

from benchmark import counts, harness, reference, scene, spec, system
from benchmark.conftest import tiny

CELL = "esac12_routed_k2_open"
SHARED = ("height", "width", "stride", "gated", "stem_channels", "head_channels", "head_depth",
          "gating_channels", "compute_dtype", "tau", "beta", "polish_iters", "refine_iters",
          "scoring_impl", "limits")


def twelve_rooms(dtype: str):
    """The cell at ``conftest.tiny``'s size with all 12 rooms kept, and a
    gating wide enough to route 12 rooms (14 channels in its first stage)."""
    wl = tiny(CELL, compute_dtype=dtype)
    wl.cfg = dict(wl.cfg, num_experts=12, gating_channels=[16, 16])
    return wl


def test_the_configuration_keeps_esac7_vgas_widths():
    wl = spec.load(CELL)
    dense = spec.load("esac7_open_single")
    cfg = wl.cfg
    assert {k: cfg[k] for k in SHARED} == {k: dense.cfg[k] for k in SHARED}
    assert cfg["scene"]["weight_noise"] == dense.cfg["scene"]["weight_noise"]
    assert (cfg["num_experts"], cfg["serve_topk"], cfg["serve_capacity"]) == (12, 2, 8)
    assert len(cfg["scene"]["room_extents_m"]) == 12 and scene.routes_by_room(cfg)
    assert all(2.0 <= side <= 10.0 for room in cfg["scene"]["room_extents_m"] for side in room)
    assert wl.mix == dense.mix and wl.chips == 1
    assert set(wl.cell) == set(dense.cell)
    assert [m["name"] for m in wl.end_to_end] == ["setup_s", "latency_p95_ms"]
    rc = system.ransac_config(cfg, wl.mix["frame_buckets"])
    assert (rc.serve_topk, rc.serve_capacity, rc.n_hyps) == (2, 8, 86)
    # 516 hypotheses a served expert, 1032 a frame; 12 blocks of 8 frames.
    assert counts.hyps_per_expert(cfg) == 516
    assert counts.score_pairs_per_frame(cfg) == 2 * 516 * 4800
    from esac_tpu_torch.ransac.esac import routed_serve_capacity

    assert 12 * routed_serve_capacity(rc, 2, 12) == 96


def test_the_cell_reports_the_routing_readers():
    names = {m["name"] for m in spec.load(CELL).per_layer}
    assert {"route_host_ms.open", "route_gpu_ms.open", "slot_fill.open",
            "route_drop_share.open", "cnn_roofline.open"} <= names
    assert {"queue_ms.open", "frames_per_dispatch.open", "host_issue_ms.open",
            "cnn_gpu_ms.open", "device_idle_share.open", "graph_replay_share.open",
            "lanes_per_frame.open", "latency_p50_ms.open"} <= names


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_twelve_room_run_agrees_with_the_routed_reference(dtype):
    """Top 2 of 12 through ``system.build``, the registry's routed bucket
    function and the dispatcher, against the routed reference within the
    configuration's limits; every served expert is the reference's."""
    wl = twelve_rooms(dtype)
    res = harness.run_cell(wl, 2 ** 31 + 2012, 1.0, False, "cpu", time.perf_counter())
    got = {k: v["value"] for k, v in res["compared"].items()}
    assert res["correct"], got
    assert got["expert_gap"] == 0.0
    assert res["attempted"] > 0 and res["failed"] == 0


def test_the_gating_keeps_each_frames_room_in_its_top_two():
    """The configuration's 12 rooms and gating widths (at 96 x 128): on a
    64-frame pool the room is in the top 2 of the reference's float32
    gating and of the program's bfloat16 one, on every frame."""
    from esac_tpu_torch.models.gating import GatingNet

    cfg = dict(spec.load(CELL).cfg, height=96, width=128)
    _, gating = scene.make_weights(cfg, 2 ** 31 + 12, "cpu")
    fr = scene.make_frames(cfg, 2 ** 31 + 12, 64, "cpu")
    assert set(fr["room"].tolist()) == set(range(12))
    net = GatingNet(12, cfg["gating_channels"], compute_dtype=torch.bfloat16)
    net.load_state_dict(gating)
    with torch.inference_mode():
        served = net(fr["images"])
    for logits in (reference.gating_logits(cfg, gating, fr["images"]), served):
        top = reference.top_experts(logits, 2)
        assert (top == fr["room"][:, None]).any(-1).all()


def _run(spans=(), profile=None, cfg=None):
    return {"cfg": cfg or spec.load(CELL).cfg, "cell": {}, "mix": {},
            "window": {"spans": list(spans), "served_frames": 0, "dispatches": 0,
                       "window_s": 0.0},
            "profile": profile, "peaks": counts.PEAKS[counts.H100_SXM]}


def _dispatch(frames, pairs, dropped, slots=96, route=0.002, gpu=0.003):
    """The spans of one dispatch's ``frames`` single-frame requests."""
    return [{"dispatched.route": route, "gpu.route": gpu, "route.pairs": pairs,
             "route.dropped": dropped, "route.slots": slots}] * frames


def read(metric, run):
    return spec.reader(metric)(run)


def test_the_routing_readers_count_each_dispatch_once():
    # Three dispatches: 5 frames (10 pairs), 1 frame (2), 3 frames with 1 drop.
    spans = _dispatch(5, 10, 0) + _dispatch(1, 2, 0, route=0.004) + _dispatch(3, 5, 1)
    run = _run(spans + [{"dispatched": 0.05}])  # a request with no routing counts
    assert read("slot_fill.open", run) == pytest.approx(100.0 * 17 / (3 * 96))
    assert read("route_drop_share.open", run) == pytest.approx(100.0 * 1 / 18)
    assert read("route_host_ms.open", run) == pytest.approx(1e3 * (8 * 0.002 + 0.004) / 9)
    assert read("route_gpu_ms.open", run) == pytest.approx(3.0)
    assert read("route_drop_share.open", _run(_dispatch(4, 8, 0))) == 0.0


@pytest.mark.parametrize("metric", ["route_host_ms.open", "route_gpu_ms.open",
                                    "slot_fill.open", "route_drop_share.open"])
def test_the_routing_readers_find_nothing_in_a_dense_window(metric):
    dense = [{"dispatched": 0.05, "dispatched.cnn": 0.02, "gpu.cnn": 0.03}] * 4
    assert read(metric, _run(dense)) is None
    assert read(metric, _run()) is None


def _profile(frames, conv_s, other_s=0.01):
    kernels = [("sm90_xmma_fprop_implicit_gemm_bf16", 0.0, 1e6 * conv_s, "conv"),
               ("void at::native::elementwise_kernel", 0.0, 1e6 * other_s, "eager")]
    return {"kernels": kernels, "busy_s": conv_s + other_s, "window_s": 2.0,
            "frames": frames, "conv_frames": None, "score_frames": None}


def test_the_open_cnn_roofline_reads_the_frames_asked_for():
    cfg = spec.load(CELL).cfg
    per = counts.cnn_flops_per_frame(cfg)
    assert per == pytest.approx(2 * counts.expert_flops(480, 640, (64, 128, 256), 512, 4)
                                + counts.gating_flops(480, 640, (32, 64, 128, 256), 12))
    peak = counts.PEAKS[counts.H100_SXM]["bf16_flops"]
    exact = read("cnn_roofline.open", _run(profile=_profile(10, 10 * per / peak)))
    assert exact == pytest.approx(100.0) and exact <= 100.0 + 1e-9
    padded = read("cnn_roofline.open", _run(profile=_profile(10, 96 / 20 * 10 * per / peak)))
    assert padded == pytest.approx(100.0 * 20 / 96)
    assert read("cnn_roofline.open", _run()) is None
    assert read("cnn_roofline.open", _run(profile=_profile(0, 0.5))) is None
    assert read("cnn_roofline.open", _run(profile=_profile(10, 0.0))) is None
    assert math.isfinite(padded)
