"""The route stage and routing counts of a traced gating-first routed
dispatch (``obs.trace.serve_routing``, ``StageClock.route_stages``), on
the CPU through ``SceneRegistry.dispatcher`` at a tiny 3-room preset, top
2, buckets 1 / 4 / 16: ``dispatched.route`` and ``gpu.route`` nest inside
``dispatched`` and telescope with the other stages; ``route.pairs``,
``route.dropped`` and ``route.slots`` equal what
``route_frames_to_experts`` gives for the dispatch's real frames, also at
an overflowing capacity; dense and k = M dispatches keep their seven
stages; an untraced routed dispatch counts nothing."""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import esac_tpu_torch.serve.dispatcher as dispatcher_mod
from esac_tpu_torch.obs import (
    ROUTE_COUNTS,
    SERVE_STAGES,
    StageClock,
    is_count,
    route_counts,
    top_level,
)
from esac_tpu_torch.obs import trace as trace_mod
from esac_tpu_torch.parallel.esac_sharded import route_frames_to_experts
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.esac import routed_serve_capacity, select_topk_experts
from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest, ScenePreset
from esac_tpu_torch.registry.serving import (
    ROUTE_TOTAL,
    SceneRegistry,
    init_scene_params,
    save_scene_params,
)

WAIT_S = 60.0
H = W = 16
M, K = 3, 2
PRESET = ScenePreset(height=H, width=W, num_experts=M, stem_channels=(2, 2, 2),
                     head_channels=2, head_depth=1, gating_channels=(2,),
                     compute_dtype="float32", gated=True)
CFG = RansacConfig(n_hyps=8, refine_iters=2, polish_iters=1, frame_buckets=(1, 4, 16))
TOP = {"coalesced", "staged", "dispatched", "device", "sliced", "served"}
DENSE = [f"dispatched.{s}" for s in SERVE_STAGES]
ROUTED = ["dispatched.resolve", "dispatched.route"] + DENSE[1:]
COUNTS = {f"route.{c}" for c in ROUTE_COUNTS}


def _registry(root, cfg):
    params = init_scene_params(PRESET, seed=3, device="cpu")
    params["centers"] = torch.tensor([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0], [0.0, 0.1, 2.0]])
    save_scene_params(params, PRESET, root / "expert", root / "gating")
    manifest = SceneManifest()
    manifest.add(SceneEntry(scene_id="a", version=1, expert_ckpt=str(root / "expert"),
                            gating_ckpt=str(root / "gating"), preset=PRESET, ransac=cfg))
    reg = SceneRegistry(manifest, device="cpu")
    reg.prewarm_programs("a", cfg.frame_buckets, route_ks=(None, K, M))
    return reg


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return _registry(tmp_path_factory.mktemp("route_obs"), CFG)


@pytest.fixture(scope="module")
def tight(tmp_path_factory):
    """Capacity 2 a block: 6 slots for a dispatch's 2 pairs a frame."""
    return _registry(tmp_path_factory.mktemp("route_obs_tight"),
                     dataclasses.replace(CFG, serve_capacity=2))


def _frame(i):
    rng = np.random.default_rng(300 + i)
    return {"image": rng.uniform(0, 1, (H, W, 3)).astype(np.float32), "seed": np.int64(i)}


def _one_dispatch(reg, frames, route_k, trace=True):
    """``frames`` queued before the worker starts, so they ride one
    dispatch; returns the requests and the dispatcher's obs registry."""
    disp = reg.dispatcher(CFG, trace=trace, start_worker=False)
    try:
        reqs = [disp.submit(f, scene="a", route_k=route_k) for f in frames]
        disp.start()
        for r in reqs:
            r.get(WAIT_S)
        assert sum(disp.dispatch_totals().values()) == 1
    finally:
        disp.close()
    return reqs, disp.obs


def _expected(reg, frames):
    """What ``route_frames_to_experts`` keeps of the real frames' top-K
    pairs (padding lanes come after them and cannot displace one)."""
    entry = reg.manifest.resolve("a")
    params = reg.cache.get(entry)
    imgs = torch.as_tensor(np.stack([f["image"] for f in frames]))
    with torch.inference_mode():
        selected = select_topk_experts(params["gating"](imgs), K)
    cap = routed_serve_capacity(entry.ransac, K, M)
    kept = route_frames_to_experts(selected, M, cap)[0]
    pairs = int(kept.sum())
    return {"route.pairs": pairs, "route.dropped": K * len(frames) - pairs,
            "route.slots": M * cap}


class _Event:
    """A stand-in timing event: records a tick of a shared counter."""

    ticks = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _Event.ticks += 1
        self.t = _Event.ticks

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    """Stage clocks that record stand-in CUDA events, so the CPU run
    carries ``gpu.<stage>`` entries as a card's does."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)

    def clock(tick, device):
        c = StageClock(tick, device)
        c._device = types.SimpleNamespace(type="cuda")
        return c

    monkeypatch.setattr(dispatcher_mod, "StageClock", clock)


def test_a_traced_routed_dispatch_nests_its_route_stage(registry, fake_card):
    frames = [_frame(i) for i in range(3)]
    reqs, _ = _one_dispatch(registry, frames, K)
    for r in reqs:
        d = r.spans.durations()
        assert set(top_level(d)) == TOP
        nested = [k for k in d if k.startswith("dispatched.")]
        assert nested == ROUTED
        assert [k for k in d if k.startswith("gpu.")] == ["gpu." + k[11:] for k in ROUTED]
        assert all(d[k] >= 0.0 for k in nested)
        assert abs(math.fsum(d[k] for k in nested) - d["dispatched"]) <= 1e-9
        assert r.spans.residual() <= 1e-9
        assert COUNTS <= set(d)


@pytest.mark.parametrize("n", [1, 3, 9])
def test_the_counts_are_the_routing_of_the_real_frames(registry, n):
    """1, 3 and 9 frames ride buckets 1, 4 and 16 (3 and 7 padding lanes):
    every traced request carries its dispatch's counts, and the
    registry's counter holds them once."""
    frames = [_frame(10 + i) for i in range(n)]
    before = {c: registry.obs.get(ROUTE_TOTAL).get(count=c) for c in ROUTE_COUNTS}
    reqs, obs = _one_dispatch(registry, frames, K)
    want = _expected(registry, frames)
    assert want["route.slots"] == M * routed_serve_capacity(CFG, K, M)
    for r in reqs:
        d = r.spans.durations()
        assert {k: d[k] for k in COUNTS} == want
        evaluated = np.asarray(r.result["experts_evaluated"])
        assert evaluated.shape == (K,)
    host = np.stack([r.result["experts_evaluated"] for r in reqs])
    assert route_counts(host, M, want["route.slots"]) == {
        k[len("route."):]: v for k, v in want.items()}
    counter = obs.get(ROUTE_TOTAL)
    assert counter is registry.obs.get(ROUTE_TOTAL)  # bind_obs shares it
    for c in ROUTE_COUNTS:
        assert counter.get(count=c) - before[c] == want[f"route.{c}"]


def test_an_overflowing_dispatch_counts_its_drops(tight):
    frames = [_frame(40 + i) for i in range(9)]
    reqs, _ = _one_dispatch(tight, frames, K)
    want = _expected(tight, frames)
    assert want["route.slots"] == 6 and want["route.dropped"] >= 2 * 9 - 6
    for r in reqs:
        d = r.spans.durations()
        assert {k: d[k] for k in COUNTS} == want
    host = np.stack([r.result["experts_evaluated"] for r in reqs])
    assert int((host == M).sum()) == want["route.dropped"]


def test_counts_stay_out_of_the_stage_histogram(registry):
    reqs, obs = _one_dispatch(registry, [_frame(i) for i in range(2)], K)
    hist = obs.get("serve_stage_seconds")
    assert hist.count(stage="dispatched.route") == 2
    assert all(hist.count(stage=k) == 0 for k in COUNTS)
    assert not is_count("dispatched.route") and all(is_count(k) for k in COUNTS)


def test_a_traced_bulk_routed_dispatch_carries_the_counts(registry):
    frames = [_frame(60 + i) for i in range(3)]
    disp = registry.dispatcher(CFG, trace=True, start_worker=False)
    try:
        disp.infer_many(frames, scene="a", route_k=K)
    finally:
        disp.close()
    (t,) = disp._trace_store.traces()
    d = t.durations()
    assert [k for k in d if k.startswith("dispatched.")] == ROUTED
    assert {k: d[k] for k in COUNTS} == _expected(registry, frames)


@pytest.mark.parametrize("route_k", [None, M], ids=["dense", "k_equal_m"])
def test_dense_and_k_equal_m_dispatches_keep_seven_stages(registry, fake_card, route_k):
    reqs, obs = _one_dispatch(registry, [_frame(i) for i in range(3)], route_k)
    for r in reqs:
        d = r.spans.durations()
        assert [k for k in d if k.startswith("dispatched.")] == DENSE
        assert [k for k in d if k.startswith("gpu.")] == ["gpu." + s for s in SERVE_STAGES]
        assert not any(k.startswith("route") or k.endswith(".route") for k in d)
    assert obs.get(ROUTE_TOTAL).total() == registry.obs.get(ROUTE_TOTAL).total()


def test_an_untraced_routed_dispatch_counts_nothing(registry, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("routing counted on an untraced dispatch")

    monkeypatch.setattr(trace_mod, "route_counts", refuse)
    monkeypatch.setattr(StageClock, "routing", refuse)
    monkeypatch.setattr(StageClock, "route_stages", refuse)
    monkeypatch.setattr(StageClock, "routed", refuse)
    before = registry.obs.get(ROUTE_TOTAL).total()
    frames = [_frame(i) for i in range(5)]
    reqs, _ = _one_dispatch(registry, frames, K, trace=False)
    disp = registry.dispatcher(CFG, start_worker=False)
    try:
        out = disp.infer_many(frames, scene="a", route_k=K)
    finally:
        disp.close()
    assert all(r.spans is None and r.result is not None for r in reqs)
    assert len(out) == 5
    assert registry.obs.get(ROUTE_TOTAL).total() == before


def test_the_route_range_names_the_routing_on_the_host(registry):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    disp = registry.dispatcher(CFG, trace=True, start_worker=False)
    try:
        cfg = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
            disp.infer_one(_frame(0), scene="a", route_k=K)
            disp.infer_one(_frame(1), scene="a")
    finally:
        disp.close()
    ranges = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name.startswith("esac.") and e.name != "esac.staging"
                    and e.name != "esac.to_host"
                    and e.time_range.end > e.time_range.start)
    names = [n for _, n in ranges]
    routed, dense = names[:names.index("esac.outputs") + 1], \
        names[names.index("esac.outputs") + 1:]
    assert routed == ["esac.resolve", "esac.route", "esac.cnn", "esac.sampling",
                      "esac.hypotheses", "esac.scoring", "esac.refine", "esac.outputs"]
    assert dense == ["esac." + s for s in SERVE_STAGES]
