"""The served chain's graph cache (``registry.graphs.ServeGraphs``) on the
CPU, with a stand-in for a CUDA graph: "capture" runs the stage's closure
once over the cache's static buffers and a replay runs it again, writing
into the captured outputs.  A value baked into a capture (a per-call tensor
read around the static buffers) would then show as a wrong answer for the
next call, as it would on the card.

- Bit equality with the eager path, call by call, for two scenes of
  different focal length, principal point, centers and weights through one
  bucket function, at buckets 1 / 4 / 16, on dense, routed (k < M),
  prior-slot and injected-set batches and with a cell subsample; one
  capture per signature and a replay on every later call.
- The engagement counters and the ``graph.<stage>`` span entries of a
  traced dispatch, which leave the ``dispatched.<stage>`` telescoping as
  it was; the default cache runs CPU tensors eagerly; the scoring kernels'
  launch counters advance by what a capture recorded on every replay.
"""

import math
import threading

import numpy as np
import pytest
import torch

import esac_tpu_torch.registry.serving as serving_mod
from esac_tpu_torch.obs import SERVE_STAGES, StageClock, stage_scope, top_level
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac import fused_scoring
from esac_tpu_torch.ransac.fused_scoring import soft_inlier_score_select
from esac_tpu_torch.registry.graphs import ServeGraphs
from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest, ScenePreset
from esac_tpu_torch.registry.serving import (
    SceneRegistry,
    init_scene_params,
    make_routed_scene_bucket_fn,
    make_scene_bucket_fn,
    save_scene_params,
)

H = W = 32  # 16 cells a frame at stride 8
M = 3
P = 2  # prior slots
PRESET = ScenePreset(height=H, width=W, num_experts=M, stem_channels=(2, 2, 2),
                     head_channels=2, head_depth=1, gating_channels=(2,),
                     compute_dtype="float32", gated=True)
CHAIN = ("hypotheses", "scoring", "refine")
LANES = {  # lane: (scoring_impl, score_cells, routed k)
    "dense": ("fused_select", 0, None),
    "routed": ("fused_select", 0, 2),
    "prior": ("fused_select", 0, None),
    "injected": ("pallas", 0, None),
    "subsample": ("errmap", 8, None),
}


def rerun(fn, pool):
    """The stand-in for a CUDA graph's capture: (replay, outputs)."""
    outs = fn()

    def replay():
        for k, v in fn().items():
            if v is not None:
                outs[k].copy_(v)

    return replay, outs


def _scene(seed, f, c, shift):
    params = init_scene_params(PRESET, seed=seed, device="cpu")
    params["centers"] = torch.tensor([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0], [0.0, 0.1, 2.0]]) + shift
    params["f"] = torch.tensor(f)
    params["c"] = torch.tensor(c)
    return params


SCENES = (_scene(3, 30.0, (16.0, 16.0), 0.0), _scene(4, 41.5, (15.0, 17.5), 0.25))


def _batch(lane, lanes, call, cfg):
    rng = np.random.default_rng(1000 * lanes + call)
    batch = {"image": rng.uniform(0, 1, (lanes, H, W, 3)).astype(np.float32),
             "seed": np.arange(lanes, dtype=np.int64) + 100 * call}
    if lane == "prior":
        batch.update(prior_rvec=rng.normal(0, 0.1, (lanes, P, 3)).astype(np.float32),
                     prior_tvec=(rng.normal(0, 0.1, (lanes, P, 3)) + [0, 0, -2]).astype(
                         np.float32),
                     prior_valid=rng.uniform(size=(lanes, P)) < 0.7)
    if lane == "injected":
        batch["idx"] = rng.integers(0, (H // 8) * (W // 8), (lanes, M, cfg.n_hyps, 4))
    return batch


def _fns(lane, graphs):
    impl, cells, k = LANES[lane]
    cfg = RansacConfig(n_hyps=8, refine_iters=2, polish_iters=1, scoring_impl=impl,
                       score_cells=cells, frame_buckets=(1, 4, 16))
    if k is None:
        return cfg, make_scene_bucket_fn(PRESET, cfg, "cpu", graphs)
    return cfg, make_routed_scene_bucket_fn(PRESET, cfg, k, "cpu", graphs)


@pytest.mark.parametrize("bucket", [1, 4, 16])
@pytest.mark.parametrize("lane", list(LANES))
def test_replays_equal_the_eager_path_bit_for_bit(lane, bucket):
    graphs = ServeGraphs(capture=rerun)
    cfg, graphed = _fns(lane, graphs)
    _, eager = _fns(lane, None)
    lanes = max(bucket, 2)
    for call in range(4):  # eager, capture, replay, replay; the scenes alternate
        params = SCENES[call % 2]
        batch = _batch(lane, lanes, call, cfg)
        got, want = graphed(params, batch), eager(params, batch)
        assert sorted(got) == sorted(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (lane, bucket, call, key)
        captures = 1 if call >= 1 else 0
        for stage in CHAIN:
            assert graphs.captures.get(stage=stage) == captures
            assert graphs.replays.get(stage=stage) == max(0, call - 1)
    assert graphs.signatures() == 1
    assert eager.graphs.captures.total() == 0  # CPU tensors: the default cache is eager
    if lane == "prior":
        assert "prior_hit" in got
    if lane == "routed":
        assert "experts_evaluated" in got


def test_a_result_is_not_overwritten_by_the_next_replay():
    graphs = ServeGraphs(capture=rerun)
    cfg, fn = _fns("dense", graphs)
    outs = [fn(SCENES[call % 2], _batch("dense", 4, call, cfg)) for call in range(4)]
    _, eager = _fns("dense", None)
    for call, got in enumerate(outs):
        want = eager(SCENES[call % 2], _batch("dense", 4, call, cfg))
        for key in want:
            assert torch.equal(got[key], want[key]), (call, key)


def test_each_signature_captures_once():
    graphs = ServeGraphs(capture=rerun)
    cfg, fn = _fns("dense", graphs)
    prior_cfg, prior_fn = _fns("prior", None)
    for call in range(3):
        for lanes in (2, 4):
            fn(SCENES[0], _batch("dense", lanes, call, cfg))
            fn(SCENES[1], _batch("prior", lanes, call, prior_cfg))
    assert graphs.signatures() == 4  # two buckets, with and without the prior slot
    assert graphs.captures.get(stage="refine") == 4
    assert graphs.replays.get(stage="refine") == 4


@pytest.mark.parametrize("others", [0, 5])
def test_replays_advance_the_launch_counters_by_what_the_capture_recorded(others):
    """A capture leaves its stages' launches on the counters (its replay is
    the call's run); each later replay adds them again.  Launches another
    thread makes during the capture are not the capture's."""
    def capture(fn, pool):  # replays run no Python, as a CUDA graph's do
        outs = fn()
        t = threading.Thread(target=lambda: [
            fused_scoring._launched(soft_inlier_score_select) for _ in range(others)])
        t.start()
        t.join()
        return (lambda: None), outs

    def stage(x, prev):
        for _ in range(2):
            fused_scoring._launched(soft_inlier_score_select)
        return {"y": x["a"] * 2.0}

    graphs = ServeGraphs(capture=capture)
    x = {"a": torch.ones(3)}
    before = soft_inlier_score_select.launches
    for _ in range(4):
        with graphs.chain(x, ("k",)) as run:
            if run is None:
                stage(x, None)
            else:
                run("hypotheses", stage, None)
    assert soft_inlier_score_select.launches - before == 8 + others
    assert graphs.captures.get(stage="hypotheses") == 1
    assert graphs.replays.get(stage="hypotheses") == 2


def test_a_failed_capture_leaves_the_signature_eager():
    def failing(fn, pool):
        raise RuntimeError("capture failed")

    graphs = ServeGraphs(capture=failing)
    cfg, fn = _fns("dense", graphs)
    _, eager = _fns("dense", None)
    batch = _batch("dense", 2, 0, cfg)
    fn(SCENES[0], batch)
    with pytest.raises(RuntimeError, match="capture failed"):
        fn(SCENES[0], batch)
    got, want = fn(SCENES[1], batch), eager(SCENES[1], batch)
    for key in want:
        assert torch.equal(got[key], want[key])
    assert graphs.captures.total() == 0 and graphs.replays.total() == 0


def test_replayed_stages_reach_the_stage_clock():
    graphs = ServeGraphs(capture=rerun)
    cfg, fn = _fns("dense", graphs)
    got = []
    for call in range(3):
        clock = StageClock(lambda: 0.0, torch.device("cpu"))
        clock.begin()
        with stage_scope(clock):
            fn(SCENES[call % 2], _batch("dense", 2, call, cfg))
        clock.finish()
        got.append(clock.graph_stages())
        assert [k for k, _ in clock.host_stages()] == [
            f"dispatched.{s}" for s in SERVE_STAGES]  # the marks are as before
    assert got[0] == [] and got[1] == []  # eager, then the capture
    assert [k for k, _ in got[2]] == [f"graph.{s}" for s in CHAIN]
    assert all(dt >= 0.0 for _, dt in got[2])


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_graphs")
    save_scene_params(SCENES[0], PRESET, root / "expert", root / "gating")
    manifest = SceneManifest()
    cfg = RansacConfig(n_hyps=8, refine_iters=2, polish_iters=1, scoring_impl="fused_select",
                       frame_buckets=(1, 4))
    manifest.add(SceneEntry(scene_id="a", version=1, expert_ckpt=str(root / "expert"),
                            gating_ckpt=str(root / "gating"), preset=PRESET, ransac=cfg))
    return SceneRegistry(manifest, device="cpu"), cfg


def test_traced_dispatches_carry_graph_stages_and_still_telescope(registry, monkeypatch):
    reg, cfg = registry
    monkeypatch.setattr(serving_mod, "ServeGraphs",
                        lambda captures, replays: ServeGraphs(captures, replays, capture=rerun))
    reg._fns.clear()
    disp = reg.dispatcher(cfg, trace=True, start_worker=False)
    try:
        frames = [_batch("dense", 1, i, cfg) for i in range(4)]
        rows = [disp.infer_one({k: v[0] for k, v in f.items()}, scene="a") for f in frames]
        bulk = disp.infer_many([{k: v[0] for k, v in f.items()} for f in frames], scene="a")
        snap = disp.obs.snapshot()
    finally:
        disp.close()
        reg._fns.clear()
    assert len(rows) == 4 and len(bulk) == 4
    nested = {f"dispatched.{s}" for s in SERVE_STAGES}
    replayed = 0
    for t in disp._trace_store.traces():
        d = t.durations()
        assert abs(math.fsum(d[k] for k in nested) - d["dispatched"]) <= 1e-9
        assert t.residual() <= 1e-9
        graph = {k for k in d if k.startswith("graph.")}
        assert graph in (set(), {f"graph.{s}" for s in CHAIN})
        replayed += bool(graph)
        assert set(top_level(d)) == {s for s, _ in t.root.segments()}
    # one-frame dispatches: eager, capture, then replays; the bulk's 4-lane
    # dispatch is a new signature (eager)
    assert replayed == 2
    samples = {name: snap["metrics"][name]["samples"]
               for name in ("serve_graph_captures_total", "serve_graph_replays_total")}
    assert {"labels": {"stage": "refine"}, "value": 2.0} in samples["serve_graph_replays_total"]
    assert disp.obs.get("serve_graph_replays_total").get(stage="refine") == 2
    assert disp.obs.get("serve_graph_captures_total").get(stage="refine") == 1
