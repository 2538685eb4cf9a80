"""Stage spans inside the served dispatch (``obs.trace.StageClock``,
``serve_stage``), on the CPU through ``SceneRegistry.dispatcher`` at a tiny
preset: the bucket call's nested stages on traced requests and bulk
dispatches, their telescoping to ``dispatched``, the unchanged top-level
chain, results bit-identical with tracing on and off (dense, routed and
prior lanes), nothing written untraced, the Prometheus labels and the
host-only profiler ranges."""

import math
import threading

import numpy as np
import pytest
import torch

import esac_tpu_torch.serve.dispatcher as dispatcher_mod
from esac_tpu_torch.obs import (
    SERVE_STAGES,
    SpanChain,
    StageClock,
    Trace,
    is_count,
    render_prometheus,
    render_traces,
    serve_stage,
    stage_scope,
    top_level,
)
from esac_tpu_torch.obs import trace as trace_mod
from esac_tpu_torch.obs.trace import CONV_COUNTS
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest, ScenePreset
from esac_tpu_torch.registry.serving import (
    SceneRegistry,
    init_scene_params,
    save_scene_params,
)
from esac_tpu_torch.serve.batching import plan_dispatches

WAIT_S = 60.0
H = W = 16
M = 3
PRESET = ScenePreset(height=H, width=W, num_experts=M, stem_channels=(2, 2, 2),
                     head_channels=2, head_depth=1, gating_channels=(2,),
                     compute_dtype="float32", gated=True)
CFG = RansacConfig(n_hyps=8, refine_iters=2, polish_iters=1, frame_buckets=(1, 4))
TOP = {"coalesced", "staged", "dispatched", "device", "sliced", "served"}
NESTED = {f"dispatched.{s}" for s in SERVE_STAGES}
COMPUTE = ("cnn", "sampling", "hypotheses", "scoring", "refine")
# Convolutions of one dispatch: per expert the stem's 1 + 2 x 3, the head
# block's 3x3 and 1x1 (no projection: 2 channels in and out) and the
# coordinate head; the gating's 2; none fuses on the CPU.
CONVS = M * (1 + 2 * 3 + 2 + 1) + 2


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage_spans")
    params = init_scene_params(PRESET, seed=3, device="cpu")
    params["centers"] = torch.tensor([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0], [0.0, 0.1, 2.0]])
    save_scene_params(params, PRESET, root / "expert", root / "gating")
    manifest = SceneManifest()
    manifest.add(SceneEntry(scene_id="a", version=1, expert_ckpt=str(root / "expert"),
                            gating_ckpt=str(root / "gating"), preset=PRESET, ransac=CFG))
    reg = SceneRegistry(manifest, device="cpu")
    reg.prewarm_programs("a", CFG.frame_buckets, route_ks=(None, 2))
    return reg


def _frame(i, prior=False):
    rng = np.random.default_rng(200 + i)
    f = {"image": rng.uniform(0, 1, (H, W, 3)).astype(np.float32), "seed": np.int64(i)}
    if prior:
        f.update(prior_rvec=rng.normal(0, 0.1, (2, 3)).astype(np.float32),
                 prior_tvec=rng.normal(0, 0.1, (2, 3)).astype(np.float32) + [0, 0, -2],
                 prior_valid=np.array([True, i % 2 == 0]))
    return f


def _served(registry, trace, lane, frames):
    """Every frame through a worker-less dispatcher on ``lane``: the sync
    path (one request per dispatch) and one bulk call."""
    disp = registry.dispatcher(CFG, start_worker=False, trace=trace)
    kw = {"dense": {}, "routed": {"route_k": 2}, "prior": {"n_hyps": CFG.n_hyps}}[lane]
    try:
        one = [disp.infer_one(f, scene="a", **kw) for f in frames]
        many = disp.infer_many(frames, scene="a", **kw)
    finally:
        disp.close()
    return one + many


def test_traced_submit_nests_the_bucket_calls_stages_inside_dispatched(registry):
    disp = registry.dispatcher(CFG, trace=True)
    try:
        reqs = [disp.submit(_frame(i), scene="a") for i in range(3)]
        for r in reqs:
            r.get(WAIT_S)
        dispatches = sum(disp.dispatch_totals().values())
    finally:
        disp.close()
    # A dispatch's convolution counts ride its first traced request alone.
    carriers = [r.spans.durations() for r in reqs if "cnn.convs" in r.spans.durations()]
    assert len(carriers) == dispatches
    assert all(d["cnn.convs"] == CONVS and d["cnn.fused_convs"] == 0 for d in carriers)
    for r in reqs:
        d = r.spans.durations()
        assert set(top_level(d)) == TOP  # the top-level keys are as before
        assert set(d) - set(CONV_COUNTS) == TOP | NESTED  # no gpu.* entry off the card
        assert all(d[f"dispatched.{s}"] >= 0.0 for s in SERVE_STAGES)
        nested = math.fsum(d[k] for k in NESTED)
        assert abs(nested - d["dispatched"]) <= 1e-9
        assert r.spans.residual() <= 1e-9
        assert abs(math.fsum(top_level(d).values()) - (r.t_done - r.t_submit)) <= 1e-9
        assert [s for s, _ in r.spans.segments()] == [
            "coalesced", "staged", "dispatched", "device", "sliced", "served"]


@pytest.mark.parametrize("lane", ["dense", "routed", "prior"])
def test_results_bit_identical_with_tracing_on_and_off(registry, lane):
    frames = [_frame(i, prior=lane == "prior") for i in range(5)]
    off = _served(registry, False, lane, frames)
    on = _served(registry, True, lane, frames)
    assert len(off) == len(on) == 10
    for a, b in zip(off, on):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), (lane, k)
    if lane == "routed":
        assert "experts_evaluated" in on[0]
    if lane == "prior":
        assert "prior_hit" in on[0]


def test_untraced_dispatch_writes_no_stage(registry, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a stage clock or range on an untraced dispatch")

    monkeypatch.setattr(dispatcher_mod, "StageClock", refuse)
    monkeypatch.setattr(dispatcher_mod, "host_range", refuse)
    seen = []
    fn_for = registry._fn_for

    def spying_fn_for(*args, **kwargs):
        fn = fn_for(*args, **kwargs)

        def run(params, batch):
            seen.append(trace_mod._STAGE_CLOCK.get())
            return fn(params, batch)

        return run

    monkeypatch.setattr(registry, "_fn_for", spying_fn_for)
    disp = registry.dispatcher(CFG)
    try:
        reqs = [disp.submit(_frame(i), scene="a") for i in range(3)]
        for r in reqs:
            r.get(WAIT_S)
        disp.infer_many([_frame(i) for i in range(5)], scene="a")
    finally:
        disp.close()
    assert seen and all(clock is None for clock in seen)
    assert all(r.spans is None and r.trace is None for r in reqs)
    assert disp._trace_store is None
    assert disp.obs.get("serve_stage_seconds").count() == 0
    assert "dispatched.cnn" not in render_prometheus(disp.obs.snapshot())


def test_traced_infer_many_stores_one_trace_per_dispatch(registry):
    disp = registry.dispatcher(CFG, trace=True, start_worker=False)
    try:
        out = disp.infer_many([_frame(i) for i in range(6)], scene="a")
        dispatches = sum(disp.dispatch_totals().values())
    finally:
        disp.close()
    assert len(out) == 6
    traces = disp._trace_store.traces()
    assert len(traces) == dispatches == len(plan_dispatches(6, CFG.frame_buckets)) >= 2
    for t in traces:
        assert t.done and t.outcome == "served" and t.scene == "a"
        assert [s for s, _ in t.root.segments()] == [
            "staged", "coalesced", "dispatched", "device", "sliced", "served"]
        d = t.durations()
        assert set(d) == {s for s, _ in t.root.segments()} | NESTED | set(CONV_COUNTS)
        assert (d["cnn.convs"], d["cnn.fused_convs"]) == (CONVS, 0)
        assert abs(math.fsum(d[k] for k in NESTED) - d["dispatched"]) <= 1e-9
        assert t.residual() <= 1e-9
        assert [k for k, _ in t.to_dict()["nested_stages"]] == [
            f"dispatched.{s}" for s in SERVE_STAGES] + list(CONV_COUNTS)
    hist = disp.obs.get("serve_stage_seconds")
    for s in SERVE_STAGES + ("staged", "coalesced", "device", "sliced"):
        key = s if s not in SERVE_STAGES else f"dispatched.{s}"
        assert hist.count(stage=key) == dispatches


@pytest.mark.parametrize("route_k", [None, 2], ids=["dense", "routed_k2"])
def test_submit_and_infer_many_nest_the_same_keys_and_counts(registry, route_k):
    """Three frames ride one 4-lane dispatch through each entry point."""
    frames = [_frame(20 + i) for i in range(3)]
    disp = registry.dispatcher(CFG, trace=True, start_worker=False)
    try:
        reqs = [disp.submit(f, scene="a", route_k=route_k) for f in frames]
        disp.start()
        for r in reqs:
            r.get(WAIT_S)
        disp.infer_many(frames, scene="a", route_k=route_k)
        assert [b for b, _ in disp.dispatch_log] == [4, 4]
    finally:
        disp.close()
    bulk = disp._trace_store.traces()[-1]
    assert all(bulk.root is not r.spans for r in reqs)
    one = reqs[0].spans.nested_durations()
    many = bulk.root.nested_durations()
    assert list(one) == list(many)
    assert {k: v for k, v in one.items() if is_count(k)} == \
        {k: v for k, v in many.items() if is_count(k)}
    assert ("route.pairs" in one) == (route_k is not None) and "cnn.convs" in one


class _Steps:
    """Spies on the dispatch steps: (step, dispatch number) in call order."""

    def __init__(self, monkeypatch):
        self.log, self._ids = [], {}
        cls = dispatcher_mod.MicroBatchDispatcher
        for name in ("_stage", "_issue", "_wait", "_land"):
            monkeypatch.setattr(cls, name, self._spy(name, getattr(cls, name)))

    def _spy(self, name, step):
        def run(*args, **kwargs):
            out = step(*args, **kwargs)
            d = out if name == "_stage" else next(a for a in args if isinstance(
                a, dispatcher_mod._Dispatch))
            self.log.append((name, self._ids.setdefault(id(d), len(self._ids))))
            return out

        return staticmethod(run) if name == "_wait" else run

    def count(self, name):
        return sum(1 for step, _ in self.log if step == name)


def test_infer_many_stages_the_next_dispatch_between_this_call_and_its_wait(
        registry, monkeypatch):
    steps = _Steps(monkeypatch)
    disp = registry.dispatcher(CFG, start_worker=False)
    try:
        disp.infer_many([_frame(i) for i in range(9)], scene="a")
    finally:
        disp.close()
    log = steps.log
    n = len(plan_dispatches(9, CFG.frame_buckets))
    for i in range(n - 1):
        assert log.index(("_issue", i)) < log.index(("_stage", i + 1)) \
            < log.index(("_wait", i)) < log.index(("_issue", i + 1))


def test_both_entry_points_go_through_the_same_steps(registry, monkeypatch):
    steps = _Steps(monkeypatch)
    disp = registry.dispatcher(CFG, start_worker=False)
    try:
        disp.infer_one(_frame(0), scene="a")
        assert [s for s, _ in steps.log] == ["_stage", "_issue", "_wait", "_land"]
        disp.infer_many([_frame(i) for i in range(6)], scene="a")
    finally:
        disp.close()
    n = 1 + len(plan_dispatches(6, CFG.frame_buckets))
    assert [steps.count(s) for s in ("_stage", "_issue", "_land")] == [n, n, n]


def test_prometheus_and_trace_renderings_carry_the_stages(registry):
    disp = registry.dispatcher(CFG, trace=True)
    try:
        disp.submit(_frame(0), scene="a").get(WAIT_S)
        snap = disp.obs.snapshot()
    finally:
        disp.close()
    prom = render_prometheus(snap)
    for s in COMPUTE + ("resolve", "outputs"):
        assert f'serve_stage_seconds_count{{stage="dispatched.{s}"}} 1' in prom
    shown = render_traces(snap, 1).splitlines()
    at = next(i for i, line in enumerate(shown) if "|- dispatched" in line)
    assert [line.split()[2] for line in shown[at + 1:at + 8]] == list(SERVE_STAGES)
    assert "|- device" in shown[at + 8]


def _profiled_events(fn):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("esac.")]


def test_stage_ranges_are_host_events_and_not_user_annotations(registry):
    from torch.autograd import DeviceType

    disp = registry.dispatcher(CFG, trace=True, start_worker=False)
    try:
        events = _profiled_events(
            lambda: (disp.infer_one(_frame(0), scene="a"),
                     disp.infer_many([_frame(1), _frame(2)], scene="a")))
    finally:
        disp.close()
    names = {e.name for e in events}
    want = {f"esac.{s}" for s in SERVE_STAGES} | {"esac.staging", "esac.to_host"}
    assert want <= names
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in events)


def test_the_workers_waits_get_ranges_when_traced(registry):
    disp = registry.dispatcher(dataclasses_replace(CFG, serve_max_wait_ms=5.0), trace=True)

    def two_dispatches():
        for i in range(2):
            disp.submit(_frame(i), scene="a").get(WAIT_S)

    try:
        disp.submit(_frame(9), scene="a").get(WAIT_S)  # the worker then waits for work
        names = {e.name for e in _profiled_events(two_dispatches)}
    finally:
        disp.close()
    assert {"esac.wait_work", "esac.hold", "esac.cnn", "esac.to_host"} <= names


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def test_span_chain_nested_entries_and_their_truncation():
    ch = SpanChain("admitted", 10.0)
    ch.stamp("staged", 10.5)
    ch.stamp("dispatched", 12.0)
    ch.nest([("dispatched.cnn", 1.0), ("dispatched.outputs", 0.5)])
    ch.stamp("served", 12.25)
    ch.nest([("dispatched.cnn", 7.0)])  # after the terminal stamp: inert
    assert ch.segments() == [("staged", 0.5), ("dispatched", 1.5), ("served", 0.25)]
    assert ch.total() == 2.25 and ch.residual() == 0.0
    assert ch.durations() == {"staged": 0.5, "dispatched": 1.5, "served": 0.25,
                              "dispatched.cnn": 1.0, "dispatched.outputs": 0.5}
    assert top_level(ch.durations()) == {"staged": 0.5, "dispatched": 1.5, "served": 0.25}
    tr = Trace(0.0)
    tr.root.nest([("gpu.cnn", 0.25)])
    assert tr.to_dict()["nested_stages"] == [["gpu.cnn", 0.25]]


def test_stage_clock_marks_telescope_and_scope_is_per_context():
    ticks = iter([1.0, 1.5, 3.0, 3.25, 4.0])
    clock = StageClock(lambda: next(ticks), torch.device("cpu"))
    assert clock.begin() == 1.0
    serve_stage("cnn")  # no clock in scope: nothing marked
    with stage_scope(clock):
        serve_stage("resolve")
        serve_stage("cnn")
        seen = []
        t = threading.Thread(target=lambda: seen.append(trace_mod._STAGE_CLOCK.get()))
        t.start()
        t.join()
        serve_stage("sampling")
    assert seen == [None]  # another thread's dispatch sees no clock
    assert not StageClock(lambda: 0.0, None).marked()
    assert clock.finish() == 4.0 and clock.marked()
    assert clock.host_stages() == [("dispatched.resolve", 0.5), ("dispatched.cnn", 1.5),
                                   ("dispatched.sampling", 0.25),
                                   ("dispatched.outputs", 0.75)]
    assert clock.device_stages() == []  # off the card
