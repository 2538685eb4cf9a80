"""The port's serving front end against the JAX package's, on the CPU.

- Staging: ``StagingCache.stage`` is bit-equal to
  ``pad_batch(stack_frames(...))`` and to the JAX package's staging of the
  same numpy frames; it rotates two buffers, rejects depth 1, falls back
  bit-exactly on a dtype drift, and ``unalias`` copies only pool aliases.
- Dispatcher against dispatcher: one deterministic echo ``infer_fn`` and
  one request stream go through the JAX and the port
  ``MicroBatchDispatcher`` under an injected tick clock (every clock read
  advances it by 1 ms, and only one thread reads it at a time): the same
  bucket sequence, per-lane ``dispatch_counts``, ``slo_totals``, expiry
  decisions (no SLO, explicit deadlines) and shed decisions (SLO: a full
  queue and predicted deadline misses), and the same echoed results.
- SLO and load generator: ``run_open_loop`` over an ``SLOPolicy`` and a
  ``FaultInjector`` drill accounts every request (the outcome classes sum
  to ``offered`` and agree with ``slo_totals``), in both packages.
- The serve-fn builders record batch signatures, and the port's
  dispatcher defaults to the card.

Every wait and join takes a timeout, so a hung dispatcher fails its test.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.serve import FaultInjector as JFaultInjector
from esac_tpu.serve import MicroBatchDispatcher as JDispatcher
from esac_tpu.serve import SLOPolicy as JSLOPolicy
from esac_tpu.serve import run_open_loop as j_run_open_loop
from esac_tpu.serve.batching import StagingCache as JStagingCache
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.serve.batching import StagingCache, pad_batch, stack_frames
from esac_tpu_torch.serve.dispatcher import (
    MicroBatchDispatcher,
    make_dsac_serve_fn,
    make_esac_serve_fn,
)
from esac_tpu_torch.serve.loadgen import run_open_loop, uniform_arrivals
from esac_tpu_torch.serve.slo import (
    ConfigError,
    DeadlineExceededError,
    FaultInjector,
    ShedError,
    SLOPolicy,
)

WAIT_S = 30.0  # every wait in this file is bounded by this


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"coords": rng.normal(size=(6, 3)).astype(np.float32),
             "pixels": rng.normal(size=(6, 2)).astype(np.float32),
             "f": np.float32(rng.uniform(10, 20)),
             "seed": np.int64(seed * 100 + i)} for i in range(n)]


# ------------------------------------------------------------ staging


@pytest.mark.parametrize("n,bucket", [(1, 1), (2, 4), (3, 4), (4, 4), (5, 16)])
def test_staging_bit_identical_to_pad_batch_and_to_jax(n, bucket):
    frames = _frames(n, seed=n)
    want, want_valid = pad_batch(stack_frames(frames), bucket)
    got, got_valid = StagingCache().stage(frames, bucket)
    jgot, j_valid = JStagingCache().stage(frames, bucket)
    assert got_valid == want_valid == j_valid == n
    assert set(got) == set(want) == set(jgot)
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        ours = got[k].numpy()
        assert ours.dtype == np.asarray(want[k]).dtype == np.asarray(jgot[k]).dtype, k
        np.testing.assert_array_equal(ours, want[k])
        np.testing.assert_array_equal(ours, np.asarray(jgot[k]))
    with pytest.raises(ConfigError):
        StagingCache().stage(_frames(3), 1)


def test_staging_rotates_two_buffers_and_rejects_depth_1():
    cache = StagingCache(depth=2)
    frames = _frames(2)
    t1, _ = cache.stage(frames, 4)
    t2, _ = cache.stage(frames, 4)
    t3, _ = cache.stage(frames, 4)
    assert t1["coords"] is t3["coords"]
    assert t1["coords"] is not t2["coords"]
    with pytest.raises(ValueError):
        StagingCache(depth=1)


def test_staging_dtype_drift_and_tensor_leaves_fall_back_bit_identical():
    frames = _frames(2, seed=30)
    frames[1] = dict(frames[1], coords=frames[1]["coords"].astype(np.float64))
    for fr in frames:
        fr["t"] = torch.arange(3, dtype=torch.bfloat16)  # numpy cannot view bf16
    want, _ = pad_batch(stack_frames(frames), 4)
    got, _ = StagingCache().stage(frames, 4)
    assert np.asarray(want["coords"]).dtype == np.float64
    np.testing.assert_array_equal(np.asarray(got["coords"]), want["coords"])
    assert got["t"].dtype == torch.bfloat16 and torch.equal(got["t"], want["t"])


def test_staging_unalias_copies_only_pool_aliases():
    cache = StagingCache()
    tree, _ = cache.stage(_frames(2), 4)
    view = tree["coords"].numpy()[:1]  # aliases a pooled buffer
    foreign = np.zeros(3, np.float32)
    out = cache.unalias([view, foreign])
    assert out[0] is not view and np.array_equal(out[0], view)
    assert out[1] is foreign


def test_echo_results_survive_staging_buffer_reuse():
    """On the CPU the staged batch IS the pooled buffer, so an echo's
    results must be copied before the pool rewrites it."""
    cfg = dataclasses.replace(RansacConfig(), frame_buckets=(2,), serve_max_wait_ms=0.0)
    disp = MicroBatchDispatcher(lambda tree, scene=None: {"x": tree["x"]}, cfg,
                                start_worker=False, device="cpu")
    outs = [disp.infer_one({"x": np.full(4, float(i), np.float32)}, scene="s")
            for i in range(6)]
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o["x"], np.full(4, float(i), np.float32))


def test_warm_frame_allocates_every_bucket_before_the_first_request(monkeypatch):
    """With a ``warm_frame`` the constructing thread and the worker hold a
    pool for every bucket before any request, and serving allocates none."""
    allocs = []

    class Counting(StagingCache):
        def _pool(self, pools, key, row):
            if key not in pools:
                allocs.append((threading.current_thread().name, key))
            return super()._pool(pools, key, row)

    monkeypatch.setattr("esac_tpu_torch.serve.dispatcher.StagingCache", Counting)
    cfg = dataclasses.replace(RansacConfig(), frame_buckets=(1, 4, 16), serve_max_wait_ms=5.0)
    disp = MicroBatchDispatcher(_echo, cfg, start_worker=False, device="cpu",
                                warm_frame={"x": np.zeros(3, np.float32)})
    want = {("x", lanes, np.dtype(np.float32).str, (3,)) for lanes in (2, 4, 16)}
    try:
        assert {k for t, k in allocs if t == threading.current_thread().name} == want
        disp.start()
        assert {k for t, k in allocs if t == "esac-serve"} == want
        n = len(allocs)
        frames = [{"x": np.full(3, float(i), np.float32)} for i in range(21)]
        reqs = [disp.submit(fr) for fr in frames]
        outs = [r.get(WAIT_S) for r in reqs] + disp.infer_many(frames)
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o["echo"], frames[i % 21]["x"])
        assert len(allocs) == n
    finally:
        disp.close()


# ------------------------------------------- dispatcher against dispatcher


def _tick_clock(step=1e-3):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]

    return clock


def _echo(tree, scene=None, route_k=None):
    return {"echo": tree["x"], "twice": tree["x"] * 2}


def _host(x):
    return {k: np.asarray(v) for k, v in x.items()}


def _summary(disp, reqs):
    """What both dispatchers must agree on."""
    outcomes, results = [], []
    for r in reqs:
        assert r.event.wait(WAIT_S), "request never resolved"
        outcomes.append((r.outcome, None if r.error is None else r.error.wire_name))
        results.append(None if r.result is None else _host(r.result))
    return dict(buckets=list(disp.dispatch_log), scenes=list(disp.scene_log),
                counts=dict(disp.dispatch_counts), totals=disp.slo_totals(),
                outcomes=outcomes), results


def _expiry_stream(disp):
    """Two scenes' requests queued before the worker starts, some with
    deadlines the tick clock passes while earlier lanes dispatch."""
    reqs = []
    for i in range(14):
        scene = "a" if i % 3 else "b"
        deadline = 6.0 if i % 5 == 4 else 500.0
        reqs.append(disp.submit({"x": np.full(3, float(i), np.float32)}, scene=scene,
                                deadline_ms=deadline))
    return reqs


def test_dispatchers_agree_on_buckets_counts_and_expiry():
    kw = dict(start_worker=False, clock=_tick_clock())
    cfg = dict(frame_buckets=(1, 4), serve_max_wait_ms=2.0, serve_queue_depth=64)
    jd = JDispatcher(_echo, JRansacConfig(**cfg), **kw)
    td = MicroBatchDispatcher(_echo, RansacConfig(**cfg), device="cpu",
                              start_worker=False, clock=_tick_clock())
    summaries = []
    for disp in (jd, td):
        reqs = _expiry_stream(disp)
        disp.start()  # from here only the worker reads the clock
        summaries.append(_summary(disp, reqs))
        many = disp.infer_many([{"x": np.full(3, 100.0 + i, np.float32)} for i in range(6)],
                               scene="a")
        summaries.append(([_host(r) for r in many], list(disp.dispatch_log)))
        disp.close()
    (j_sum, j_res), j_many, (t_sum, t_res), t_many = summaries
    assert t_sum == j_sum
    assert any(o == ("expired", "deadline_exceeded") for o in t_sum["outcomes"])
    assert t_sum["totals"]["served"] > 0 and len(set(t_sum["buckets"])) > 1
    for a, b in zip(t_res, j_res):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert t_many[1] == j_many[1]
    for a, b in zip(t_many[0], j_many[0]):
        np.testing.assert_array_equal(a["twice"], b["twice"])


def test_dispatchers_agree_on_admission_sheds():
    """SLO mode, no worker: three synchronous dispatches set the dispatch
    time EMA, then a flood meets the full queue and the predicted-miss
    check; close() fails what stayed queued.  Both packages make the same
    decision for every request."""
    def slow_echo(clock):
        def fn(tree, scene=None, route_k=None):
            for _ in range(5):  # a dispatch "takes" 5 ticks
                clock()
            return {"echo": tree["x"]}
        return fn

    records = []
    for pkg in ("jax", "torch"):
        clock = _tick_clock()
        cfg = dict(frame_buckets=(1, 4), serve_max_wait_ms=2.0, serve_queue_depth=5)
        if pkg == "jax":
            disp = JDispatcher(slow_echo(clock), JRansacConfig(**cfg), start_worker=False,
                               clock=clock, slo=JSLOPolicy(deadline_ms=50.0))
        else:
            disp = MicroBatchDispatcher(slow_echo(clock), RansacConfig(**cfg), device="cpu",
                                        start_worker=False, clock=clock,
                                        slo=SLOPolicy(deadline_ms=50.0))
        served = [_host(disp.infer_one({"x": np.full(2, float(i), np.float32)}, scene="s"))
                  for i in range(3)]
        decisions = []
        for i in range(10):
            try:
                disp.submit({"x": np.zeros(2, np.float32)}, scene="s",
                            deadline_ms=[50.0, 1.0, 12.0][i % 3])
                decisions.append("admitted")
            except ShedError as e:  # the JAX package's ShedError is another class
                decisions.append(e.wire_name)
            except Exception as e:  # noqa: BLE001 -- the JAX package's typed errors
                decisions.append(getattr(e, "wire_name", repr(e)))
        disp.close()
        records.append((decisions, disp.slo_totals(), [s["echo"].tolist() for s in served]))
    (j_dec, j_tot, j_srv), (t_dec, t_tot, t_srv) = records
    assert t_dec == j_dec and t_tot == j_tot and t_srv == j_srv
    assert "shed" in t_dec and "admitted" in t_dec
    assert t_tot["failed"] == t_dec.count("admitted")  # closed with them queued
    assert sum(t_tot[o] for o in ("served", "shed", "expired", "degraded", "failed",
                                  "pending")) == t_tot["offered"] == 13


def test_infer_one_timeout_is_a_hard_bound():
    release = threading.Event()

    def gated(tree, scene=None):
        release.wait(WAIT_S)
        return {"echo": tree["x"]}

    cfg = RansacConfig(frame_buckets=(1,), serve_max_wait_ms=0.0)
    disp = MicroBatchDispatcher(gated, cfg, device="cpu", slo=SLOPolicy())
    with pytest.raises(DeadlineExceededError):
        disp.infer_one({"x": np.zeros(2, np.float32)}, timeout=0.05)
    release.set()
    disp.close()
    t = disp.slo_totals()
    assert t["expired"] == 1 and t["offered"] == 1 and t["served"] == 0


# ------------------------------------------------- SLO + load generator


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_open_loop_fault_drill_accounts_every_request(pkg):
    """A FaultInjector wedges scene a's first dispatch past the watchdog
    (its lane is then quarantined) and fails scene b's first dispatch and
    its one retry; run_open_loop's outcome classes sum to offered and equal
    the dispatcher's own accounting."""
    cfg = dict(frame_buckets=(1, 4), serve_max_wait_ms=1.0, serve_queue_depth=8)
    release = threading.Event()
    slo = dict(deadline_ms=2_000.0, watchdog_ms=150.0, watchdog_poll_ms=5.0, retry_max=1,
               retry_backoff_ms=1.0)
    if pkg == "jax":
        inj = JFaultInjector(_echo)
        disp = JDispatcher(inj, JRansacConfig(**cfg), slo=JSLOPolicy(**slo))
        loop = j_run_open_loop
    else:
        inj = FaultInjector(_echo)
        disp = MicroBatchDispatcher(inj, RansacConfig(**cfg), device="cpu",
                                    slo=SLOPolicy(**slo))
        loop = run_open_loop
    inj.stall_once(release, match=lambda ctx: ctx["scene"] == "a")
    inj.fail_times(RuntimeError("transient"), times=2, match=lambda ctx: ctx["scene"] == "b")
    try:
        res = loop(disp, lambda i: ({"x": np.full(2, float(i), np.float32)},
                                    ("a", "b", "c")[i % 3], None),
                   uniform_arrivals(300.0, 60), deadline_ms=2_000.0, settle_s=WAIT_S,
                   freeze_gc=False)
    finally:
        release.set()
        disp.close()
    t = disp.slo_totals()
    assert res["offered"] == t["offered"] == 60 and res["outcomes"]["lost"] == 0
    assert sum(res["outcomes"][o] for o in
               ("served", "degraded", "shed", "expired", "failed")) == 60
    for o in ("served", "degraded", "shed", "expired", "failed"):
        assert res["outcomes"][o] == t[o], (o, res["outcomes"], t)
    assert t["pending"] == 0 and res["outcomes"]["failed"] > 0 and t["served"] > 0
    assert inj.stats()["stalls"] == 1 and inj.stats()["failures"] == 2
    assert ("a", None) in disp.quarantined_lanes()  # the wedged lane


# ------------------------------------------------- builders and the card


@pytest.mark.parametrize("which", ["dsac", "esac"])
def test_serve_fn_counts_batch_signatures_and_dispatcher_defaults_to_the_card(
        monkeypatch, which):
    cfg = RansacConfig(n_hyps=8, refine_iters=1, frame_buckets=(1, 4))
    rng = np.random.default_rng(0)
    frames = []
    for i in range(5):
        coords = rng.normal(size=(16, 3)).astype(np.float32) + [0, 0, 4]
        fr = {"pixels": rng.uniform(0, 8, (16, 2)).astype(np.float32),
              "f": np.float32(10.0), "seed": np.int64(i)}
        if which == "dsac":
            fr["coords"] = coords
        else:
            fr["coords_all"] = np.stack([coords, coords[::-1]])
            fr["gating_logits"] = np.array([0.5, -0.5], np.float32)
        frames.append(fr)
    build = make_dsac_serve_fn if which == "dsac" else make_esac_serve_fn
    fn = build([4.0, 4.0], cfg, device="cpu")
    disp = MicroBatchDispatcher(fn, RansacConfig(frame_buckets=(1, 4)), start_worker=False,
                                device="cpu")
    out = disp.infer_many(frames)
    disp.infer_one(frames[0])
    assert len(out) == 5 and all(np.isfinite(o["rvec"]).all() for o in out)
    assert list(disp.dispatch_log) == [(4, 4), (1, 1), (1, 1)]
    assert disp.cache_size() == 2  # one signature per frame bucket
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MicroBatchDispatcher(fn, RansacConfig(), start_worker=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build([4.0, 4.0], cfg)
