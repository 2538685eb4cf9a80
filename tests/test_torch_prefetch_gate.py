"""The dispatch gate (esac_tpu_torch/serve/gate.py): prefetch steps wait
while a dispatch of the process is in flight, a demand load never waits, a
demand that joins a prefetch's load releases it, an abandoned dispatch
leaves the gate (a led one too: a led call inside a dispatch adds no hold
of its own), a closing prefetcher stops waiting, and what a prefetch
stages is what a demand load stages.

Every case is ordered by events and joins, never by a measured time: the
loader's steps are recorded through ``load_scene_params``'s
``read_checkpoint`` hook, and a prefetch step is known to wait once the
gate counts it (``DispatchGate.waits``).  Each case runs on a gate of its
own with no longest wait."""

from __future__ import annotations

import functools
import threading
import time

import numpy as np
import pytest
import torch

from esac_tpu_torch.bench.fixtures import image_frame, tiny_preset, write_scene
from esac_tpu_torch.fleet import router
from esac_tpu_torch.parallel import multihost
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry import prefetch
from esac_tpu_torch.registry.hosttier import HostWeightTier
from esac_tpu_torch.registry.manifest import SceneManifest
from esac_tpu_torch.registry.prefetch import PrefetchPolicy
from esac_tpu_torch.registry.serving import SceneRegistry, load_scene_params
from esac_tpu_torch.serve import dispatcher, gate
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
from esac_tpu_torch.serve.slo import DispatchStalledError, SLOPolicy
from esac_tpu_torch.utils.checkpoint import load_checkpoint

CPU = torch.device("cpu")
JOIN_S = 60.0  # a bound on a join that must succeed, not a measured time
CFG = RansacConfig(n_hyps=4, refine_iters=1, polish_iters=1, frame_buckets=(1,),
                   serve_max_wait_ms=0.0)


@pytest.fixture
def fresh_gate(monkeypatch):
    g = gate.DispatchGate()
    for mod in (gate, dispatcher, prefetch, multihost, router):
        monkeypatch.setattr(mod, "DISPATCH_GATE", g)
    monkeypatch.setattr(gate, "MAX_YIELD_S", None)
    return g


class Reads:
    """A checkpoint reader that records each read and can hold the next
    one until released."""

    def __init__(self):
        self.paths = []
        self.hold = None  # threading.Event the next read waits for
        self.entered = threading.Event()

    def hold_next(self) -> threading.Event:
        """Hold the next read until the returned event is set."""
        self.entered.clear()
        self.hold = threading.Event()
        return self.hold

    def __call__(self, path):
        self.paths.append(str(path))
        self.entered.set()
        hold, self.hold = self.hold, None
        if hold is not None:
            assert hold.wait(JOIN_S)
        return load_checkpoint(path)


def _until(pred, what):
    """Poll ``pred`` until true (bounded: a hang fails the test)."""
    t_end = time.monotonic() + JOIN_S
    while not pred():
        assert time.monotonic() < t_end, f"never: {what}"
        time.sleep(0.001)


def _registry(tmp_path, reads, host_tier=None, scenes=2):
    preset = tiny_preset(16, 2)
    manifest = SceneManifest()
    for i in range(scenes):
        manifest.add(write_scene(tmp_path, f"s{i}", preset, CFG, seed=i, checksums=True))
    loader = functools.partial(load_scene_params, read_checkpoint=reads)
    reg = SceneRegistry(manifest, loader=loader, device=CPU, host_tier=host_tier)
    reg.attach_prefetcher(PrefetchPolicy(device_scenes=1, max_device_per_cycle=1,
                                         host_scenes=None, max_host_per_cycle=1,
                                         repromote_cooldown_s=0.0), start=False)
    return reg


def _thread(fn):
    box = {}

    def run():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised by the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _joined(t, box):
    t.join(JOIN_S)
    assert not t.is_alive(), "thread did not finish"
    if "error" in box:
        raise box["error"]
    return box.get("result")


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        return [(k, v) for k, v in tree.state_dict().items()]
    if isinstance(tree, dict):
        return [(f"{k}.{n}", v) for k, sub in sorted(tree.items()) if sub is not None
                for n, v in _leaves(sub)]
    if isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        return [(f"{i}.{n}", v) for i, sub in enumerate(tree) for n, v in _leaves(sub)]
    return [("", tree)]


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("tier", ["device", "host"])
def test_a_cycle_under_a_held_gate_reads_nothing_until_it_opens(tmp_path, fresh_gate, tier):
    reads = Reads()
    reg = _registry(tmp_path, reads,
                    host_tier=HostWeightTier(compression="bf16") if tier == "host" else None)
    pf = reg._prefetcher
    if tier == "host":
        reg.cache.get(reg.manifest.resolve("s0"))  # device-resident: s1 goes to the host tier
        reads.paths.clear()
    pf.observe("s1")
    if tier == "host":
        pf.observe("s0")
        pf.observe("s0")
    token = fresh_gate.enter()
    t, box = _thread(pf.run_cycle)
    _until(lambda: fresh_gate.waits >= 1, "the cycle waits on the gate")
    assert reads.paths == []
    assert t.is_alive()
    fresh_gate.leave(token)
    issued = _joined(t, box)
    assert reads.paths, "the cycle read nothing after the gate opened"
    key = reg.manifest.resolve("s1").key
    if tier == "device":
        assert issued["device"] == [key] and key in reg.cache
    else:
        assert issued["host"] == [key] and key in reg.host_tier and key not in reg.cache


def test_a_prefetch_step_in_flight_waits_at_its_next_step(tmp_path, fresh_gate):
    """A dispatch that starts while a read runs stretches by that read only:
    the load's next step waits for the gate."""
    reads = Reads()
    reg = _registry(tmp_path, reads)
    pf = reg._prefetcher
    pf.observe("s1")
    release = reads.hold_next()
    t, box = _thread(pf.run_cycle)
    assert reads.entered.wait(JOIN_S)
    token = fresh_gate.enter()           # a dispatch starts during the read
    n_reads = len(reads.paths)
    release.set()
    _until(lambda: fresh_gate.waits >= 1, "the next step waits")
    assert len(reads.paths) == n_reads and t.is_alive()
    fresh_gate.leave(token)
    assert _joined(t, box)["device"] == [reg.manifest.resolve("s1").key]


@pytest.mark.parametrize("tier", ["device", "host"])
def test_a_demand_joining_a_prefetch_load_finishes(tmp_path, fresh_gate, tier):
    """The dispatch holds the gate and waits on the prefetch's load future
    (the cache's, or the host tier's); the owner must stop yielding to it."""
    reads = Reads()
    reg = _registry(tmp_path, reads,
                    host_tier=HostWeightTier(compression="bf16") if tier == "host" else None)
    pf = reg._prefetcher
    entry = reg.manifest.resolve("s1")
    if tier == "host":
        reg.cache.get(reg.manifest.resolve("s0"))
        pf.observe("s0")
        pf.observe("s0")
    pf.observe("s1")
    release = reads.hold_next()
    tp, bp = _thread(pf.run_cycle)
    assert reads.entered.wait(JOIN_S)    # the prefetch owns s1's load future

    def dispatch():
        with fresh_gate.held():
            return reg.cache.get(entry)      # a demand: coalesces onto the future

    td, bd = _thread(dispatch)
    loading = reg.cache._loading if tier == "device" else reg.host_tier._loading
    _until(lambda: loading.get(entry.key, {}).get("demanded"), "the demand joins")
    release.set()
    tree = _joined(td, bd)
    issued = _joined(tp, bp)
    assert issued["device" if tier == "device" else "host"] == [entry.key]
    assert fresh_gate.in_flight() == 0
    assert len([p for p in reads.paths if "s1" in p]) == 2  # expert + gating, read once
    _bit_equal(tree, reg.cache.get(entry))


def test_a_demand_load_never_waits(tmp_path, fresh_gate):
    reads = Reads()
    reg = _registry(tmp_path, reads)
    entry = reg.manifest.resolve("s1")
    with fresh_gate.held():
        t, box = _thread(lambda: reg.cache.get(entry))
        _joined(t, box)
        assert entry.key in reg.cache and len(reads.paths) == 2
        assert fresh_gate.waits == 0


def test_an_abandoned_dispatch_leaves_the_gate(fresh_gate):
    wedge, entered = threading.Event(), threading.Event()

    def infer(batch):
        entered.set()
        wedge.wait()  # released by the test's finally, after the checks
        return {"x": torch.as_tensor(batch["seed"])}

    disp = MicroBatchDispatcher(infer, CFG, slo=SLOPolicy(watchdog_ms=200.0,
                                                          watchdog_poll_ms=5.0),
                                device=CPU)
    try:
        req = disp.submit({"seed": np.int64(1)})
        assert entered.wait(JOIN_S)
        assert fresh_gate.in_flight() == 1
        with pytest.raises(DispatchStalledError):
            req.get(JOIN_S)
        _until(lambda: fresh_gate.in_flight() == 0, "the abandoned dispatch leaves")
        # The wedged call is still running; a prefetch step passes.
        assert not wedge.is_set()
        fresh_gate.wait_idle()
    finally:
        wedge.set()
        disp.close()
    assert fresh_gate.in_flight() == 0


def test_an_abandoned_led_dispatch_leaves_the_gate(fresh_gate, monkeypatch):
    """A dispatcher over a led function (``parallel.multihost.lead``): the
    led call rides the dispatch's hold, so the watchdog's abandoning the
    wedged dispatch -- and then the replacement worker's, queued on the led
    call's lock -- opens the gate while the wedged call still runs."""
    monkeypatch.setattr(multihost, "_broadcast", lambda obj, device: obj)  # one rank
    wedge, entered = threading.Event(), threading.Event()

    def infer(batch, scene):
        entered.set()
        wedge.wait()  # released by the test's finally, after the checks
        return {"x": torch.as_tensor(batch["seed"])}

    disp = MicroBatchDispatcher(multihost.lead(infer, CPU), CFG,
                                slo=SLOPolicy(watchdog_ms=200.0, watchdog_poll_ms=5.0),
                                device=CPU)
    try:
        req = disp.submit({"seed": np.int64(1)}, scene="s0")
        assert entered.wait(JOIN_S)
        assert fresh_gate.in_flight() == 1
        with pytest.raises(DispatchStalledError):
            req.get(JOIN_S)
        # The wedge quarantined s0's lane; s1's request goes to the
        # replacement worker.
        queued = disp.submit({"seed": np.int64(2)}, scene="s1")
        with pytest.raises(DispatchStalledError):
            queued.get(JOIN_S)
        _until(lambda: fresh_gate.in_flight() == 0, "both abandoned dispatches leave")
        assert not wedge.is_set()
        assert fresh_gate.wait_idle(timeout_s=0.0)  # a prefetch step passes at once
    finally:
        wedge.set()
        disp.close()
    assert fresh_gate.in_flight() == 0


def test_a_dispatch_holds_the_gate_for_its_call_only(tmp_path, fresh_gate):
    reads = Reads()
    reg = _registry(tmp_path, reads)
    seen = []
    fn = reg.infer_fn()

    def infer(batch, scene):
        seen.append(fresh_gate.in_flight())
        return fn(batch, scene)

    disp = MicroBatchDispatcher(infer, CFG, start_worker=False, device=CPU)
    disp.infer_one(image_frame(0, 16), scene="s0")
    disp.infer_many([image_frame(1, 16), image_frame(2, 16)], scene="s0")
    assert seen == [1, 1, 1] and fresh_gate.in_flight() == 0


def test_close_returns_while_the_gate_is_held(tmp_path, fresh_gate):
    reads = Reads()
    reg = _registry(tmp_path, reads)
    pf = reg._prefetcher
    pf.observe("s1")
    token = fresh_gate.enter()
    pf.start()
    _until(lambda: fresh_gate.waits >= 1, "the prefetch thread waits")
    pf.close(timeout_s=JOIN_S)
    assert not pf._thread.is_alive()
    assert fresh_gate.in_flight() == 1
    fresh_gate.leave(token)


@pytest.mark.parametrize("tier", ["device", "host"])
def test_prefetched_trees_equal_demand_loaded_ones(tmp_path, fresh_gate, tier):
    def make():
        return _registry(tmp_path / tier, Reads(),
                         host_tier=HostWeightTier(compression="bf16") if tier == "host" else None)

    pre, dem = make(), make()
    entry = pre.manifest.resolve("s1")
    pf = pre._prefetcher
    if tier == "host":
        # s1 staged into the host tier ahead of demand, then promoted.
        pre.cache.get(pre.manifest.resolve("s0"))
        pf.observe("s0")
        pf.observe("s0")
    pf.observe("s1")
    issued = pf.run_cycle()
    assert issued["device" if tier == "device" else "host"] == [entry.key]
    _bit_equal(pre.cache.get(entry), dem.cache.get(dem.manifest.resolve("s1")))
