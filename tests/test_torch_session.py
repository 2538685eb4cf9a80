"""The port's tracked sessions against the JAX package's, on the CPU.

- ``SessionTable``: one scripted plan/observe sequence (winner poses and
  soft-inlier fractions made from a seed, tracked -> lost -> recovered
  flaps, hysteresis, dispatch errors, LRU eviction) gives equal prior slates
  (float32, bit-equal), budgets, transitions and counters in both packages.
- Evicted and unknown sessions raise the same typed errors (class tree,
  wire names, retry flags).
- ``SessionRouter`` over a dispatcher whose serve function echoes a scripted
  winner: both packages dispatch the same frames on the same lanes -- cold
  frames at the full budget, tracked frames on the ``(scene, route_k, 32)``
  lane with 4 prior slots -- with the worker and on the synchronous path; a
  track loss on a traced request lands as a ``session:track_loss`` event.
"""

import threading

import numpy as np
import pytest

from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.serve import MicroBatchDispatcher as JMicroBatchDispatcher
from esac_tpu.serve import SessionPolicy as JSessionPolicy
from esac_tpu.serve import SessionRouter as JSessionRouter
from esac_tpu.serve import SessionTable as JSessionTable
from esac_tpu.serve import SLOPolicy as JSLOPolicy
from esac_tpu.serve import session as j_session
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.serve import (
    SessionEvictedError,
    SessionPolicy,
    SessionRouter,
    SessionTable,
    SessionUnknownError,
)
from esac_tpu_torch.serve import session as t_session
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
from esac_tpu_torch.serve.slo import SLOPolicy

FULL = 256


def _script(seed=0, n=40):
    """(op, session, rvec, tvec, frac) steps: frames of sessions s0-s2 with
    fractions that cross the loss and entry bars, dispatch errors, a
    re-open, and opens beyond the table's capacity."""
    rng = np.random.default_rng(seed)
    steps = [("open", "s0"), ("open", "s1"), ("open", "s2")]
    for i in range(n):
        sid = f"s{i % 3}"
        if i == 17:
            steps.append(("error", sid))
        elif i == 29:
            steps.append(("open", "s1"))
        frac = float(rng.choice([0.02, 0.08, 0.12, 0.3, 0.7]))
        steps.append(("frame", sid, rng.normal(size=3).astype(np.float32),
                      rng.normal(size=3).astype(np.float32), np.float32(frac)))
    steps += [("open", "s3"), ("open", "s4"), ("frame", "s1", np.zeros(3, np.float32),
                                               np.ones(3, np.float32), np.float32(0.5))]
    return steps


def _run_table(table, steps):
    trail = []
    for op, sid, *rest in steps:
        try:
            if op == "open":
                table.open(sid, scene="sc", route_k=None, full_n_hyps=FULL)
                trail.append(("open", sid))
            elif op == "error":
                table.note_error(sid)
                trail.append(("error", sid))
            else:
                scene, route_k, n_hyps, rv, tv, valid, tracked = table.plan(sid)
                rvec, tvec, frac = rest
                trail.append(("plan", sid, scene, route_k, n_hyps, rv.tobytes(),
                              tv.tobytes(), valid.tobytes(), rv.dtype.str, tracked))
                trail.append(("observe", table.observe(sid, rvec, tvec, frac, tracked)))
        except Exception as e:  # noqa: BLE001 -- the typed error is the record
            trail.append(("raised", type(e).__name__, e.wire_name, e.retryable))
    return trail, table.stats()


@pytest.mark.parametrize("enter", [None, 0.25])
def test_session_table_matches_jax(enter):
    kw = dict(prior_slots=4, track_n_hyps=32, track_loss_frac=0.1,
              track_enter_frac=enter, max_sessions=3, evicted_ring=4)
    steps = _script()
    j = _run_table(JSessionTable(JSessionPolicy(**kw)), steps)
    t = _run_table(SessionTable(SessionPolicy(**kw)), steps)
    assert t == j
    trail, stats = t
    assert stats["track_losses"] >= 2 and stats["tracked_frames"] >= 5
    assert stats["evicted"] == 2 and ("raised", "SessionEvictedError",
                                      "session_evicted", True) in trail


def test_session_errors_typed_alike():
    for mod in (j_session, t_session):
        table = mod.SessionTable(mod.SessionPolicy(max_sessions=1))
        table.open("a")
        table.open("b")  # evicts a
        with pytest.raises(mod.SessionEvictedError):
            table.plan("a")
        with pytest.raises(mod.SessionUnknownError):
            table.plan("never")
        assert table.close("b") and not table.close("b")
        with pytest.raises(mod.SessionUnknownError):
            table.plan("b")
    for name in ("SessionEvictedError", "SessionUnknownError"):
        ours, ref = getattr(t_session, name), getattr(j_session, name)
        assert (ours.wire_name, ours.retryable) == (ref.wire_name, ref.retryable)
        assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in ref.__mro__]
    assert issubclass(SessionEvictedError, t_session.ShedError)
    assert issubclass(SessionUnknownError, t_session.ConfigError)


def _echo(seen, fracs):
    """A serve function that records each dispatch's (lanes' n_hyps, prior
    slots, valid mask) and answers a scripted winner per frame value."""
    mu = threading.Lock()

    def fn(tree, scene=None, route_k=None, n_hyps=None):
        x = np.asarray(tree["x"])
        with mu:
            seen.append((scene, route_k, n_hyps, np.asarray(tree["prior_valid"]).tolist(),
                         np.asarray(tree["prior_rvec"]).round(6).tolist()))
        return {"rvec": np.repeat(x[:, :1], 3, axis=1).astype(np.float32),
                "tvec": np.ones((len(x), 3), np.float32),
                "inlier_frac": np.asarray([fracs[int(v)] for v in x[:, 0]], np.float32)}
    return fn


FRACS = [0.5, 0.6, 0.7, 0.05, 0.4, 0.6, 0.3, 0.2]


@pytest.mark.parametrize("worker", [True, False])
def test_session_router_tracked_frames_ride_the_n_hyps_lane(worker):
    records = []
    for disp_cls, pol_cls, router_cls, slo_cls, cfg_cls, kw in (
            (JMicroBatchDispatcher, JSessionPolicy, JSessionRouter, JSLOPolicy,
             JRansacConfig, {}),
            (MicroBatchDispatcher, SessionPolicy, SessionRouter, SLOPolicy, RansacConfig,
             {"device": "cpu"})):
        seen = []
        cfg = cfg_cls(n_hyps=FULL, frame_buckets=(1,), serve_max_wait_ms=0.0)
        disp = disp_cls(_echo(seen, FRACS), cfg, start_worker=worker,
                        slo=slo_cls(watchdog_ms=60_000.0) if worker else None, **kw)
        router = router_cls(disp, pol_cls(track_loss_frac=0.1, track_enter_frac=0.3))
        router.open("s", scene="a", full_n_hyps=FULL)
        outs = [router.infer_frame("s", {"x": np.full(2, float(i), np.float32)},
                                   timeout=30.0) for i in range(len(FRACS))]
        disp.close()
        records.append((seen, [(o["session_tracked"], o["session_transition"])
                               for o in outs], router.table.stats(),
                        disp.slo_totals(), dict(disp.dispatch_counts)))
    assert records[1] == records[0]
    seen, transitions, stats, totals, counts = records[1]
    tracked = [s for s in seen if s[2] == 32]
    assert len(tracked) == stats["tracked_frames"] >= 3
    assert all(len(s[3][0]) == 4 and s[3][0][0] for s in tracked)  # 4 slots, slot 0 valid
    assert all(s[2] == FULL and not any(s[3][0]) for s in seen if s[2] != 32)
    assert ("lost" in {t for _, t in transitions}) and totals["served"] == len(FRACS)
    assert counts == {("a", None): len(FRACS)}  # accounting stays (scene, route_k)


def test_track_loss_event_rides_a_traced_request():
    seen = []
    disp = MicroBatchDispatcher(_echo(seen, [0.05]), RansacConfig(frame_buckets=(1,)),
                                trace=True, device="cpu", slo=SLOPolicy(watchdog_ms=60_000.0))
    try:
        router = SessionRouter(disp, SessionPolicy(track_loss_frac=0.5, track_enter_frac=0.5))
        router.open("s", scene="a", full_n_hyps=FULL)
        router.table.observe("s", np.zeros(3, np.float32), np.zeros(3, np.float32), 0.9, False)
        out = router.infer_frame("s", {"x": np.zeros(2, np.float32)}, timeout=30.0)
        assert out["session_transition"] == "lost" and seen[0][2] == 32
        events = [s for t in disp._trace_store.traces() for s in list(t.spans)
                  if s.name == "session:track_loss"]
        assert len(events) == 1 and events[0].annotations["session"] == "s"
        assert disp.obs.snapshot()["collectors"]["session"]["track_losses"] == 1
    finally:
        disp.close()
