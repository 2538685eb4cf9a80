"""The port's FleetRouter against the JAX package's, on the CPU.

Scripted, sequential traffic through both packages' routers over echo
replicas (a ``FaultInjector`` around a host serve function per replica, as
tests/test_fleet.py builds them) gives the same route kinds, homes,
quarantines, failovers, replica breaker events and fleet books:

- affinity: cold scenes spread over an idle fleet and claim homes, repeat
  traffic is an affinity hit, scene-less traffic routes dense;
- failover: a wedged home (every injector armed alike, the predicate picks
  the home) is quarantined typed, the request is served by the survivor
  inside its deadline, equal to the survivor dispatched directly, and
  counted once; ``release_replica`` puts the home back in service;
- scene-level faults fail fast on the first replica (no failover, no
  quarantine); a deadline that dies in routing is booked expired.
"""

import threading

import numpy as np
import pytest

from esac_tpu.fleet import FleetPolicy as JFleetPolicy
from esac_tpu.fleet import FleetRouter as JFleetRouter
from esac_tpu.fleet import Replica as JReplica
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.serve import FaultInjector as JFaultInjector
from esac_tpu.serve import MicroBatchDispatcher as JMicroBatchDispatcher
from esac_tpu.serve import SLOPolicy as JSLOPolicy
from esac_tpu_torch.fleet import FleetPolicy, FleetRouter, Replica
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
from esac_tpu_torch.serve.slo import FaultInjector, SLOPolicy

PKGS = {
    "jax": dict(policy=JFleetPolicy, router=JFleetRouter, replica=JReplica, cfg=JRansacConfig,
                inj=JFaultInjector, disp=JMicroBatchDispatcher, slo=JSLOPolicy, kw={}),
    "torch": dict(policy=FleetPolicy, router=FleetRouter, replica=Replica, cfg=RansacConfig,
                  inj=FaultInjector, disp=MicroBatchDispatcher, slo=SLOPolicy,
                  kw={"device": "cpu"}),
}


def _echo(tree, scene=None, route_k=None, n_hyps=None):
    if scene == "bad":
        raise ValueError("scene-level fault")
    return {"echo": tree["x"]}


def _frame(v=0.0):
    return {"x": np.full(2, v, np.float32)}


def _fleet(pkg, n=3):
    p = PKGS[pkg]
    cfg = p["cfg"](n_hyps=8, refine_iters=2, frame_buckets=(1,), serve_max_wait_ms=0.0,
                   serve_queue_depth=64)
    slo = p["slo"](watchdog_ms=400.0, watchdog_poll_ms=10.0)
    reps, injs = [], {}
    for i in range(n):
        inj = p["inj"](_echo, tag=f"r{i}")
        reps.append(p["replica"](f"r{i}", p["disp"](inj, cfg, slo=slo, **p["kw"])))
        injs[f"r{i}"] = inj
    return p["router"](reps, p["policy"](poll_ms=2.0)), injs


def _books(router):
    t = router.fleet_totals()
    assert sum(t[o] for o in ("served", "shed", "expired", "degraded", "failed",
                              "pending")) == t["offered"], t
    return t


def _affinity(pkg):
    router, _ = _fleet(pkg, 3)
    outs = []
    for rounds in range(3):
        for i, s in enumerate(["sA", "sB", "sC", "sD", "sE"]):
            outs.append(router.infer_one(_frame(i + rounds), scene=s, deadline_ms=5_000))
    for i in range(3):
        outs.append(router.infer_one(_frame(i), deadline_ms=5_000))
    router.close()
    stats = router.affinity_stats()
    return dict(homes=router.scene_homes(), stats={k: v for k, v in stats.items()
                                                   if k != "hit_rate"},
                hit_rate=stats["hit_rate"], books=_books(router),
                echo=[o["echo"].tolist() for o in outs],
                routes=sorted(router.obs.get("fleet_routes_total").items(),
                              key=lambda kv: sorted(kv[0].items())))


def _failover(pkg):
    router, injs = _fleet(pkg, 2)
    router.infer_one(_frame(0), scene="sA", deadline_ms=5_000)
    home = router.scene_homes()["sA"][0]
    survivor = "r1" if home == "r0" else "r0"
    release = threading.Event()
    for inj in injs.values():
        inj.stall_once(release, match=lambda ctx, t=home: ctx["tag"] == t)
    req = router.submit(_frame(7), scene="sA", deadline_ms=5_000)
    out = req.get(5.0)
    direct = router._replicas[survivor].dispatcher.infer_one(_frame(7), scene="sA")
    quarantined = router.quarantined_replicas()
    try:
        router._route_locked("sZ", {survivor}, None)
        blocked = None
    except Exception as e:  # noqa: BLE001 -- the typed refusal is the record
        blocked = (type(e).__name__, e.wire_name, e.retryable)
    release.set()
    released = router.release_replica(home)
    again = router.release_replica(home)
    after = [router.infer_one(_frame(9), scene=s, deadline_ms=5_000)
             for s in ("sA", "sB", "sC")]
    router.close()
    return dict(home_is_r=home[0], outcome=req.outcome, failover_from=req.failover_from == [home],
                served_by_survivor=req.replica == survivor,
                equal_direct=bool(np.array_equal(out["echo"], direct["echo"])),
                quarantined=list(quarantined) == [home], blocked=blocked,
                stalls={n == home: i.stats()["stalls"] for n, i in injs.items()},
                released=(released, again), homes=len(router.scene_homes()["sA"]),
                after=[a["echo"].tolist() for a in after],
                stats={k: v for k, v in router.affinity_stats().items() if k != "hit_rate"},
                books=_books(router),
                events=sorted(router.obs.get("fleet_events_total").items(),
                              key=lambda kv: sorted(kv[0].items())))


def _faults(pkg):
    router, _ = _fleet(pkg, 2)
    errs = []
    for scene, deadline in (("bad", 5_000), ("sA", 5_000), ("sA", -1.0)):
        try:
            router.infer_one(_frame(1), scene=scene, deadline_ms=deadline)
            errs.append(None)
        except Exception as e:  # noqa: BLE001 -- the typed error is the record
            errs.append((type(e).__name__, getattr(e, "wire_name", None)))
    router.close()
    return dict(errs=errs, quarantined=router.quarantined_replicas(), books=_books(router),
                stats={k: v for k, v in router.affinity_stats().items() if k != "hit_rate"})


def _affinity_claims(a):
    assert a["stats"]["cold"] == 5 and a["stats"]["affinity"] == 10 and a["stats"]["dense"] == 3
    assert {h for hs in a["homes"].values() for h in hs} == {"r0", "r1", "r2"}


def _failover_claims(f):
    assert f["outcome"] == "served" and f["failover_from"] and f["served_by_survivor"]
    assert f["equal_direct"] and f["quarantined"] and f["released"] == (True, False)
    assert f["blocked"] == ("ReplicaQuarantinedError", "replica_quarantined", False)
    assert f["books"]["offered"] == f["books"]["served"] == 5


def _faults_claims(x):
    assert x["errs"][0] == ("ValueError", None) and x["errs"][1] is None
    assert x["errs"][2][0] == "DeadlineExceededError" and not x["quarantined"]
    assert x["books"]["failed"] == 1 and x["books"]["expired"] == 1


@pytest.mark.parametrize("drill, claims", [(_affinity, _affinity_claims),
                                           (_failover, _failover_claims),
                                           (_faults, _faults_claims)],
                         ids=["affinity", "failover", "faults"])
def test_scripted_traffic_matches_the_jax_router(drill, claims):
    j, t = drill("jax"), drill("torch")
    assert t == j
    claims(t)  # and the drill exercised what it claims
