"""The port's retrieval front-end against the JAX package's, on the CPU.

- The retriever: ``make_retrieval_fn`` at a small config (32x32, channels
  (4, 8), embedding 16, float32) with the JAX package's initialized weights
  carried over by ``models.convert.load_retriever``: embedding and posterior
  within atol 1e-5 of the JAX forward, masked slots exactly 0, and no new
  batch signature across enrollments.
- ``SceneIndex``: one enroll / refresh / remove sequence (and its typed
  refusals) gives bit-equal snapshots in both packages.
- ``RetrievalFront.decide`` over a host fake retriever (as
  tests/test_retrieval.py builds it): the same candidates, posteriors, miss
  classes, breaker skips and books in both packages.
- ``FleetRouter.infer_image`` over echo replicas: the same winners,
  retrieval evidence and books; the port's winner scoring also reads the
  ``score`` leaf that "fused_select" results carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esac_tpu.fleet import FleetPolicy as JFleetPolicy
from esac_tpu.fleet import FleetRouter as JFleetRouter
from esac_tpu.fleet import Replica as JReplica
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.retrieval import RetrievalFront as JRetrievalFront
from esac_tpu.retrieval import RetrievalPolicy as JRetrievalPolicy
from esac_tpu.retrieval import SceneIndex as JSceneIndex
from esac_tpu.retrieval.model import RetrievalConfig as JRetrievalConfig
from esac_tpu.retrieval.model import build_retriever as j_build_retriever
from esac_tpu.retrieval.model import make_retrieval_fn as j_make_retrieval_fn
from esac_tpu.serve import FaultInjector as JFaultInjector
from esac_tpu.serve import MicroBatchDispatcher as JMicroBatchDispatcher
from esac_tpu.serve import SLOPolicy as JSLOPolicy
from esac_tpu_torch.fleet import FleetPolicy, FleetRouter, Replica
from esac_tpu_torch.models.convert import load_retriever
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.retrieval import (
    RetrievalConfig,
    RetrievalFront,
    RetrievalPolicy,
    RetrieverNet,
    SceneIndex,
    make_retrieval_fn,
)
from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher
from esac_tpu_torch.serve.slo import FaultInjector, SLOPolicy

SMALL = dict(height=32, width=32, max_scenes=8, embed_dim=16, channels=(4, 8))


def test_retriever_forward_matches_jax():
    jcfg, cfg = JRetrievalConfig(**SMALL), RetrievalConfig(**SMALL)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    params = j_build_retriever(jcfg).init(jax.random.key(0), images[:1])
    net = load_retriever(RetrieverNet(cfg.embed_dim, cfg.channels), params)
    fn, jfn = make_retrieval_fn(cfg, device="cpu"), j_make_retrieval_fn(jcfg)
    index = SceneIndex(cfg.max_scenes, cfg.embed_dim)
    for i, sid in enumerate("abc"):
        index.enroll(sid, rng.normal(size=(2, cfg.embed_dim)))
    protos, mask, ids = index.snapshot()
    got = fn(net, protos, mask, images)
    want = jfn(params, jnp.asarray(protos), jnp.asarray(mask), jnp.asarray(images))
    np.testing.assert_allclose(got["embedding"].numpy(), np.asarray(want["embedding"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["posterior"].numpy(), np.asarray(want["posterior"]),
                               atol=1e-5)
    post = got["posterior"].numpy()
    assert np.all(post[:, ~mask] == 0.0) and np.allclose(post.sum(-1), 1.0, atol=1e-6)
    n = fn._cache_size()
    index.enroll("d", rng.normal(size=(1, cfg.embed_dim)))
    index.remove("a")
    fn(net, *index.snapshot()[:2], images)
    assert fn._cache_size() == n == 1


D = 4
SCENES = ("a", "b", "c")
VECS = {sid: np.eye(D, dtype=np.float32)[i] for i, sid in enumerate(SCENES)}


def _query(sid, pure=1.0, other=None):
    v = pure * VECS[sid] + (0.0 if other is None else (1.0 - pure) * VECS[other])
    return {"image": v.astype(np.float32)}


def _noise():
    return {"image": np.eye(D, dtype=np.float32)[3]}


def _fake_retriever(params, protos, mask, images):
    """The host mirror of make_retrieval_fn's product (tests/test_retrieval.py)."""
    x = np.asarray(images, np.float32)
    x = x[None] if x.ndim == 1 else x
    emb = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    logits = emb @ np.asarray(protos, np.float32).T / 0.1
    logits = np.where(np.asarray(mask)[None, :], logits, -1e30)
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return {"embedding": emb, "posterior": p / p.sum(-1, keepdims=True)}


def _stats(stats):
    """A stats dict with NaN means spelled out, so two can compare equal."""
    return {k: "nan" if isinstance(v, float) and v != v else v for k, v in stats.items()}


def _index_script(index_cls):
    idx = index_cls(capacity=3, embed_dim=D)
    trail = []
    ops = [("enroll", "a", VECS["a"][None]), ("enroll", "b", np.stack([VECS["b"], VECS["c"]])),
           ("enroll", "z", np.zeros((1, D + 1), np.float32)), ("enroll", "c", VECS["c"]),
           ("enroll", "d", VECS["a"]), ("remove", "b", None), ("remove", "b", None),
           ("enroll", "a", np.stack([VECS["a"], VECS["b"]])), ("enroll", "d", VECS["b"])]
    for op, sid, emb in ops:
        try:
            trail.append(idx.enroll(sid, emb) if op == "enroll" else idx.remove(sid))
        except Exception as e:  # noqa: BLE001 -- the typed refusal is the record
            trail.append(type(e).__name__)
        protos, mask, ids = idx.snapshot()
        trail.append((protos.tobytes(), mask.tobytes(), ids))
    return trail, idx.stats(), idx.scene_ids(), len(idx)


def test_scene_index_matches_jax():
    j, t = _index_script(JSceneIndex), _index_script(SceneIndex)
    assert t == j
    assert "ManifestError" in t[0] and t[1]["removals"] == 1


def _decide_script(front_cls, index_cls, policy_cls):
    index = index_cls(capacity=4, embed_dim=D)
    for sid in SCENES:
        index.enroll(sid, VECS[sid][None])
    tripped = set()
    front = front_cls(_fake_retriever, None, index, policy=policy_cls(top_k=2),
                      healthy=lambda s: s not in tripped)
    trail = []
    queries = [_query("a"), _query("b", 0.7, "c"), _noise(), _query("c", 0.55, "a"),
               "trip a", _query("a", 0.9, "b"), "trip b", _query("a"), "trip c",
               _query("a")]
    for q in queries:
        if isinstance(q, str):
            tripped.add(q.split()[1])
            continue
        tok = front.offer()
        try:
            d = front.decide(q)
            trail.append((d.candidates, d.ranked, d.top1, d.top1_p, d.entropy,
                          d.tripped_skipped, sorted(d.posterior.items())))
            front.note_result(d.candidates[0], d)
            tok.book("served")
        except Exception as e:  # noqa: BLE001 -- the typed miss is the record
            tok.book("shed", e)
            trail.append((type(e).__name__, e.wire_name))
    empty = front_cls(_fake_retriever, None, index_cls(capacity=2, embed_dim=D))
    try:
        empty.decide(_query("a"))
    except Exception as e:  # noqa: BLE001
        trail.append(type(e).__name__)
    return trail, _stats(front.stats()), _stats(empty.stats())


def test_front_decide_matches_jax():
    j = _decide_script(JRetrievalFront, JSceneIndex, JRetrievalPolicy)
    t = _decide_script(RetrievalFront, SceneIndex, RetrievalPolicy)
    assert t == j
    trail, stats, empty = t
    assert stats["missed_low_confidence"] == 1 and stats["missed_tripped"] == 1
    assert stats["tripped_skipped"] >= 3 and empty["missed_no_candidate"] == 1
    assert stats["offered"] == stats["served"] + stats["shed"]


def _scene_infer(tree, scene=None, route_k=None, n_hyps=None):
    """Per-scene expert fake: the soft-inlier score is the query's alignment
    with the dispatched scene's axis, so the right scene wins."""
    x = np.asarray(tree["image"], np.float32)
    return {"scores": (x @ VECS[scene])[:, None],
            "rvec": (x[:, :3] * 2.0 + ord(scene)).astype(np.float32)}


def _image_fleet(pkg, infer=_scene_infer):
    if pkg == "jax":
        P, R, Rep, C, I, Dp, S, F, Pol, Ix = (JFleetPolicy, JFleetRouter, JReplica,
                                              JRansacConfig, JFaultInjector,
                                              JMicroBatchDispatcher, JSLOPolicy,
                                              JRetrievalFront, JRetrievalPolicy, JSceneIndex)
        kw = {}
    else:
        P, R, Rep, C, I, Dp, S, F, Pol, Ix = (FleetPolicy, FleetRouter, Replica, RansacConfig,
                                              FaultInjector, MicroBatchDispatcher, SLOPolicy,
                                              RetrievalFront, RetrievalPolicy, SceneIndex)
        kw = {"device": "cpu"}
    cfg = C(n_hyps=8, refine_iters=2, frame_buckets=(1,), serve_max_wait_ms=0.0)
    reps = [Rep(f"r{i}", Dp(I(infer, tag=f"r{i}"), cfg, slo=S(watchdog_ms=30_000.0), **kw))
            for i in range(2)]
    router = R(reps, P(poll_ms=2.0))
    index = Ix(capacity=4, embed_dim=D)
    for sid in SCENES:
        index.enroll(sid, VECS[sid][None])
    front = F(_fake_retriever, None, index, policy=Pol(top_k=2))
    router.attach_retrieval(front)
    return router, front


def _image_drill(pkg):
    router, front = _image_fleet(pkg)
    trail = []
    for q in (_query("a", 0.9, "b"), _query("c"), _noise(), _query("b", 0.6, "a")):
        try:
            out = router.infer_image(q, timeout=30.0)
            trail.append((out["retrieval"], out["rvec"].tolist(), out["scores"].tolist()))
        except Exception as e:  # noqa: BLE001 -- the typed miss is the record
            trail.append(type(e).__name__)
    router.close()
    return trail, _stats(front.stats()), router.fleet_totals(), router.scene_homes()


def test_infer_image_matches_jax():
    j, t = _image_drill("jax"), _image_drill("torch")
    assert t == j
    trail, stats, totals, _ = t
    assert [x[0]["scene"] for x in trail if not isinstance(x, str)] == ["a", "c", "b"]
    assert stats["served"] == 3 and stats["shed"] == 1 and totals["served"] == 6


def test_winner_scoring_reads_the_fused_select_score_leaf():
    def fused(tree, scene=None, route_k=None, n_hyps=None):
        out = _scene_infer(tree, scene)
        return {"score": out.pop("scores")[:, 0], **out}

    router, front = _image_fleet("torch", infer=fused)
    try:
        out = router.infer_image(_query("b", 0.8, "a"), timeout=30.0)
        assert out["retrieval"]["scene"] == "b" and "scores" not in out
        assert float(out["score"]) == pytest.approx(0.8)
    finally:
        router.close()
    assert front.stats()["served"] == 1
    best = RetrievalFront.select_winner([("a", {"score": np.float32(0.5)}),
                                         ("b", {"scores": np.array([[0.1, 0.7]])})])
    assert best[0] == "b"
