"""The port's host weight tier and prefetcher against the JAX package's, on
the CPU.

- Codec: ``compress_tree`` / ``decompress_tree`` of one numpy tree are the
  JAX package's bit for bit under "none", "bf16" and "int8" (bf16 by its
  uint16 view, int8 values and scales exactly, ``EXACT_KEYS`` and non-float32
  leaves byte-exact); payloads never alias the caller's buffers.
- Hierarchy: one access sequence (gets, explicit demotions, purges) through
  both packages' ``DeviceWeightCache`` + ``HostWeightTier`` under one pair of
  byte budgets (stub loaders, no RNG) gives the same demotions, host hits,
  disk loads and LRU order in both tiers.
- Prefetch: the same arrival stream under an injected clock gives both
  ``WeightPrefetcher``s the same scores, rankings and issued admissions.
- Coalescing: concurrent ``get_or_load`` / ``get`` calls of one key pay one
  load.
- The registry on the port alone (16x16, two 2-channel experts): a demoted
  scene comes back as a host hit bit-equal to its first serve, and results
  equal a tierless registry loaded from the bf16-rounded tree; hypothesis
  budget overrides and prior slots prewarm their own signatures.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from esac_tpu.registry import DeviceWeightCache as JDeviceWeightCache
from esac_tpu.registry import HostWeightTier as JHostWeightTier
from esac_tpu.registry import PrefetchPolicy as JPrefetchPolicy
from esac_tpu.registry import WeightPrefetcher as JWeightPrefetcher
from esac_tpu.registry import compress_tree as j_compress_tree
from esac_tpu.registry import decompress_tree as j_decompress_tree
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.cache import DeviceWeightCache, tree_nbytes
from esac_tpu_torch.registry.hosttier import (
    EXACT_KEYS,
    HostWeightTier,
    compress_tree,
    decompress_tree,
)
from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest, ScenePreset
from esac_tpu_torch.registry.prefetch import PrefetchPolicy, WeightPrefetcher
from esac_tpu_torch.registry.serving import (
    SceneRegistry,
    init_scene_params,
    load_scene_params,
    save_scene_params,
)

CODECS = ("none", "bf16", "int8")


def _host_tree(seed=0, k=64):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, 3)).astype(np.float32)
    w[0, :] = [0.0, -0.0, 1e-39]   # zeros and a denormal
    w[1, :] = [3.0e38, -2.5, 0.5]  # a huge value, and halves for the rounding
    return {
        "expert": {"conv": {"w": w, "b": rng.standard_normal(k).astype(np.float32)},
                   "steps": np.arange(4, dtype=np.int64),
                   "half": rng.standard_normal(5).astype(np.float16)},
        "gating": {"w": rng.standard_normal((k,)).astype(np.float32),
                   "zero": np.zeros(3, np.float32)},
        "centers": rng.standard_normal((2, 3)).astype(np.float32),
        "c": np.asarray([8.0, 8.0], np.float32),
        "f": np.float32(20.0),
    }


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("codec", CODECS)
def test_codec_is_the_jax_codec_bit_for_bit(codec):
    tree = _host_tree()
    j, t = j_compress_tree(tree, codec), compress_tree(tree, codec)
    assert t["nbytes"] == j["nbytes"] and t["compression"] == j["compression"] == codec
    jl, tl = dict(_leaves(j["tree"])), dict(_leaves(t["tree"]))
    assert jl.keys() == tl.keys()
    for path, jleaf in jl.items():
        tleaf = tl[path]
        assert tleaf.codec == jleaf.codec, path
        assert tleaf.nbytes == jleaf.nbytes, path
        if jleaf.codec == "bf16":
            assert np.array_equal(tleaf.data.view(torch.int16).numpy().view(np.uint16),
                                  jleaf.data.view(np.uint16)), path
        else:
            assert tleaf.data.numpy().dtype == np.asarray(jleaf.data).dtype, path
            assert tleaf.data.numpy().tobytes() == np.asarray(jleaf.data).tobytes(), path
        assert tleaf.scale == jleaf.scale, path  # int8 scales exactly, else None
        if path[0] in EXACT_KEYS or path[-1] in ("steps", "half"):
            assert tleaf.codec == "f32", path
    jd, td = dict(_leaves(j_decompress_tree(j))), dict(_leaves(decompress_tree(t)))
    for path, want in jd.items():
        got = _np(td[path])
        assert got.dtype == np.asarray(want).dtype and got.tobytes() == \
            np.asarray(want).tobytes(), path
    if codec == "none":
        for path, leaf in _leaves(tree):
            assert _np(td[path]).tobytes() == np.asarray(leaf).tobytes(), path


def test_payload_never_aliases_caller_buffers():
    centers = np.arange(6, dtype=np.float32).reshape(2, 3)
    conv = torch.ones(4)
    p = compress_tree({"centers": centers, "expert": {"w": conv, "i": torch.arange(3)}},
                      "none")
    centers[:] = -1.0   # hostile post-compress mutations of the caller's buffers
    conv.fill_(7.0)
    d = decompress_tree(p)
    assert np.array_equal(d["centers"].numpy(), np.arange(6, dtype=np.float32).reshape(2, 3))
    assert torch.equal(d["expert"]["w"], torch.ones(4))
    d["centers"][0, 0] = 5.0  # the decompressed tree is a copy, not the payload
    assert float(decompress_tree(p)["centers"][0, 0]) == 0.0


@dataclasses.dataclass(frozen=True)
class _Key:
    scene_id: str
    version: int = 1

    @property
    def key(self):
        return (self.scene_id, self.version)


def _stub_loader(counts):
    def loader(entry):
        counts[entry.scene_id] = counts.get(entry.scene_id, 0) + 1
        k = 64 * (1 + (entry.scene_id == "c"))
        return {"expert": {"w": np.full(k, 0.1 * ord(entry.scene_id[0]), np.float32)},
                "centers": np.zeros((2, 3), np.float32)}
    return loader


# ("get" | "demote" | "evict", scene)
SEQUENCE = [("get", s) for s in "abcbd"] + [("demote", "b"), ("get", "a"), ("get", "b"),
                                             ("evict", "c"), ("get", "c")] + \
    [("get", s) for s in "eadbca"] + [("demote", "a"), ("get", "a"), ("evict", "a"),
                                     ("get", "a")]


def test_tiered_cache_sequence_matches_jax():
    """Device budget 3 small scenes, host budget 4 small payloads (bf16
    halves the CNN bytes): device hits, demotions, host hits, disk loads,
    purges and both LRU orders."""
    results = []
    for cache_cls, tier_cls, kw in ((JDeviceWeightCache, JHostWeightTier, {}),
                                    (DeviceWeightCache, HostWeightTier, {"device": "cpu"})):
        counts = {}
        tier = tier_cls(budget_bytes=4 * 152, compression="bf16")
        cache = cache_cls(_stub_loader(counts), budget_bytes=3 * 280, tier=tier, **kw)
        trail = []
        for op, s in SEQUENCE:
            if op == "get":
                w = cache.get(_Key(s))["expert"]["w"]
                trail.append(("get", s, np.asarray(w).tobytes()))
            else:
                trail.append((op, s, getattr(cache, op)((s, 1))))
            trail.append((tuple(cache.keys()), tuple(tier.keys())))
        results.append(dict(trail=trail, counts=counts, cache=cache.stats(),
                            tier=tier.stats(), evictions=list(cache.evictions),
                            tier_evictions=list(tier.evictions)))
    j, t = results
    assert t == j
    c, h = t["cache"], t["tier"]
    assert min(c["hits"], c["host_hits"], c["demotions"], h["purges"], h["evictions"]) >= 1


class _StubRegistry:
    """What WeightPrefetcher reads of a SceneRegistry: ``cache`` and
    ``prefetch_targets``."""

    def __init__(self, cache, scenes):
        self.cache = cache
        self._entries = {s: _Key(s) for s in scenes}

    def prefetch_targets(self, scene):
        e = self._entries.get(scene)
        return [] if e is None else [e]


def test_prefetcher_ranking_and_decay_match_jax():
    stream = [(0.0, "a"), (0.0, "a"), (0.1, "b"), (0.2, "a"), (0.4, "c"), (0.4, "c"),
              (0.4, "c"), (0.5, "d"), (1.5, "b"), (1.6, "b"), (1.7, "e"), (3.0, "c")]
    cycles = (0.3, 0.6, 1.8, 2.2, 3.5, 40.0)
    results = []
    for pkg in ("jax", "torch"):
        t = [0.0]
        counts = {}
        if pkg == "jax":
            tier = JHostWeightTier(budget_bytes=3 * 152)
            cache = JDeviceWeightCache(_stub_loader(counts), budget_bytes=2 * 280, tier=tier)
            pf = JWeightPrefetcher(_StubRegistry(cache, "abcde"), JPrefetchPolicy(
                halflife_s=1.0, device_scenes=2, max_device_per_cycle=1,
                max_host_per_cycle=2, repromote_cooldown_s=0.5), clock=lambda: t[0])
        else:
            tier = HostWeightTier(budget_bytes=3 * 152)
            cache = DeviceWeightCache(_stub_loader(counts), budget_bytes=2 * 280, tier=tier,
                                      device="cpu")
            pf = WeightPrefetcher(_StubRegistry(cache, "abcde"), PrefetchPolicy(
                halflife_s=1.0, device_scenes=2, max_device_per_cycle=1,
                max_host_per_cycle=2, repromote_cooldown_s=0.5), clock=lambda: t[0])
        trail, i = [], 0
        for tc in cycles:
            while i < len(stream) and stream[i][0] <= tc:
                t[0] = stream[i][0]
                pf.observe(stream[i][1])
                i += 1
            t[0] = tc
            issued = pf.run_cycle()
            trail.append((issued, pf.scores(), cache.keys(), tier.keys()))
        results.append((trail, pf.stats(), counts))
    assert results[1] == results[0]
    trail, stats, _ = results[1]
    assert stats["issued_device"] >= 2 and stats["issued_host"] >= 1
    assert trail[-1][1] == {}  # every score aged out


def test_concurrent_loads_coalesce_to_one():
    gate = threading.Event()
    calls = []

    def producer():
        calls.append(1)
        gate.wait(5.0)
        return compress_tree({"expert": {"w": np.ones(4, np.float32)}}, "bf16")

    tier = HostWeightTier()
    got = []
    threads = [threading.Thread(target=lambda: got.append(tier.get_or_load(("a", 1), producer)))
               for _ in range(6)]
    for th in threads:
        th.start()
    time.sleep(0.05)
    gate.set()
    for th in threads:
        th.join(5.0)
    assert len(calls) == 1 and len(got) == 6 and all(g is got[0] for g in got)

    counts = {}
    loader = _stub_loader(counts)

    def slow(entry):
        time.sleep(0.05)
        return loader(entry)

    cache = DeviceWeightCache(slow, tier=HostWeightTier(), device="cpu")
    trees = []
    threads = [threading.Thread(target=lambda: trees.append(cache.get(_Key("a"))))
               for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(5.0)
    assert counts == {"a": 1} and len(trees) == 6 and all(x is trees[0] for x in trees)
    assert cache.stats()["disk_loads"] == 1 and cache.stats()["misses"] == 6


# ------------------------------------------------ the registry on the port

H = W = 16
PRESET = ScenePreset(height=H, width=W, num_experts=2, stem_channels=(2, 2, 2),
                     head_channels=2, head_depth=1, gating_channels=(2,),
                     compute_dtype="float32", gated=True)
CFG = RansacConfig(n_hyps=8, refine_iters=2, polish_iters=1, frame_buckets=(1, 4))
KEYS = ("rvec", "tvec", "scores", "expert", "inlier_frac")


def _frame(i):
    rng = np.random.default_rng(200 + i)
    return {"image": rng.uniform(0, 1, (H, W, 3)).astype(np.float32), "seed": np.int64(i)}


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiers")
    out = {}
    for name, seed in (("a", 0), ("b", 1)):
        params = init_scene_params(PRESET, seed=seed, device="cpu")
        params["centers"] = torch.tensor([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0]])
        save_scene_params(params, PRESET, root / name / "expert", root / name / "gating")
        out[name] = SceneEntry(scene_id=name, version=1, expert_ckpt=str(root / name / "expert"),
                               gating_ckpt=str(root / name / "gating"), preset=PRESET,
                               ransac=CFG)
    return out


def _manifest(entries):
    m = SceneManifest()
    for e in entries.values():
        m.add(e)
    return m


def _same(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in KEYS)


def test_registry_host_hit_bit_equal_and_matches_the_rounded_tree(entries):
    frames = [_frame(i) for i in range(3)]
    one = load_scene_params(entries["a"])
    budget = int(1.2 * tree_nbytes(one))
    reg = SceneRegistry(_manifest(entries), budget_bytes=budget, device="cpu",
                        host_tier=HostWeightTier(compression="bf16"))
    disp = reg.dispatcher(CFG, start_worker=False)
    first = disp.infer_many(frames, scene="a")
    disp.infer_many(frames, scene="b")  # demotes a under the 1-scene budget
    assert ("a", 1) not in reg.cache and ("a", 1) in reg.host_tier
    loads = reg.cache.stats()["disk_loads"]
    again = disp.infer_many(frames, scene="a")
    stats = reg.cache.stats()
    assert stats["disk_loads"] == loads and stats["host_hits"] == 1 and stats["demotions"] >= 1
    assert all(_same(g, w) for g, w in zip(again, first))

    # A tierless registry whose loader returns the bf16-rounded tree serves
    # the same results.
    def rounded(entry):
        tree = load_scene_params(entry)
        for sub in ("expert", "gating"):
            tree[sub] = {k: v.to(torch.bfloat16).float() for k, v in tree[sub].items()}
        return tree

    plain = SceneRegistry(_manifest(entries), loader=rounded, device="cpu")
    want = plain.dispatcher(CFG, start_worker=False).infer_many(frames, scene="a")
    assert all(_same(g, w) for g, w in zip(first, want))
    # The promoted weights themselves: bf16-rounded CNNs, byte-exact geometry.
    staged = reg.cache.get(entries["a"])
    assert torch.equal(staged["centers"], one["centers"]) and torch.equal(staged["f"], one["f"])
    w = staged["expert"][0].state_dict()
    for k, v in one["expert"].items():
        assert torch.equal(w[k], v[0].to(torch.bfloat16).float()), k


def test_budget_override_and_prior_slots_prewarm_their_signatures(entries):
    reg = SceneRegistry(_manifest(entries), device="cpu")
    e = entries["a"]
    assert reg._fn_for(e, None, CFG.n_hyps) is reg._fn_for(e)  # the scene's own budget
    assert reg._fn_for(e, None, 4) is not reg._fn_for(e)
    with pytest.raises(Exception, match="n_hyps override"):
        reg._fn_for(e, None, 0)
    n = reg.prewarm_programs("a", CFG.frame_buckets, n_hyps_overrides=(None, 4),
                             prior_slots=2)
    assert n == 2 * 2 * 2  # (own, 4) x (plain, prior) x 2 buckets
    disp = reg.dispatcher(CFG, start_worker=False)
    f = dict(_frame(0), prior_rvec=np.zeros((2, 3), np.float32),
             prior_tvec=np.zeros((2, 3), np.float32), prior_valid=np.zeros(2, bool))
    out = disp.infer_one(f, scene="a", n_hyps=4)
    assert out["prior_hit"].shape == () and reg.compile_cache_size() == n
    assert disp.dispatch_counts[("a", None)] == 1
