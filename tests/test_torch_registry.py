"""The port's scene registry against the JAX package's, on the CPU.

- Manifest: a manifest saved by the JAX package loads in the port and its
  JSON round-trips byte-equal (and back); both packages reject the same
  malformed documents; ``params_checksum`` of one numpy tree is one digest
  in both, torch leaves included.
- Health: the same sequence of probe results (injected through stubbed
  bucket functions, an injected tick clock, no RNG) gives the same trips,
  rollbacks, sheds and canary decisions in both ``SceneRegistry``s.
- Cache: the same access sequence evicts in the same strict-LRU order
  under one byte budget in both ``DeviceWeightCache``s.
- The slice as a whole: two scenes made by the JAX package (the committed
  test-size experts, a JAX gating net) are carried into the port's
  registry checkpoints (``models.convert.load_scene``,
  ``save_scene_params``) and served with injected correspondence sets
  through ``SceneRegistry.dispatcher().infer_many`` / ``infer_one``; each
  frame's winning expert equals the one the JAX package's pieces pick,
  and its pose agrees within 1e-4 (inlier_frac rtol 2e-4), the tolerance
  of tests/test_torch_routed.py.  At the 16x16 registry size a frame has
  4 cells, P3P is degenerate and scores tie, so this fixture runs at the
  test experts' 96x128 (192 cells, no near ties).
- On the port alone (16x16, two 2-channel experts, 8 hypotheses):
  cold-load, warm-hit and post-eviction results are bit-equal; a hot swap
  and a second scene add no batch signature; a NaN version trips its
  breaker from the deferred probes and rolls back, bit-equal to the
  previous version served directly; checksums and load faults are typed.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.data.datasets import SyntheticScene
from esac_tpu.data.synthetic import output_pixel_grid as j_pixel_grid
from esac_tpu.models import ExpertNet as JExpertNet
from esac_tpu.models import GatingNet as JGatingNet
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac.esac import _per_expert_winners as j_winners
from esac_tpu.ransac.refine import refine_soft_inliers as j_refine
from esac_tpu.registry import DeviceWeightCache as JDeviceWeightCache
from esac_tpu.registry import HealthPolicy as JHealthPolicy
from esac_tpu.registry import ManifestError as JManifestError
from esac_tpu.registry import SceneEntry as JSceneEntry
from esac_tpu.registry import SceneManifest as JSceneManifest
from esac_tpu.registry import ScenePreset as JScenePreset
from esac_tpu.registry import SceneRegistry as JSceneRegistry
from esac_tpu.registry import SceneUnhealthyError as JSceneUnhealthyError
from esac_tpu.registry import params_checksum as j_params_checksum
from esac_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from esac_tpu_torch.models.convert import load_scene
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.cache import DeviceWeightCache, tree_nbytes
from esac_tpu_torch.registry.health import (
    ChecksumMismatchError,
    HealthPolicy,
    SceneLoadError,
    SceneUnhealthyError,
    unhealthy_frames,
)
from esac_tpu_torch.registry.manifest import (
    ManifestError,
    SceneEntry,
    SceneManifest,
    ScenePreset,
    params_checksum,
)
from esac_tpu_torch.registry.serving import (
    SceneRegistry,
    compute_entry_checksums,
    init_scene_params,
    load_scene_params,
    make_scene_bucket_fn,
    save_scene_params,
    stage_scene_params,
)
from esac_tpu_torch.serve.batching import pad_batch, stack_frames
from esac_tpu_torch.serve.slo import FaultInjector
from esac_tpu_torch.utils.checkpoint import checkpoint_nbytes, load_checkpoint

WAIT_S = 60.0
H = W = 16
M = 2
PRESET = ScenePreset(height=H, width=W, num_experts=M, stem_channels=(2, 2, 2),
                     head_channels=2, head_depth=1, gating_channels=(2,),
                     compute_dtype="float32", gated=True)
CFG = RansacConfig(n_hyps=8, refine_iters=2, polish_iters=1, frame_buckets=(1, 4))
POSE_KEYS = ("rvec", "tvec", "scores", "expert")


def _bit_equal(a, b, keys=POSE_KEYS):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in keys)


# ---------------------------------------------------------- manifest


def _entry_kw(root, name, v):
    return dict(scene_id=name, version=v, expert_ckpt=f"{root}/{name}{v}/expert",
                gating_ckpt=f"{root}/{name}{v}/gating",
                checksums=(("expert", f"{v:064x}"), ("gating", f"{v + 7:064x}")))


def _jax_manifest(root="/ckpt"):
    preset = JScenePreset(**dataclasses.asdict(PRESET))
    ransac = JRansacConfig(**dataclasses.asdict(CFG))
    m = JSceneManifest()
    for name, v in (("a", 1), ("a", 2), ("b", 1)):
        m.add(JSceneEntry(preset=preset, ransac=ransac, **_entry_kw(root, name, v)),
              activate=False)
    m.promote("a", 2)
    return m


def test_jax_manifest_loads_in_the_port_and_round_trips_byte_equal(tmp_path):
    path = tmp_path / "manifest.json"
    _jax_manifest().save(path)
    text = path.read_text()
    ours = SceneManifest.load(path)
    assert ours.to_json() == text
    assert ours.resolve("a").version == 2 and ours.previous_version("a") == 1
    assert ours.resolve("a").ransac == dataclasses.replace(CFG)
    assert ours.rollback("a").version == 1
    ours.promote("a", 2)
    ours.save(tmp_path / "port.json")
    assert (tmp_path / "port.json").read_text() == text
    assert JSceneManifest.load(tmp_path / "port.json").to_json() == text
    assert not (tmp_path / "port.json.tmp").exists()


MUTATIONS = [
    (lambda d: d.update(format_version=99), "format_version"),
    (lambda d: d.update(extra_field=1), "unknown field"),
    (lambda d: d.pop("scenes"), "missing scenes"),
    (lambda d: d["scenes"]["a"].pop("versions"), "versions"),
    (lambda d: d["scenes"]["a"].update(active=7), "active"),
    (lambda d: d["scenes"]["a"].update(active=True), "not an exact integer"),
    (lambda d: d["scenes"]["a"].update(previous=1.7), "not an exact integer"),
    (lambda d: d["scenes"]["a"]["versions"]["1"].update(surprise=1), "unknown field"),
    (lambda d: d["scenes"]["a"]["versions"]["1"].update(scene_id="zzz"), "declares"),
    (lambda d: d["scenes"]["a"]["versions"]["1"]["ransac"].update(n_hypz=4), "ransac"),
    (lambda d: d["scenes"]["a"]["versions"]["1"]["preset"].update(height=17), "stride"),
    (lambda d: d["scenes"]["a"]["versions"]["1"].update(gating_ckpt=None), "gated"),
    (lambda d: d["scenes"]["a"]["versions"]["1"].update(schema_version=99), "newer"),
    (lambda d: d["scenes"]["a"]["versions"]["1"].update(checksums=[["expert", "zz"]]),
     "not 64-hex"),
    (lambda d: d["scenes"]["a"]["versions"]["1"].update(
        checksums=[["expert", "0" * 64], ["expert", "1" * 64]]), "duplicate checksum role"),
]


@pytest.mark.parametrize("case", range(len(MUTATIONS)))
def test_both_packages_reject_the_same_malformed_manifest(case):
    mutate, err = MUTATIONS[case]
    doc = _jax_manifest().to_dict()
    mutate(doc)
    doc = json.loads(json.dumps(doc))
    with pytest.raises(JManifestError, match=err):
        JSceneManifest.from_dict(json.loads(json.dumps(doc)))
    with pytest.raises(ManifestError, match=err):
        SceneManifest.from_dict(doc)


def test_params_checksum_is_one_digest_in_both_packages():
    rng = np.random.default_rng(0)
    tree = {"expert": {"w": rng.normal(size=(2, 3, 3)).astype(np.float32),
                       "b": np.arange(4, dtype=np.int64)},
            "layers": [np.float32(2.5), rng.normal(size=5)]}
    cfg = {"f": 20.0, "c": [8.0, 8.0]}
    want = j_params_checksum(tree, cfg)
    assert params_checksum(tree, cfg) == want
    as_torch = {"expert": {k: torch.from_numpy(v) for k, v in tree["expert"].items()},
                "layers": [torch.tensor(2.5), torch.from_numpy(tree["layers"][1])]}
    assert params_checksum(as_torch, cfg) == want
    as_torch["expert"]["w"][0, 0, 0] += 1
    assert params_checksum(as_torch, cfg) != want


# ------------------------------------------------------- health parity


def _tick_clock():
    t = [0.0]

    def clock():
        t[0] += 1e-3
        return t[0]

    return clock


def _out(bad):
    v = np.nan if bad else 0.0
    return {"rvec": np.full((2, 3), v), "tvec": np.zeros((2, 3)), "inlier_frac": np.ones(2)}


def _stub_registry(pkg, bad_versions, n_versions):
    """A registry over scene 's' whose bucket functions return per-version
    outputs (bad = NaN poses): the breaker and canary logic alone."""
    policy = dict(window=8, min_samples=4, trip_bad_frac=0.5, canary_min_samples=8)
    if pkg == "jax":
        preset = JScenePreset(height=16, width=16, num_experts=2, gated=False)
        m = JSceneManifest()
        for v in range(1, n_versions + 1):
            m.add(JSceneEntry(scene_id="s", version=v, expert_ckpt=f"/ck{v}", preset=preset),
                  activate=False)
        reg = JSceneRegistry(m, loader=lambda e: {"w": np.zeros(4, np.float32)},
                             health=JHealthPolicy(**policy), clock=_tick_clock())
    else:
        preset = ScenePreset(height=16, width=16, num_experts=2, gated=False)
        m = SceneManifest()
        for v in range(1, n_versions + 1):
            m.add(SceneEntry(scene_id="s", version=v, expert_ckpt=f"/ck{v}", preset=preset),
                  activate=False)
        reg = SceneRegistry(m, loader=lambda e: {"w": np.zeros(4, np.float32)},
                            health=HealthPolicy(**policy), clock=_tick_clock(), device="cpu")
        reg.cache._stage = lambda entry, host: host
    reg._fn_for = lambda entry, route_k=None, n_hyps=None: (
        lambda params, batch: _out(entry.version in bad_versions))
    return reg


SCRIPTS = {
    # (bad versions, versions, steps); a step is a serve, or an operator action
    "trip_and_auto_rollback": ({2}, 2, ["serve"] * 3 + ["promote 2"] + ["serve"] * 8),
    "no_target_sheds_until_release": (
        {1}, 1, ["serve"] * 6 + ["release"] + ["serve"] * 2),
    "never_rolls_back_into_a_tripped_version": (
        {1, 2}, 2, ["serve"] * 5 + ["promote 2"] + ["serve"] * 5),
    "canary_finalizes_when_healthy": (set(), 2, ["canary 2 0.25"] + ["serve"] * 20),
    "canary_rolls_back_when_unhealthy": ({2}, 2, ["canary 2 0.5"] + ["serve"] * 14),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_and_canary_decisions_match_the_jax_registry(name):
    bad, n_versions, steps = SCRIPTS[name]
    runs = []
    for pkg in ("jax", "torch"):
        reg = _stub_registry(pkg, bad, n_versions)
        serve, trail = reg.infer_fn(), []
        for step in steps:
            op, *args = step.split()
            try:
                if op == "serve":
                    serve({}, "s")
                elif op == "promote":
                    reg.promote("s", int(args[0]))
                elif op == "canary":
                    reg.promote("s", int(args[0]), canary=float(args[1]))
                else:
                    reg.release_scene("s")
                trail.append((step, "ok", reg.manifest.active_version("s")))
            except (SceneUnhealthyError, JSceneUnhealthyError) as e:
                trail.append((step, e.wire_name, reg.manifest.active_version("s")))
        runs.append((trail, json.loads(json.dumps(reg.health(), default=str))))
    (j_trail, j_health), (t_trail, t_health) = runs
    assert t_trail == j_trail
    assert t_health == j_health
    assert t_health["events"], "the script made no breaker or canary decision"


def test_unhealthy_frames_counts_any_nonfinite_leaf_on_tensors_and_arrays():
    leaves = {"rvec": np.array([[0, 0, 0], [np.nan, 0, 0], [0, 0, 0]], np.float32),
              "tvec": np.zeros((3, 3)), "inlier_frac": np.array([1.0, 1.0, np.inf])}
    assert unhealthy_frames(leaves) == (2, 3)
    assert unhealthy_frames({k: torch.as_tensor(v) for k, v in leaves.items()}) == (2, 3)
    assert unhealthy_frames({}) == (0, 0)


# -------------------------------------------------------- cache parity


@dataclasses.dataclass(frozen=True)
class _Key:
    scene_id: str
    version: int = 1

    @property
    def key(self):
        return (self.scene_id, self.version)


def test_lru_eviction_order_matches_the_jax_cache():
    def loader(entry):
        return {"w": np.zeros(256 * (1 + (entry.scene_id == "c")), np.float32)}

    caches = [JDeviceWeightCache(loader, budget_bytes=3072),
              DeviceWeightCache(loader, budget_bytes=3072, device="cpu")]
    for cache in caches:
        for s in "abcbdaecab":
            cache.get(_Key(s))
    j, t = caches
    assert list(t.evictions) == list(j.evictions) and len(t.evictions) >= 4
    assert t.keys() == j.keys() and t.bytes_in_use == j.bytes_in_use
    for k in ("hits", "misses", "evictions", "resident", "bytes_in_use", "load_failures"):
        assert t.stats()[k] == j.stats()[k], k
    with pytest.raises(ValueError):
        DeviceWeightCache(loader, budget_bytes=1024, device="cpu", tier=object())


# ------------------------------------------ the port's registry at 16x16


def _write_scene(root: pathlib.Path, name, version, seed, nan=False):
    params = init_scene_params(PRESET, seed=seed, device="cpu")
    params["centers"] = torch.tensor([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0]]) + seed * 0.01
    if nan:
        with torch.no_grad():
            for p in params["expert"].parameters():
                p.fill_(float("nan"))
    d = root / f"{name}_v{version}"
    save_scene_params(params, PRESET, d / "expert", d / "gating")
    return SceneEntry(scene_id=name, version=version, expert_ckpt=str(d / "expert"),
                      gating_ckpt=str(d / "gating"), preset=PRESET, ransac=CFG)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_registry")
    return {("a", 1): _write_scene(root, "a", 1, 0), ("a", 2): _write_scene(root, "a", 2, 5),
            ("b", 1): _write_scene(root, "b", 1, 1),
            ("a", 3): _write_scene(root, "a", 3, 9, nan=True)}


def _manifest(scenes, keys):
    m = SceneManifest()
    for k in keys:
        m.add(scenes[k], activate=False)
    return m


def _frame(i):
    rng = np.random.default_rng(100 + i)
    return {"image": rng.uniform(0, 1, (H, W, 3)).astype(np.float32), "seed": np.int64(i)}


def test_registry_checkpoint_layout_and_staging(scenes):
    entry = scenes[("a", 1)]
    host = load_scene_params(entry)
    assert host["expert"]["coord.weight"].shape[0] == M
    params = stage_scene_params(host, PRESET, "cpu")
    assert not any(p.is_meta for p in params["expert"].parameters())
    nbytes = checkpoint_nbytes(entry.expert_ckpt) + checkpoint_nbytes(entry.gating_ckpt)
    assert tree_nbytes(host) == tree_nbytes(params) == nbytes + (M * 3 + 2 + 1) * 4
    with pytest.raises(ManifestError, match="head_channels"):
        load_scene_params(dataclasses.replace(
            entry, preset=dataclasses.replace(PRESET, head_channels=4)))


def test_cold_warm_post_eviction_bit_equal_and_no_new_signature(scenes):
    one = tree_nbytes(load_scene_params(scenes[("a", 1)]))
    reg = SceneRegistry(_manifest(scenes, [("a", 1), ("b", 1)]), budget_bytes=one + 1,
                        device="cpu")
    disp = reg.dispatcher(CFG, start_worker=False)
    f = _frame(0)
    cold = disp.infer_one(f, scene="a")
    warm = disp.infer_one(f, scene="a")
    other = disp.infer_one(f, scene="b")
    assert list(reg.cache.evictions) == [("a", 1)]
    post = disp.infer_one(f, scene="a")
    assert list(reg.cache.evictions) == [("a", 1), ("b", 1)]
    assert _bit_equal(cold, warm) and _bit_equal(cold, post)
    assert not np.array_equal(cold["rvec"], other["rvec"])
    assert reg.cache.stats()["misses"] == 3 and reg.cache.stats()["hits"] == 1
    bulk = disp.infer_many([_frame(i) for i in range(3)], scene="b")
    assert len(bulk) == 3
    # two frame buckets x one bucket key, whatever scenes were swapped
    assert reg.compile_cache_size() == disp.cache_size() == 2
    disp.close()


def test_hot_swap_under_a_live_worker_serves_the_new_weights(scenes):
    reg = SceneRegistry(_manifest(scenes, [("a", 1), ("a", 2)]), device="cpu")
    disp = reg.dispatcher(CFG)
    try:
        frames = [_frame(10 + i) for i in range(3)]
        v1 = [disp.infer_one(f, scene="a", timeout=WAIT_S) for f in frames]
        before = reg.compile_cache_size()
        reg.promote("a", 2)
        v2 = [disp.infer_one(f, scene="a", timeout=WAIT_S) for f in frames]
        params = reg.cache.get(scenes[("a", 2)])
        fn = make_scene_bucket_fn(PRESET, CFG, device="cpu")
        for f, got in zip(frames, v2):
            want = fn(params, pad_batch(stack_frames([f]), 1)[0])
            assert _bit_equal(got, {k: v[0] for k, v in want.items()})
        assert not np.array_equal(v1[0]["rvec"], v2[0]["rvec"])
        assert reg.compile_cache_size() == before == 1
        reqs = [disp.submit(f, scene="a") for f in frames]
        for r in reqs:
            r.get(WAIT_S)
    finally:
        disp.close()
    t = disp.slo_totals()
    assert t["served"] == t["offered"] == 9


def test_nan_version_trips_and_rolls_back_bit_equal(scenes):
    reg = SceneRegistry(_manifest(scenes, [("a", 1), ("a", 3)]), device="cpu",
                        health=HealthPolicy(window=8, min_samples=4))
    solo = SceneRegistry(_manifest(scenes, [("a", 1)]), device="cpu")
    disp = reg.dispatcher(CFG, start_worker=False)
    frames = [_frame(20 + i) for i in range(4)]
    want = solo.dispatcher(CFG, start_worker=False).infer_many(frames, scene="a")
    reg.promote("a", 3)
    bad = disp.infer_many(frames, scene="a")
    assert not np.isfinite(bad[0]["rvec"]).all()
    back = disp.infer_many(frames, scene="a")  # the deferred probe trips here
    assert reg.manifest.active_version("a") == 1
    assert [e["event"] for e in reg.health()["events"]] == ["auto_rollback"]
    assert ("a", 3) not in reg.cache
    for g, w in zip(back, want):
        assert _bit_equal(g, w)
    assert reg.compile_cache_size() == 1
    snap = disp.obs.snapshot()
    assert {"scene_health", "weight_cache", "serve_slo_totals"} <= set(snap["collectors"])


def test_checksums_and_load_faults_are_typed(scenes):
    entry = compute_entry_checksums(scenes[("b", 1)])
    assert load_scene_params(entry)["centers"].shape == (M, 3)
    inj = FaultInjector()
    inj.corrupt_loads(times=1)
    with pytest.raises(ChecksumMismatchError):
        load_scene_params(entry, read_checkpoint=inj.checkpoint_reader(load_checkpoint))
    inj.fail_loads(OSError("blip"), times=1)
    assert load_scene_params(entry, backoff_s=0.001,
                             read_checkpoint=inj.checkpoint_reader(load_checkpoint))
    inj.fail_loads(OSError("down"), times=5)
    with pytest.raises(SceneLoadError, match="3 attempts"):
        load_scene_params(entry, backoff_s=0.001,
                          read_checkpoint=inj.checkpoint_reader(load_checkpoint))
    assert inj.stats()["load_corruptions"] == 1


def test_registry_defaults_to_the_card(monkeypatch, scenes):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SceneRegistry(_manifest(scenes, [("a", 1)]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceWeightCache(lambda e: {})


# ------------------------------------------------ the slice against JAX

TH, TW, NH = 96, 128, 16
TN = (TH // 8) * (TW // 8)
TPRESET = ScenePreset(height=TH, width=TW, num_experts=2,
                      gating_channels=GATING_PRESETS["test"]["channels"],
                      compute_dtype="float32", **EXPERT_PRESETS["test"])
TCFG = RansacConfig(n_hyps=NH, frame_buckets=(1, 4))


def _jax_frame_winner(co, idx, px, f, c, cfg):
    rv, tv, best_j, best_s, _ = j_winners(jax.random.key(0), co, px, f, c, cfg, idx=idx)
    mi = jnp.argmax(best_s)
    rvec, tvec = j_refine(rv[mi, best_j[mi]], tv[mi, best_j[mi]], co[mi], px, f, c,
                          cfg.tau, cfg.beta, iters=cfg.refine_iters)
    return dict(rvec=rvec, tvec=tvec, mi=mi, best=best_s[mi])


@jax.jit
def _jax_scene(tree, imgs, idx):
    """The reference's dense bucket program from its pieces: every expert
    CNN plus its centre, the gating CNN, then each frame's winner with the
    sets ``idx`` (B, M, NH, 4) injected."""
    expert = JExpertNet(scene_center=(0.0, 0.0, 0.0), compute_dtype=jnp.float32,
                        **EXPERT_PRESETS["test"])
    gating = JGatingNet(num_experts=2, channels=GATING_PRESETS["test"]["channels"],
                        compute_dtype=jnp.float32)
    coords = jax.vmap(lambda pe: expert.apply(pe, imgs))(tree["expert"])
    coords = jnp.moveaxis(coords, 0, 1).reshape(imgs.shape[0], 2, -1, 3) \
        + tree["centers"][None, :, None, :]
    logits = gating.apply(tree["gating"], imgs)
    cfg = JRansacConfig(n_hyps=NH)
    win = jax.vmap(lambda co, ix: _jax_frame_winner(co, ix, j_pixel_grid(TH, TW, 8),
                                                    tree["f"], tree["c"], cfg))(coords, idx)
    return win, jax.nn.softmax(logits, axis=-1)


@pytest.fixture(scope="module")
def jax_scenes(tmp_path_factory):
    """Two scenes made by the JAX package -- experts (synth0, synth1) and
    (synth1, synth0) from the committed checkpoints, each with its own JAX
    gating net -- written as the port's registry checkpoints."""
    root = tmp_path_factory.mktemp("jax_scenes")
    ckpts = [j_load_checkpoint(f"ckpts/ckpt_expert_synth{m}") for m in (0, 1)]
    scenes = [SyntheticScene(f"synth{m}", "test", n_frames=4, height=TH, width=TW)
              for m in (0, 1)]
    images = np.stack([scenes[i % 2][i].image for i in range(4)]).astype(np.float32)
    gating = JGatingNet(num_experts=2, channels=GATING_PRESETS["test"]["channels"],
                        compute_dtype=jnp.float32)
    m, trees = SceneManifest(), {}
    for name, order, key in (("s0", (0, 1), 3), ("s1", (1, 0), 4)):
        tree = {
            "expert": jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                   *[ckpts[o][0] for o in order]),
            "gating": jax.tree.map(np.asarray, gating.init(jax.random.key(key), images[:1])),
            "centers": np.array([ckpts[o][1]["scene_center"] for o in order], np.float32),
            "f": np.float32(scenes[0].focal),
            "c": np.array([TW / 2.0, TH / 2.0], np.float32),
        }
        params = load_scene(init_scene_params(TPRESET, device="cpu"), tree)
        save_scene_params(params, TPRESET, root / name / "expert", root / name / "gating")
        m.add(SceneEntry(scene_id=name, version=1, expert_ckpt=str(root / name / "expert"),
                         gating_ckpt=str(root / name / "gating"), preset=TPRESET,
                         ransac=TCFG))
        trees[name] = tree
    return m, trees, images


def test_served_scenes_match_the_jax_pieces(jax_scenes):
    manifest, trees, images = jax_scenes
    idx = np.random.default_rng(5).integers(0, TN, (4, 2, NH, 4))
    reg = SceneRegistry(manifest, device="cpu")
    disp = reg.dispatcher(TCFG)
    try:
        for name in ("s0", "s1"):
            frames = [{"image": images[b], "seed": np.int64(b), "idx": idx[b]}
                      for b in range(4)]
            many = disp.infer_many(frames, scene=name)
            one = [disp.infer_one(frames[b], scene=name, timeout=WAIT_S) for b in (0, 1)]
            want, probs = _jax_scene(trees[name], jnp.asarray(images), jnp.asarray(idx))
            mi = np.asarray(want["mi"])
            assert len(set(mi.tolist())) == 2  # each scene's frames pick both experts
            for b, got in list(enumerate(many)) + list(enumerate(one)):
                assert int(got["expert"]) == mi[b], (name, b)
                np.testing.assert_allclose(got["rvec"], want["rvec"][b], atol=1e-4)
                np.testing.assert_allclose(got["tvec"], want["tvec"][b], atol=1e-4)
                np.testing.assert_allclose(got["inlier_frac"], float(want["best"][b]) / TN,
                                           rtol=2e-4)
                np.testing.assert_allclose(got["gating_probs"], probs[b], atol=1e-5)
    finally:
        disp.close()
    assert disp.slo_totals()["served"] == 12 and reg.compile_cache_size() == 2
