"""The port's expert-parallel inference (esac_tpu_torch.parallel) on 4 gloo
CPU ranks against its own single-device entries and against the JAX
package's parallel module on a 4-device virtual mesh.

One group of 4 ranks is spawned for the whole file (tests/
torch_parallel_cases.py runs every case there and saves the results);
the JAX side runs here.  Contracts:

- the sharded dense and routed entries equal the port's single-device
  entries bit for bit (torch.equal), at expert axes 4 (1x4 mesh) and 2
  (2x2), under every scoring impl, with drawn and with injected sets --
  each expert's sets are drawn by its global index;
- ``_winner_allreduce`` equals the JAX package's on hand-made scores with
  ties inside a rank, across ranks and -inf pads;
- against the JAX package's own ``esac_infer_sharded`` /
  ``esac_infer_routed`` (different RNG streams): the same winning expert,
  the same evaluated sets, poses within 2 deg / 2 cm of each other and
  both within 5 deg / 5 cm of the ground truth.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_cases as cases
from esac_tpu.data import CAMERA_F, make_correspondence_frame
from esac_tpu.parallel import (
    esac_infer_routed as j_esac_infer_routed,
    esac_infer_sharded as j_esac_infer_sharded,
    expert_sharding as j_expert_sharding,
    make_mesh as j_make_mesh,
    pad_experts_for_mesh as j_pad_experts,
    pad_gating_logits as j_pad_logits,
)
from esac_tpu.parallel.esac_sharded import _winner_allreduce as j_winner_allreduce
from esac_tpu.parallel.mesh import shard_map
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu_torch.geometry.camera import pose_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.parallel import pad_experts_for_mesh, pad_gating_logits, spawn_ranks
from esac_tpu_torch.registry.manifest import (
    ManifestError,
    SceneEntry,
    SceneManifest,
    ScenePreset,
)
from esac_tpu_torch.registry.health import HealthPolicy, SceneUnhealthyError
from esac_tpu_torch.registry.serving import SceneRegistry, make_registry_sharded_serve_fn

WORLD = 4
FRAME_KW = dict(height=120, width=160, f=CAMERA_F / 4.0, c=(80.0, 60.0))
F = np.float32(CAMERA_F / 4.0)
C = np.array([80.0, 60.0], np.float32)
CFG = dict(n_hyps=32, refine_iters=4)
# Sharded and single-device poses drawn from different RNG streams: the
# JAX package's own sharded-vs-single criterion.
POSE_AGREE = (2.0, 0.02)   # degrees, meters
POSE_GT = (5.0, 0.05)


def _maps(seed, M, correct):
    """tests/test_parallel.py's make_expert_maps: the true map at
    ``correct``, uniform junk elsewhere."""
    key = jax.random.key(seed)
    frame = make_correspondence_frame(key, noise=0.01, **FRAME_KW)
    n = frame["coords"].shape[0]
    maps = [np.asarray(frame["coords"]) if m == correct else
            np.asarray(jax.random.uniform(jax.random.fold_in(key, m), (n, 3), maxval=5.0))
            for m in range(M)]
    return np.stack(maps).astype(np.float32), {k: np.asarray(v) for k, v in frame.items()}


def _winner_rows():
    """4 ranks x 5 frames of local scores: frame 0 a clear winner, 1 a tie
    across ranks 1 and 3, 2 every rank tied, 3 -inf on three ranks, 4
    every rank -inf; each rank's index is its local winner's global id."""
    ninf = -np.inf
    scores = np.array([[10.0, 7.0, 3.0, ninf, ninf],
                       [12.0, 9.0, 3.0, ninf, ninf],
                       [11.0, 8.0, 3.0, 2.0, ninf],
                       [9.0, 9.0, 3.0, ninf, ninf]], np.float32)
    g = np.array([[1, 0, 1, 0, 1], [2, 3, 3, 2, 2], [5, 4, 4, 4, 5], [7, 7, 6, 6, 7]])
    rng = np.random.default_rng(3)
    return dict(scores=scores, g=g, M=8,
                rvec=rng.normal(size=(4, 5, 3)).astype(np.float32),
                tvec=rng.normal(size=(4, 5, 3)).astype(np.float32))


def _inputs():
    rng = np.random.default_rng(0)
    B, M = 3, 8
    coords, pixels = [], None
    for b in range(B):
        maps, fr = _maps(100 + b, M, correct=(3 * b + 1) % M)
        coords.append(maps)
        pixels = fr["pixels"]
    dense = dict(coords=np.stack(coords), pixels=pixels, f=np.full(B, F), c=C,
                 seeds=np.arange(40, 40 + B), cfg=dict(n_hyps=16, refine_iters=2),
                 idx=rng.integers(0, pixels.shape[0], (B, M, 16, 4)))
    fx_maps, fx = _maps(42, 8, 3)
    routed = {}
    # tests/test_parallel.py:346 on a 4-shard mesh: experts 4 and 5 share
    # rank 2, capacity 1 keeps the higher-mass 5 only.
    maps16, fr16 = _maps(0, 8, 5)
    logits = np.full(8, -2.0, np.float32)
    logits[4], logits[5] = 2.5, 3.0
    routed["overflow"] = dict(maps=maps16, logits=logits[None], capacity=1, cfg=CFG,
                              pixels=fr16["pixels"], f=F, c=C, frame=fr16, correct=5)
    # tests/test_parallel.py:364: M = 6 padded to 8 over 4 ranks (rank 3
    # holds padding only); the pad may be selected, never win.
    maps6, fr6 = _maps(5, 6, 2)
    logits = np.zeros(6, np.float32)
    logits[2] = 3.0
    routed["padding"] = dict(maps=maps6, logits=logits[None], capacity=1, cfg=CFG,
                             pixels=fr6["pixels"], f=F, c=C, frame=fr6, correct=2)
    rmaps, rfr = _maps(9, 8, 2)
    routed_frames = dict(maps=rmaps, pixels=rfr["pixels"], f=np.full(3, F), c=C, k=4,
                         seeds=np.arange(3), cfg=dict(n_hyps=8, refine_iters=2,
                                                      polish_iters=1, frame_buckets=(4,)),
                         logits=np.tile(np.array([2.0, -3.0, 5.0, -3.0, 1.0, -4.0, 0.5, -5.0],
                                                 np.float32), (3, 1)))
    dp_frames = [make_correspondence_frame(k, noise=0.01, **FRAME_KW)
                 for k in jax.random.split(jax.random.key(0), 4)]
    dp = dict(coords=np.stack([np.asarray(fr["coords"]) for fr in dp_frames]),
              pixels=np.stack([np.asarray(fr["pixels"]) for fr in dp_frames]),
              rvec=np.stack([np.asarray(fr["rvec"]) for fr in dp_frames]),
              tvec=np.stack([np.asarray(fr["tvec"]) for fr in dp_frames]),
              f=F, c=C, seeds=np.arange(4), cfg=CFG)
    serve = dict(coords=dense["coords"][:, :4], pixels=pixels, f=np.full(B, F),
                 seeds=np.arange(7, 7 + B), c={"a": C, "b": C + np.float32([2.0, -2.0])},
                 cfg=dict(n_hyps=8, refine_iters=2, frame_buckets=(4,)))
    return dict(war=_winner_rows(), dense=dense, routed=routed, routed_frames=routed_frames,
                dp=dp, serve=serve,
                fixture=dict(coords=fx_maps, pixels=fx["pixels"], f=F, c=C, cfg=CFG,
                             frame=fx))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    torch.save(inp, d / "inputs.pt")
    spawn_ranks(cases.run_inference, WORLD, args=(str(d),), backend="gloo", device="cpu")
    return inp, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _equal(a, b, what):
    for k in b:
        assert np.array_equal(a[k], b[k]), f"{what}: {k} differs"


def _pose_err(rvec_a, tvec_a, rvec_b, tvec_b):
    rvec_a, tvec_a, rvec_b, tvec_b = (torch.tensor(np.array(x))
                                      for x in (rvec_a, tvec_a, rvec_b, tvec_b))
    r, t = pose_errors(rodrigues(rvec_a), tvec_a, rodrigues(rvec_b), tvec_b)
    return float(r), float(t)


def _jax_mesh():
    return j_make_mesh(n_data=1, n_expert=WORLD, devices=jax.devices()[:WORLD])


def test_winner_allreduce_matches_jax(world):
    inp, ranks = world
    w = inp["war"]

    def body(s, g, r, t):
        return tuple(x[None] for x in j_winner_allreduce(s[0], g[0], r[0], t[0], w["M"]))

    fn = shard_map(body, mesh=_jax_mesh(), in_specs=(P("expert"),) * 4,
                   out_specs=(P("expert"),) * 4)
    want = [np.asarray(x) for x in fn(w["scores"], w["g"].astype(np.int32), w["rvec"],
                                      w["tvec"])]
    for r in range(WORLD):
        rvec, tvec, win, best = ranks[r]["war"]
        np.testing.assert_array_equal(win, want[2][r])
        np.testing.assert_array_equal(best, want[3][r])
        np.testing.assert_array_equal(rvec, want[0][r])
        np.testing.assert_array_equal(tvec, want[1][r])
    # Frame 1 ties ranks 1 and 3 (ids 3 and 7): the smaller id wins; frame
    # 4 is -inf everywhere: every rank ties and id 1 wins.
    assert ranks[0]["war"][2].tolist() == [2, 3, 1, 4, 1]


@pytest.mark.parametrize("M,n_shards", [(6, 4), (8, 4), (5, 2), (3, 8)])
def test_padding_matches_jax(M, n_shards):
    rng = np.random.default_rng(M)
    stack = rng.normal(size=(M, 5)).astype(np.float32)
    centers = rng.normal(size=(M, 3)).astype(np.float32)
    logits = rng.normal(size=(2, M)).astype(np.float32)
    j_stack, j_centers, j_M = j_pad_experts(jnp.asarray(stack), jnp.asarray(centers), n_shards)
    stack_p, centers_p, M_pad = pad_experts_for_mesh(torch.as_tensor(stack),
                                                     torch.as_tensor(centers), n_shards)
    assert M_pad == j_M
    np.testing.assert_array_equal(stack_p.numpy(), np.asarray(j_stack))
    np.testing.assert_array_equal(centers_p.numpy(), np.asarray(j_centers))
    np.testing.assert_array_equal(pad_gating_logits(torch.as_tensor(logits), M_pad).numpy(),
                                  np.asarray(j_pad_logits(jnp.asarray(logits), j_M)))
    modules = torch.nn.ModuleList(torch.nn.Linear(2, 2) for _ in range(M))
    padded, _, _ = pad_experts_for_mesh(modules, torch.as_tensor(centers), n_shards)
    assert len(padded) == M_pad
    if M_pad > M:  # deep copies of expert 0
        assert padded[M_pad - 1] is not modules[0]
        assert torch.equal(padded[M_pad - 1].weight, modules[0].weight)


@pytest.mark.parametrize("impl", ["errmap", "fused", "fused_select", "pallas"])
@pytest.mark.parametrize("injected", [False, True], ids=["drawn", "injected"])
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_sharded_frames_bit_equal_single_device(world, impl, injected, mesh):
    _, ranks = world
    for r in range(WORLD):
        got, ref = ranks[r]["dense"][(impl, injected, mesh)]
        _equal(got, ref, f"rank {r}")


def test_sharded_single_frame_bit_equal_esac_infer(world):
    _, ranks = world
    for r in range(WORLD):
        got, ref = ranks[r]["single"]
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)


def test_sharded_agrees_with_jax_esac_infer_sharded(world):
    """tests/test_parallel.py:62-81's fixture: the true map at expert 3 of
    8.  JAX's sharded entry draws other hypotheses than the port's."""
    inp, ranks = world
    fx = inp["fixture"]
    mesh = _jax_mesh()
    rvec, tvec, expert, score = j_esac_infer_sharded(
        mesh, jax.random.key(7), jax.device_put(jnp.asarray(fx["coords"]),
                                                j_expert_sharding(mesh)),
        jnp.asarray(fx["pixels"]), jnp.float32(F), jnp.asarray(C), JRansacConfig(**CFG))
    assert int(expert) == 3
    for r in range(WORLD):
        p_rvec, p_tvec, p_expert, _ = ranks[r]["fixture"]
        assert int(p_expert) == 3
        r_err, t_err = _pose_err(p_rvec, p_tvec, np.asarray(rvec), np.asarray(tvec))
        assert r_err < POSE_AGREE[0] and t_err < POSE_AGREE[1]
        r_err, t_err = _pose_err(p_rvec, p_tvec, fx["frame"]["rvec"], fx["frame"]["tvec"])
        assert r_err < POSE_GT[0] and t_err < POSE_GT[1]


@pytest.mark.parametrize("case", ["overflow", "padding"])
def test_routed_semantics_match_jax(world, case):
    """tests/test_parallel.py:346 (capacity overflow drops the co-located
    lower-mass expert) and :364 (a padded expert may be selected, never
    win) on a 4-shard mesh: evaluated sets and winners equal to JAX's."""
    inp, ranks = world
    c = inp["routed"][case]
    mesh = _jax_mesh()
    maps = jnp.asarray(c["maps"])
    h, w = cases.GRID

    def apply_fn(p, images):
        return jnp.broadcast_to(p.reshape(1, h, w, 3), (images.shape[0], h, w, 3))

    stack, centers, M_pad = j_pad_experts(maps, jnp.zeros((len(maps), 3)), WORLD)
    want = j_esac_infer_routed(mesh, apply_fn, stack, centers, capacity=c["capacity"],
                               cfg=JRansacConfig(**c["cfg"]))(
        jax.random.key(3), j_pad_logits(jnp.asarray(c["logits"]), M_pad),
        jnp.zeros((1, 1, 1, 3)), jnp.full((1,), F), jnp.asarray(c["pixels"]), jnp.asarray(C))
    want_ev = np.sort(np.asarray(want["experts_evaluated"]), axis=1)
    assert int(want["expert"][0]) == c["correct"]
    for r in range(WORLD):
        got = ranks[r]["routed"][case]
        assert got["M_pad"] == M_pad
        np.testing.assert_array_equal(np.sort(got["experts_evaluated"], axis=1), want_ev)
        assert int(got["expert"][0]) == c["correct"]
        r_err, t_err = _pose_err(got["rvec"][0], got["tvec"][0], np.asarray(want["rvec"][0]),
                                 np.asarray(want["tvec"][0]))
        assert r_err < POSE_AGREE[0] and t_err < POSE_AGREE[1]
        r_err, t_err = _pose_err(got["rvec"][0], got["tvec"][0], c["frame"]["rvec"],
                                 c["frame"]["tvec"])
        assert r_err < POSE_GT[0] and t_err < POSE_GT[1]
    ev = ranks[0]["routed"][case]["experts_evaluated"][0]
    if case == "overflow":
        assert 5 in ev and 4 not in ev
    else:
        assert M_pad == 8 and {6} & set(ev.tolist())  # a pad ran, and lost


@pytest.mark.parametrize("cap", [None, 2], ids=["capacity_default", "capacity_2_drops"])
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_routed_frames_bit_equal_single_device(world, cap, mesh):
    """make_esac_infer_routed_frames_sharded against esac_infer_routed_frames
    on the capacity dispatch's selection: winners, scores, poses and the
    evaluated accounting bit for bit; at capacity 2 frame 2 loses every
    slot and reports selected[0]."""
    _, ranks = world
    for r in range(WORLD):
        got, ref = ranks[r]["routed_frames"][(cap, mesh)]
        for k in ("rvec", "tvec", "expert", "experts_evaluated"):
            assert np.array_equal(got[k], ref[k]), (r, k)
        np.testing.assert_array_equal(got["score"], ref["scores"].max(axis=(1, 2)))
    got = ranks[0]["routed_frames"][(cap, mesh)][0]
    if cap == 2:
        assert (got["experts_evaluated"][2] == 8).all() and got["expert"][2] == 0
        assert np.isfinite(got["rvec"]).all()
    else:
        assert got["expert"].tolist() == [2, 2, 2]


def test_data_parallel_dsac_batch(world):
    """tests/test_parallel.py:109: a frame batch split over a 4x1 mesh's
    data axis runs the whole kernel; each rank's frame equals its row of
    the unsharded batch and recovers the pose."""
    inp, ranks = world
    dp = inp["dp"]
    for r in range(WORLD):
        mine, full = ranks[r]["dp"]
        for k in ("rvec", "tvec"):
            assert np.array_equal(mine[k][0], full[k][r])
        r_err, t_err = _pose_err(mine["rvec"][0], mine["tvec"][0], dp["rvec"][r],
                                 dp["tvec"][r])
        assert r_err < POSE_GT[0] and t_err < POSE_GT[1]


def test_sharded_serve_fns_behind_a_dispatcher(world):
    """make_sharded_serve_fn and make_registry_sharded_serve_fn on rank 0,
    the other ranks following: each frame bit-equal to esac_infer_frames
    with its scene's principal point, one batch signature for both
    scenes, and every follower made every call."""
    _, ranks = world
    s = ranks[0]["serve"]
    for i, row in enumerate(s["plain"]):
        for k in ("rvec", "tvec", "expert", "score"):
            assert np.array_equal(row[k], s["ref"]["a"][k][i]), k
    for sid in ("a", "b"):
        for i, row in enumerate(s["registry"][sid]):
            for k in ("rvec", "tvec", "expert", "score"):
                assert np.array_equal(row[k], s["ref"][sid][k][i]), (sid, k)
    assert not np.array_equal(s["ref"]["a"]["rvec"], s["ref"]["b"]["rvec"])
    assert s["plain_signatures"] == 1 and s["registry_signatures"] == 1
    for r in range(1, WORLD):
        assert ranks[r]["serve"]["calls"] == [1, 2, 2]


def test_led_serve_fn_serializes_concurrent_callers(world):
    """Two threads call one led serve function at once on rank 0: each
    call's broadcast and collectives run whole before the other's, so every
    follower replays both calls and each thread's frames equal
    esac_infer_frames bit for bit."""
    _, ranks = world
    s = ranks[0]["serve"]
    assert sorted(i for rows, _ in s["concurrent"] for i in rows) == list(
        range(len(s["ref"]["a"]["rvec"])))
    for rows, got in s["concurrent"]:
        for k in ("rvec", "tvec", "expert", "score"):
            assert np.array_equal(got[k], s["ref"]["a"][k][rows]), k


def _registry(health=None):
    preset = ScenePreset(height=16, width=16, num_experts=2, gated=False)
    m = SceneManifest()
    m.add(SceneEntry(scene_id="s", version=1, expert_ckpt="/ck", preset=preset))
    reg = SceneRegistry(m, loader=lambda e: {"c": torch.tensor([8.0, 8.0])}, device="cpu",
                        health=health)
    reg.cache._stage = lambda entry, host: host
    return reg


def test_registry_sharded_path_rejects_route_k():
    serve = make_registry_sharded_serve_fn(None, _registry(), device="cpu")
    with pytest.raises(ManifestError, match="route_k is not supported"):
        serve({"seed": None}, "s", 2)


def test_registry_sharded_path_rides_the_breaker(monkeypatch):
    """The sharded registry path takes the breaker and probe layer of
    infer_fn(): all-NaN winners trip the scene (tests/
    test_registry_health.py:855 on the JAX package)."""
    from esac_tpu_torch.parallel import esac_sharded

    def fake_maker(mesh, cfg, device=None):
        def infer(batch, c):
            nan = torch.full((2, 3), float("nan"))
            return {"rvec": nan, "tvec": nan, "inlier_frac": torch.zeros(2)}

        infer._cache_size = lambda: 1
        return infer

    monkeypatch.setattr(esac_sharded, "make_esac_infer_sharded_frames_dynamic", fake_maker)
    reg = _registry(HealthPolicy(window=8, min_samples=4, trip_bad_frac=0.5))
    serve = make_registry_sharded_serve_fn(None, reg, device="cpu")
    tripped = False
    for _ in range(6):
        try:
            serve({}, "s")
        except SceneUnhealthyError:
            tripped = True
            break
    assert tripped, "sharded path never tripped on all-NaN winners"
    assert reg.health()["scenes"]["s@v1"]["tripped"] is not None
    assert reg.health()["scenes"]["s@v1"]["frames"] > 0


def test_dense_config_matches_jax_default():
    """The fixtures' RansacConfig knobs exist on both packages alike."""
    from esac_tpu_torch.ransac.config import RansacConfig

    for d in (CFG, dict(n_hyps=8, refine_iters=2, polish_iters=1, frame_buckets=(4,))):
        assert dataclasses.asdict(RansacConfig(**d)) == dataclasses.asdict(JRansacConfig(**d))


def test_exports_cover_the_jax_parallel_package():
    import esac_tpu.parallel as jpar

    import esac_tpu_torch.parallel as par

    assert set(jpar.__all__) <= set(par.__all__)
    assert all(callable(getattr(par, name)) for name in par.__all__)


def test_bootstrap_summary_mesh_and_backend_rules():
    """initialize_multihost's summary dict (the JAX package's keys), the
    mesh's size rule (its ValueError text) and the explicit backends:
    NCCL is refused off the card and for more ranks than cards."""
    import torch.distributed as dist

    from esac_tpu_torch.parallel import (batch_sharding, expert_sharding,
                                         initialize_multihost, make_mesh)
    from esac_tpu_torch.parallel.multihost import free_port

    with pytest.raises(ValueError, match="NCCL backend runs on the card"):
        initialize_multihost("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    info = initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo",
                                device="cpu")
    try:
        assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                        "global_devices": 1, "backend": "gloo", "device": "cpu"}
        with pytest.raises(ValueError, match=r"mesh 2x1 != device count 1"):
            make_mesh(2, 1)
        mesh = make_mesh()
        assert mesh.mesh_dim_names == ("data", "expert") and mesh.size() == 1
        x = torch.arange(12).reshape(3, 4)
        assert torch.equal(expert_sharding(mesh, x, dim=1), x)
        assert torch.equal(batch_sharding(mesh, x), x)
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
