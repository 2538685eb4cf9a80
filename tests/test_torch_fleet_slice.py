"""The fleet slice as a whole: the port's FleetRouter, host tiers and
SessionRouter against the JAX package's pieces, on the CPU.

Two scenes made by the JAX package -- the committed test-size experts
(synth0, synth1) in both orders, each with its own JAX gating net -- are
carried into the port's registry checkpoints.  The port serves them through
a ``FleetRouter`` of two CPU replicas, each a ``SceneRegistry`` with a
one-scene device budget and a bf16 ``HostWeightTier``, with a
``SessionRouter`` on top streaming one session per scene (frames with
injected correspondence sets; each scene is demoted to its replica's host
tier mid-stream, so later frames run on promoted weights).

The reference is the JAX package's pieces on the same bf16-rounded weights
(``esac_tpu.registry.compress_tree`` / ``decompress_tree``): the expert and
gating CNNs, ``_per_expert_winners(idx=)``, ``_prior_slot_winner`` on every
map, the strictly-greater prior replacement, the argmax and
``refine_soft_inliers`` (the body of ``esac_infer_prior``), with priors
planned by the JAX package's own ``SessionTable`` from its own winners.
Frame by frame: winning expert and prior hit equal, poses within 1e-4,
inlier_frac within rtol 2e-4 (the tolerances of tests/test_torch_prior.py),
the same session transitions, and the next prior slate equal (validity and
budget exactly; poses within 3e-4, the extrapolated slot doubling the
pose tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esac_tpu.data.datasets import SyntheticScene
from esac_tpu.data.synthetic import output_pixel_grid as j_pixel_grid
from esac_tpu.models import ExpertNet as JExpertNet
from esac_tpu.models import GatingNet as JGatingNet
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac.esac import _per_expert_winners as j_winners
from esac_tpu.ransac.esac import _prior_slot_winner as j_prior_slot_winner
from esac_tpu.ransac.refine import refine_soft_inliers as j_refine
from esac_tpu.registry import compress_tree as j_compress_tree
from esac_tpu.registry import decompress_tree as j_decompress_tree
from esac_tpu.serve import SessionPolicy as JSessionPolicy
from esac_tpu.serve import SessionTable as JSessionTable
from esac_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from esac_tpu_torch.fleet import FleetPolicy, FleetRouter, Replica
from esac_tpu_torch.models.convert import load_scene
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.cache import tree_nbytes
from esac_tpu_torch.registry.hosttier import HostWeightTier
from esac_tpu_torch.registry.manifest import SceneEntry, SceneManifest, ScenePreset
from esac_tpu_torch.registry.serving import (
    SceneRegistry,
    init_scene_params,
    load_scene_params,
    save_scene_params,
)
from esac_tpu_torch.serve import SessionPolicy, SessionRouter
from esac_tpu_torch.serve.slo import SLOPolicy

TH, TW, NH, M, P = 96, 128, 16, 2, 4
TN = (TH // 8) * (TW // 8)
TPRESET = ScenePreset(height=TH, width=TW, num_experts=M,
                      gating_channels=GATING_PRESETS["test"]["channels"],
                      compute_dtype="float32", **EXPERT_PRESETS["test"])
TCFG = RansacConfig(n_hyps=NH, frame_buckets=(1, 4))
# Tracked frames keep the scene's budget so the injected sets fit every
# frame; the lane is still the session's explicit (scene, None, NH) one.
SESSION = dict(prior_slots=P, track_n_hyps=NH, track_loss_frac=0.01)
FRAMES = 4  # per session


def _jax_frame(co, idx, prv, ptv, pvalid, px, f, c, cfg):
    """One frame of ``esac_infer_prior`` (every map live, score_cells = 0)
    from the reference's pieces."""
    rv, tv, best_j, best_s, _ = j_winners(jax.random.key(0), co, px, f, c, cfg, idx=idx)
    p_j, p_s = jax.vmap(lambda m: j_prior_slot_winner(jax.random.key(1), prv, ptv, pvalid, m,
                                                      px, f, c, cfg))(co)
    is_prior = p_s > best_s
    ext_s = jnp.where(is_prior, p_s, best_s)
    mi = jnp.argmax(ext_s)
    hit = is_prior[mi]
    rv0 = jnp.where(hit, prv[p_j[mi]], rv[mi, best_j[mi]])
    tv0 = jnp.where(hit, ptv[p_j[mi]], tv[mi, best_j[mi]])
    rvec, tvec = j_refine(rv0, tv0, co[mi], px, f, c, cfg.tau, cfg.beta,
                          iters=cfg.refine_iters)
    return dict(rvec=rvec, tvec=tvec, mi=mi, best=ext_s[mi], hit=hit)


@jax.jit
def _jax_scene(tree, imgs, idx, prv, ptv, pvalid):
    expert = JExpertNet(scene_center=(0.0, 0.0, 0.0), compute_dtype=jnp.float32,
                        **EXPERT_PRESETS["test"])
    coords = jax.vmap(lambda pe: expert.apply(pe, imgs))(tree["expert"])
    coords = jnp.moveaxis(coords, 0, 1).reshape(imgs.shape[0], M, -1, 3) \
        + tree["centers"][None, :, None, :]
    cfg = JRansacConfig(n_hyps=NH)
    px = j_pixel_grid(TH, TW, 8)
    return jax.vmap(functools.partial(_jax_frame, px=px, f=tree["f"], c=tree["c"], cfg=cfg))(
        coords, idx, prv, ptv, pvalid)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_slice")
    ckpts = [j_load_checkpoint(f"ckpts/ckpt_expert_synth{m}") for m in (0, 1)]
    synth = [SyntheticScene(f"synth{m}", "test", n_frames=FRAMES, height=TH, width=TW)
             for m in (0, 1)]
    gating = JGatingNet(num_experts=M, channels=GATING_PRESETS["test"]["channels"],
                        compute_dtype=jnp.float32)
    m, trees, images = SceneManifest(), {}, {}
    for name, order, key in (("s0", (0, 1), 3), ("s1", (1, 0), 4)):
        images[name] = np.stack([synth[order[0]][i].image for i in range(FRAMES)]) \
            .astype(np.float32)
        tree = {
            "expert": jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                   *[ckpts[o][0] for o in order]),
            "gating": jax.tree.map(np.asarray,
                                   gating.init(jax.random.key(key), images[name][:1])),
            "centers": np.array([ckpts[o][1]["scene_center"] for o in order], np.float32),
            "f": np.float32(synth[0].focal),
            "c": np.array([TW / 2.0, TH / 2.0], np.float32),
        }
        params = load_scene(init_scene_params(TPRESET, device="cpu"), tree)
        save_scene_params(params, TPRESET, root / name / "expert", root / name / "gating")
        m.add(SceneEntry(scene_id=name, version=1, expert_ckpt=str(root / name / "expert"),
                         gating_ckpt=str(root / name / "gating"), preset=TPRESET,
                         ransac=TCFG))
        trees[name] = j_decompress_tree(j_compress_tree(tree, "bf16"))
    return m, trees, images


def test_fleet_sessions_on_host_tiers_match_the_jax_pieces(scenes):
    manifest, trees, images = scenes
    scene_bytes = tree_nbytes(load_scene_params(manifest.resolve("s0")))
    regs = [SceneRegistry(manifest, budget_bytes=scene_bytes, device="cpu",
                          host_tier=HostWeightTier(budget_bytes=3 * scene_bytes,
                                                   compression="bf16"))
            for _ in range(2)]
    reps = [Replica(f"r{i}", reg.dispatcher(TCFG, slo=SLOPolicy(watchdog_ms=120_000.0)),
                    registry=reg) for i, reg in enumerate(regs)]
    router = FleetRouter(reps, FleetPolicy(poll_ms=2.0))
    sessions = SessionRouter(router, SessionPolicy(**SESSION))
    jtable = JSessionTable(JSessionPolicy(**SESSION))
    idx = np.random.default_rng(5).integers(0, TN, (2, FRAMES, M, NH, 4))
    checked = {"tracked": 0, "hits": 0}
    try:
        for s, name in enumerate(("s0", "s1")):
            sessions.open(name, scene=name, full_n_hyps=NH)
            jtable.open(name, scene=name, full_n_hyps=NH)
        for i in range(FRAMES):
            for s, name in enumerate(("s0", "s1")):
                if i == 2:  # push the scene down to its home's host tier
                    home = router.scene_homes()[name][0]
                    assert regs[int(home[1])].cache.demote((name, 1))
                frame = {"image": images[name][i], "seed": np.int64(10 * s + i),
                         "idx": idx[s, i]}
                got = sessions.infer_frame(name, frame, timeout=120.0)
                _, _, n_hyps, prv, ptv, pvalid, tracked = jtable.plan(name)
                assert n_hyps == NH and tracked == got["session_tracked"], (name, i)
                w = _jax_scene(trees[name], images[name][i:i + 1], idx[s, i][None],
                               prv[None], ptv[None], pvalid[None])
                w = {k: np.asarray(v[0]) for k, v in w.items()}
                assert int(got["expert"]) == int(w["mi"]), (name, i)
                assert bool(got["prior_hit"]) == bool(w["hit"]), (name, i)
                np.testing.assert_allclose(got["rvec"], w["rvec"], atol=1e-4)
                np.testing.assert_allclose(got["tvec"], w["tvec"], atol=1e-4)
                np.testing.assert_allclose(got["inlier_frac"], float(w["best"]) / TN,
                                           rtol=2e-4)
                transition = jtable.observe(name, w["rvec"], w["tvec"],
                                            float(w["best"]) / TN, tracked)
                assert transition == got["session_transition"], (name, i)
                # The next prior slate, planned by each package's table.
                ours = sessions.table.plan(name)
                ref = jtable.plan(name)
                assert ours[2] == ref[2] and np.array_equal(ours[5], ref[5]), (name, i)
                np.testing.assert_allclose(ours[3], ref[3], atol=3e-4)
                np.testing.assert_allclose(ours[4], ref[4], atol=3e-4)
                checked["tracked"] += bool(tracked)
                checked["hits"] += bool(w["hit"])
    finally:
        router.close()
    assert checked["tracked"] >= 4  # tracked frames rode the prior lane
    homes = router.scene_homes()
    assert sorted(h for hs in homes.values() for h in hs) == ["r0", "r1"]
    for reg in regs:  # one disk load, then a host-tier promote, per replica
        st = reg.cache.stats()
        assert st["disk_loads"] == 1 and st["host_hits"] == 1 and st["demotions"] == 1
    t = router.fleet_totals()
    assert t["offered"] == t["served"] == 2 * FRAMES
    assert router.affinity_stats()["affinity"] == 2 * FRAMES - 2
