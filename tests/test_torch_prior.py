"""The session prior slot: the port against the JAX package.

``esac_infer_frames_prior`` and ``esac_infer_routed_frames_prior`` are held
against JAX compositions of the reference's own pieces with the same
correspondence sets injected: ``_per_expert_winners(idx=)``, the
reference's ``_prior_slot_winner`` called directly on every (live) map, the
strictly-greater replacement, the argmax and ``refine_soft_inliers`` -- the
bodies of ``esac_infer_prior`` and ``_routed_frame_winner_prior``.  Both
sides float32, ``score_cells=0``; hit, slot and expert exactly, the pose to
1e-4, inlier_frac to 2e-4 relative.  On the CPU the port's own contracts:
an all-invalid slate gives the plain entry's result bit for bit (dense,
routed, both bucket functions), and the priors score on the sampled
stream's own cell subsample.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.data.datasets import SyntheticScene
from esac_tpu.data.synthetic import output_pixel_grid as j_pixel_grid
from esac_tpu.models import GatingNet as JGatingNet
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac.esac import _per_expert_winners as j_winners
from esac_tpu.ransac.esac import _prior_slot_winner as j_prior_slot_winner
from esac_tpu.ransac.refine import refine_soft_inliers as j_refine
from esac_tpu.utils.checkpoint import load_checkpoint
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.models.convert import load_scene
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.ransac import esac as t_esac
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import frame_generators
from esac_tpu_torch.ransac.scoring import subsample_cells
from esac_tpu_torch.registry.manifest import ScenePreset
from esac_tpu_torch.registry.serving import (
    init_scene_params,
    make_routed_scene_bucket_fn,
    make_scene_bucket_fn,
)

H, W, NH, M, P = 96, 128, 16, 3, 4
N = (H // 8) * (W // 8)
PRESET = ScenePreset(height=H, width=W, num_experts=M,
                     gating_channels=GATING_PRESETS["test"]["channels"],
                     compute_dtype="float32", **EXPERT_PRESETS["test"])


def _jax_frame_prior(co, live, idx, prv, ptv, pvalid, px, f, c, cfg):
    """One frame of ``_routed_frame_winner_prior`` (``esac_infer_prior``
    where every slot is live) from the reference's pieces."""
    k_sub = jax.random.key(1)  # score_cells = 0: no subsample is drawn
    rv, tv, best_j, best_s, _ = j_winners(jax.random.key(0), co, px, f, c, cfg, idx=idx)
    best_s = jnp.where(live, best_s, -jnp.inf)
    p_j, p_s = jax.vmap(lambda m: j_prior_slot_winner(k_sub, prv, ptv, pvalid, m, px, f, c,
                                                      cfg))(co)
    p_s = jnp.where(live, p_s, -jnp.inf)
    is_prior = p_s > best_s
    ext_s = jnp.where(is_prior, p_s, best_s)
    mi = jnp.argmax(ext_s)
    hit = is_prior[mi]
    j = jnp.where(live[mi], best_j[mi], 0)
    rv0 = jnp.where(hit, prv[p_j[mi]], rv[mi, j])
    tv0 = jnp.where(hit, ptv[p_j[mi]], tv[mi, j])
    rvec, tvec = j_refine(rv0, tv0, co[mi], px, f, c, cfg.tau, cfg.beta,
                          iters=cfg.refine_iters)
    return dict(rvec=rvec, tvec=tvec, mi=mi, best=ext_s[mi], hit=hit,
                slot=jnp.where(hit, p_j[mi], prv.shape[0]))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_frames_prior(co, live, idx, prv, ptv, pvalid, px, f, c, cfg):
    return jax.vmap(lambda *a: _jax_frame_prior(*a, px, f, c, cfg))(
        co, live, idx, prv, ptv, pvalid)


@pytest.fixture(scope="module")
def frames():
    """Four synthetic frames, M maps each: map (b % M) the true coordinates
    with 1 cm noise, the others scrambled decoys.  Prior slates: frame 0's
    slot 2 its GT pose (valid; slot 1 the same pose, invalid), frame 1 a
    valid decoy pose only, frame 2 all invalid, frame 3 its GT pose in
    slot 0."""
    sc = SyntheticScene("synth1", "test", n_frames=4, height=H, width=W)
    rng = np.random.default_rng(23)
    coords, prv, ptv = [], np.zeros((4, P, 3), np.float32), np.zeros((4, P, 3), np.float32)
    for b in range(4):
        X = sc[b].coords_gt.reshape(-1, 3)
        maps = [X[rng.permutation(N)] + rng.uniform(-0.5, 0.5, 3) for _ in range(M)]
        maps[b % M] = X + rng.normal(0, 0.01, X.shape)
        coords.append(maps)
        prv[b] = rng.uniform(-0.3, 0.3, (P, 3))
        ptv[b] = rng.uniform(-1, 1, (P, 3))
    valid = np.zeros((4, P), bool)
    for b, slots in ((0, (1, 2)), (3, (0,))):
        prv[b, list(slots)], ptv[b, list(slots)] = sc[b].rvec, sc[b].tvec
    valid[0, 2] = valid[1, 0] = valid[3, 0] = True
    return dict(coords=np.array(coords, np.float32), f=np.float32(sc.focal),
                c=np.array([W / 2, H / 2], np.float32), prv=prv, ptv=ptv, valid=valid,
                idx=rng.integers(0, N, (4, M, NH * M // 2, 4)).astype(np.int32),
                logits=rng.normal(size=(4, M)).astype(np.float32))


def _args(fr):
    return output_pixel_grid(H, W), fr["f"], fr["c"]


def _assert_prior_parity(got, want, sel):
    assert got["prior_hit"].tolist() == np.asarray(want["hit"]).tolist()
    assert got["prior_slot"].tolist() == np.asarray(want["slot"]).tolist()
    np.testing.assert_array_equal(got["expert"].numpy(),
                                  np.take_along_axis(sel, np.asarray(want["mi"])[:, None],
                                                     1)[:, 0])
    np.testing.assert_allclose(got["rvec"].numpy(), want["rvec"], atol=1e-4)
    np.testing.assert_allclose(got["tvec"].numpy(), want["tvec"], atol=1e-4)
    np.testing.assert_allclose(got["inlier_frac"].numpy(), np.asarray(want["best"]) / N,
                               rtol=2e-4)


@pytest.mark.parametrize("impl", ["errmap", "pallas"])
def test_prior_entry_matches_jax(frames, impl):
    """The dense prior entry: GT priors win their frames (0 and 3), the
    invalid GT copy of frame 0 does not, a valid decoy and an all-invalid
    slate leave the sampled stream the winner."""
    fr = frames
    idx = fr["idx"][:, :, :NH]
    want = _jax_frames_prior(fr["coords"], np.ones((4, M), bool), idx, fr["prv"], fr["ptv"],
                             fr["valid"], j_pixel_grid(H, W, 8), fr["f"], fr["c"],
                             JRansacConfig(n_hyps=NH))
    got = t_esac.esac_infer_frames_prior(
        frame_generators(range(4), "cpu"), fr["logits"], fr["coords"], *_args(fr), fr["prv"],
        fr["ptv"], fr["valid"], RansacConfig(n_hyps=NH, scoring_impl=impl), idx=idx,
        device="cpu")
    assert got["prior_hit"].tolist() == [True, False, False, True]
    assert got["prior_slot"].tolist() == [2, P, P, 0]
    _assert_prior_parity(got, want, np.tile(np.arange(M), (4, 1)))
    one = t_esac.esac_infer_prior(
        frame_generators([3], "cpu")[0], fr["logits"][3], fr["coords"][3], *_args(fr),
        fr["prv"][3], fr["ptv"][3], fr["valid"][3], RansacConfig(n_hyps=NH, scoring_impl=impl),
        idx=idx[3], device="cpu")
    # A batch of one rounds differently (a near-degenerate set may even
    # take another P3P branch), so the winner's outputs are compared.
    for key in ("rvec", "tvec", "expert", "inlier_frac", "prior_hit", "prior_slot"):
        torch.testing.assert_close(one[key], got[key][3], msg=key)


def test_routed_prior_entry_matches_jax(frames):
    """The routed prior entry with a dropped slot: priors score on live
    slots only (frame 0's GT prior rides a dropped slot and loses it)."""
    fr = frames
    sel = np.array([[0, 1], [1, 2], [0, 2], [0, 1]])
    kept = np.array([[False, True], [True, True], [True, False], [True, True]])
    co_sel = np.take_along_axis(fr["coords"], sel[..., None, None], axis=1)
    idx = np.take_along_axis(fr["idx"], sel[..., None, None], axis=1)
    want = _jax_frames_prior(co_sel, kept, idx, fr["prv"], fr["ptv"], fr["valid"],
                             j_pixel_grid(H, W, 8), fr["f"], fr["c"], JRansacConfig(n_hyps=NH))
    got = t_esac.esac_infer_routed_frames_prior(
        frame_generators(range(4), "cpu"), fr["logits"], co_sel, sel, kept, *_args(fr),
        fr["prv"], fr["ptv"], fr["valid"], RansacConfig(n_hyps=NH), idx=idx, device="cpu")
    assert got["prior_hit"].tolist() == [False, False, False, True]
    _assert_prior_parity(got, want, sel)
    np.testing.assert_array_equal(got["experts_evaluated"].numpy(), np.where(kept, sel, M))


@pytest.mark.parametrize("impl", ["errmap", "pallas", "fused_select"])
def test_all_invalid_prior_is_the_plain_entry(frames, impl):
    """With an all-invalid slate every prior scores -inf: selection and the
    refine's inputs are the plain entry's, so every output is bit-equal,
    dense and routed (with a dropped slot), and prior_slot is P."""
    fr = frames
    cfg = RansacConfig(n_hyps=NH, scoring_impl=impl, score_cells=100)
    none = np.zeros((4, P), bool)
    dense = t_esac.esac_infer_frames(frame_generators(range(4), "cpu"), fr["logits"],
                                     fr["coords"], *_args(fr), cfg, device="cpu")
    prior = t_esac.esac_infer_frames_prior(
        frame_generators(range(4), "cpu"), fr["logits"], fr["coords"], *_args(fr), fr["prv"],
        fr["ptv"], none, cfg, device="cpu")
    sel = np.array([[0, 1], [1, 2], [0, 2], [0, 1]])
    kept = np.array([[False, False], [True, True], [True, False], [True, True]])
    co_sel = np.take_along_axis(fr["coords"], sel[..., None, None], axis=1)
    routed = t_esac.esac_infer_routed_frames(frame_generators(range(4), "cpu"), fr["logits"],
                                             co_sel, sel, kept, *_args(fr), cfg, device="cpu")
    routed_prior = t_esac.esac_infer_routed_frames_prior(
        frame_generators(range(4), "cpu"), fr["logits"], co_sel, sel, kept, *_args(fr),
        fr["prv"], fr["ptv"], none, cfg, device="cpu")
    for plain, got in ((dense, prior), (routed, routed_prior)):
        for key, v in plain.items():
            assert torch.equal(v, got[key]), key
        assert not got["prior_hit"].any() and (got["prior_slot"] == P).all()


@pytest.mark.parametrize("impl", ["pallas", "fused_select"])
def test_priors_score_on_the_sampled_streams_subsample(frames, impl):
    """One subsample for the priors and the sampled stream (score_cells
    > 0): a prior equal to an expert's streamed winner scores within 1e-5
    of that winner's score; the same prior on a second draw of cells lands
    far off (40% of each true map's cells are outliers here, so the
    inliers among 60 drawn cells vary by draw)."""
    fr = frames
    cfg = RansacConfig(n_hyps=NH, scoring_impl=impl, score_cells=60)
    coords = torch.from_numpy(fr["coords"]).clone()
    rng = np.random.default_rng(2)
    for b in range(4):
        out = torch.from_numpy(rng.permutation(N)[: 2 * N // 5])
        coords[b, b % M, out] = torch.from_numpy(rng.uniform(0, 4, (len(out), 3))).float()
    px = output_pixel_grid(H, W)
    f, c = torch.full((4,), float(fr["f"])), torch.from_numpy(fr["c"])
    gens = frame_generators(range(4), "cpu")
    rv, tv, best_j, best_s, _, cells = t_esac._per_expert_winners(gens, coords, px, f, c, cfg)
    b = torch.arange(4)
    m = torch.argmax(best_s, dim=1)
    prv, ptv = rv[b, m, best_j[b, m]][:, None], tv[b, m, best_j[b, m]][:, None]
    valid = torch.ones((4, 1), dtype=torch.bool)
    fBM = f[:, None].expand(4, M)
    _, ps = t_esac._prior_slot_winner(prv, ptv, valid, cells, fBM, c, cfg)
    torch.testing.assert_close(ps[b, m], best_s[b, m], rtol=1e-5, atol=0)
    other = subsample_cells(gens, coords, px, cfg.score_cells)  # the generators' next draw
    _, ps2 = t_esac._prior_slot_winner(prv, ptv, valid, other, fBM, c, cfg)
    assert ((ps2[b, m] - best_s[b, m]).abs() / best_s[b, m]).max() > 1e-3
    # Through the entry: the winner's own pose as a prior cannot beat it by
    # more than rounding, and the frame's expert and inlier_frac stay.
    plain = t_esac.esac_infer_frames(frame_generators(range(4), "cpu"), fr["logits"], coords,
                                     px, f, c, cfg, device="cpu")
    got = t_esac.esac_infer_frames_prior(frame_generators(range(4), "cpu"), fr["logits"],
                                         coords, px, f, c, prv, ptv, valid, cfg, device="cpu")
    assert torch.equal(got["expert"], plain["expert"])
    torch.testing.assert_close(got["inlier_frac"], plain["inlier_frac"], rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def scene():
    ckpts = [load_checkpoint(f"ckpts/ckpt_expert_synth{m}") for m in (0, 1, 0)]
    centers = np.array([c["scene_center"] for _, c in ckpts], np.float32)
    centers[2] += 0.5
    sc = SyntheticScene("synth0", "test", n_frames=4, height=H, width=W)
    images = np.stack([sc[i].image for i in range(4)]).astype(np.float32)
    gating = JGatingNet(num_experts=M, channels=GATING_PRESETS["test"]["channels"],
                        compute_dtype=jnp.float32)
    tree = {
        "expert": jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                               *[p for p, _ in ckpts]),
        "gating": jax.tree.map(np.asarray, gating.init(jax.random.key(3), images[:1])),
        "centers": centers, "f": np.float32(sc.focal),
        "c": np.array([W / 2.0, H / 2.0], np.float32),
    }
    return dict(images=images,
                params=load_scene(init_scene_params(PRESET, device="cpu"), tree))


@pytest.mark.parametrize("routed", [False, True])
def test_bucket_fns_serve_prior_batches(scene, routed):
    """A session lane's batch (prior leaves) through the dense and the
    routed (k = 2) bucket function: an all-invalid slate equals the plain
    batch bit for bit; a slate holding each frame's refined pose from the
    plain dispatch (a tracked frame's motion prior) wins its frame against
    4 sampled hypotheses a map, in the slot it was put in."""
    cfg = RansacConfig(n_hyps=4, scoring_impl="pallas")
    fn = (make_routed_scene_bucket_fn(PRESET, cfg, 2, device="cpu") if routed
          else make_scene_bucket_fn(PRESET, cfg, device="cpu"))
    plain = {"image": scene["images"], "seed": np.arange(4)}
    want = fn(scene["params"], plain)
    rng = np.random.default_rng(4)
    prv = rng.uniform(-0.3, 0.3, (4, P, 3)).astype(np.float32)
    ptv = rng.uniform(-1, 1, (4, P, 3)).astype(np.float32)
    got = fn(scene["params"], dict(plain, prior_rvec=prv, prior_tvec=ptv,
                                   prior_valid=np.zeros((4, P), bool)))
    for key, v in want.items():
        assert torch.equal(v, got[key]), key
    prv[:, 3], ptv[:, 3] = want["rvec"].numpy(), want["tvec"].numpy()
    valid = np.zeros((4, P), bool)
    valid[:, [0, 3]] = True
    hit = fn(scene["params"], dict(plain, prior_rvec=prv, prior_tvec=ptv, prior_valid=valid))
    assert hit["prior_hit"].all() and (hit["prior_slot"] == 3).all()
    assert (hit["inlier_frac"] > want["inlier_frac"]).all()
