"""Top-k and gating-first routed serving: the port against the JAX package.

The pure routing pieces (``select_topk_experts``, ``routed_serve_capacity``,
``route_frames_to_experts``) are held exactly equal.  The entries
(``esac_infer_topk_frames``, ``esac_infer_routed_frames``) and the routed
bucket function are held against JAX compositions of the reference's own
pieces with the same correspondence sets injected (the reference entries
draw their own): ``_per_expert_winners(idx=)`` over the gathered maps, the
slot-level ``-inf`` masking, the argmax with the all-dropped pin, and
``refine_soft_inliers`` -- the body of ``_routed_frame_winner``.  Both
sides run float32 with ``score_cells=0``; winners and evaluated sets
exactly, the refined pose to 1e-4 and inlier_frac to 2e-4 relative
(tests/test_torch_esac.py says why).  The port's own bit contracts are held
on the CPU: routed K = M equals dense, results across frame buckets, the
all-dropped failure output and overflow accounting.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.data.datasets import SyntheticScene
from esac_tpu.data.synthetic import output_pixel_grid as j_pixel_grid
from esac_tpu.models import ExpertNet as JExpertNet
from esac_tpu.models import GatingNet as JGatingNet
from esac_tpu.parallel.esac_sharded import route_frames_to_experts as j_route
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac.esac import _per_expert_winners as j_winners
from esac_tpu.ransac.esac import routed_serve_capacity as j_capacity
from esac_tpu.ransac.esac import select_topk_experts as j_select
from esac_tpu.ransac.refine import refine_soft_inliers as j_refine
from esac_tpu.utils.checkpoint import load_checkpoint
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.models.convert import load_scene
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.parallel.esac_sharded import route_frames_to_experts
from esac_tpu_torch.ransac import esac as t_esac
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import frame_generators, generate_hypotheses
from esac_tpu_torch.ransac.refine import refine_soft_inliers
from esac_tpu_torch.registry.manifest import ManifestError, ScenePreset
from esac_tpu_torch.registry.serving import (
    init_scene_params,
    make_routed_scene_bucket_fn,
    make_scene_bucket_fn,
)
from esac_tpu_torch.serve import batching as t_batching

H, W, NH = 96, 128, 16
N = (H // 8) * (W // 8)
# Three experts from the two committed test-size checkpoints: expert 2 is
# expert 0's network with its scene centre moved 0.5 m, so K = 2 of 3 routes.
M, K = 3, 2
NH_K = NH * M // K  # hypotheses a routed slot
PRESET = ScenePreset(height=H, width=W, num_experts=M,
                     gating_channels=GATING_PRESETS["test"]["channels"],
                     compute_dtype="float32", **EXPERT_PRESETS["test"])


def _jax_frame_winner(co_sel, live, idx, px, f, c, cfg):
    """One frame of the routed hypothesis loop from the reference's pieces
    (``_routed_frame_winner`` with ``idx`` injected)."""
    rv, tv, best_j, best_s, scores = j_winners(jax.random.key(0), co_sel, px, f, c, cfg,
                                               idx=idx)
    best_s = jnp.where(live, best_s, -jnp.inf)
    mi = jnp.argmax(best_s)
    j = jnp.where(live[mi], best_j[mi], 0)
    rvec, tvec = j_refine(rv[mi, j], tv[mi, j], co_sel[mi], px, f, c, cfg.tau, cfg.beta,
                          iters=cfg.refine_iters)
    return dict(rvec=rvec, tvec=tvec, mi=mi, best=best_s[mi],
                scores=jnp.where(live[:, None], scores, -jnp.inf))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_frames(co_sel, live, idx, px, f, c, cfg):
    return jax.vmap(lambda co, lv, ix: _jax_frame_winner(co, lv, ix, px, f, c, cfg))(
        co_sel, live, idx)


# ------------------------------------------------------- routing pieces


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_select_topk_experts_matches_jax(k):
    """Ascending top-k ids, equal to the reference's on random logits, on
    integer logits full of ties and on the all-zero logits of an ungated
    preset (ties go to the lower index)."""
    rng = np.random.default_rng(k)
    for logits in (rng.normal(size=(6, 7)), rng.integers(-2, 3, (6, 7)),
                   np.zeros((6, 7))):
        logits = logits.astype(np.float32)
        got = t_esac.select_topk_experts(torch.from_numpy(logits), k)
        want = np.asarray(j_select(jnp.asarray(logits), k))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int64
    zeros = t_esac.select_topk_experts(torch.zeros(2, 7), k)
    assert zeros.tolist() == [list(range(k))] * 2


def test_routed_serve_capacity_matches_jax():
    """The cases of tests/test_serve_routed.py, then a grid of (buckets,
    capacity, k, M) against the reference rule."""
    cfg = RansacConfig(frame_buckets=(1, 4, 16))
    assert t_esac.routed_serve_capacity(cfg, 2, 8) == 8
    assert t_esac.routed_serve_capacity(cfg, 1, 16) == 2
    assert t_esac.routed_serve_capacity(cfg, 16, 16) == 16
    assert t_esac.routed_serve_capacity(dataclasses.replace(cfg, serve_capacity=5), 2, 8) == 5
    assert t_esac.routed_serve_capacity(dataclasses.replace(cfg, serve_capacity=1), 2, 8) == 2
    assert t_esac.routed_serve_capacity(cfg, 2, 8) == t_esac.routed_serve_capacity(
        dataclasses.replace(cfg, serve_max_wait_ms=99.0), 2, 8)
    assert t_esac.routed_serve_capacity(RansacConfig(), 2, 7) == 37  # 7 x 37 CNN images
    for buckets in ((1, 4, 16, 64), (1,), (2, 8), (3, 5)):
        for cap in (0, 1, 3, 100):
            for m in (1, 3, 7, 50):
                for k in range(1, m + 1, max(1, m // 4)):
                    ours = RansacConfig(frame_buckets=buckets, serve_capacity=cap)
                    ref = JRansacConfig(frame_buckets=buckets, serve_capacity=cap)
                    assert t_esac.routed_serve_capacity(ours, k, m) == j_capacity(ref, k, m)


def _random_selection(rng, B, k, m):
    return np.sort(np.stack([rng.permutation(m)[:k] for _ in range(B)]), axis=-1)


@pytest.mark.parametrize("B,k,m,cap", [(4, 2, 4, 2), (9, 2, 7, 3), (16, 3, 5, 4),
                                       (7, 1, 3, 2), (6, 4, 4, 6)])
def test_route_frames_to_experts_matches_jax(B, k, m, cap):
    rng = np.random.default_rng(B * 100 + k)
    for _ in range(3):
        sel = _random_selection(rng, B, k, m)
        got = route_frames_to_experts(torch.from_numpy(sel), m, cap)
        want = j_route(jnp.asarray(sel, jnp.int32), m, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        kept, pos, slot_frame, slot_valid = got
        assert int(slot_valid.sum(1).max()) <= cap
        # every kept pair sits in its expert's block at its slot
        for b, j in zip(*np.nonzero(kept.numpy())):
            assert int(slot_frame[sel[b, j], pos[b, j]]) == b


def test_route_frames_capacity_and_priority():
    """The reference's worked case: frame-index drop priority."""
    sel = torch.tensor([[0, 2], [0, 1], [0, 2], [2, 3]])
    kept, pos, slot_frame, slot_valid = route_frames_to_experts(sel, 4, 2)
    assert kept.tolist() == [[True, True], [True, True], [False, True], [False, True]]
    assert slot_frame[0].tolist() == [0, 1] and slot_frame[2].tolist() == [0, 2]
    assert slot_valid[1].tolist() == [True, False] and slot_valid[3].tolist() == [True, False]


def test_route_later_frames_never_displace_earlier():
    """Appending frames (tail padding appends pads) changes no earlier
    frame's kept/pos: the bucket-invariance prerequisite."""
    rng = np.random.default_rng(3)
    sel = torch.from_numpy(_random_selection(rng, 6, 2, 4))
    kept, pos, _, _ = route_frames_to_experts(sel, 4, 2)
    for extra in (sel[:2], sel[-1:].repeat(5, 1)):
        kept2, pos2, _, _ = route_frames_to_experts(torch.cat([sel, extra]), 4, 2)
        assert torch.equal(kept2[:6], kept) and torch.equal(pos2[:6], pos)


# ----------------------------------------------------- entries on coords


@pytest.fixture(scope="module")
def synth():
    return SyntheticScene("synth0", "test", n_frames=4, height=H, width=W)


@pytest.fixture(scope="module")
def frames(synth):
    """Four synthetic frames: M maps each, map (b % M) their true
    coordinates plus 1 cm noise, the others decoys (scrambled and offset);
    a routed selection with drops, and injected sets (every JAX
    composition of this module runs at one shape, so it compiles once)."""
    rng = np.random.default_rng(11)
    coords = []
    for b in range(4):
        X = synth[b].coords_gt.reshape(-1, 3)
        maps = [X[rng.permutation(N)] + rng.uniform(-0.5, 0.5, 3) for _ in range(M)]
        maps[b % M] = X + rng.normal(0, 0.01, X.shape)
        coords.append(maps)
    return dict(coords=np.array(coords, np.float32),
                logits=rng.normal(size=(4, M)).astype(np.float32),
                f=np.float32(synth.focal), c=np.array([W / 2, H / 2], np.float32),
                idx=rng.integers(0, N, (4, M, NH_K, 4)).astype(np.int32),
                sel=np.array([[0, 1], [1, 2], [0, 2], [1, 2]]),
                kept=np.array([[True, True], [True, False], [False, True], [True, True]]))


def _gather(x, sel):
    return np.take_along_axis(x, sel.reshape(sel.shape + (1,) * (x.ndim - 2)), axis=1)


def _jax_routed(fr, sel, kept, idx, cfg):
    co_sel = _gather(fr["coords"], sel)
    return _jax_frames(co_sel, kept, idx, j_pixel_grid(H, W, 8), fr["f"], fr["c"], cfg)


def _assert_winner_parity(got, want, sel):
    np.testing.assert_array_equal(got["expert"].numpy(),
                                  np.take_along_axis(sel, np.asarray(want["mi"])[:, None],
                                                     1)[:, 0])
    np.testing.assert_allclose(got["rvec"].numpy(), want["rvec"], atol=1e-4)
    np.testing.assert_allclose(got["tvec"].numpy(), want["tvec"], atol=1e-4)
    live = np.isfinite(np.asarray(want["best"]))
    np.testing.assert_array_equal(np.isfinite(got["inlier_frac"].numpy()), live)
    np.testing.assert_allclose(got["inlier_frac"].numpy()[live],
                               np.asarray(want["best"])[live] / N, rtol=2e-4)


def test_routed_entry_matches_jax(frames):
    """esac_infer_routed_frames with capacity drops against the reference's
    routed frame body: nh = n_hyps * M // K hypotheses a slot, dropped
    slots -inf in the scores and the sentinel M in experts_evaluated."""
    fr = frames
    idx = _gather(fr["idx"], fr["sel"])
    want = _jax_routed(fr, fr["sel"], fr["kept"], idx, JRansacConfig(n_hyps=NH))
    got = t_esac.esac_infer_routed_frames(
        frame_generators(range(4), "cpu"), fr["logits"], _gather(fr["coords"], fr["sel"]),
        fr["sel"], fr["kept"], output_pixel_grid(H, W), fr["f"], fr["c"],
        RansacConfig(n_hyps=NH), idx=idx, device="cpu")
    _assert_winner_parity(got, want, fr["sel"])
    assert got["scores"].shape == (4, K, NH_K)
    np.testing.assert_array_equal(np.isneginf(got["scores"].numpy()),
                                  np.isneginf(np.asarray(want["scores"])))
    np.testing.assert_array_equal(got["experts_evaluated"].numpy(),
                                  np.where(fr["kept"], fr["sel"], M))
    np.testing.assert_allclose(got["gating_probs"].numpy(),
                               jax.nn.softmax(fr["logits"], axis=-1), atol=1e-6)


def test_topk_entry_matches_jax(frames):
    """esac_infer_topk_frames: the dense path over the k maps of the largest
    logits, in jax.lax.top_k's order, with the global expert index back."""
    fr, k = frames, K
    logits = fr["logits"].copy()
    logits[1] = [0.5, 0.5, 0.5]  # a frame of ties: the lower indices win
    top = np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1])
    idx = fr["idx"][:, :k]  # n_hyps = NH_K here: the JAX side's shapes stay
    want = _jax_routed(fr, top, np.ones((4, k), bool), idx, JRansacConfig(n_hyps=NH))
    got = t_esac.esac_infer_topk_frames(
        frame_generators(range(4), "cpu"), logits, fr["coords"], output_pixel_grid(H, W),
        fr["f"], fr["c"], RansacConfig(n_hyps=NH_K), k=k, idx=idx, device="cpu")
    np.testing.assert_array_equal(got["experts_evaluated"].numpy(), top)
    assert got["experts_evaluated"][1].tolist() == [0, 1]
    _assert_winner_parity(got, want, top)
    np.testing.assert_allclose(got["gating_probs"].numpy(),
                               jax.nn.softmax(logits, axis=-1), atol=1e-6)
    one = t_esac.esac_infer_topk(
        frame_generators([2], "cpu")[0], logits[2], fr["coords"][2], output_pixel_grid(H, W),
        fr["f"], fr["c"], RansacConfig(n_hyps=NH_K), k=k, idx=idx[2], device="cpu")
    # A batch of one rounds differently: the winner's outputs are compared.
    for key in ("rvec", "tvec", "expert", "inlier_frac", "experts_evaluated"):
        torch.testing.assert_close(one[key], got[key][2], msg=key)


@pytest.mark.parametrize("impl", ["errmap", "pallas", "fused_select"])
@pytest.mark.parametrize("score_cells", [0, 50])
def test_routed_k_eq_m_is_dense(frames, impl, score_cells):
    """Routed at K = M with nothing dropped is esac_infer_frames bit for bit:
    the generators draw (M, n_hyps, 4) either way and the selection is the
    identity, so every hypothesis, subsample and score is the same."""
    fr = frames
    cfg = RansacConfig(n_hyps=NH, scoring_impl=impl, score_cells=score_cells)
    args = (output_pixel_grid(H, W), fr["f"], fr["c"])
    dense = t_esac.esac_infer_frames(frame_generators(range(4, 8), "cpu"), fr["logits"],
                                     fr["coords"], *args, cfg, device="cpu")
    routed = t_esac.esac_infer_routed_frames(
        frame_generators(range(4, 8), "cpu"), fr["logits"], fr["coords"],
        np.tile(np.arange(M), (4, 1)), np.ones((4, M), bool), *args, cfg, device="cpu")
    for key, v in dense.items():
        assert torch.equal(v, routed[key]), key
    assert routed["experts_evaluated"].tolist() == [list(range(M))] * 4


def test_routed_all_dropped_frame_pins_slot_0_hypothesis_0(frames):
    """A frame whose every pair dropped refines hypothesis 0 of slot 0 (the
    reference's flat-argmax failure output): finite pose, -inf score, every
    slot the sentinel M, under both kernels' plain versions."""
    fr = frames
    kept = fr["kept"].copy()
    kept[0] = False
    idx = _gather(fr["idx"], fr["sel"])
    co_sel = torch.from_numpy(_gather(fr["coords"], fr["sel"]))
    px = output_pixel_grid(H, W)
    for impl in ("pallas", "fused_select"):
        cfg = RansacConfig(n_hyps=NH, scoring_impl=impl)
        got = t_esac.esac_infer_routed_frames(
            frame_generators(range(4), "cpu"), fr["logits"], co_sel, fr["sel"], kept, px,
            fr["f"], fr["c"], cfg, idx=idx, device="cpu")
        rv, tv = generate_hypotheses(None, co_sel[0, 0], px, torch.tensor(fr["f"]),
                                     torch.from_numpy(fr["c"]),
                                     dataclasses.replace(cfg, n_hyps=idx.shape[2]),
                                     idx=torch.from_numpy(idx[0, 0]))
        want = refine_soft_inliers(rv[0], tv[0], co_sel[0, 0], px, torch.tensor(fr["f"]),
                                   torch.from_numpy(fr["c"]), cfg.tau, cfg.beta,
                                   iters=cfg.refine_iters)
        # the same hypothesis, solved and refined in a batch of one here
        torch.testing.assert_close(got["rvec"][0], want[0], rtol=0, atol=1e-5)
        torch.testing.assert_close(got["tvec"][0], want[1], rtol=0, atol=1e-5)
        assert int(got["expert"][0]) == fr["sel"][0, 0]
        assert got["experts_evaluated"][0].tolist() == [M, M]
        assert bool(torch.isneginf(got["inlier_frac"][0]))
        key = "scores" if impl == "pallas" else "score"
        assert bool(torch.isneginf(got[key][0]).all())


# ------------------------------------------------- the routed bucket fn


@pytest.fixture(scope="module")
def scene(synth):
    ckpts = [load_checkpoint(f"ckpts/ckpt_expert_synth{m}") for m in (0, 1, 0)]
    centers = np.array([c["scene_center"] for _, c in ckpts], np.float32)
    centers[2] += 0.5
    other = SyntheticScene("synth1", "test", n_frames=4, height=H, width=W)
    images = np.stack([(synth, other)[i % 2][i].image for i in range(4)]).astype(np.float32)
    gating = JGatingNet(num_experts=M, channels=GATING_PRESETS["test"]["channels"],
                        compute_dtype=jnp.float32)
    tree = {
        "expert": jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                               *[p for p, _ in ckpts]),
        "gating": jax.tree.map(np.asarray, gating.init(jax.random.key(3), images[:1])),
        "centers": centers,
        "f": np.float32(synth.focal),
        "c": np.array([W / 2.0, H / 2.0], np.float32),
    }
    params = load_scene(init_scene_params(PRESET, device="cpu"), tree)
    return dict(tree=tree, images=images, gating=gating, params=params)


def _jax_routed_bucket(scene, idx_all, cap):
    """The reference's routed bucket program from its pieces: gating CNN,
    select_topk_experts, route_frames_to_experts, one expert forward per
    capacity block, the scatter back, then the routed frame body with the
    selected rows of ``idx_all`` (B, M, nh, 4) injected."""
    tree, imgs = scene["tree"], jnp.asarray(scene["images"])
    expert = JExpertNet(scene_center=(0.0, 0.0, 0.0), compute_dtype=jnp.float32,
                        **EXPERT_PRESETS["test"])
    logits = scene["gating"].apply(tree["gating"], imgs)
    sel = j_select(logits, K)
    kept, pos, slot_frame, _ = j_route(sel, M, cap)
    blocks = jax.vmap(expert.apply)(tree["expert"], imgs[slot_frame])
    blocks = blocks.reshape(M, cap, -1, 3) + tree["centers"][:, None, None, :]
    co_sel = blocks[sel, jnp.minimum(pos, cap - 1)]
    idx = np.take_along_axis(idx_all, np.asarray(sel)[..., None, None], axis=1)
    out = _jax_frames(co_sel, kept, idx, j_pixel_grid(H, W, 8), tree["f"],
                      jnp.asarray(tree["c"]), JRansacConfig(n_hyps=NH))
    return out, np.asarray(sel), np.asarray(kept), idx, logits


def test_routed_bucket_fn_matches_jax(scene):
    """The slice as a whole: make_routed_scene_bucket_fn(k=2) at capacity 2
    (4 frames, so some pairs drop) against the reference's routed program
    composed from its pieces, the same sets injected."""
    cfg = RansacConfig(n_hyps=NH, serve_capacity=2)
    cap = t_esac.routed_serve_capacity(cfg, K, M)
    idx_all = np.random.default_rng(9).integers(0, N, (4, M, NH_K, 4))
    want, sel, kept, idx, logits = _jax_routed_bucket(scene, idx_all, cap)
    fn = make_routed_scene_bucket_fn(PRESET, cfg, K, device="cpu")
    got = fn(scene["params"], {"image": scene["images"], "seed": np.arange(4), "idx": idx})
    np.testing.assert_array_equal(got["experts_evaluated"].numpy(), np.where(kept, sel, M))
    assert not kept.all()  # the fixture exercises drops
    _assert_winner_parity(got, want, sel)
    np.testing.assert_allclose(got["gating_probs"].numpy(),
                               jax.nn.softmax(np.asarray(logits), axis=-1), atol=1e-5)


@pytest.mark.parametrize("impl", ["errmap", "fused_select"])
def test_routed_bucket_fn_k_eq_m_is_the_dense_bucket_fn(scene, impl):
    cfg = RansacConfig(n_hyps=NH, scoring_impl=impl)
    batch = {"image": scene["images"], "seed": np.arange(4)}
    dense = make_scene_bucket_fn(PRESET, cfg, device="cpu")(scene["params"], batch)
    routed = make_routed_scene_bucket_fn(PRESET, cfg, M, device="cpu")(scene["params"], batch)
    for key, v in dense.items():
        assert torch.equal(v, routed[key]), key
    assert routed["experts_evaluated"].tolist() == [list(range(M))] * 4


def test_routed_results_across_frame_buckets(scene):
    """A frame served alone (2 lanes) and inside a padded 4-lane dispatch
    gives bit-equal results: the capacity, hence the expert CNNs' batch
    width and the surviving pairs, is one constant per (cfg, k).  The
    gating CNN runs at the dispatch's width, so gating_probs are held to
    float32 rounding apart."""
    fn = make_routed_scene_bucket_fn(PRESET, RansacConfig(n_hyps=NH, scoring_impl="pallas"),
                                     K, device="cpu")
    batch = {"image": scene["images"][:3], "seed": np.arange(3)}
    padded, n = t_batching.pad_batch(batch, t_batching.pick_bucket(3, (1, 4, 16, 64)))
    many = fn(scene["params"], padded)
    for b in range(n):
        one, _ = t_batching.pad_batch({k: v[b:b + 1] for k, v in batch.items()}, 1)
        single = fn(scene["params"], one)
        for key in ("rvec", "tvec", "expert", "scores", "inlier_frac", "experts_evaluated"):
            assert torch.equal(single[key][0], many[key][b]), (b, key)
        torch.testing.assert_close(single["gating_probs"][0], many["gating_probs"][b],
                                   rtol=0, atol=1e-6)


def test_routed_overflow_accounting(scene):
    """Capacity 2, four copies of one image: identical gating, so frames 2-3
    lose every pair -- the sentinel M in every slot, -inf scores, finite
    poses -- and frames 0-1 equal a 2-frame dispatch bit for bit."""
    fn = make_routed_scene_bucket_fn(
        PRESET, RansacConfig(n_hyps=NH, scoring_impl="pallas", serve_capacity=2), K,
        device="cpu")
    img = np.repeat(scene["images"][:1], 4, axis=0)
    got = fn(scene["params"], {"image": img, "seed": np.arange(4)})
    pair = fn(scene["params"], {"image": img[:2], "seed": np.arange(2)})
    assert (got["experts_evaluated"][2:] == M).all()
    assert (got["experts_evaluated"][:2] < M).all()
    assert torch.isneginf(got["scores"][2:]).all() and torch.isneginf(got["inlier_frac"][2:]).all()
    assert torch.isfinite(got["rvec"]).all() and torch.isfinite(got["tvec"]).all()
    for key, v in pair.items():
        assert torch.equal(got[key][:2], v), key


def test_routed_bucket_fn_rejects_bad_k():
    for k in (0, M + 1):
        with pytest.raises(ManifestError):
            make_routed_scene_bucket_fn(PRESET, RansacConfig(), k, device="cpu")
    ungated = dataclasses.replace(PRESET, gated=False)
    with pytest.raises(ManifestError, match="gated"):
        make_routed_scene_bucket_fn(ungated, RansacConfig(), K, device="cpu")
    make_routed_scene_bucket_fn(ungated, RansacConfig(), M, device="cpu")  # k = M is fine


@pytest.mark.parametrize("impl", ["errmap", "pallas", "fused_select"])
def test_ransac_stage_bit_identical_across_lanes(frames, impl):
    """One frame's RANSAC stage does not depend on the batch it rides: the
    same coordinates and seeds through the dense and the routed entries in
    one batch of 4 and in batches of 2 give every output bit for bit (the
    geometry core sums in a batch-independent order, utils/precision)."""
    fr = frames
    cfg = RansacConfig(n_hyps=NH, scoring_impl=impl, score_cells=100)
    coords, sel = fr["coords"], fr["sel"]
    co_sel = _gather(coords, sel)
    args = (output_pixel_grid(H, W), fr["f"], fr["c"])

    def dense(s):
        return t_esac.esac_infer_frames(frame_generators(range(s.start, s.stop), "cpu"),
                                        fr["logits"][s], coords[s], *args, cfg, device="cpu")

    def routed(s):
        return t_esac.esac_infer_routed_frames(
            frame_generators(range(s.start, s.stop), "cpu"), fr["logits"][s], co_sel[s],
            sel[s], fr["kept"][s], *args, cfg, device="cpu")

    for run in (dense, routed):
        four = run(slice(0, 4))
        pairs = [run(slice(0, 2)), run(slice(2, 4))]
        for key, v in four.items():
            assert torch.equal(v, torch.cat([p[key] for p in pairs])), (run.__name__, key)
