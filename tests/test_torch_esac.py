"""The slice as a whole: the port's serving entry point
(``make_scene_bucket_fn(..., device="cpu")``) against the JAX package's
pipeline on the same frames, weights and correspondence sets.

Two committed test-size experts (ckpts/ckpt_expert_synth{0,1}) and a gating
net from the JAX init, on SyntheticScene frames.  The JAX side composes
ExpertNet.apply + GatingNet.apply -> _per_expert_winners(idx=) -> argmax
-> refine_soft_inliers; the port side is one call of its bucket function
with the same ``idx`` injected.  Both run in float32.  Winner expert and
index are compared exactly (the fixture has no near ties); the refined
pose to 1e-4 -- float32 CNN, P3P and 8 IRLS rounds in two frameworks --
and inlier_frac to 2e-4 relative: the winner's pose is solved from CNN
coordinates that differ by convolution rounding, and a soft-inlier score
moves by up to beta/4 per pixel of pose shift, summed over every cell.
"""

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
from esac_tpu.serve import batching as j_batching
from esac_tpu.utils.checkpoint import load_checkpoint
from esac_tpu_torch.data.synthetic import output_pixel_grid
from esac_tpu_torch.models.convert import load_scene
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.ransac import esac as t_esac
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import frame_generators
from esac_tpu_torch.registry.manifest import ScenePreset
from esac_tpu_torch.registry.serving import init_scene_params, make_scene_bucket_fn
from esac_tpu_torch.serve import batching as t_batching

H, W, M, NH, B = 96, 128, 2, 16, 3
PRESET = ScenePreset(height=H, width=W, num_experts=M,
                     gating_channels=GATING_PRESETS["test"]["channels"],
                     compute_dtype="float32", **EXPERT_PRESETS["test"])


@pytest.fixture(scope="module")
def scene():
    ckpts = [load_checkpoint(f"ckpts/ckpt_expert_synth{m}") for m in range(M)]
    frames = [SyntheticScene(f"synth{s}", "test", n_frames=2, height=H, width=W)[i]
              for s, i in ((0, 0), (1, 0), (0, 1))]
    images = np.stack([fr.image for fr in frames]).astype(np.float32)
    gating = JGatingNet(num_experts=M, channels=GATING_PRESETS["test"]["channels"],
                        compute_dtype=jnp.float32)
    tree = {
        "expert": jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                               *[p for p, _ in ckpts]),
        "gating": jax.tree.map(np.asarray, gating.init(jax.random.key(7), images[:1])),
        "centers": np.array([c["scene_center"] for _, c in ckpts], np.float32),
        "f": np.float32(frames[0].focal),
        "c": np.array([W / 2.0, H / 2.0], np.float32),
    }
    idx = np.random.default_rng(0).integers(0, (H // 8) * (W // 8), (B, M, NH, 4))
    return dict(tree=tree, images=images, idx=idx.astype(np.int32), gating=gating)


def _jax_pipeline(scene):
    """JAX composition of the serving path, per frame, errmap scoring."""
    tree, images = scene["tree"], scene["images"]
    expert = JExpertNet(scene_center=(0.0, 0.0, 0.0), compute_dtype=jnp.float32,
                        **EXPERT_PRESETS["test"])
    pixels = j_pixel_grid(H, W, 8)
    cfg = JRansacConfig(n_hyps=NH)
    f, c = tree["f"], jnp.asarray(tree["c"])

    @jax.jit
    def one(img, idx):
        coords = jnp.stack([
            expert.apply(jax.tree.map(lambda x: x[m], tree["expert"]), img[None])
            .reshape(-1, 3) + tree["centers"][m] for m in range(M)])
        rv, tv, best_j, best_s, _ = j_winners(jax.random.key(0), coords, pixels, f, c,
                                              cfg, idx=idx)
        m = jnp.argmax(best_s)
        rvec, tvec = j_refine(rv[m, best_j[m]], tv[m, best_j[m]], coords[m], pixels,
                              f, c, cfg.tau, cfg.beta, iters=cfg.refine_iters)
        return dict(expert=m, best=best_j[m], rvec=rvec, tvec=tvec,
                    inlier_frac=best_s[m] / pixels.shape[0],
                    logits=scene["gating"].apply(tree["gating"], img[None])[0])

    outs = [one(images[b], scene["idx"][b]) for b in range(B)]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


def _port(scene, impl):
    params = load_scene(init_scene_params(PRESET, device="cpu"), scene["tree"])
    fn = make_scene_bucket_fn(PRESET, RansacConfig(n_hyps=NH, scoring_impl=impl),
                              device="cpu")
    return params, fn


def _serve(scene, impl, images, seeds, idx):
    params, fn = _port(scene, impl)
    return fn(params, {"image": images, "seed": seeds, "idx": idx})


def test_slice_matches_jax_pipeline(scene):
    want = _jax_pipeline(scene)
    got = _serve(scene, "errmap", scene["images"], [0, 1, 2], scene["idx"])
    np.testing.assert_array_equal(got["expert"].numpy(), want["expert"])
    np.testing.assert_allclose(got["rvec"].numpy(), want["rvec"], atol=1e-4)
    np.testing.assert_allclose(got["tvec"].numpy(), want["tvec"], atol=1e-4)
    np.testing.assert_allclose(got["inlier_frac"].numpy(), want["inlier_frac"], rtol=2e-4)
    np.testing.assert_allclose(got["gating_probs"].numpy(),
                               jax.nn.softmax(want["logits"], axis=-1), atol=1e-5)
    # Winner index inside the winning expert: the port's own per-expert stage
    # on the port's CNN output.
    params, _ = _port(scene, "errmap")
    with torch.no_grad():
        imgs = torch.from_numpy(scene["images"])
        coords = torch.stack([net(imgs) for net in params["expert"]], 1).reshape(B, M, -1, 3)
        coords = coords + params["centers"][None, :, None]
        _, _, best_j, _, _ = t_esac._per_expert_winners(
            frame_generators([0, 1, 2], "cpu"), coords, output_pixel_grid(H, W),
            params["f"].expand(B), params["c"], RansacConfig(n_hyps=NH),
            idx=torch.from_numpy(scene["idx"]))
    got_best = best_j[torch.arange(B), got["expert"]].numpy()
    np.testing.assert_array_equal(got_best, want["best"])


def test_scoring_impls_agree_inside_the_port(scene):
    """errmap, fused, pallas (scoring kernel's plain version on the CPU) and
    fused_select (select kernel's plain version) pick the same winners; the
    fused formula differs from the errmap one by float32 rounding only."""
    outs = {impl: _serve(scene, impl, scene["images"], [0, 1, 2], scene["idx"])
            for impl in ("errmap", "fused", "pallas", "fused_select")}
    ref = outs["errmap"]
    for impl in ("fused", "pallas", "fused_select"):
        out = outs[impl]
        assert torch.equal(out["expert"], ref["expert"]), impl
        np.testing.assert_allclose(out["rvec"].numpy(), ref["rvec"].numpy(), atol=1e-5)
        np.testing.assert_allclose(out["tvec"].numpy(), ref["tvec"].numpy(), atol=1e-5)
        np.testing.assert_allclose(out["inlier_frac"].numpy(),
                                   ref["inlier_frac"].numpy(), rtol=1e-5)
    assert "score" in outs["fused_select"] and "scores" not in outs["fused_select"]
    assert outs["pallas"]["scores"].shape == (B, M, NH)
    torch.testing.assert_close(outs["fused_select"]["score"],
                               outs["pallas"]["scores"].amax(dim=(1, 2)))


def test_padded_bucket_gives_per_frame_results(scene):
    """The MIN_LANES contract: a 3-frame request padded to bucket 4 gives
    the same per-frame results as each frame served alone (padded to 2)."""
    params, fn = _port(scene, "fused_select")
    batch = {"image": scene["images"], "seed": np.arange(B), "idx": scene["idx"]}
    padded, n = t_batching.pad_batch(batch, t_batching.pick_bucket(B, (1, 4, 16, 64)))
    assert n == B and len(padded["image"]) == 4
    many = fn(params, padded)
    for b in range(B):
        one, _ = t_batching.pad_batch({k: v[b:b + 1] for k, v in batch.items()}, 1)
        single = fn(params, one)
        for key in ("rvec", "tvec", "expert", "score", "inlier_frac"):
            assert torch.equal(single[key][0], many[key][b]), (b, key)


@pytest.mark.parametrize("score_cells", [0, 100])
def test_unseeded_sampling_recovers_the_scene(score_cells):
    """Without injected sets the port draws its own from per-frame
    generators: on clean synthetic correspondences the refined pose is the
    ground truth and the right (undisturbed) expert wins -- also when
    scoring runs on a per-frame random subset of 100 of the 192 cells
    (per-frame pixel groups through the select kernel's plain version)."""
    sc = SyntheticScene("synth0", "test", n_frames=2, height=H, width=W)
    fr = sc[0]
    coords = fr.coords_gt.reshape(-1, 3)
    rng = np.random.default_rng(1)
    decoy = rng.uniform(0, 4, coords.shape).astype(np.float32)
    coords_all = np.stack([decoy, coords])[None].repeat(2, 0)  # (2 frames, M, N, 3)
    out = t_esac.esac_infer_frames(
        frame_generators([5, 6], "cpu"), np.zeros((2, M)), coords_all,
        output_pixel_grid(H, W), fr.focal, [W / 2, H / 2],
        RansacConfig(n_hyps=32, scoring_impl="fused_select", score_cells=score_cells),
        device="cpu")
    assert out["expert"].tolist() == [1, 1]
    np.testing.assert_allclose(out["rvec"].numpy(), np.stack([fr.rvec] * 2), atol=1e-3)
    np.testing.assert_allclose(out["tvec"].numpy(), np.stack([fr.tvec] * 2), atol=1e-3)


@pytest.mark.parametrize("buckets", [(1, 4, 16, 64), (2, 8), (3,)])
def test_dispatch_planning_matches_jax(buckets):
    for n in range(1, 140):
        assert t_batching.plan_dispatches(n, buckets) == \
            j_batching.plan_dispatches(n, buckets), n
        for chunk in t_batching.plan_dispatches(n, buckets):
            assert t_batching.pick_bucket(chunk, buckets) == \
                j_batching.pick_bucket(chunk, buckets)
    with pytest.raises(t_batching.ConfigError):
        t_batching.pick_bucket(max(buckets) + 1, buckets)
    frames = [{"image": np.full((2, 2, 3), i, np.float32), "seed": i} for i in range(3)]
    stacked = t_batching.stack_frames(frames)
    padded, n = t_batching.pad_batch(stacked, t_batching.pick_bucket(3, (1, 4)))
    assert n == 3 and padded["seed"].tolist() == [0, 1, 2, 2]
