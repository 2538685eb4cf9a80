"""The training path's losses (esac_tpu_torch.ransac.kernel, models) against
the JAX package, on the CPU.

Inputs are made with the JAX package's synthetic frames (N = 300 cells at
120x160) and handed to both packages as numpy; correspondence sets are
drawn with the JAX sampler from the key ``dsac_train_loss`` itself uses and
injected into the port (``idx=``).  Both sides run in float32; the JAX
Pallas path runs in interpret mode.

Tolerances: plain loss values rtol 1e-5 (one float32 formula in two
frameworks); their gradients rtol 1e-4, atol 1e-4 of the largest entry:
the direction du / err of a reprojection residual cancels digits at cells
that reproject within a fraction of a pixel, and atan2 of a rotation's
skew part does at small angles.

``dsac_train_loss``: the refined poses, and so the loss, are float32-
conditioned at ~1e-3 relative -- both packages sit that far from a
float64 oracle of the same math (the JAX package's pieces run under x64),
the JAX one no closer -- so the loss and the coordinates' gradient are
held by the criterion of tests/test_pallas_scoring.py:79-136 (no farther
from the oracle than 2x the JAX value's own distance + 1e-3), beside
allclose to JAX at rtol 5e-3 for the loss and, for the gradient, a cosine
similarity of at least 0.999 and a norm within 1% of JAX's.
Scores (rtol 1e-3) and selection probabilities (rtol 2e-3: alpha times a
score's rounding) are compared on the hypotheses whose minimal solves
agree between the packages to 1e-3 (a degenerate set's near-tied quartic
branches flip on one ulp, ROADMAP C); those that disagree must carry under
1e-3 of the selection mass in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.data import CAMERA_F, make_correspondence_frame
from esac_tpu.data.synthetic import ROOM_SIZE, render_box_scene
from esac_tpu.geometry.rotations import rodrigues as j_rodrigues
from esac_tpu.models.expert import coordinate_loss as j_coordinate_loss
from esac_tpu.models.expert import reprojection_loss as j_reprojection_loss
from esac_tpu.models.gating import gating_cross_entropy as j_gating_ce
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac.kernel import _score_hypotheses as j_score
from esac_tpu.ransac.kernel import dsac_train_loss as j_dsac_train_loss
from esac_tpu.ransac.kernel import generate_hypotheses as j_generate
from esac_tpu.ransac.kernel import pose_loss as j_pose_loss
from esac_tpu.ransac.refine import refine_soft_inliers as j_refine
from esac_tpu.ransac.sampling import sample_correspondence_sets as j_sample
from esac_tpu.ransac.sampling import sample_expert_indices as j_sample_experts
from esac_tpu.train.expert import reprojection_loss as j_reprojection_loss_batched
from esac_tpu_torch.models.expert import coordinate_loss, reprojection_loss
from esac_tpu_torch.models.gating import gating_cross_entropy
from esac_tpu_torch.ransac import kernel as K
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.sampling import sample_expert_indices
from esac_tpu_torch.train.expert import reprojection_loss as reprojection_loss_batched

F = np.float32(CAMERA_F / 4.0)
C = np.array([80.0, 60.0], np.float32)
FRAME_KW = dict(height=120, width=160, f=CAMERA_F / 4.0, c=(80.0, 60.0))
NH = 16


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _value_and_grads(fn, *xs):
    ts = [_t(x, grad=True) for x in xs]
    out = fn(*ts)
    out.backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _close_grad(got, want):
    want = np.asarray(want)
    _close(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _grad_like(got, want):
    """A gradient float32 conditioning keeps from matching element by
    element: the same direction (cosine >= 0.999) and the same size (norms
    within 1%)."""
    a, b = (np.ravel(x).astype(np.float64) for x in (got, want))
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    assert a @ b >= 0.999 * na * nb, a @ b / (na * nb)
    assert abs(na - nb) <= 1e-2 * nb, na / nb


# ---------------------------------------------------------------- losses


def test_pose_loss_matches_jax():
    """Value and gradient (rvec, tvec) over poses below and above the clamp,
    the rotation and the translation term each deciding somewhere."""
    rng = np.random.default_rng(0)
    rv = rng.uniform(-0.5, 0.5, (12, 3)).astype(np.float32)
    tv = rng.uniform(-2, 2, (12, 3)).astype(np.float32)
    rv_gt, tv_gt = rv[0] + 0.05, tv[0] + 0.002
    R_gt = np.asarray(j_rodrigues(rv_gt))
    cfg = RansacConfig()
    jcfg = JRansacConfig()
    j_fn = jax.vmap(lambda r, t: j_pose_loss(r, t, R_gt, tv_gt, jcfg))
    want = np.asarray(j_fn(rv, tv))
    assert (want < jcfg.loss_clamp).any() and (want == jcfg.loss_clamp).any()
    want_g = jax.grad(lambda r, t: jnp.sum(j_fn(r, t) * jnp.arange(12.0)), argnums=(0, 1))(rv, tv)
    _close(K.pose_loss(_t(rv), _t(tv), _t(R_gt), _t(tv_gt), cfg), want)
    _, got_g = _value_and_grads(
        lambda r, t: torch.sum(K.pose_loss(r, t, _t(R_gt), _t(tv_gt), cfg)
                               * torch.arange(12.0)), rv, tv)
    for a, b in zip(got_g, want_g):
        _close_grad(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_coordinate_loss_matches_jax(masked):
    rng = np.random.default_rng(1)
    pred, target = rng.normal(size=(2, 2, 5, 7, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 5, 7)) < 0.7).astype(np.float32) if masked else None
    want = j_coordinate_loss(pred, target, mask)
    want_g = jax.grad(lambda p: j_coordinate_loss(p, target, mask))(pred)
    got, (got_g,) = _value_and_grads(
        lambda p: coordinate_loss(p, _t(target), None if mask is None else _t(mask)), pred)
    _close(got, want)
    _close_grad(got_g, want_g)


def test_reprojection_losses_match_jax():
    """models.expert.reprojection_loss (hard clamp, one frame) and
    train.expert.reprojection_loss (log1p clamp, batched, per-frame focals)
    against their JAX counterparts, with cells behind the camera and beyond
    the clamp."""
    frames = [make_correspondence_frame(jax.random.key(s), noise=0.05, outlier_frac=0.3,
                                        **FRAME_KW) for s in (2, 3)]
    pred = np.stack([np.asarray(fr["coords"]) for fr in frames])
    pixels = np.asarray(frames[0]["pixels"])
    rvecs = np.stack([np.asarray(fr["rvec"]) for fr in frames])
    tvecs = np.stack([np.asarray(fr["tvec"]) for fr in frames])
    R0 = np.asarray(j_rodrigues(rvecs[0]))
    want = j_reprojection_loss(pred[0], pixels, R0, tvecs[0], F, C, 20.0)
    want_g = jax.grad(lambda p: j_reprojection_loss(p, pixels, R0, tvecs[0], F, C, 20.0))(
        pred[0])
    got, (got_g,) = _value_and_grads(
        lambda p: reprojection_loss(p, _t(pixels), _t(R0), _t(tvecs[0]), _t(F), _t(C), 20.0),
        pred[0])
    _close(got, want)
    _close_grad(got_g, want_g)
    fs = np.array([F, F * 1.1], np.float32)
    want = j_reprojection_loss_batched(pred, rvecs, tvecs, pixels, fs, C)
    want_g = jax.grad(lambda p, r: j_reprojection_loss_batched(p, r, tvecs, pixels, fs, C),
                      argnums=(0, 1))(pred, rvecs)
    got, got_g = _value_and_grads(
        lambda p, r: reprojection_loss_batched(p, r, _t(tvecs), _t(pixels), _t(fs), _t(C)),
        pred, rvecs)
    _close(got, want)
    for a, b in zip(got_g, want_g):
        _close_grad(a, b)


def test_gating_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    labels = np.array([0, 4, 2, 2, 1, 3])
    want = j_gating_ce(logits, labels)
    want_g = jax.grad(lambda lg: j_gating_ce(lg, labels))(logits)
    got, (got_g,) = _value_and_grads(lambda lg: gating_cross_entropy(lg, labels), logits)
    _close(got, want)
    _close_grad(got_g, want_g)


def test_sample_expert_indices_follows_the_gating_distribution():
    """The categorical draw: the port's and the JAX sampler's frequencies
    agree with the gating probabilities (4000 draws: 4 sigma of a
    binomial), an expert of zero probability is never drawn, and a seeded
    generator repeats its draws."""
    g = np.array([0.5, 0.3, 0.2, 0.0], np.float32)
    n = 4000
    gen = torch.Generator().manual_seed(3)
    got = sample_expert_indices(gen, torch.from_numpy(g), n)
    assert got.shape == (n,) and got.dtype == torch.int64
    want = np.asarray(j_sample_experts(jax.random.key(3), jnp.asarray(g), n))
    sigma = np.sqrt(g * (1 - g) / n)
    for draws in (got.numpy(), want):
        freq = np.bincount(draws, minlength=4) / n
        assert (np.abs(freq - g) <= 4 * sigma + 1e-9).all(), freq
    assert torch.equal(got, sample_expert_indices(torch.Generator().manual_seed(3),
                                                  torch.from_numpy(g), n))


# ------------------------------------------------------- dsac_train_loss


def _frame(key=7, noise=0.02):
    fr = make_correspondence_frame(jax.random.key(key), noise=noise, **FRAME_KW)
    return {k: np.asarray(v) for k, v in fr.items()}


def _dsac_jax(fr, coords, cfg):
    jcfg = JRansacConfig(**dataclasses.asdict(cfg))
    R_gt = np.asarray(j_rodrigues(fr["rvec"]))

    def loss(co):
        return j_dsac_train_loss(jax.random.key(8), co, fr["pixels"], F, C, R_gt,
                                 fr["tvec"], jcfg)

    (val, aux), g = jax.value_and_grad(loss, has_aux=True)(coords)
    return val, aux, np.asarray(g)


def _dsac_port(fr, coords, cfg, idx):
    co = _t(coords, grad=True)
    val, aux = K.dsac_train_loss(None, co, fr["pixels"], F, C,
                                 np.asarray(j_rodrigues(fr["rvec"])), fr["tvec"], cfg,
                                 idx=idx, device="cpu")
    val.backward()
    return val, aux, co.grad.numpy()


def _dsac_oracle(fr, coords, cfg, idx):
    """float64 value and coordinates' gradient of the same loss, built from
    the JAX package's pieces under x64 with the sets injected (the body of
    its dsac_train_loss, error-map scoring; the quartic's roots stay
    complex64 there)."""
    jcfg = JRansacConfig(**dataclasses.asdict(dataclasses.replace(cfg, scoring_impl="errmap")))
    with jax.enable_x64(True):
        px, f, c, R_gt, t_gt = (jnp.asarray(np.asarray(x, np.float64)) for x in (
            fr["pixels"], F, C, j_rodrigues(fr["rvec"]), fr["tvec"]))

        def loss(co):
            rv, tv = j_generate(None, co, px, f, c, jcfg, idx=jnp.asarray(idx))
            scores = j_score(None, rv, tv, co, px, f, c, jcfg)
            rv_r, tv_r = jax.vmap(lambda r, t: j_refine(
                r, t, co, px, f, c, jcfg.tau, jcfg.beta, iters=jcfg.train_refine_iters))(rv, tv)
            losses = jax.vmap(lambda r, t: j_pose_loss(r, t, R_gt, t_gt, jcfg))(rv_r, tv_r)
            return jnp.sum(jax.nn.softmax(jcfg.alpha * scores) * losses)

        val, g = jax.value_and_grad(loss)(jnp.asarray(np.asarray(coords, np.float64)))
        assert g.dtype == jnp.float64
        return float(val), np.asarray(g)


@pytest.mark.parametrize("grad_through_refine", [True, False])
@pytest.mark.parametrize("impl", ["errmap", "pallas"])
def test_dsac_train_loss_matches_jax(impl, grad_through_refine):
    """Loss, aux and the coordinates' gradient of dsac_train_loss against
    the JAX package; "pallas" runs SoftInlierScores (its plain forward here)
    against the JAX custom_vjp in interpret mode.  grad_through_refine is a
    field dsac_train_loss reads in neither package (only the multi-expert
    loss does): both values give the JAX result."""
    fr = _frame()
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl=impl,
                       grad_through_refine=grad_through_refine)
    idx = np.asarray(j_sample(jax.random.key(8), NH, fr["coords"].shape[0]))
    want, want_aux, want_g = _dsac_jax(fr, fr["coords"], cfg)
    got, aux, got_g = _dsac_port(fr, fr["coords"], cfg, idx)
    oracle, oracle_g = _dsac_oracle(fr, fr["coords"], cfg, idx)
    got = float(got)
    assert abs(got - oracle) <= 2.0 * abs(float(want) - oracle) + 1e-3
    _close(got, want, rtol=5e-3)
    _close(aux["expected_loss"].detach(), got, rtol=0)
    for k in ("best_loss", "entropy"):
        _close(aux[k].detach(), want_aux[k], rtol=5e-3)
    assert np.abs(got_g - oracle_g).max() <= 2.0 * np.abs(want_g - oracle_g).max() + 1e-3
    _grad_like(got_g, want_g)
    assert np.isfinite(got_g).all() and np.abs(got_g).max() > 0

    rv, tv = j_generate(jax.random.key(8), fr["coords"], fr["pixels"], F, C,
                        JRansacConfig(n_hyps=NH))
    port_rv, port_tv = K.generate_hypotheses(
        None, _t(fr["coords"])[None], _t(fr["pixels"]), _t([F]), _t(C), cfg,
        idx=torch.as_tensor(idx)[None])
    same = ((np.abs(port_rv[0].numpy() - rv).max(-1) < 1e-3)
            & (np.abs(port_tv[0].numpy() - tv).max(-1) < 1e-3))
    probs, want_probs = aux["selection_probs"].detach().numpy(), want_aux["selection_probs"]
    assert same.sum() >= NH // 2
    assert probs[~same].sum() < 1e-3 and np.asarray(want_probs)[~same].sum() < 1e-3
    _close(aux["scores"].detach().numpy()[same], np.asarray(want_aux["scores"])[same],
           rtol=1e-3)
    _close(probs[same], np.asarray(want_probs)[same], rtol=2e-3, atol=1e-6)


def test_dsac_train_loss_remat_is_bit_identical():
    """cfg.remat checkpoints the per-hypothesis refine: memory, not math --
    the same loss and the same gradient bit for bit inside the port."""
    fr = _frame(15)
    idx = np.random.default_rng(16).integers(0, fr["coords"].shape[0], (NH, 4))
    runs = [_dsac_port(fr, fr["coords"], RansacConfig(n_hyps=NH, train_refine_iters=2,
                                                      remat=remat), idx)
            for remat in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][2], runs[1][2])


def test_dsac_train_loss_frames_batches_frames():
    """Two frames in one call (per-frame pixels, focals and GT) equal each
    frame's one-frame loss and gradient."""
    frs = [_frame(7), _frame(9, noise=0.05)]
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl="pallas")
    idx = np.random.default_rng(2).integers(0, 300, (2, NH, 4))
    co = _t(np.stack([fr["coords"] for fr in frs]), grad=True)
    loss, aux = K.dsac_train_loss_frames(
        [None, None], co, np.stack([fr["pixels"] for fr in frs]), np.array([F, F]), C,
        np.stack([np.asarray(j_rodrigues(fr["rvec"])) for fr in frs]),
        np.stack([fr["tvec"] for fr in frs]), cfg, idx=idx, device="cpu")
    loss.sum().backward()
    for b, fr in enumerate(frs):
        one, one_aux, one_g = _dsac_port(fr, fr["coords"], cfg, idx[b])
        _close(loss[b].detach(), one.detach(), rtol=1e-5)
        _close(aux["scores"][b].detach(), one_aux["scores"].detach(), rtol=1e-5)
        # Batched matmuls round differently; the refine amplifies it (see
        # the module docstring): the same direction, elements to 5e-3.
        g = co.grad[b].numpy().ravel()
        assert g @ one_g.ravel() / (np.linalg.norm(g) * np.linalg.norm(one_g)) > 0.9999
        _close(g, one_g.ravel(), rtol=0, atol=5e-3 * np.abs(one_g).max())


def test_gradient_finite_at_perfect_coords_and_identity_pose():
    """The atan2 / eps-norm traps: perfect coordinates seen from a camera
    with exactly the identity rotation, so hypotheses refine to exactly
    the GT pose (rotation error 0, so3_log at 0).  Loss and gradient stay
    finite in both packages (tests/test_ransac_kernel.py:134)."""
    sc = render_box_scene(jnp.zeros(3), -jnp.asarray(ROOM_SIZE) * 0.5, FRAME_KW["height"],
                          FRAME_KW["width"], FRAME_KW["f"], FRAME_KW["c"])
    fr = {"coords": np.asarray(sc["coords_gt"]), "pixels": np.asarray(sc["pixels"]),
          "rvec": np.zeros(3, np.float32), "tvec": -ROOM_SIZE * 0.5}
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl="pallas")
    idx = np.asarray(j_sample(jax.random.key(8), NH, fr["coords"].shape[0]))
    got, aux, g = _dsac_port(fr, fr["coords"], cfg, idx)
    assert torch.isfinite(got) and np.isfinite(g).all()
    assert float(aux["best_loss"]) < 0.1
    _, _, want_g = _dsac_jax(fr, fr["coords"], cfg)
    assert np.isfinite(want_g).all()


def test_gradient_finite_with_repeated_points_in_minimal_sets():
    """Degenerate minimal sets -- one cell four times, one cell twice, two
    cells twice each -- give some finite pose and finite gradients
    (the solver's branch penalties and guarded divisions)."""
    fr = _frame(7)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 300, (NH, 4))
    idx[0] = 11
    idx[1, 1] = idx[1, 0]
    idx[2] = [3, 3, 8, 8]
    for impl in ("errmap", "pallas"):
        cfg = RansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl=impl)
        got, aux, g = _dsac_port(fr, fr["coords"], cfg, idx)
        assert torch.isfinite(got) and np.isfinite(g).all(), impl
        assert torch.isfinite(aux["scores"]).all()
