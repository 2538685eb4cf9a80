"""The multi-expert training loss (esac_tpu_torch.ransac.esac
.esac_train_loss) against the JAX package, dense and sampled, on the CPU.

Fixture after tests/test_esac.py: one 120x160 frame (N = 300 cells),
M = 4 experts of which one predicts the frame's coordinates and the others
uniform room points.  The draws are made with the JAX samplers and
injected: dense ``idx`` (M, n_hyps, 4), sets whose minimal solves agree
between the packages; sampled, the experts and sets the JAX entry draws
from ``jax.random.split(key)`` at a key whose hypotheses agree.  Both
sides run in float32.

Tolerances (the reasons are tests/test_torch_train.py's): losses rtol 5e-3
beside the float64-oracle criterion (no farther from an oracle of the
same math -- the JAX loss under x64 -- than 2x the JAX value + 1e-3); the
coordinates' gradient by the same criterion, a cosine similarity of at
least 0.999 to JAX's and a norm within 1% of it; the gating gradient
rtol 5e-3, atol 1e-3 of its largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.data import CAMERA_F
from esac_tpu.data.synthetic import output_pixel_grid as j_pixel_grid
from esac_tpu.geometry.pnp import solve_pnp_minimal as j_solve
from esac_tpu.geometry.rotations import rodrigues as j_rodrigues
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac.esac import esac_train_loss as j_esac_train_loss
from esac_tpu.ransac.kernel import generate_hypotheses as j_generate
from esac_tpu.ransac.sampling import sample_correspondence_sets as j_sample
from esac_tpu.ransac.sampling import sample_expert_indices as j_sample_experts
from esac_tpu_torch.geometry.pnp import solve_pnp_minimal
from esac_tpu_torch.ransac import esac as E
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import generate_hypotheses

F = np.float32(CAMERA_F / 4.0)
C = np.array([80.0, 60.0], np.float32)
M, NH, TRUE = 4, 16, 1
LOGITS = np.array([0.1, 1.0, -0.3, 0.2], np.float32)


@pytest.fixture(scope="module")
def frame():
    """The true expert's map: cells back-projected at random depths (1-6 m)
    under a GT pose, 1 cm noise; the other experts' maps uniform room
    points.  Random depths keep most minimal sets well-conditioned (a box
    room's planar walls put near-double roots in the P3P quartic)."""
    rng = np.random.default_rng(1)
    pixels = np.asarray(j_pixel_grid(120, 160, 8))
    rvec = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    R = np.asarray(j_rodrigues(rvec))
    t = (-R @ rng.uniform([2.0, 1.5, 1.0], [4.0, 2.5, 2.0])).astype(np.float32)
    depth = rng.uniform(1.0, 6.0, len(pixels))
    Y = np.concatenate([(pixels - C) / F, np.ones((len(pixels), 1))], 1) * depth[:, None]
    X = (Y - t) @ R + 0.01 * rng.normal(size=Y.shape)
    maps = [X if m == TRUE else rng.uniform(0.0, 5.0, X.shape) for m in range(M)]
    return dict(coords_all=np.stack(maps).astype(np.float32), pixels=pixels, R_gt=R,
                t_gt=t)


def _agreeing_sets(fr, key, m, n):
    """The first ``n`` of the JAX sampler's sets from ``key`` whose minimal
    solves agree between the packages to 1e-5 on expert ``m``'s map: no
    near-tied quartic branch (ROADMAP C) in the fixture."""
    cand = 6 * n
    X = fr["coords_all"][m]
    idx = np.asarray(j_sample(key, cand, X.shape[0]))
    rv, tv = j_generate(key, X, fr["pixels"], F, C, JRansacConfig(n_hyps=cand))
    prv, ptv = generate_hypotheses(None, torch.tensor(X)[None], torch.tensor(fr["pixels"]),
                                   torch.tensor([F]), torch.tensor(C),
                                   RansacConfig(n_hyps=cand), idx=torch.tensor(idx)[None])
    ok = ((np.abs(prv[0].numpy() - rv).max(-1) < 1e-5)
          & (np.abs(ptv[0].numpy() - tv).max(-1) < 1e-5))
    assert ok.sum() >= n
    return idx[ok][:n]


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _jax(fr, logits, cfg, mode, idx=None, key=5):
    jcfg = JRansacConfig(**dataclasses.asdict(cfg))

    def loss(lg, ca):
        return j_esac_train_loss(jax.random.key(key), lg, ca, fr["pixels"], F, C, fr["R_gt"],
                                 fr["t_gt"], jcfg, mode, idx=idx)

    (val, aux), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        logits, fr["coords_all"])
    return float(val), aux, [np.asarray(x) for x in g]


def _port(fr, logits, cfg, mode, **draws):
    lg, ca = _t(logits, grad=True), _t(fr["coords_all"], grad=True)
    val, aux = E.esac_train_loss(None, lg, ca, fr["pixels"], F, C, fr["R_gt"], fr["t_gt"],
                                 cfg, mode, device="cpu", **draws)
    val.backward()
    return float(val.detach()), aux, [lg.grad.numpy(), ca.grad.numpy()]


def _oracle_dense(fr, logits, cfg, idx):
    """float64 value and coordinates' gradient of the dense loss: the JAX
    package's esac_train_loss under x64 with the sets injected (error-map
    scoring; the quartic's roots stay complex64 there)."""
    jcfg = JRansacConfig(**dataclasses.asdict(dataclasses.replace(cfg, scoring_impl="errmap")))
    with jax.enable_x64(True):
        ca, px, f, c, R_gt, t_gt, lg = (jnp.asarray(np.asarray(x, np.float64)) for x in (
            fr["coords_all"], fr["pixels"], F, C, fr["R_gt"], fr["t_gt"], logits))
        val, g = jax.value_and_grad(lambda co: j_esac_train_loss(
            jax.random.key(5), lg, co, px, f, c, R_gt, t_gt, jcfg, "dense",
            idx=jnp.asarray(idx))[0])(ca)
        assert g.dtype == jnp.float64
        return float(val), np.asarray(g)


def _hold(got, want, oracle):
    assert np.abs(got - oracle).max() <= 2.0 * np.abs(want - oracle).max() + 1e-3


def _grad_like(got, want):
    """The same direction (cosine >= 0.999) and size (norms within 1%)."""
    a, b = (np.ravel(x).astype(np.float64) for x in (got, want))
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    assert a @ b >= 0.999 * na * nb, a @ b / (na * nb)
    assert abs(na - nb) <= 1e-2 * nb, na / nb


@pytest.mark.parametrize("grad_through_refine", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "errmap"])
def test_dense_loss_and_gradients_match_jax(frame, impl, grad_through_refine):
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl=impl,
                       grad_through_refine=grad_through_refine)
    idx = np.stack([_agreeing_sets(frame, jax.random.key(6 + m), m, NH) for m in range(M)])
    want, want_aux, (want_lg, want_ca) = _jax(frame, LOGITS, cfg, "dense", idx=idx)
    got, aux, (got_lg, got_ca) = _port(frame, LOGITS, cfg, "dense", idx=idx)
    oracle, oracle_ca = _oracle_dense(frame, LOGITS, cfg, idx)
    _hold(np.float64(got), np.float64(want), oracle)
    np.testing.assert_allclose(got, want, rtol=5e-3)
    np.testing.assert_allclose(aux["per_expert_loss"].detach(), want_aux["per_expert_loss"],
                               rtol=5e-3)
    np.testing.assert_allclose(aux["gating_probs"].detach(), want_aux["gating_probs"],
                               rtol=1e-6)
    np.testing.assert_allclose(got_lg, want_lg, rtol=5e-3, atol=1e-3 * np.abs(want_lg).max())
    _hold(got_ca, want_ca, oracle_ca)
    _grad_like(got_ca, want_ca)
    assert np.abs(got_ca[TRUE]).max() > 0 and np.isfinite(got_ca).all()


def test_dense_gating_gradient_prefers_the_true_expert(frame):
    """At uniform gating the dense loss falls fastest by raising the true
    expert's logit (tests/test_esac.py:71)."""
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl="pallas")
    idx = np.random.default_rng(0).integers(0, 300, (M, NH, 4))
    _, _, (g, _) = _port(frame, np.zeros(M, np.float32), cfg, "dense", idx=idx)
    assert int(np.argmin(g)) == TRUE, g


def test_sampled_loss_and_gating_gradient_match_jax(frame):
    """The REINFORCE estimator with the JAX draws injected: the value (the
    expected loss; the score-function term adds only its gradient) and the
    gating gradient against JAX.  Key 27 draws 16 sets whose minimal solves
    agree between the packages (checked here)."""
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1)
    k_draw, k_hyp = jax.random.split(jax.random.key(27))
    experts = np.asarray(j_sample_experts(k_draw, jax.nn.softmax(jnp.asarray(LOGITS)), NH))
    idx = np.asarray(j_sample(k_hyp, NH, 300))
    X4 = frame["coords_all"][experts[:, None], idx]
    x4 = frame["pixels"][idx]
    j_rv, j_tv = jax.vmap(lambda a, b: j_solve(a, b, F, C, polish_iters=3))(X4, x4)
    rv, tv = solve_pnp_minimal(torch.from_numpy(X4), torch.from_numpy(x4), torch.tensor(F),
                               torch.from_numpy(C), polish_iters=3)
    assert np.abs(rv.numpy() - j_rv).max() < 1e-4 and np.abs(tv.numpy() - j_tv).max() < 1e-4
    want, want_aux, (want_lg, _) = _jax(frame, LOGITS, cfg, "sampled", key=27)
    np.testing.assert_array_equal(want_aux["drawn_experts"], experts)
    got, aux, (got_lg, got_ca) = _port(frame, LOGITS, cfg, "sampled", experts=experts,
                                       idx=idx)
    assert aux["drawn_experts"].tolist() == experts.tolist()
    np.testing.assert_allclose(got, want, rtol=5e-3)
    # total = expected + r - r.detach(): the expected loss up to the
    # rounding of adding and taking away the REINFORCE value.
    np.testing.assert_allclose(float(aux["expected_loss"].detach()), got, rtol=1e-4)
    np.testing.assert_allclose(got_lg, want_lg, rtol=5e-3, atol=1e-3 * np.abs(want_lg).max())
    assert np.isfinite(got_ca).all()


def test_sampled_draws_come_from_the_frame_generator(frame):
    """Without injection the sampled loss draws experts, then sets, from
    the frame's generator: one seed, one result; the drawn experts follow
    the gate (a gate of one expert draws only it)."""
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1)
    lg = np.array([-30.0, 30.0, -30.0, -30.0], np.float32)
    outs = [E.esac_train_loss(torch.Generator().manual_seed(3), lg, frame["coords_all"],
                              frame["pixels"], F, C, frame["R_gt"], frame["t_gt"], cfg,
                              "sampled", device="cpu") for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1]["drawn_experts"].tolist() == [TRUE] * NH
    with pytest.raises(ValueError):
        E.esac_train_loss(None, lg, frame["coords_all"], frame["pixels"], F, C,
                          frame["R_gt"], frame["t_gt"], cfg, "dense",
                          experts=np.zeros(NH, int), device="cpu")
