"""Port geometry (esac_tpu_torch.geometry, ransac.refine) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
port counterpart on the CPU.  Tolerances: both sides are float32 with
different transcendental implementations and summation orders, so
elementwise results agree to a few ULP of their magnitude; solves that
iterate (PnP polish, IRLS) are held by pose error, since near-tied quartic
branches flip on one ULP (esac_tpu/geometry/pnp.py:76-82).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.data import CAMERA_F, make_correspondence_frame
from esac_tpu.geometry import camera as jcam
from esac_tpu.geometry import pnp as jpnp
from esac_tpu.geometry import quartic as jquartic
from esac_tpu.geometry import rotations as jrot
from esac_tpu.ransac.refine import refine_soft_inliers as j_refine
from esac_tpu_torch.geometry import camera as tcam
from esac_tpu_torch.geometry import pnp as tpnp
from esac_tpu_torch.geometry import quartic as tquartic
from esac_tpu_torch.geometry import rotations as trot
from esac_tpu_torch.ransac.refine import refine_soft_inliers as t_refine

F = np.float32(CAMERA_F / 4.0)
C = np.array([80.0, 60.0], np.float32)
FRAME_KW = dict(height=120, width=160, f=CAMERA_F / 4.0, c=(80.0, 60.0))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rvecs(seed, n=64):
    rng = np.random.default_rng(seed)
    rv = rng.normal(size=(n, 3)).astype(np.float32)
    rv[0] = 0.0                                            # identity
    rv[1] = [1e-8, -2e-8, 0.0]                             # Taylor branch
    rv[2] = [np.pi - 1e-4, 0.0, 0.0]                       # near pi
    axis = np.array([1.0, 2.0, -2.0], np.float32) / 3.0
    rv[3] = axis * np.float32(np.pi - 5e-4)                # near pi, oblique
    return rv


@pytest.mark.parametrize("seed", [0, 1])
def test_rodrigues_and_so3_log_match_jax(seed):
    """Identity, small-angle, near-pi and random rotations: matrices and
    logs agree to 2e-6 (float32 sin/cos/atan2 ULP differences)."""
    rv = _rvecs(seed)
    Rj = np.asarray(jax.vmap(jrot.rodrigues)(rv))
    Rt = trot.rodrigues(_t(rv)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=2e-6)
    lj = np.asarray(jax.vmap(jrot.so3_log)(Rj))
    lt = trot.so3_log(_t(Rj)).numpy()
    np.testing.assert_allclose(lt, lj, atol=2e-6)
    ej = np.asarray(jax.vmap(jrot.rot_error_deg)(Rj, Rj[::-1]))
    et = trot.rot_error_deg(_t(Rj), _t(Rj[::-1])).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-3)  # degrees: atan2 near 0/180


def test_reprojection_errors_with_behind_camera_points():
    """Points behind the MIN_DEPTH plane get the +1000 px penalty on both
    sides; errors agree to rtol 1e-5 (pixel errors up to ~1e3)."""
    rng = np.random.default_rng(3)
    X = rng.uniform(-3, 3, size=(200, 3)).astype(np.float32)
    X[:20, 2] = -5.0  # behind the camera (t_z = 2)
    X[20:30, 2] = -1.95  # inside the MIN_DEPTH clamp
    x2d = rng.uniform(0, 160, size=(200, 2)).astype(np.float32)
    R = np.asarray(jrot.rodrigues(jnp.array([0.1, -0.2, 0.05])))
    t = np.array([0.1, 0.2, 2.0], np.float32)
    ej = np.asarray(jcam.reprojection_errors(R, t, X, x2d, F, C))
    et = tcam.reprojection_errors(_t(R), _t(t), _t(X), _t(x2d), torch.tensor(F), _t(C)).numpy()
    assert (ej[:20] > 1000).all() and (et[:20] > 1000).all()
    np.testing.assert_allclose(et, ej, rtol=1e-5, atol=1e-4)
    rj, tj = jcam.pose_errors(R, t, R.T, -t)
    rt, tt = tcam.pose_errors(_t(R), _t(t), _t(R.T), _t(-t))
    np.testing.assert_allclose([float(rt), float(tt)], [float(rj), float(tj)], rtol=1e-5)


def test_solve_quartic_roots_match_jax():
    """Random and P3P-shaped quartics, including the reversed-polynomial
    branch (|q0| > |q4|) and a near-degenerate leading coefficient: the
    root SETS agree to 1e-3 relative, the solver's stated complex64 accuracy
    (a conjugate pair may come back in swapped order, which P3P ignores: it
    reads real parts and |imag|)."""
    rng = np.random.default_rng(4)
    co = rng.normal(size=(40, 5)).astype(np.float32)
    co[0, 0] = 1e-4            # near-cubic: reversed branch
    co[1] = [1, -10, 35, -50, 24]  # roots 1, 2, 3, 4
    rj = np.asarray(jax.vmap(jquartic.solve_quartic)(co))
    rt = tquartic.solve_quartic(_t(co)).numpy()
    for a, b in zip(rj, rt):
        d = np.abs(a[:, None] - b[None, :])
        tol = 1e-3 * np.maximum(1.0, np.abs(a))
        assert (d.min(axis=1) <= tol).all(), (a, b)
        assert (d.min(axis=0) <= 1e-3 * np.maximum(1.0, np.abs(b))).all(), (a, b)
    np.testing.assert_allclose(np.sort(rt[1].real), [1, 2, 3, 4], atol=1e-3)


def _pnp_problems(seed, n=64):
    """Random scene points 2.5-5.5 m in front of random poses with exact
    pixel observations (the generator of tests/test_pnp.py), in numpy."""
    rng = np.random.default_rng(seed)
    rv = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    t = (np.array([0.2, -0.1, 0.3]) + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    X = (rng.uniform(-1.5, 1.5, (n, 4, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    R = np.asarray(jax.vmap(jrot.rodrigues)(rv))
    Y = np.einsum("nij,nkj->nki", R, X) + t[:, None]
    x2d = (Y[..., :2] / Y[..., 2:] * F + C).astype(np.float32)
    return R, t, X, x2d


def test_solve_pnp_minimal_recovers_pose_like_jax():
    """64 random minimal problems solved in one batched call.  Held by pose
    error, not bitwise: with the bounds of tests/test_pnp.py (1 deg, 5 cm,
    56/64 -- random 4-point geometry occasionally hits a P3P-ambiguous
    configuration), both packages recover the ground truth, and the port's
    solution agrees with the JAX one on as many problems."""
    R_gt, t_gt, X4, x4 = _pnp_problems(5)
    rj, tj = jax.vmap(lambda X, x: jpnp.solve_pnp_minimal(X, x, F, C))(X4, x4)
    rt, tt = tpnp.solve_pnp_minimal(_t(X4), _t(x4), torch.tensor(F), _t(C))
    rj, tj = _t(np.asarray(rj)), _t(np.asarray(tj))
    for R_ref, t_ref in ((_t(R_gt), _t(t_gt)), (trot.rodrigues(rj), tj)):
        rot, trans = tcam.pose_errors(trot.rodrigues(rt), tt, R_ref, t_ref)
        assert int(((rot < 1.0) & (trans < 0.05)).sum()) >= 56, (rot, trans)
    rot, trans = tcam.pose_errors(trot.rodrigues(rj), tj, _t(R_gt), _t(t_gt))
    assert int(((rot < 1.0) & (trans < 0.05)).sum()) >= 56


def test_gn_and_solve6_match_jax():
    """One weighted GN step with the hand Jacobian, including clamped
    (behind-camera) points, and the unrolled 6x6 solve."""
    rng = np.random.default_rng(6)
    R_gt, t_gt, X, _ = _pnp_problems(6, n=1)
    X = (rng.uniform(-1.5, 1.5, (300, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    Y = X @ R_gt[0].T + t_gt[0]
    x2d = (Y[:, :2] / Y[:, 2:] * F + C + rng.normal(0, 0.5, (300, 2))).astype(np.float32)
    X[:5] = [0.0, 0.0, -50.0]  # clamped points
    R = np.asarray(jrot.rodrigues(jrot.so3_log(R_gt[0]) + 0.01))
    t = t_gt[0] + 0.02
    w = rng.uniform(0, 1, 300).astype(np.float32)
    Rj, tj = jpnp._gn_pose_step(R, t, X, x2d, F, C, w, 1e-4)
    Rt, tt = tpnp._gn_pose_step(_t(R), _t(t), _t(X), _t(x2d), torch.tensor(F), _t(C), _t(w), 1e-4)
    # The 6x6 normal equations are summed over 300 cells in another order,
    # and rotation and translation are strongly coupled for a narrow field
    # of points (condition ~1e4), which amplifies float32 rounding of the
    # sums: 1e-4 absolute on R entries and t (m).
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    A = A @ A.T + 6 * np.eye(6, dtype=np.float32)
    g = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(tpnp._solve6_spd(_t(A), _t(g)).numpy(),
                               np.asarray(jpnp._solve6_spd(A, g)), rtol=1e-4, atol=1e-6)


def test_refine_soft_inliers_matches_jax():
    """8 IRLS rounds from a perturbed pose on a noisy frame with 30%
    outliers: both packages converge to the same pose (1e-4 rad / 1e-4 m;
    float32 jitter through 8 GN solves), batched on the port side."""
    frame = make_correspondence_frame(jax.random.key(2), noise=0.02,
                                      outlier_frac=0.3, **FRAME_KW)
    coords, pixels = np.asarray(frame["coords"]), np.asarray(frame["pixels"])
    rv0 = np.asarray(frame["rvec"]) + np.float32(0.02)
    tv0 = np.asarray(frame["tvec"]) - np.float32(0.05)
    rj, tj = j_refine(rv0, tv0, coords, pixels, F, C, 10.0, 0.5, iters=8)
    rt, tt = t_refine(_t(rv0)[None].repeat(2, 1), _t(tv0)[None].repeat(2, 1),
                      _t(coords), _t(pixels), torch.tensor(F), _t(C), 10.0, 0.5, iters=8)
    for b in range(2):
        np.testing.assert_allclose(rt[b].numpy(), np.asarray(rj), atol=1e-4)
        np.testing.assert_allclose(tt[b].numpy(), np.asarray(tj), atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_refine_pose_gn_matches_jax(weighted):
    """Axis-angle GN from a perturbed start on 16 problems of the generator
    of tests/test_pnp.py, 12 points each with 0.5 px noise, batched on the
    port side: both packages reach the same pose (1e-4 rad / 1e-4 m, float32
    jitter through 5 GN solves), closer to the ground truth than the start."""
    rng = np.random.default_rng(8)
    R_gt, t_gt, _, _ = _pnp_problems(8, n=16)
    X = (rng.uniform(-1.5, 1.5, (16, 12, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    Y = np.einsum("nij,nkj->nki", R_gt, X) + t_gt[:, None]
    x2d = (Y[..., :2] / Y[..., 2:] * F + C + rng.normal(0, 0.5, (16, 12, 2))).astype(np.float32)
    rv0 = (np.asarray(jax.vmap(jrot.so3_log)(R_gt)) + rng.normal(0, 0.03, (16, 3))).astype(
        np.float32)
    tv0 = (t_gt + rng.normal(0, 0.05, (16, 3))).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (16, 12)).astype(np.float32) if weighted else None
    rj, tj = jax.vmap(lambda r, t, Xi, xi, wi: jpnp.refine_pose_gn(r, t, Xi, xi, F, C, wi))(
        rv0, tv0, X, x2d, w if weighted else np.ones((16, 12), np.float32))
    rt, tt = tpnp.refine_pose_gn(_t(rv0), _t(tv0), _t(X), _t(x2d), torch.tensor(F), _t(C),
                                 None if w is None else _t(w))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    rot, trans = tcam.pose_errors(trot.rodrigues(rt), tt, _t(R_gt), _t(t_gt))
    rot0, trans0 = tcam.pose_errors(trot.rodrigues(_t(rv0)), _t(tv0), _t(R_gt), _t(t_gt))
    assert float(rot.median()) < float(rot0.median())
    assert float(trans.median()) < float(trans0.median())


def test_pnp_success_matches_jax():
    """The GT poses of 64 problems fit their 4 points within 2 px; moved by
    5 cm, most do not; a point behind the camera fails its +1000 px: the
    two packages' predicates agree everywhere."""
    R_gt, t_gt, X4, x4 = _pnp_problems(9)
    rv = np.asarray(jax.vmap(jrot.so3_log)(R_gt))
    tv = np.stack([t_gt, t_gt + np.float32(0.05)])
    X4b = X4.copy()
    X4b[::7, 2] = [0.0, 0.0, -10.0]
    for X in (X4, X4b):
        for t in tv:
            want = np.asarray(jax.vmap(lambda r, ti, Xi, xi: jpnp.pnp_success(
                r, ti, Xi, xi, F, C, 2.0))(rv, t, X, x4))
            got = tpnp.pnp_success(_t(rv), _t(t), _t(X), _t(x4), torch.tensor(F), _t(C), 2.0)
            np.testing.assert_array_equal(got.numpy(), want)
            if X is X4b:
                assert not got[::7].any()
    assert want.sum() < 32 and got.dtype == torch.bool
    exact = tpnp.pnp_success(_t(rv), _t(t_gt), _t(X4), _t(x4), torch.tensor(F), _t(C), 2.0)
    assert bool(exact.all())


def test_exact_sampler_draws_distinct_uniform_sets():
    """Gumbel-top-4 on an explicit generator: 4 distinct indices a set,
    uniform marginals (chi-square of the cell counts below the 0.999
    quantile, as the JAX sampler's on its own draws), batch shape and device
    kept, a seeded generator repeating its draws."""
    from esac_tpu.ransac.sampling import sample_correspondence_sets_exact as j_exact
    from esac_tpu_torch.ransac.sampling import sample_correspondence_sets_exact

    n_cells, n_hyps = 40, 3000
    got = sample_correspondence_sets_exact(torch.Generator().manual_seed(1), n_hyps, n_cells)
    want = np.asarray(j_exact(jax.random.key(1), n_hyps, n_cells))
    assert got.shape == want.shape == (n_hyps, 4) and got.dtype == torch.int64
    chi2_999 = 73.4  # 0.999 quantile of chi-square with 39 degrees of freedom
    for draws in (got.numpy(), want):
        assert all(len(set(row)) == 4 for row in draws.tolist())
        counts = np.bincount(draws.ravel(), minlength=n_cells)
        expect = 4 * n_hyps / n_cells
        assert ((counts - expect) ** 2 / expect).sum() < chi2_999
        for j in range(4):  # each position alone is uniform too
            col = np.bincount(draws[:, j], minlength=n_cells)
            assert ((col - n_hyps / n_cells) ** 2 / (n_hyps / n_cells)).sum() < chi2_999
    batched = sample_correspondence_sets_exact(torch.Generator().manual_seed(1), 5, 9, (2, 3))
    assert batched.shape == (2, 3, 5, 4) and int(batched.max()) < 9
    assert torch.equal(got, sample_correspondence_sets_exact(
        torch.Generator().manual_seed(1), n_hyps, n_cells))
