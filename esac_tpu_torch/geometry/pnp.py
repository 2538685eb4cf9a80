"""Batched minimal PnP and weighted Gauss-Newton (counterpart of
``esac_tpu/geometry/pnp.py``).

The same algorithm as the JAX package -- Grunert P3P on the first three
correspondences via the branchless complex quartic, all four root branches
disambiguated by the fourth point, the pose of each branch by orthonormal
triads, then a few Gauss-Newton steps -- written over leading batch
dimensions instead of under ``vmap``: ``solve_pnp_minimal`` on
(B, M, n_hyps, 4, 3) inputs is one tensor computation with no Python loop
over hypotheses.  Near-tied quartic branches flip on one ULP, so results
agree with the JAX package by pose error, not bit for bit.
"""

from __future__ import annotations

import torch

from esac_tpu_torch.geometry.camera import MIN_DEPTH, reprojection_errors
from esac_tpu_torch.geometry.quartic import solve_quartic
from esac_tpu_torch.geometry.rotations import rodrigues, so3_log
from esac_tpu_torch.utils.num import safe_norm, safe_sqrt
from esac_tpu_torch.utils.precision import hmm


def bearings(x2d: torch.Tensor, f: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pixels -> unit bearing vectors. x2d (..., N, 2), f (...) -> (..., N, 3).

    The focal length is a physical intrinsic bounded away from 0, so it is
    not floored (as in the JAX package)."""
    xy = (x2d - c) / f[..., None, None]
    rays = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return rays / safe_norm(rays)[..., None]


def _p3p_depths(b3: torch.Tensor, X3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Algebraic P3P (Grunert): depths of 3 rays for up to 4 solutions.

    b3: (..., 3, 3) unit bearings, X3: (..., 3, 3) scene points.  Returns
    (depths (..., 4, 3), penalty (..., 4)); the penalty is 0 for clean real
    positive-depth roots and large for complex/negative/degenerate ones.
    See the JAX docstring for the derivation of D, E, G and Q.
    """
    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    ca = dot(b3[..., 1, :], b3[..., 2, :])
    cb = dot(b3[..., 0, :], b3[..., 2, :])
    cg = dot(b3[..., 0, :], b3[..., 1, :])
    asq = torch.sum((X3[..., 1, :] - X3[..., 2, :]) ** 2, dim=-1)
    bsq = torch.sum((X3[..., 0, :] - X3[..., 2, :]) ** 2, dim=-1)
    csq = torch.sum((X3[..., 0, :] - X3[..., 1, :]) ** 2, dim=-1)
    w = asq - csq

    d1, d0 = 2.0 * bsq * ca, -2.0 * bsq * cg
    e2, e1, e0 = w - bsq, -2.0 * w * cb, bsq + w
    g2, g1, g0 = -csq, 2.0 * csq * cb, bsq - csq

    # Polynomial products by explicit convolution (highest degree first).
    E2 = torch.stack(
        [e2 * e2, 2 * e2 * e1, 2 * e2 * e0 + e1 * e1, 2 * e1 * e0, e0 * e0], dim=-1
    )
    ED = torch.stack(
        [torch.zeros_like(e2), e2 * d1, e2 * d0 + e1 * d1, e1 * d0 + e0 * d1, e0 * d0],
        dim=-1,
    )
    A2, B2, C2 = d1 * d1, 2 * d1 * d0, d0 * d0
    GD2 = torch.stack(
        [g2 * A2, g2 * B2 + g1 * A2, g2 * C2 + g1 * B2 + g0 * A2,
         g1 * C2 + g0 * B2, g0 * C2],
        dim=-1,
    )
    Q = bsq[..., None] * E2 + (2.0 * bsq * cg)[..., None] * ED + GD2

    roots = solve_quartic(Q)  # (..., 4) complex
    v = roots.real
    imag_pen = torch.abs(roots.imag)

    d1, d0, cb, bsq = d1[..., None], d0[..., None], cb[..., None], bsq[..., None]
    e2, e1, e0 = e2[..., None], e1[..., None], e0[..., None]
    Dv = d1 * v + d0
    Ev = (e2 * v + e1) * v + e0
    # Sign-preserving clamp (sign(0) -> +1), penalized like the other
    # degeneracies.
    Dv_sign = torch.where(Dv < 0, -1.0, 1.0).to(Dv.dtype)
    Dv_safe = torch.where(torch.abs(Dv) < 1e-9, Dv_sign * 1e-9, Dv)
    u = -Ev / Dv_safe
    denom = 1.0 + v * v - 2.0 * v * cb
    s1 = safe_sqrt(bsq / torch.clamp(denom, min=1e-9))
    depths = torch.stack([s1, u * s1, v * s1], dim=-1)  # (..., 4 roots, 3 points)

    penalty = (
        imag_pen
        + 1e3 * torch.sum(torch.clamp(MIN_DEPTH - depths, min=0.0), dim=-1)
        + 1e3 * (denom < 1e-9).to(v.dtype)
        + 1e3 * (torch.abs(Dv) < 1e-9).to(v.dtype)
    )
    return depths, penalty


def _triad_align(X: torch.Tensor, Y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rigid pose (R, t) with Y ~= R X + t from exactly 3 correspondences.
    X, Y: (..., 3, 3) points as rows.  Orthonormal triads: pure elementwise
    arithmetic, finite garbage for collinear triples (safe_norm guards)."""
    ux, vx = X[..., 1, :] - X[..., 0, :], X[..., 2, :] - X[..., 0, :]
    uy, vy = Y[..., 1, :] - Y[..., 0, :], Y[..., 2, :] - Y[..., 0, :]
    nx = torch.linalg.cross(ux, vx, dim=-1)
    ny = torch.linalg.cross(uy, vy, dim=-1)
    e1x = ux / safe_norm(ux)[..., None]
    e3x = nx / safe_norm(nx)[..., None]
    e2x = torch.linalg.cross(e3x, e1x, dim=-1)
    e1y = uy / safe_norm(uy)[..., None]
    e3y = ny / safe_norm(ny)[..., None]
    e2y = torch.linalg.cross(e3y, e1y, dim=-1)
    Bx = torch.stack([e1x, e2x, e3x], dim=-1)  # columns
    By = torch.stack([e1y, e2y, e3y], dim=-1)
    R = hmm(By, Bx.transpose(-1, -2))
    t = Y.mean(dim=-2) - hmm(R, X.mean(dim=-2)[..., None])[..., 0]
    return R, t


def _solve6_spd(A: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve damped SPD 6x6 systems by unrolled Gauss-Jordan, no pivoting
    (SPD + Levenberg damping keeps the diagonal positive).  A (..., 6, 6),
    g (..., 6) -> (..., 6).  Six unrolled steps of batched arithmetic in
    place of ``torch.linalg.solve``, as in the JAX package."""
    M = torch.cat([A, g[..., None]], dim=-1)  # (..., 6, 7)
    for i in range(6):
        piv = M[..., i, i]
        piv = torch.where(torch.abs(piv) < 1e-12, torch.full_like(piv, 1e-12), piv)
        row = M[..., i, :] / piv[..., None]
        keep = torch.ones(6, dtype=M.dtype, device=M.device)
        keep[i] = 0.0
        factors = M[..., :, i] * keep
        M = M - factors[..., :, None] * row[..., None, :]
        M[..., i, :] = row
    return M[..., 6]


def _gn_pose_step(
    R: torch.Tensor,
    t: torch.Tensor,
    X: torch.Tensor,
    x2d: torch.Tensor,
    f: torch.Tensor,
    c: torch.Tensor,
    w: torch.Tensor,
    damping: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One weighted GN/LM step with the hand-derived Jacobian of the JAX
    package (left-multiplicative rotation update R <- exp(delta) R).
    R (..., 3, 3), t (..., 3), X (..., N, 3), x2d (..., N, 2), f (...),
    w (..., N)."""
    Y = hmm(X, R.transpose(-1, -2)) + t[..., None, :]
    z = torch.clamp(Y[..., 2], min=MIN_DEPTH)
    inv_z = 1.0 / z
    fN = f[..., None]
    u = fN * Y[..., 0] * inv_z + c[0]
    v = fN * Y[..., 1] * inv_z + c[1]
    ru = u - x2d[..., 0]
    rv = v - x2d[..., 1]
    # Where the depth clamp is active the residual is constant in Y2, so its
    # z-derivative is zero (what autodiff through the clamp gives).
    clamped = Y[..., 2] < MIN_DEPTH
    zero = torch.zeros_like(inv_z)
    fu0 = fN * inv_z
    fu2 = torch.where(clamped, zero, -fN * Y[..., 0] * inv_z * inv_z)
    fv2 = torch.where(clamped, zero, -fN * Y[..., 1] * inv_z * inv_z)
    W = Y - t[..., None, :]  # = R X
    W0, W1, W2 = W[..., 0], W[..., 1], W[..., 2]
    # d(exp(d) W)/dd_k = e_k x W.
    rowu = torch.stack(
        [fu2 * W1, fu0 * W2 - fu2 * W0, -fu0 * W1, fu0, torch.zeros_like(fu0), fu2],
        dim=-1,
    )
    rowv = torch.stack(
        [-fu0 * W2 + fv2 * W1, -fv2 * W0, fu0 * W0, torch.zeros_like(fu0), fu0, fv2],
        dim=-1,
    )
    wu = w[..., None] * rowu
    wv = w[..., None] * rowv
    A = hmm(rowu.transpose(-1, -2), wu) + hmm(rowv.transpose(-1, -2), wv)  # (..., 6, 6)
    g = (hmm(wu.transpose(-1, -2), ru[..., None])[..., 0]
         + hmm(wv.transpose(-1, -2), rv[..., None])[..., 0])
    trace = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    mu = damping * (trace / 6.0 + 1e-6)
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    delta = _solve6_spd(A + mu[..., None, None] * eye, g)
    R_new = hmm(rodrigues(-delta[..., :3]), R)
    t_new = t - delta[..., 3:]
    return R_new, t_new


def refine_pose_gn_R(
    R: torch.Tensor,
    tvec: torch.Tensor,
    X: torch.Tensor,
    x2d: torch.Tensor,
    f,
    c: torch.Tensor,
    weights: torch.Tensor | None = None,
    iters: int = 5,
    damping: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """R-in/R-out weighted GN, a fixed number of steps."""
    f = torch.as_tensor(f, dtype=X.dtype, device=X.device)
    w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device) \
        if weights is None else weights
    for _ in range(iters):
        R, tvec = _gn_pose_step(R, tvec, X, x2d, f, c, w, damping)
    return R, tvec


def solve_pnp_minimal(
    X4: torch.Tensor,
    x4: torch.Tensor,
    f,
    c: torch.Tensor,
    polish_iters: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimal 4-point PnP. X4 (..., 4, 3) scene points, x4 (..., 4, 2)
    pixels, f (...) or scalar, c (2,).  Returns (rvec, tvec), each (..., 3),
    scene->camera.  Degenerate samples give some finite pose that scoring
    rejects."""
    f = torch.as_tensor(f, dtype=X4.dtype, device=X4.device)
    b = bearings(x4, f, c)
    depths, penalty = _p3p_depths(b[..., :3, :], X4[..., :3, :])  # (..., 4, 3), (..., 4)
    Y3 = depths[..., :, :, None] * b[..., None, :3, :]  # (..., 4 roots, 3, 3)
    X3 = X4[..., None, :3, :].expand(Y3.shape)
    Rs, ts = _triad_align(X3, Y3)
    # Disambiguate with the 4th correspondence.
    err4 = reprojection_errors(
        Rs, ts, X4[..., None, 3:4, :], x4[..., None, 3:4, :], f[..., None], c
    )[..., 0]
    cost = err4 + penalty
    # A NaN branch (pathological geometry) must never win the argmin.
    cost = torch.where(torch.isnan(cost), torch.full_like(cost, float("inf")), cost)
    best = torch.argmin(cost, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    R, t = refine_pose_gn_R(R, t, X4, x4, f, c, weights=None, iters=polish_iters)
    return so3_log(R), t
