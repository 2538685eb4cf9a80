"""Closed-form cubic/quartic roots in complex64 (counterpart of
``esac_tpu/geometry/quartic.py``).

Cardano/Ferrari written branchless over any batch, so B x M x n_hyps P3P
quartics are one tensor computation.  This is plain PyTorch, as it is plain
XLA in the JAX package; it is not one of the hand-written kernels.

Integer powers are written as products: ``torch.pow`` of a complex tensor
may take the exp/log route, which is less accurate than the repeated
products ``jnp``'s integer powers lower to.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12
# Complex-sqrt epsilon: keeps sqrt's derivative finite at double roots;
# shifts roots by ~1e-9, far below the solver's float32 accuracy.
_SQRT_EPS = 1e-18


def _safe_csqrt(z: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(z + _SQRT_EPS)


def _cbrt(z: torch.Tensor) -> torch.Tensor:
    """Principal complex cube root, total at 0."""
    small = torch.abs(z) < _EPS
    safe = torch.where(small, torch.ones_like(z), z)
    return torch.where(small, torch.zeros_like(z), torch.exp(torch.log(safe) / 3.0))


def solve_cubic(B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Roots of m^3 + B m^2 + C m + D.  (...) each -> (..., 3) complex64."""
    B = B.to(torch.complex64)
    C = C.to(torch.complex64)
    D = D.to(torch.complex64)
    P = C - B * B / 3.0
    Q = 2.0 * (B * B * B) / 27.0 - B * C / 3.0 + D
    Qh, Pt = Q / 2.0, P / 3.0
    S = _safe_csqrt(Qh * Qh + Pt * Pt * Pt)
    z1 = -Q / 2.0 + S
    z2 = -Q / 2.0 - S
    # The larger branch for the cube root avoids cancellation.
    z = torch.where(torch.abs(z1) >= torch.abs(z2), z1, z2)
    U = _cbrt(z)
    small = torch.abs(U) < _EPS
    W = torch.where(
        small, torch.zeros_like(U),
        -P / (3.0 * torch.where(small, torch.ones_like(U), U)),
    )
    omega = complex(math.cos(2 * math.pi / 3), math.sin(2 * math.pi / 3))
    ks = torch.tensor([1.0 + 0j, omega, omega * omega], dtype=torch.complex64,
                      device=B.device)
    return ks * U[..., None] + ks.conj() * W[..., None] - (B / 3.0)[..., None]


def _ferrari(a3: torch.Tensor, a2: torch.Tensor, a1: torch.Tensor,
             a0: torch.Tensor) -> torch.Tensor:
    """Roots of the monic quartic v^4 + a3 v^3 + a2 v^2 + a1 v + a0
    (complex (...) each) -> (..., 4)."""
    # Depressed quartic y^4 + p y^2 + q y + r with v = y - a3/4.
    a3sq = a3 * a3
    p = a2 - 3.0 * a3sq / 8.0
    q = a1 - a3 * a2 / 2.0 + (a3sq * a3) / 8.0
    r = a0 - a3 * a1 / 4.0 + a3sq * a2 / 16.0 - 3.0 * (a3sq * a3sq) / 256.0

    # Resolvent cubic m^3 + p m^2 + (p^2 - 4r)/4 m - q^2/8 = 0; the root of
    # largest |m| keeps s = sqrt(2m) away from zero.
    m_roots = solve_cubic(p, (p * p - 4.0 * r) / 4.0, -q * q / 8.0)
    k = torch.argmax(torch.abs(m_roots), dim=-1, keepdim=True)
    m = torch.gather(m_roots, -1, k)[..., 0]
    s = _safe_csqrt(2.0 * m)
    small = torch.abs(s) < _EPS
    s_safe = torch.where(small, torch.ones_like(s), s)
    qs = torch.where(small, torch.zeros_like(s), q / (2.0 * s_safe))

    t1 = p / 2.0 + m - qs
    t2 = p / 2.0 + m + qs
    d1 = _safe_csqrt(s * s - 4.0 * t1)
    d2 = _safe_csqrt(s * s - 4.0 * t2)
    y = torch.stack(
        [(-s + d1) / 2.0, (-s - d1) / 2.0, (s + d2) / 2.0, (s - d2) / 2.0],
        dim=-1,
    )
    return y - (a3 / 4.0)[..., None]


def solve_quartic(coeffs: torch.Tensor) -> torch.Tensor:
    """Roots of q4 v^4 + q3 v^3 + q2 v^2 + q1 v + q0.

    coeffs: (..., 5) real [q4, q3, q2, q1, q0].  Returns (..., 4) complex64.

    When |q0| > |q4| the reversed polynomial (roots 1/v) is better
    conditioned, so both ends are solved and one selected, branchless.  The
    ``lead_safe`` floor (1e-2 of the max coefficient) keeps the untaken
    branch finite: Ferrari's worst intermediate (~|a3|^6) stays in float32.
    """
    mx = torch.amax(torch.abs(coeffs), dim=-1)
    scale = torch.where(mx > 1e-15, mx, torch.ones_like(mx))
    c = (coeffs / scale[..., None]).to(torch.float32)
    q4, q0 = c[..., 0], c[..., 4]

    def lead_safe(q):
        floor = torch.where(q < 0, -1e-2, 1e-2).to(q.dtype)
        return torch.where(torch.abs(q) < 1e-2, floor, q)

    def cplx(x):
        return x.to(torch.complex64)

    q4s = lead_safe(q4)
    q0s = lead_safe(q0)
    fwd = _ferrari(cplx(c[..., 1] / q4s), cplx(c[..., 2] / q4s),
                   cplx(c[..., 3] / q4s), cplx(c[..., 4] / q4s))
    rev_w = _ferrari(cplx(c[..., 3] / q0s), cplx(c[..., 2] / q0s),
                     cplx(c[..., 1] / q0s), cplx(c[..., 0] / q0s))
    w_safe = torch.where(torch.abs(rev_w) < 1e-8,
                         torch.full_like(rev_w, 1e-8), rev_w)
    rev = 1.0 / w_safe
    return torch.where((torch.abs(q4) >= torch.abs(q0))[..., None], fwd, rev)
