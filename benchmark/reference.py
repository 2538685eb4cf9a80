"""Plain PyTorch reference of one served frame: the CNNs, the hypothesis
loop and the refinement, written from the published method and imports
nothing of the program.

- CNNs in float32 (the caller turns TF32 off), from the weights the
  benchmark made (``scene.make_weights``), by the published layer order.
- Correspondence sets: each frame's ``torch.Generator`` on the device,
  seeded with the frame's request seed, draws (M, n_hyps, 4) cell indices
  with ``torch.randint`` -- the serving contract of the seed a request
  carries (gating-first routed: (M, n_hyps M // K, 4), the rows of the K
  selected experts kept; :func:`serve_frames`).
- Minimal solve: Grunert's P3P quartic on the first three points (the
  coefficients of Haralick et al. 1994), its roots as eigenvalues of the
  companion matrix, each root's rigid fit by SVD (Kabsch), the fourth
  point choosing the root, then Gauss-Newton on the four points to
  convergence -- float64.
- Score: the soft-inlier count sum(sigmoid(beta (tau - err))) over every
  cell, a 1000 px penalty behind 0.1 m; the winner is the first maximum
  over all served experts' hypotheses.
- Refinement: ``refine_iters`` rounds of soft-inlier-weighted Gauss-Newton
  from the winner, float64.

``precision`` lowers the arithmetic for the controls of the comparison:
"cnn_fp8" rounds every convolution's input and weights to float8 e4m3
(the step below the bfloat16 the configuration states for the CNNs);
"head3_fp8" does so for the experts' head 3 x 3 convolutions alone (most
of an expert's operations), and "head3_skip" leaves them out (each head
block keeps its skip alone); "score_bf16" scores in bfloat16 (the step
below float32 for the hypothesis loop).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.counts import hyps_per_expert, served_experts
from benchmark.scene import expert_layers, gating_layers

MIN_DEPTH = 0.1
BEHIND_PENALTY_PX = 1000.0
POLISH_ITERS = 6


def pixel_grid(cfg: dict, device) -> torch.Tensor:
    """Centers of the stride-``s`` output cells, (N, 2) as (x, y), row-major."""
    s = cfg["stride"]
    ys = torch.arange(cfg["height"] // s, device=device, dtype=torch.float64) * s + s / 2
    xs = torch.arange(cfg["width"] // s, device=device, dtype=torch.float64) * s + s / 2
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def _round(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).float() if fp8 else x


def _conv(x, w, b, stride, k, fp8):
    return F.conv2d(_round(x, fp8), _round(w, fp8), b, stride, k // 2)


def expert_coords(cfg: dict, experts: dict, images: torch.Tensor,
                  precision: str = "float32") -> torch.Tensor:
    """Every expert's scene coordinates (B, M, N, 3) of images (B, H, W, 3)."""
    out = []
    layers = {key: (stride, k, kind) for key, _, _, k, stride, kind in expert_layers(cfg)}
    for m in range(cfg["num_experts"]):
        def conv(key, x):
            stride, k, kind = layers[key]
            fp8 = precision == "cnn_fp8" or (precision == "head3_fp8" and kind == "feature")
            return _conv(x, experts[f"{key}.weight"][m], experts[f"{key}.bias"][m], stride,
                         k, fp8)

        x = images.permute(0, 3, 1, 2).float()
        for key in [key for key in layers if key.startswith("stem.")]:
            x = F.relu(conv(key, x))
        for b in range(cfg["head_depth"]):
            h = (0.0 if precision == "head3_skip" else
                 conv(f"head.{b}.conv1", F.relu(conv(f"head.{b}.conv3", x))))
            if f"head.{b}.proj" in layers:
                x = conv(f"head.{b}.proj", x)
            x = F.relu(x + h)
        x = conv("coord", x).permute(0, 2, 3, 1) + experts["scene_center"][m]
        out.append(x.reshape(x.shape[0], -1, 3))
    return torch.stack(out, 1)


def gating_logits(cfg: dict, gating: dict | None, images: torch.Tensor,
                  precision: str = "float32") -> torch.Tensor:
    """Gating logits (B, M); zeros for an ungated configuration."""
    if gating is None:
        return torch.zeros((images.shape[0], cfg["num_experts"]), device=images.device)
    x = images.permute(0, 3, 1, 2).float()
    for key, _, _, k, stride in gating_layers(cfg):
        w, b = gating[f"{key}.weight"], gating[f"{key}.bias"]
        if k:
            x = F.relu(_conv(x, w, b, stride, k, precision == "cnn_fp8"))
        elif key == "dense0":
            x = F.relu(F.linear(x.mean(dim=(2, 3)), w, b))
        else:
            x = F.linear(x, w, b)
    return x


def correspondence_sets(seeds, M: int, n_hyps: int, n_cells: int, device) -> torch.Tensor:
    """(B, M, n_hyps, 4) cell indices, one seeded generator a frame."""
    return torch.stack([
        torch.randint(0, n_cells, (M, n_hyps, 4), device=device,
                      generator=torch.Generator(device=device).manual_seed(int(s)))
        for s in seeds])


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def expm_so3(w: torch.Tensor) -> torch.Tensor:
    """Rotation matrices of rotation vectors (..., 3) (Rodrigues)."""
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    K = _hat(w)
    small = th < 1e-12
    th_s = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th ** 2 / 6, torch.sin(th_s) / th_s)
    b = torch.where(small, 0.5 - th ** 2 / 24, (1 - torch.cos(th_s)) / th_s ** 2)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * (K @ K)


def rotation_angle_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    cos = ((R1.transpose(-1, -2) @ R2).diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def _project(R, t, X, f, c):
    """Camera points Y = R X + t and their pixels; X (..., N, 3)."""
    Y = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Y[..., 2:3]
    return Y, f * Y[..., :2] / z + c


def reprojection_errors(R, t, X, x, f, c) -> torch.Tensor:
    Y, uv = _project(R, t, X, f, c)
    err = torch.linalg.norm(uv - x, dim=-1)
    return torch.where(Y[..., 2] < MIN_DEPTH, err + BEHIND_PENALTY_PX, err)


def _gn_step(R, t, X, x, f, c, w):
    """One weighted Gauss-Newton step on the pose (left rotation update)."""
    Y, uv = _project(R, t, X, f, c)
    r = (uv - x)                                           # (..., N, 2)
    z = Y[..., 2].clamp(min=MIN_DEPTH)
    zero = torch.zeros_like(z)
    dproj = torch.stack([torch.stack([f / z, zero, -f * Y[..., 0] / z ** 2], -1),
                         torch.stack([zero, f / z, -f * Y[..., 1] / z ** 2], -1)], -2)
    W = Y - t[..., None, :]                                # R X
    dY = torch.cat([-_hat(W), torch.eye(3, dtype=X.dtype, device=X.device).expand(
        W.shape + (3,))], -1)                              # (..., N, 3, 6)
    J = dproj @ dY                                         # (..., N, 2, 6)
    Jw = J * w[..., None, None]
    A = torch.einsum("...nki,...nkj->...ij", Jw, J)
    g = torch.einsum("...nki,...nk->...i", Jw, r)
    A = A + 1e-9 * A.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] * torch.eye(
        6, dtype=X.dtype, device=X.device)
    d = torch.linalg.solve_ex(A, -g[..., None], check_errors=False)[0][..., 0]
    return expm_so3(d[..., :3]) @ R, t + d[..., 3:]


def _kabsch(P: torch.Tensor, Q: torch.Tensor):
    """R, t with Q ~= R P + t; P, Q (..., n, 3)."""
    pm, qm = P.mean(-2, keepdim=True), Q.mean(-2, keepdim=True)
    H = (P - pm).transpose(-1, -2) @ (Q - qm)
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    d = torch.linalg.det(V @ U.transpose(-1, -2))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = V @ D @ U.transpose(-1, -2)
    return R, (qm - pm @ R.transpose(-1, -2))[..., 0, :]


def p3p_grunert(X4: torch.Tensor, x4: torch.Tensor, f: float, c: torch.Tensor):
    """Minimal pose of each 4-point set, float64.  X4 (..., 4, 3), x4
    (..., 4, 2).  Returns R (..., 3, 3), t (..., 3); a set with no valid
    root gives NaN."""
    rays = torch.cat([(x4 - c) / f, torch.ones_like(x4[..., :1])], -1)
    j = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    P1, P2, P3 = X4[..., 0, :], X4[..., 1, :], X4[..., 2, :]
    a2 = ((P2 - P3) ** 2).sum(-1)
    b2 = ((P1 - P3) ** 2).sum(-1)
    c2 = ((P1 - P2) ** 2).sum(-1)
    ca = (j[..., 1, :] * j[..., 2, :]).sum(-1)
    cb = (j[..., 0, :] * j[..., 2, :]).sum(-1)
    cg = (j[..., 0, :] * j[..., 1, :]).sum(-1)
    p = (a2 - c2) / b2
    q = (a2 + c2) / b2
    A4 = (p - 1) ** 2 - 4 * c2 / b2 * ca ** 2
    A3 = 4 * (p * (1 - p) * cb - (1 - q) * ca * cg + 2 * c2 / b2 * ca ** 2 * cb)
    A2 = 2 * (p ** 2 - 1 + 2 * p ** 2 * cb ** 2 + 2 * (b2 - c2) / b2 * ca ** 2
              - 4 * q * ca * cb * cg + 2 * (b2 - a2) / b2 * cg ** 2)
    A1 = 4 * (-p * (1 + p) * cb + 2 * a2 / b2 * cg ** 2 * cb - (1 - q) * ca * cg)
    A0 = (1 + p) ** 2 - 4 * a2 / b2 * cg ** 2
    lead = A4.shape
    comp = torch.zeros(lead + (4, 4), dtype=X4.dtype, device=X4.device)
    comp[..., 0, :] = -torch.stack([A3, A2, A1, A0], -1) / A4[..., None]
    comp[..., 1, 0] = comp[..., 2, 1] = comp[..., 3, 2] = 1.0
    finite = torch.isfinite(comp).all(-1).all(-1)
    comp = torch.where(finite[..., None, None], comp, torch.zeros_like(comp))
    # LAPACK on the host: batched 4 x 4 eigenproblems are a loop there
    # either way, and on the card each one would round-trip.
    roots = torch.linalg.eigvals(comp.cpu()).to(X4.device)  # (..., 4) complex
    v = roots.real
    real = (roots.imag.abs() <= 1e-6 * (1 + v.abs())) & finite[..., None]
    v4 = v
    p_, cb_, ca_, cg_, b2_ = (x[..., None] for x in (p, cb, ca, cg, b2))
    u = ((p_ - 1) * v4 ** 2 - 2 * p_ * cb_ * v4 + 1 + p_) / (2 * (cg_ - v4 * ca_))
    s1 = torch.sqrt(b2_ / (1 + v4 ** 2 - 2 * v4 * cb_))
    depths = torch.stack([s1, u * s1, v4 * s1], -1)         # (..., 4 roots, 3)
    ok = real & (depths > 0).all(-1) & torch.isfinite(depths).all(-1)
    Y3 = depths[..., None] * j[..., None, :3, :]            # (..., 4, 3, 3)
    Y3 = torch.where(ok[..., None, None], Y3, torch.zeros_like(Y3))
    X3 = X4[..., None, :3, :].expand(Y3.shape)
    Rs, ts = _kabsch(X3, Y3)
    err4 = reprojection_errors(Rs, ts, X4[..., None, 3:4, :], x4[..., None, 3:4, :], f,
                               c)[..., 0]
    err4 = torch.where(ok & torch.isfinite(err4), err4, torch.inf)
    best = err4.argmin(-1)
    R = torch.take_along_dim(Rs, best[..., None, None, None], -3)[..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None, None], -2)[..., 0, :]
    bad = ~torch.isfinite(err4.amin(-1))
    R = torch.where(bad[..., None, None], torch.nan, R)
    t = torch.where(bad[..., None], torch.nan, t)
    for _ in range(POLISH_ITERS):
        R, t = _gn_step(R, t, X4, x4, f, c, torch.ones_like(X4[..., 0]))
    return R, t


def scores(R, t, X, x, f, c, tau, beta, precision="float32") -> torch.Tensor:
    """Soft-inlier counts of poses (..., H) over maps X (..., N, 3)."""
    if precision == "score_bf16":
        R, t, X, x = (v.to(torch.bfloat16) for v in (R, t, X, x))
        c = c.to(torch.bfloat16)
    err = reprojection_errors(R, t, X[..., None, :, :], x, f, c)
    return torch.sigmoid(beta * (tau - err)).double().sum(-1)


def refine(R, t, X, x, f, c, tau, beta, iters):
    for _ in range(iters):
        w = torch.sigmoid(beta * (tau - reprojection_errors(R, t, X, x, f, c)))
        R, t = _gn_step(R, t, X, x, f, c, w)
    return R, t


def top_experts(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Each frame's ``k`` experts of largest logit (B, k): the order of a
    stable descending sort (equal logits by ascending id), then sorted
    ascending by expert id."""
    top = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.sort(top, dim=-1).values


def serve_frames(cfg: dict, experts: dict, gating: dict | None, images: torch.Tensor,
                 seeds, precision: str = "float32") -> dict:
    """The reference's answer for a block of frames: gating probabilities,
    every expert's best score, the winning expert and score, and the
    refined pose (R, t), float64.

    Gating-first routed (``serve_topk`` K < M): the top K of the float32
    gating logits serve the frame, each with nh = n_hyps M // K
    hypotheses, the rows of their ids kept from the frame's (M, nh, 4)
    sets; the winner is the first maximum over the K x nh scores, and an
    expert outside the top K has best score -inf.  Capacity drops, which
    depend on what else rode a dispatch, are not modelled.  At K = M this
    is the dense answer."""
    dev = images.device
    M, K, H = cfg["num_experts"], served_experts(cfg), hyps_per_expert(cfg)
    f, (cx, cy) = 525.0 * cfg["width"] / 640.0, (cfg["width"] / 2.0, cfg["height"] / 2.0)
    c = torch.tensor([cx, cy], dtype=torch.float64, device=dev)
    pix = pixel_grid(cfg, dev)
    logits = gating_logits(cfg, gating, images, precision)
    X = expert_coords(cfg, experts, images, precision).double()       # (B, M, N, 3)
    B, N = X.shape[0], X.shape[2]
    rows = torch.arange(B, device=dev)
    sel = top_experts(logits, K)                                       # (B, K)
    X = X[rows[:, None], sel]                                          # (B, K, N, 3)
    idx = correspondence_sets(seeds, M, H, N, dev)[rows[:, None], sel]
    X4 = torch.take_along_dim(X[:, :, None], idx[..., None], -2)      # (B, K, H, 4, 3)
    x4 = pix[idx]
    R, t = p3p_grunert(X4, x4, f, c)
    s = scores(R, t, X, pix, f, c, cfg["tau"], cfg["beta"], precision)  # (B, K, H)
    s = torch.nan_to_num(s, nan=-torch.inf)
    flat = s.reshape(B, K * H).argmax(-1)
    k, jh = flat // H, flat % H
    R0, t0 = R[rows, k, jh], t[rows, k, jh]
    Rr, tr = refine(R0, t0, X[rows, k], pix, f, c, cfg["tau"], cfg["beta"],
                    cfg["refine_iters"])
    best = torch.full((B, M), -torch.inf, dtype=s.dtype, device=dev)
    return {"gating_probs": torch.softmax(logits.double(), -1), "expert": sel[rows, k],
            "best": best.scatter(1, sel, s.amax(-1)), "score": s.reshape(B, -1).amax(-1),
            "R": Rr, "t": tr}
