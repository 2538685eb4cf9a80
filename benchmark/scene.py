"""Weights and request images of a run, made on the device from the seed.

Random CNN weights give scene coordinates with no geometry in them: every
pose hypothesis then scores near zero, near-ties decide the winner, and a
comparison of served poses with a reference can only read rounding.  So
the weights made here have the shapes and the cost of the configured
networks but carry a signal, as a trained network's do, through every
convolution:

- every 3 x 3 convolution spreads its signal over all nine taps: a
  point-symmetric kernel, drawn per output channel, whose taps sum to one
  and whose eight off-centre taps hold 40-60% of the weight (an affine
  image passes unchanged, so a planar surface keeps its geometry);
- the stem convolutions and head block 0's 1 x 1 projection pass the image
  on as known mixtures of its three channels (see :func:`make_weights`);
- in each head block the 3 x 3 convolution permutes the channels the skip
  carries and its 1 x 1 convolution permutes them back, so the residual
  branch carries half of the block's output signal: a fault or a lower
  precision in either convolution reaches the coordinates;
- expert m's coordinate head reads the image back from every channel and
  scales it by room m's extent (metres);
- every weight also gets Gaussian noise of relative size ``weight_noise``.

A request image is the scene-coordinate rendering of a camera inside one
room (a box), each coordinate divided by that room's extent: the expert of
that room reads the room's coordinates back, within the noise the weights
add; the other experts read the same room stretched by the ratio of two
rooms' extents, which no rigid pose explains.  So the right expert wins by
consensus, as with trained experts, and the refined pose is a well-posed
optimum.  The cost of every layer is what it is for any weights.

Everything is drawn from one ``torch.Generator`` on the device, in one
large call per network, in float32 (the type the program stores).

A configuration whose ``scene`` block names ``"gating": "rooms"`` gets a
gating net that routes by room, as a trained one does (gating-first
routed serving scores only the experts it selects).  A frame's image
coordinates say nothing of its room (each is divided by its own room's
extent, and their per-frame means swing over most of [0, 1]), so every
frame of room r carries a sign: its top band of ``2 ** stages`` rows
holds -(r + 1) / 16 in every channel, below any coordinate (>= 0).  The
gating reads the sign on the one row of its sampling grid inside the
band (:func:`_routing_gating`); the experts read the band as outliers
(their first ReLU zeroes it) and every other cell as before.  Without
the key nothing of the weights or the frames changes.
"""

from __future__ import annotations

import math

import torch


def expert_layers(cfg: dict) -> list[tuple]:
    """(key, cin, cout, k, stride, kind) of every expert convolution in call
    order; ``kind`` is "pass", "feature", "residual" or "coord"."""
    c0 = cfg["stem_channels"][0] // 2
    out = [("stem.0", 3, c0, 3, 1, "pass")]
    cin, i = c0, 1
    for ch in cfg["stem_channels"]:
        out += [(f"stem.{i}", cin, ch, 3, 2, "pass"), (f"stem.{i + 1}", ch, ch, 3, 1, "pass")]
        cin, i = ch, i + 2
    hc = cfg["head_channels"]
    for b in range(cfg["head_depth"]):
        out += [(f"head.{b}.conv3", cin, hc, 3, 1, "feature"),
                (f"head.{b}.conv1", hc, hc, 1, 1, "residual")]
        if cin != hc:
            out.append((f"head.{b}.proj", cin, hc, 1, 1, "pass"))
        cin = hc
    out.append(("coord", cin, 3, 1, 1, "coord"))
    return out


def gating_layers(cfg: dict) -> list[tuple]:
    """(key, cin, cout, k, stride) of the gating convolutions, then the two
    dense layers as (key, cin, cout, 0, 0)."""
    out, cin = [], 3
    for i, ch in enumerate(cfg["gating_channels"]):
        out += [(f"convs.{2 * i}", cin, ch, 3, 2), (f"convs.{2 * i + 1}", ch, ch, 3, 1)]
        cin = ch
    hidden = max(4 * cfg["num_experts"], 64)
    return out + [("dense0", cin, hidden, 0, 0), ("dense1", hidden, cfg["num_experts"], 0, 0)]


def routes_by_room(cfg: dict) -> bool:
    """Whether the configuration's gating routes by room (module docstring)."""
    return cfg["scene"].get("gating") == "rooms"


# Step between two rooms' signs (a power of two: every sign, and every
# value the routing gating computes from it, is exact in bfloat16), and
# the logit between a frame's consecutive choices of expert.
SIGN_STEP = 1.0 / 16.0
ROUTING_MARGIN = 4.0


def sign_band(cfg: dict) -> int:
    """Rows of the sign band: one stride-2 stage of the gating halves the
    grid it samples, so after all of them row 0 is the only sampled row
    in the band."""
    return 2 ** len(cfg["gating_channels"])


def _routing_gating(cfg: dict, device) -> dict:
    """The gating state dict that routes a frame of room r to experts r,
    r + 1, r + 2, ... (mod M) in that order, ``ROUTING_MARGIN`` logits
    apart, whatever the coordinates.

    Only centre taps are non-zero, so each convolution reads the pixel its
    stride lands on.  With s = -pixel / SIGN_STEP (r + 1 on a sign, <= 0 on
    a coordinate): conv 0 gives the ramps SIGN_STEP relu(s - k), k = 0 ..
    M + 1; conv 1 the hats ramp(m) - 2 ramp(m + 1) + ramp(m + 2), which are
    SIGN_STEP where m = r and 0 elsewhere; every later convolution passes
    the M hats on.  The pool averages them over the sampled grid, of which
    the band holds one row; ``dense0`` scales that back to a one-hot of the
    room and ``dense1`` ranks the experts.  Every conv output is exact in
    bfloat16; the pool's one rounding scales a frame's logits by one
    factor, which no ranking can flip."""
    M, ch = cfg["num_experts"], cfg["gating_channels"]
    if ch[0] < M + 2 or min(ch) < M:
        raise ValueError(f"a gating that routes {M} rooms needs {M + 2} channels in its "
                         f"first stage and {M} in every other, not {ch}")
    rows = cfg["height"]
    for _ in ch:
        rows = -(-rows // 2)
    gating = {}
    for key, cin, cout, k, _ in gating_layers(cfg):
        w = torch.zeros((cout, cin, k, k) if k else (cout, cin), device=device)
        b = torch.zeros((cout,), device=device)
        if key == "convs.0":
            w[: M + 2, 0, 1, 1] = -1.0
            b[: M + 2] = -SIGN_STEP * torch.arange(M + 2, device=device, dtype=torch.float32)
        elif key == "convs.1":
            m = torch.arange(M, device=device)
            w[m, m, 1, 1], w[m, m + 1, 1, 1], w[m, m + 2, 1, 1] = 1.0, -2.0, 1.0
        elif k:
            w[torch.arange(M), torch.arange(M), 1, 1] = 1.0
        elif key == "dense0":
            w[torch.arange(M), torch.arange(M)] = rows / SIGN_STEP
        else:
            m = torch.arange(M, device=device)
            w[:, :M] = ROUTING_MARGIN * (M - 1 - (m[:, None] - m[None, :]) % M).float()
        gating[f"{key}.weight"], gating[f"{key}.bias"] = w, b
    return gating


def room_extents(cfg: dict, device) -> torch.Tensor:
    return torch.tensor(cfg["scene"]["room_extents_m"], dtype=torch.float32,
                        device=device)[: cfg["num_experts"]]


def _mixing(g, M: int, cout: int, cin: int, device) -> torch.Tensor:
    """(M, cout, cin) mixing rows.  From the three image channels: rows drawn
    uniformly from the simplex.  Widening: the ``cin`` channels kept, and
    each new channel a copy of one of them scaled by a factor in [0.5, 1)
    (distinct values round differently; rows stay spread, so the
    coordinate head's pseudo-inverse stays well conditioned)."""
    mix = torch.zeros((M, cout, cin), device=device)
    if cin == 3:
        e = -torch.log(torch.rand((M, cout, 3), generator=g, device=device).clamp_min(1e-12))
        return e / e.sum(-1, keepdim=True)
    keep = min(cout, cin)
    mix[:, torch.arange(keep), torch.arange(keep)] = 1.0
    new = cout - keep
    if new:
        src = torch.randint(0, cin, (M, new), generator=g, device=device)
        scale = 0.5 + 0.5 * torch.rand((M, new), generator=g, device=device)
        mix[:, keep:].scatter_(-1, src[..., None], scale[..., None])
    return mix


def _taps(g, M: int, cout: int, k: int, device) -> torch.Tensor:
    """(M, cout, 1, k, k) spatial kernels: ones for k = 1; for k = 3 a
    point-symmetric kernel per output channel whose taps sum to one, the
    centre drawn from [0.4, 0.6] and the rest split over the four pairs of
    opposite taps (an affine signal passes unchanged)."""
    if k == 1:
        return torch.ones((M, cout, 1, 1, 1), device=device)
    centre = 0.4 + 0.2 * torch.rand((M, cout), generator=g, device=device)
    e = -torch.log(torch.rand((M, cout, 4), generator=g, device=device).clamp_min(1e-12))
    pair = (1.0 - centre)[..., None] * e / e.sum(-1, keepdim=True) / 2
    K = torch.zeros((M, cout, 3, 3), device=device)
    K[..., 1, 1] = centre
    for p, (dy, dx) in enumerate(((1, 0), (0, 1), (1, 1), (1, -1))):
        K[..., 1 + dy, 1 + dx] = K[..., 1 - dy, 1 - dx] = pair[..., p]
    return K[:, :, None]


def _signal(g, cfg: dict, device) -> tuple[dict, torch.Tensor]:
    """The channel mixing (M, cout, cin) that each expert convolution but
    the coordinate head applies to the signal, and the mixture C
    (M, channels, 3) of the image that the last block's output holds.

    Stem: the first convolution spreads the three image channels over its
    outputs by random convex combinations, each widening convolution keeps
    its inputs and adds scaled copies of them, the others are identities.
    Head block b: the skip S (head block 0's projection, a widening
    mixing; an identity after), the 3 x 3 convolution S with its rows
    permuted, the 1 x 1 convolution the inverse permutation; the block's
    output is then 2 S x, half of it through the residual branch."""
    M, hc = cfg["num_experts"], cfg["head_channels"]
    signal = {}
    C = torch.eye(3, device=device, dtype=torch.float64).expand(M, 3, 3)
    for key, cin, cout, _, _, _ in expert_layers(cfg):
        if key.startswith("stem."):
            signal[key] = _mixing(g, M, cout, cin, device)
            C = signal[key].double() @ C
    cin = cfg["stem_channels"][-1]
    for b in range(cfg["head_depth"]):
        if cin != hc:
            skip = signal[f"head.{b}.proj"] = _mixing(g, M, hc, cin, device)
        else:
            skip = torch.eye(hc, device=device).expand(M, hc, hc)
        perm = torch.argsort(torch.rand((M, hc), generator=g, device=device), -1)
        signal[f"head.{b}.conv3"] = torch.take_along_dim(skip, perm[..., None], 1)
        signal[f"head.{b}.conv1"] = torch.zeros((M, hc, hc), device=device).scatter_(
            1, perm[:, None, :], 1.0)
        C = 2.0 * skip.double() @ C
        cin = hc
    return signal, C


def _served(w: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Weights a convolution runs in the configuration's compute type, made
    in that type (stored as float32, as the program stores them)."""
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]
    return w.to(dtype).float()


def make_weights(cfg: dict, seed: int, device) -> tuple[dict, dict | None]:
    """(experts, gating): the experts' state dicts stacked on a leading M
    axis under the program's checkpoint keys, and the gating net's state
    dict (None for an ungated configuration); float32 on ``device``.

    Every expert convolution but the coordinate head is its signal mixing
    (:func:`_signal`) times its spatial kernel (:func:`_taps`), plus noise;
    so every channel of the last block holds a known mixture C of the
    image, and the coordinate head is ``diag(extent) pinv(C)``, which reads
    the image back from all channels at once (their rounding errors average
    out, as a trained head's do).  The convolutions the program runs in
    bfloat16 get bfloat16 weights and the coordinate head and the gating
    net's dense layers, which it runs in float32, float32 ones.  The gating
    net is He-initialized, or routes by room (:func:`_routing_gating`)."""
    M, eps = cfg["num_experts"], cfg["scene"]["weight_noise"]
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    layers = expert_layers(cfg)
    sizes = [cout * cin * k * k for _, cin, cout, k, _, _ in layers]
    noise = torch.randn((M, sum(sizes)), generator=g, device=device)
    signal, C = _signal(g, cfg, device)
    extents = room_extents(cfg, device)
    experts, at = {"scene_center": torch.zeros((M, 3), device=device)}, 0
    for (key, cin, cout, k, _, kind), n in zip(layers, sizes):
        w = noise[:, at:at + n].reshape(M, cout, cin, k, k) * (eps / math.sqrt(cin * k * k))
        at += n
        if kind == "coord":
            head = extents.double()[:, :, None] * torch.linalg.pinv(C)
            w[:, :, :, 0, 0] += head.float()
        else:
            w = _served(w + signal[key][..., None, None] * _taps(g, M, cout, k, device), cfg)
        experts[f"{key}.weight"] = w.contiguous()
        experts[f"{key}.bias"] = torch.zeros((M, cout), device=device)
    if not cfg["gated"]:
        return experts, None
    if routes_by_room(cfg):
        return experts, _routing_gating(cfg, device)
    glayers = gating_layers(cfg)
    gsizes = [cout * cin * max(k, 1) ** 2 for _, cin, cout, k, _ in glayers]
    gnoise = torch.randn((sum(gsizes),), generator=g, device=device)
    gating, at = {}, 0
    for (key, cin, cout, k, _), n in zip(glayers, gsizes):
        shape = (cout, cin, k, k) if k else (cout, cin)
        fan = cin * max(k, 1) ** 2
        w = gnoise[at:at + n].reshape(shape) * math.sqrt((2.0 if k else 1.0) / fan)
        gating[f"{key}.weight"] = (_served(w, cfg) if k else w).contiguous()
        gating[f"{key}.bias"] = torch.zeros((cout,), device=device)
        at += n
    return experts, gating


def camera_intrinsics(cfg: dict) -> tuple[float, tuple[float, float]]:
    """Focal length and principal point: 525 px at 640 px wide, scaled with
    the width; the image center."""
    return 525.0 * cfg["width"] / 640.0, (cfg["width"] / 2.0, cfg["height"] / 2.0)


def _rot_wc(yaw, pitch, roll) -> torch.Tensor:
    """Camera-to-world rotations (n, 3, 3), world z up; camera x right,
    y down, z forward."""
    fwd = torch.stack([torch.cos(pitch) * torch.cos(yaw), torch.cos(pitch) * torch.sin(yaw),
                       torch.sin(pitch)], -1)
    right = torch.stack([torch.sin(yaw), -torch.cos(yaw), torch.zeros_like(yaw)], -1)
    down = torch.linalg.cross(fwd, right, dim=-1)
    cr, sr = torch.cos(roll)[:, None], torch.sin(roll)[:, None]
    right, down = cr * right + sr * down, -sr * right + cr * down
    return torch.stack([right, down, fwd], -1)


def make_frames(cfg: dict, seed: int, n: int, device) -> dict:
    """``n`` request images (n, H, W, 3) float32 on ``device``, each the
    scene-coordinate rendering of a camera inside a room drawn from the
    seed, with its room and its scene -> camera pose (R (n, 3, 3),
    t (n, 3)).  Pixel values are made in the type the CNNs take them in,
    as 8-bit camera images are: quantized, the same for every reader.  A
    scene that routes by room signs each frame's top band (module
    docstring)."""
    H, W, s = cfg["height"], cfg["width"], cfg["stride"]
    g = torch.Generator(device=device).manual_seed((int(seed) + 1) % (2 ** 63))
    u = torch.rand((n, 7), generator=g, device=device, dtype=torch.float64)
    extents = room_extents(cfg, device).double()
    room = torch.randint(0, cfg["num_experts"], (n,), generator=g, device=device)
    e = extents[room]
    center = e * torch.stack([0.3 + 0.4 * u[:, 0], 0.3 + 0.4 * u[:, 1],
                              0.35 + 0.3 * u[:, 2]], -1)
    yaw = 2 * math.pi * u[:, 3]
    pitch = math.radians(15.0) * (2 * u[:, 4] - 1)
    roll = math.radians(8.0) * (2 * u[:, 5] - 1)
    R_wc = _rot_wc(yaw, pitch, roll)
    f, (cx, cy) = camera_intrinsics(cfg)
    ys = torch.arange(H, device=device, dtype=torch.float64) + s / 2.0
    xs = torch.arange(W, device=device, dtype=torch.float64) + s / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([(gx - cx) / f, (gy - cy) / f, torch.ones_like(gx)], -1)
    images = torch.empty((n, H, W, 3), device=device)
    for i in range(n):  # one frame at a time keeps the float64 rays small
        d = d_cam @ R_wc[i].T                                  # (H, W, 3)
        lo = (0.0 - center[i]) / d
        hi = (e[i] - center[i]) / d
        step = torch.where(d > 0, hi, torch.where(d < 0, lo, torch.inf)).amin(-1)
        X = center[i] + step[..., None] * d
        images[i] = _served((X / e[i]).clamp(0.0, 1.0), cfg)
    if routes_by_room(cfg):
        images[:, : sign_band(cfg)] = -SIGN_STEP * (room + 1).float()[:, None, None, None]
    R = R_wc.transpose(-1, -2)
    t = -(R @ center[..., None])[..., 0]
    return {"images": images, "room": room, "R": R.float(), "t": t.float()}
