"""Frozen operation, FLOP and byte counts, and the table of peaks.

The yardstick of every roofline and utilization metric.  Each count is
worked out from the published shapes and the formulas, never from what a
kernel happens to execute, so it stays the same whatever implements the
layer.

Scoring, one (hypothesis, cell) pair of the soft-inlier formula
``sigmoid(beta * (tau - err))`` with ``err`` the pixel distance of the
projected point (a point behind ``MIN_DEPTH`` pays a 1000 px penalty):
:data:`SCORE_OPS` itemizes it and :data:`SCORE_OPS_PER_PAIR` is its sum,
41.  The sigmoid counts as the four operations it takes (negate, exp,
1 + e, reciprocal) and the square root as one.  Three other counts of the
same formula live in the program: 45 (``utils/profiling.SCORE_FLOPS_PER_CELL``,
a rounded hand count), 41 (``chip_smoke.OPS_PER_PAIR``, the same items
as here) and 39 (``utils/profiling.score_ops_per_pair()``, which counts
each PyTorch op once, so the sigmoid as one and the penalty's add,
compare and select as three).

CNNs: two FLOPs a multiply-accumulate, over every convolution and dense
layer of ``models/expert.py`` and ``models/gating.py`` as the architecture
is published (SAME padding, stride-2 stages); biases, ReLUs and the pool
are left out.  At 480 x 640 with the ``ref`` widths an expert image is
116.62 GFLOP and a gating image 7.92 GFLOP.

Gating-first routed serving (a configuration that names ``serve_topk``
K < M) counts the (frame, expert) pairs routing selects: K expert CNNs
and the gating a frame, and K problems of n_hyps M // K hypotheses each,
not the capacity slots the program pads; so a program that stops
convolving empty slots reads higher on its roofline.  At K = M every
count is the dense one.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W), by the
# name torch.cuda.get_device_name() gives.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAKS = {
    H100_SXM: {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}

SCORE_OPS = (
    ("R X: 9 multiplies, 6 adds", 15),
    ("+ t", 3),
    ("clamp of the depth at MIN_DEPTH", 1),
    ("f * Y0, f * Y1", 2),
    ("/ z, twice", 2),
    ("+ cx, + cy, - px, - py", 4),
    ("du * du + dv * dv + eps", 4),
    ("sqrt", 1),
    ("depth compare and penalty select", 2),
    ("beta * (tau - err)", 2),
    ("sigmoid: negate, exp, 1 + e, reciprocal", 4),
    ("running sum", 1),
)
SCORE_OPS_PER_PAIR = sum(n for _, n in SCORE_OPS)


def _conv_macs(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1) -> tuple:
    """(MACs, output h, output w) of one SAME-padded k x k convolution."""
    ho, wo = -(-h // stride), -(-w // stride)
    return ho * wo * cout * cin * k * k, ho, wo


def expert_flops(height: int, width: int, stem_channels, head_channels: int,
                 head_depth: int) -> float:
    """FLOPs of one expert CNN image: stem conv, per stem stage a stride-2
    and a 3 x 3 conv, per head block a 3 x 3 and a 1 x 1 conv (and a 1 x 1
    projection where the width changes), then the 1 x 1 coordinate head."""
    h, w = height, width
    cin = stem_channels[0] // 2
    macs, _, _ = _conv_macs(h, w, 3, cin, 3)
    for ch in stem_channels:
        m1, h, w = _conv_macs(h, w, cin, ch, 3, stride=2)
        m2, _, _ = _conv_macs(h, w, ch, ch, 3)
        macs += m1 + m2
        cin = ch
    for _ in range(head_depth):
        macs += _conv_macs(h, w, cin, head_channels, 3)[0]
        macs += _conv_macs(h, w, head_channels, head_channels, 1)[0]
        if cin != head_channels:
            macs += _conv_macs(h, w, cin, head_channels, 1)[0]
        cin = head_channels
    macs += _conv_macs(h, w, cin, 3, 1)[0]
    return 2.0 * macs


def gating_flops(height: int, width: int, channels, num_experts: int) -> float:
    """FLOPs of one gating CNN image: per stage a stride-2 and a 3 x 3 conv,
    then two dense layers (hidden width max(4 M, 64))."""
    h, w, cin, macs = height, width, 3, 0
    for ch in channels:
        m1, h, w = _conv_macs(h, w, cin, ch, 3, stride=2)
        m2, _, _ = _conv_macs(h, w, ch, ch, 3)
        macs += m1 + m2
        cin = ch
    hidden = max(4 * num_experts, 64)
    macs += cin * hidden + hidden * num_experts
    return 2.0 * macs


def served_experts(cfg: dict) -> int:
    """K, the experts that serve a frame: ``serve_topk`` where a
    configuration names one, else every expert."""
    return cfg.get("serve_topk") or cfg["num_experts"]


def hyps_per_expert(cfg: dict) -> int:
    """Hypotheses each served expert draws: the frame's budget of M x
    n_hyps spread over its K experts (``n_hyps`` at K = M)."""
    return max(1, cfg["n_hyps"] * cfg["num_experts"] // served_experts(cfg))


def cnn_flops_per_frame(cfg: dict) -> float:
    """The CNN of every expert that serves a frame, and the gating CNN
    (gated configurations), over one frame of a configuration file's
    sizes."""
    per = served_experts(cfg) * expert_flops(
        cfg["height"], cfg["width"], cfg["stem_channels"], cfg["head_channels"],
        cfg["head_depth"])
    if cfg["gated"]:
        per += gating_flops(cfg["height"], cfg["width"], cfg["gating_channels"],
                            cfg["num_experts"])
    return per


def n_cells(cfg: dict) -> int:
    return (cfg["height"] // cfg["stride"]) * (cfg["width"] // cfg["stride"])


def score_pairs_per_frame(cfg: dict) -> int:
    """(hypothesis, cell) pairs one frame scores: every served expert's
    hypotheses over every cell of its map."""
    return served_experts(cfg) * hyps_per_expert(cfg) * n_cells(cfg)


def score_bytes(cfg: dict, frames: int) -> int:
    """Bytes the score-and-select pass needs for ``frames`` frames, each
    input read once and each output written once: per (frame, served
    expert) problem its poses (a 3 x 3 rotation and a translation,
    float32, a hypothesis), its map (float32 x 3 a cell), its focal and
    its winner (an int32 index and a float32 score); the shared pixel grid
    and the principal point once."""
    problems = frames * served_experts(cfg)
    n = n_cells(cfg)
    return (problems * hyps_per_expert(cfg) * 48 + problems * n * 12 + n * 8 + problems * 4
            + 8 + problems * 8)


def score_least_seconds(cfg: dict, frames: int, peaks: dict) -> float:
    """The least time the scoring pass could take on ``frames`` frames: the
    larger of its operations over the FP32 peak and its bytes over the
    memory bandwidth."""
    ops = frames * score_pairs_per_frame(cfg) * SCORE_OPS_PER_PAIR
    return max(ops / peaks["fp32_flops"], score_bytes(cfg, frames) / peaks["hbm_bytes"])
