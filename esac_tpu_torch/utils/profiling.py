"""Profiling: a fenced stage timer, the hypotheses/s counter and the FLOP /
roofline model (counterpart of ``esac_tpu/utils/profiling.py``).

PyTorch returns before the card has finished, so a wall clock around a
CUDA call measures the enqueue: every timer here fences with
``torch.cuda.synchronize`` before it reads the clock.

The FLOP model keeps the JAX package's per-stage hand counts and formulas,
so the same inputs give the same numbers; its peak tables hold the card's
own figures only, keyed by ``torch.cuda.get_device_name()``.
:func:`score_ops_per_pair` counts the port's own scoring formula, the
cross-check of the hand count.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def wait_for(target) -> None:
    """Wait for the card: ``target`` is a tensor, a ``torch.device`` or
    None; nothing to wait for on the CPU."""
    dev = target if isinstance(target, torch.device) else getattr(target, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates fenced wall-clock time per named stage.

    >>> t = StageTimer()
    >>> with t("solve", fence=device):
    ...     out = kernel(...)        # the timer synchronizes on exit
    >>> t.summary()

    The fence is the ``fence`` argument, or a tensor the body appends to
    the yielded list.  ``calls[name]`` keeps every call's seconds, so a
    caller can drop a warm-up call.
    """

    def __init__(self):
        self.calls: dict[str, list[float]] = defaultdict(list)

    @property
    def totals(self) -> dict[str, float]:
        return {name: sum(xs) for name, xs in self.calls.items()}

    @property
    def counts(self) -> dict[str, int]:
        return {name: len(xs) for name, xs in self.calls.items()}

    @contextlib.contextmanager
    def __call__(self, name: str, fence=None):
        t0 = time.perf_counter()
        holder = []
        try:
            yield holder
        finally:
            wait_for(holder[0] if holder else fence)
            self.calls[name].append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = len(self.calls[name])
            lines.append(f"{name:24s} {1e3 * total:10.1f} ms total "
                         f"{1e3 * total / n:8.2f} ms/call x{n}")
        return "\n".join(lines)


def hypotheses_per_sec(fn, args: tuple, n_hyps_per_call: int, repeats: int = 20,
                       device=None) -> float:
    """Fenced throughput of a hypothesis-loop callable: ``repeats`` calls
    after one warm-up, synchronized on ``device`` before each clock read."""
    fn(*args)
    wait_for(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(*args)
    wait_for(device)
    return repeats * n_hyps_per_call / (time.perf_counter() - t0)


# Model FLOP counts per stage (the JAX package's hand counts; mul, add, div,
# exp and sqrt one FLOP each):
#   scoring (per hypothesis x cell): R X + t, projection, error, sigmoid,
#     accumulate -- ~45.
#   minimal solve (per hypothesis): P3P quartic + 4-branch disambiguation +
#     triad alignment + `polish_iters` Gauss-Newton rounds on 4 points --
#     ~1.5k + polish_iters * ~600.
#   IRLS refine (per refined pose per iteration): residuals and weights over
#     all cells (~50 a cell) + the 6x6 normal-equation solve (~2.5k).
#     Inference refines only the winner; training refines every hypothesis.
SCORE_FLOPS_PER_CELL = 45.0
P3P_FLOPS_BASE = 1500.0
P3P_FLOPS_PER_POLISH = 600.0
REFINE_FLOPS_PER_CELL_ITER = 50.0
REFINE_FLOPS_SOLVE = 2500.0

# Peaks by torch.cuda.get_device_name(), from NVIDIA's H100 SXM data sheet
# (dense, without sparsity; at the 700 W power limit).  The H100 SXM's name
# under PyTorch is "NVIDIA H100 80GB HBM3"; other cards have no entry, and
# then the summary carries no %-of-peak and the roofline is None.
H100_SXM = "NVIDIA H100 80GB HBM3"
# Dense BF16 tensor-core peak (1,979 TFLOP/s with sparsity): the headline
# number.  Scoring is elementwise FP32 outside the tensor cores, so a
# %-of-this-peak is a deliberately conservative utilization figure.
DEVICE_PEAK_FLOPS = {H100_SXM: 989e12}
# FP32 peak outside the tensor cores: the compute ceiling of the elementwise
# scoring stage.
DEVICE_FP32_FLOPS = {H100_SXM: 67e12}
# HBM3 bandwidth.
DEVICE_HBM_BYTES_PER_S = {H100_SXM: 3.35e12}

# Scoring-stage device-memory traffic model, bytes per (hypothesis x cell):
#   errmap  -- materializes the (n_hyps, cells) f32 error map: a 4 B write
#              and a 4 B read back for the sigmoid and the sum;
#   fused / pallas -- the formula in one kernel: no error map reaches
#              memory, the coordinates and pixels are amortized over all
#              hypotheses, so ~0 per pair and FP32 throughput binds.
SCORE_HBM_BYTES_PER_CELL = {"errmap": 8.0, "fused": 0.0, "pallas": 0.0}


def flops_per_hypothesis(
    n_cells: int,
    polish_iters: int = 3,
    refine_iters: int = 8,
    refined_frac: float = 0.0,
) -> float:
    """Model FLOPs for one hypothesis through sample -> solve -> score, plus
    ``refined_frac`` of an IRLS refinement (1/n_hyps at inference where only
    the argmax winner is refined; 1.0 in training expectations)."""
    solve = P3P_FLOPS_BASE + polish_iters * P3P_FLOPS_PER_POLISH
    score = n_cells * SCORE_FLOPS_PER_CELL
    refine = refined_frac * refine_iters * (
        n_cells * REFINE_FLOPS_PER_CELL_ITER + REFINE_FLOPS_SOLVE)
    return solve + score + refine


def pipeline_flop_summary(
    hyps_per_sec: float,
    device_kind: str | None,
    basis: str = "live",
    n_cells: int = 4800,
    n_hyps: int = 256,
    scoring_impl: str = "errmap",
) -> dict:
    """Effective GFLOP/s (model FLOPs x measured rate) and %-of-peak.
    ``basis`` labels where the rate came from ("live" or an artifact's tag);
    ``device_kind`` is ``torch.cuda.get_device_name()`` of the card that
    measured the rate."""
    fph = flops_per_hypothesis(n_cells, refined_frac=1.0 / n_hyps)
    out = {
        "flops_per_hypothesis_model": round(fph),
        "assumptions": f"{n_cells} cells scored/hyp at "
                       f"{SCORE_FLOPS_PER_CELL:.0f} flops/cell; winner-only "
                       f"IRLS refine amortized 1/{n_hyps}",
    }
    eff = hyps_per_sec * fph
    out["effective_gflops"] = round(eff / 1e9, 1)
    out["basis"] = basis
    peak = DEVICE_PEAK_FLOPS.get(device_kind or "")
    if peak:
        out["pct_of_bf16_peak"] = round(100.0 * eff / peak, 3)
        out["device_kind"] = device_kind
        out["peak_note"] = (
            "dense BF16 tensor-core peak of the data sheet; scoring is "
            "elementwise FP32 outside the tensor cores, so this is the "
            "conservative denominator")
    roofline = scoring_roofline(hyps_per_sec, device_kind, n_cells, scoring_impl)
    if roofline:
        out["roofline"] = roofline
    return out


def scoring_roofline(
    hyps_per_sec: float,
    device_kind: str | None,
    n_cells: int = 4800,
    scoring_impl: str = "errmap",
) -> dict | None:
    """Which resource binds the scoring stage, and how far from it a
    measured rate runs: given the stage's FP32 FLOPs and memory bytes per
    (hypothesis x cell), the model's most hypotheses/s on this card, which
    resource sets it, and the measured rate's share of that ceiling.  None
    for a card without an entry in the peak tables."""
    fp32 = DEVICE_FP32_FLOPS.get(device_kind or "")
    hbm = DEVICE_HBM_BYTES_PER_S.get(device_kind or "")
    if not (fp32 and hbm):
        return None
    bytes_cell = SCORE_HBM_BYTES_PER_CELL.get(scoring_impl, 0.0)
    t_fp32 = SCORE_FLOPS_PER_CELL / fp32  # s per (hyp x cell), compute
    t_hbm = bytes_cell / hbm              # s per (hyp x cell), memory
    binding = "FP32" if t_fp32 >= t_hbm else "HBM"
    max_rate = 1.0 / (max(t_fp32, t_hbm) * n_cells)
    return {
        "scoring_impl": scoring_impl,
        "binding_resource": binding,
        "max_hyps_per_sec_model": round(max_rate),
        "pct_of_binding_resource": round(100.0 * hyps_per_sec / max_rate, 2),
        "fp32_peak_tflops": round(fp32 / 1e12, 1),
        "hbm_gbps": round(hbm / 1e9),
        "hbm_bytes_per_cell_model": bytes_cell,
        "note": "scoring-stage-only roofline: solve/select/refine and launch "
                "latency are outside the model, so the ceiling is optimistic; "
                "a measured rate far below it means the pipeline is bound "
                "elsewhere (serial stages, launches), not that FP32 is busy",
    }


def score_ops_per_pair(n_cells: int = 1200, n_hyps: int = 64) -> float:
    """Cross-check of :data:`SCORE_FLOPS_PER_CELL` against the port's own
    scoring formula (the counterpart of the JAX package's XLA cost count):
    runs ``ransac.fused_scoring.soft_inlier_scores_fused`` -- the formula
    the CUDA kernels compute -- on CPU tensors under a dispatch mode that
    counts each elementwise operation's output elements and each sum's
    input elements, and returns the operations per (hypothesis, cell)
    pair.  Counts what the formula does, not a kernel's instruction mix."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.fused_scoring import soft_inlier_scores_fused

    class _Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                self.ops += out.numel()
            elif func.overloadpacket is torch.ops.aten.sum:
                self.ops += args[0].numel()
            return out

    Rs = rodrigues(torch.full((n_hyps, 3), 0.1))
    ts = torch.ones((n_hyps, 3))
    coords = torch.linspace(0.0, 1.0, n_cells * 3).reshape(n_cells, 3)
    pixels = torch.linspace(0.0, 100.0, n_cells * 2).reshape(n_cells, 2)
    f, c = torch.tensor(100.0), torch.tensor([50.0, 50.0])
    with _Count() as count:
        soft_inlier_scores_fused(Rs, ts, coords, pixels, f, c, 10.0, 0.5)
    return count.ops / (n_cells * n_hyps)
