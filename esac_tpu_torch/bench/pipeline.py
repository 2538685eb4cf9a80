"""The headline and ``streaming`` lines (counterpart of ``bench.py``'s
``_measure_jax``, ``_measure_cpp`` and ``_main_measured``): fenced
hypotheses/s of the full single-expert pipeline (sample -> P3P -> score
over every cell -> argmax -> IRLS refine of the winner) at BASELINE.md
config #1 (16 frames x 256 hypotheses x 4800 cells), against the C++ host
hypothesis loop (``esac_cpp/``); ``streaming`` measures one chip's shard of
config #5 (64 // 8 = 8 frames x 4096 hypotheses).  The default RansacConfig
scores with "errmap", as ``bench.py`` does: neither line launches a
kernel."""

from __future__ import annotations

import os
import time

import torch

from esac_tpu_torch.bench.constants import (
    BATCH,
    C,
    CELLS,
    N_HYPS,
    REPEATS,
    STREAM_BATCH,
    STREAM_MESH_CHIPS,
)
from esac_tpu_torch.bench.fixtures import fence
from esac_tpu_torch.bench.scaffold import finish
from esac_tpu_torch.data.synthetic import CAMERA_F, make_correspondence_frame
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.kernel import dsac_infer_frames, frame_generators
from esac_tpu_torch.utils.precision import resolve_device
from esac_tpu_torch.utils.profiling import pipeline_flop_summary

STREAM_HYPS = 4096
STREAM_REPEATS = 5


def correspondence_frames(batch: int, dev: torch.device) -> tuple:
    """``batch`` synthetic frames (1 cm noise, 30% outliers) from seeds 0..:
    coords (B, N, 3) and pixels (B, N, 2) on ``dev``."""
    frames = [make_correspondence_frame(torch.Generator().manual_seed(i), noise=0.01,
                                        outlier_frac=0.3, device=dev) for i in range(batch)]
    return (torch.stack([f["coords"] for f in frames]),
            torch.stack([f["pixels"] for f in frames]))


def measure_pipeline(batch: int = BATCH, n_hyps: int = N_HYPS, repeats: int = REPEATS,
                     shard_data: bool = False, device=None) -> float:
    """Fenced throughput of ``dsac_infer_frames`` in hypotheses/s.  With
    ``shard_data`` (config #5 streaming) one card measures one chip's shard
    of the STREAM_MESH_CHIPS mesh: ``batch // STREAM_MESH_CHIPS`` frames,
    the same per-chip workload."""
    dev = resolve_device(device)
    if shard_data:
        batch = max(1, batch // STREAM_MESH_CHIPS)
    cfg = RansacConfig(n_hyps=n_hyps)
    coords, pixels = correspondence_frames(batch, dev)
    f = torch.full((batch,), CAMERA_F, device=dev)
    c = torch.tensor(C, device=dev)

    def run(seed0):
        return dsac_infer_frames(frame_generators(range(seed0, seed0 + batch), dev), coords,
                                 pixels, f, c, cfg, device=dev)

    run(1_000)  # CUDA context, cuDNN and allocator warm-up
    fence(dev)
    t0 = time.perf_counter()
    for i in range(repeats):
        run(2_000 + i * batch)
    fence(dev)
    dt = time.perf_counter() - t0
    return repeats * batch * n_hyps / dt


def cpp_threads() -> int:
    """OpenMP threads the C++ host loop runs on (its library's
    ``omp_get_max_threads``)."""
    import ctypes

    from esac_tpu_torch.backends.cpp import _load

    fn = _load().omp_get_max_threads
    fn.restype, fn.argtypes = ctypes.c_int, []
    return int(fn())


def measure_cpp() -> float | None:
    """Hypotheses/s of the C++ host loop on config #1's frame (seed 0), or
    None where the backend does not build and load here."""
    from esac_tpu_torch.backends.cpp import cpp_available, esac_infer_cpp

    if not cpp_available():
        return None
    frame = make_correspondence_frame(torch.Generator().manual_seed(0), noise=0.01,
                                      outlier_frac=0.3, device="cpu")
    co, px = frame["coords"].numpy(), frame["pixels"].numpy()
    esac_infer_cpp(co, px, CAMERA_F, C, n_hyps=N_HYPS, seed=0)  # warm
    reps = 5
    t0 = time.perf_counter()
    for i in range(reps):
        esac_infer_cpp(co, px, CAMERA_F, C, n_hyps=N_HYPS, seed=i)
    return reps * N_HYPS / (time.perf_counter() - t0)


def main_measured(streaming: bool, dev: torch.device, **kwargs) -> dict:
    """Print the headline line (or ``streaming``'s) and write its artifact;
    ``kwargs`` override :func:`measure_pipeline`'s counts (tests)."""
    load_before = [round(x, 2) for x in os.getloadavg()]
    on_card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_card else None
    basis = "live" if on_card else "live (cpu)"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    if streaming:
        args = {"batch": STREAM_BATCH, "n_hyps": STREAM_HYPS, "repeats": STREAM_REPEATS,
                "shard_data": True, **kwargs}
        rate = measure_pipeline(**args, device=dev)
        out = {
            "metric": "streaming_hypotheses_per_sec_per_chip",
            "value": round(rate, 1), "unit": "hyps/s", "vs_baseline": None,
            "flop_model": pipeline_flop_summary(
                rate, kind, basis, n_cells=CELLS, n_hyps=args["n_hyps"],
                scoring_impl=RansacConfig().scoring_impl),
        }
        extra = {"frames": max(1, args["batch"] // STREAM_MESH_CHIPS),
                 "n_hyps": args["n_hyps"],
                 "max_memory_allocated_bytes":
                     torch.cuda.max_memory_allocated(dev) if on_card else None}
        return finish("streaming", out, dev, load_before, device_kind=False,
                      artifact_extra=extra)

    args = {"batch": BATCH, "n_hyps": N_HYPS, "repeats": REPEATS, **kwargs}
    rate = measure_pipeline(**args, device=dev)
    cpp_rate = measure_cpp()
    vs = rate / cpp_rate if cpp_rate else None
    out = {
        "metric": "pose_hypotheses_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": "hyps/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
    }
    if vs is not None:
        out["baseline_normalization"] = (
            f"cpp baseline ran on {cpp_threads()} OpenMP threads of this host "
            f"({os.cpu_count()} CPUs): vs_baseline compares one card with that host")
    out["flop_model"] = pipeline_flop_summary(
        rate, kind, basis, n_cells=CELLS, n_hyps=args["n_hyps"],
        scoring_impl=RansacConfig().scoring_impl)
    extra = {"cpp_hyps_per_s": round(cpp_rate, 1) if cpp_rate else None,
             "max_memory_allocated_bytes":
                 torch.cuda.max_memory_allocated(dev) if on_card else None}
    return finish("headline", out, dev, load_before, artifact_extra=extra)

