"""ctypes binding of the C++ hypothesis-loop backend (counterpart of
``esac_tpu/backends/cpp.py``).

The same C source, ``esac_cpp/esac.cpp`` (g++ -O3 -march=native -fopenmp; no
OpenCV, no torch), the same C signatures and the same five entry points,
with the same arguments, defaults and result dicts.  The library is built by
``esac_tpu_torch._build.build_host`` into ``esac_tpu_torch/build/``, never
beside the source.  A failed build raises with the compiler's output:
:func:`cpp_available` reports it, and no entry point takes another path.

Inputs and outputs are host numpy arrays: the loop runs on the CPU, once a
frame, on host copies of what the CNNs produced.
"""

from __future__ import annotations

import ctypes

import numpy as np

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int32)
_int, _f32, _u64 = ctypes.c_int, ctypes.c_float, ctypes.c_uint64

_SIGNATURES = {
    "esac_cpp_infer": [
        _F, _F, _int,                  # coords, pixels, n_cells
        _f32, _f32, _f32,              # f, cx, cy
        _int, _f32, _f32, _int, _u64,  # n_hyps, tau, beta, refine_iters, seed
        _D, _D, _D, _D,                # out_R, out_t, out_score, out_scores (may be NULL)
    ],
    "esac_cpp_train": [
        _F, _F, _I,                    # coords_all, pixels, idx
        _int, _int, _int,              # n_experts, n_cells, n_hyps
        _f32, _f32, _f32,              # f, cx, cy
        _f32, _f32, _f32, _int,        # tau, beta, alpha, train_refine_iters
        _D, _D, _f32, _f32,            # R_gt, t_gt, trans_scale, loss_clamp
        _D, _D, _D, _F, _I,            # out expert_losses, scores, losses, grad_coords, valid
    ],
    "esac_cpp_infer_gated": [
        _F, _F, _int, _int, _F,        # coords_all, pixels, n_experts, n_cells, gating probs
        _int, _f32, _f32, _f32,        # n_hyps (total), f, cx, cy
        _f32, _f32, _int, _u64,        # tau, beta, refine_iters, seed
        _D, _D, _D, _I, _D,            # out_R, out_t, out_score, out_counts, out_scores
    ],
    "esac_cpp_infer_multi": [
        _F, _F, _int, _int,            # coords_all, pixels, n_experts, n_cells
        _f32, _f32, _f32, _int,        # f, cx, cy, n_hyps_per_expert
        _f32, _f32, _int, _u64,        # tau, beta, refine_iters, seed
        _D, _D, _D, _D,                # out_R, out_t, out_score, out_expert_scores
    ],
}


def _load() -> ctypes.CDLL:
    """The built library with its C signatures set (built on first use)."""
    from esac_tpu_torch import _build

    lib = _build.load_host()
    if not getattr(lib, "_esac_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._esac_typed = True
    return lib


def _ptr(a: np.ndarray | None, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty)) if a is not None else None


def _f32s(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def cpp_available() -> bool:
    """Whether the C++ backend builds and loads here."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def esac_infer_cpp(
    coords: np.ndarray,
    pixels: np.ndarray,
    f: float,
    c: tuple[float, float],
    n_hyps: int = 256,
    tau: float = 10.0,
    beta: float = 0.5,
    refine_iters: int = 8,
    seed: int = 0,
    return_scores: bool = False,
) -> dict:
    """Single-frame hypothesis loop on the CPU backend.

    coords: (N, 3) float32 scene coordinates; pixels: (N, 2) float32.
    Returns dict with 'R' (3,3), 't' (3,), 'score', 'n_valid' (+ 'scores').
    """
    lib = _load()
    coords, pixels = _f32s(coords), _f32s(pixels)
    out_R, out_t, out_score = np.zeros(9), np.zeros(3), np.zeros(1)
    scores = np.zeros(n_hyps) if return_scores else None
    n_valid = lib.esac_cpp_infer(
        _ptr(coords, ctypes.c_float), _ptr(pixels, ctypes.c_float), coords.shape[0],
        f, c[0], c[1], n_hyps, tau, beta, refine_iters, seed,
        _ptr(out_R, ctypes.c_double), _ptr(out_t, ctypes.c_double),
        _ptr(out_score, ctypes.c_double), _ptr(scores, ctypes.c_double))
    out = {"R": out_R.reshape(3, 3), "t": out_t, "score": float(out_score[0]),
           "n_valid": int(n_valid)}
    if return_scores:
        out["scores"] = scores
    return out


def esac_train_cpp(
    coords_all: np.ndarray,
    pixels: np.ndarray,
    idx: np.ndarray,
    f: float,
    c: tuple[float, float],
    R_gt: np.ndarray,
    t_gt: np.ndarray,
    tau: float = 10.0,
    beta: float = 0.5,
    alpha: float = 0.5,
    train_refine_iters: int = 2,
    trans_scale: float = 100.0,
    loss_clamp: float = 100.0,
    want_grad: bool = True,
) -> dict:
    """Training-mode forward (+ selection-path backward) on the CPU backend.

    coords_all: (M, N, 3) float32; idx: (M, n_hyps, 4) int32 correspondence
    sets drawn by the caller (the port's ``ransac.sampling``), so both
    backends can train on identical sets.  Returns dict with
    'expert_losses' (M,) expected pose loss per expert, 'scores' / 'losses'
    (M, n_hyps), 'valid' (M, n_hyps) bool, 'n_valid' and, with
    ``want_grad``, 'grad_coords' (M, N, 3) = d expert_losses[m] /
    d coords_all[m] through the selection path (analytic through the scores,
    central finite differences through the minimal solve: the dominant cost).
    """
    lib = _load()
    coords_all, pixels = _f32s(coords_all), _f32s(pixels)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    M, n = coords_all.shape[0], coords_all.shape[1]
    n_hyps = idx.shape[1]
    if idx.shape != (M, n_hyps, 4):
        raise ValueError(f"idx shape {idx.shape} != ({M}, n_hyps, 4)")
    if (idx < 0).any() or (idx >= n).any():
        raise ValueError("idx out of range")
    if pixels.shape != (n, 2):
        raise ValueError(f"pixels shape {pixels.shape} != ({n}, 2)")
    R_gt = np.ascontiguousarray(R_gt, dtype=np.float64).reshape(9)
    t_gt = np.ascontiguousarray(t_gt, dtype=np.float64).reshape(3)
    expert_losses = np.zeros(M)
    scores, losses = np.zeros((M, n_hyps)), np.zeros((M, n_hyps))
    grad = np.zeros((M, n, 3), dtype=np.float32) if want_grad else None
    valid = np.zeros((M, n_hyps), dtype=np.int32)
    n_valid = lib.esac_cpp_train(
        _ptr(coords_all, ctypes.c_float), _ptr(pixels, ctypes.c_float),
        _ptr(idx, ctypes.c_int32), M, n, n_hyps, f, c[0], c[1], tau, beta, alpha,
        train_refine_iters, _ptr(R_gt, ctypes.c_double), _ptr(t_gt, ctypes.c_double),
        trans_scale, loss_clamp, _ptr(expert_losses, ctypes.c_double),
        _ptr(scores, ctypes.c_double), _ptr(losses, ctypes.c_double),
        _ptr(grad, ctypes.c_float), _ptr(valid, ctypes.c_int32))
    out = {"expert_losses": expert_losses, "scores": scores, "losses": losses,
           "valid": valid.astype(bool), "n_valid": int(n_valid)}
    if want_grad:
        out["grad_coords"] = grad
    return out


def esac_infer_gated_cpp(
    coords_all: np.ndarray,
    pixels: np.ndarray,
    gating_probs: np.ndarray,
    f: float,
    c: tuple[float, float],
    n_hyps: int = 256,
    tau: float = 10.0,
    beta: float = 0.5,
    refine_iters: int = 8,
    seed: int = 0,
) -> dict:
    """Gating-faithful multi-expert loop: each hypothesis draws its expert
    from ``gating_probs`` (the reference's sparse allocation), so a gating
    miss fails the frame as ``esac_infer_topk`` can.

    coords_all: (M, N, 3) float32; gating_probs: (M,) nonnegative (need not
    be normalized).  ``n_hyps`` is the TOTAL budget across experts.  Returns
    dict with 'R', 't', 'score', 'expert' (-1 if all solves failed) and
    'counts' (M,) hypotheses allocated per expert.
    """
    lib = _load()
    coords_all, pixels, gating = _f32s(coords_all), _f32s(pixels), _f32s(gating_probs)
    M, n = coords_all.shape[0], coords_all.shape[1]
    if gating.shape != (M,):
        raise ValueError(f"gating shape {gating.shape} != ({M},)")
    if pixels.shape != (n, 2):
        raise ValueError(f"pixels shape {pixels.shape} != ({n}, 2)")
    out_R, out_t, out_score = np.zeros(9), np.zeros(3), np.zeros(1)
    counts = np.zeros(M, dtype=np.int32)
    expert = lib.esac_cpp_infer_gated(
        _ptr(coords_all, ctypes.c_float), _ptr(pixels, ctypes.c_float), M, n,
        _ptr(gating, ctypes.c_float), n_hyps, f, c[0], c[1], tau, beta, refine_iters, seed,
        _ptr(out_R, ctypes.c_double), _ptr(out_t, ctypes.c_double),
        _ptr(out_score, ctypes.c_double), _ptr(counts, ctypes.c_int32), None)
    return {"R": out_R.reshape(3, 3), "t": out_t, "score": float(out_score[0]),
            "expert": int(expert), "counts": counts}


def esac_infer_multi_cpp(
    coords_all: np.ndarray,
    pixels: np.ndarray,
    f: float,
    c: tuple[float, float],
    n_hyps_per_expert: int = 256,
    tau: float = 10.0,
    beta: float = 0.5,
    refine_iters: int = 8,
    seed: int = 0,
) -> dict:
    """Multi-expert hypothesis loop on the CPU backend, ``n_hyps_per_expert``
    for every expert.

    coords_all: (M, N, 3) float32 per-expert scene coordinates.  Returns
    dict with 'R', 't', 'score', 'expert' (winner index, -1 if all solves
    failed) and 'expert_scores' (M,).
    """
    lib = _load()
    coords_all, pixels = _f32s(coords_all), _f32s(pixels)
    M, n = coords_all.shape[0], coords_all.shape[1]
    out_R, out_t, out_score = np.zeros(9), np.zeros(3), np.zeros(1)
    expert_scores = np.zeros(M)
    expert = lib.esac_cpp_infer_multi(
        _ptr(coords_all, ctypes.c_float), _ptr(pixels, ctypes.c_float), M, n,
        f, c[0], c[1], n_hyps_per_expert, tau, beta, refine_iters, seed,
        _ptr(out_R, ctypes.c_double), _ptr(out_t, ctypes.c_double),
        _ptr(out_score, ctypes.c_double), _ptr(expert_scores, ctypes.c_double))
    return {"R": out_R.reshape(3, 3), "t": out_t, "score": float(out_score[0]),
            "expert": int(expert), "expert_scores": expert_scores}
