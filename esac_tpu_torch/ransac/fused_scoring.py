"""Soft-inlier scoring kernels (counterpart of ``esac_tpu/ransac/pallas_scoring.py``).

Two hand-written CUDA kernels (``csrc/soft_inlier.cu``) replace the JAX
package's two Pallas kernels, each behind a wrapper with a launch counter:

- :func:`soft_inlier_scores_kernel` -- every hypothesis' score
  (``_score_kernel``; ``scoring_impl="pallas"``);
- :func:`soft_inlier_score_select` -- score and first-max argmax in one
  pass, neither the error map nor the score vector reaching memory
  (``_score_select_kernel``; ``scoring_impl="fused_select"``).

Both run the same partial pass over the same cell split
(:func:`cell_chunks`) and sum each hypothesis' partials in the same order,
so the first entry's scores at the second's winner are bit-equal to its
best score.

A wrapper launches its kernel for CUDA tensors (or raises on what the
kernel does not take) and takes the plain PyTorch version only for CPU
tensors; there is no fallback from the card.  The plain versions
(:func:`soft_inlier_scores_fused`, :func:`_select_plain`) repeat the
kernels' formula op for op and are what the CPU tests hold against the
JAX package and what ``chip_smoke.py`` holds the kernels against.

Batched layout: one call covers all P problems (frame x expert) of a
dispatch.  Rs (..., H, 3, 3), ts (..., H, 3), coords (..., N, 3) share the
leading problem dims; pixels are (N, 2) shared, or (G, N, 2) where the
flattened problems fall into G equal contiguous groups (one per frame);
f has the problem shape (or is a scalar); c is (2,).

The kernel wrappers are forward-only (this slice serves): a CUDA input
that requires grad raises.  Their autograd ``Function``s land with the
training slice.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from esac_tpu_torch.geometry.camera import MIN_DEPTH
from esac_tpu_torch.ransac.scoring import reprojection_error_map, soft_inlier_score


def soft_inlier_scores_fused(Rs, ts, coords, pixels, f, c, tau, beta):
    """The kernels' math as plain PyTorch broadcasts (counterpart of
    ``soft_inlier_scores_fused``): Rs (..., H, 3, 3), ts (..., H, 3),
    coords (..., N, 3), pixels (..., N, 2) broadcastable against coords,
    f (...) or scalar.  Returns (..., H) float32 scores."""
    Rsf = Rs.reshape(Rs.shape[:-2] + (9,)).float()
    tsf = ts.float()
    X0 = coords[..., None, :, 0].float()  # (..., 1, N)
    X1 = coords[..., None, :, 1].float()
    X2 = coords[..., None, :, 2].float()
    px = pixels[..., None, :, 0].float()
    py = pixels[..., None, :, 1].float()
    f = torch.as_tensor(f, dtype=torch.float32, device=Rs.device)[..., None, None]
    cx, cy = c[0].float(), c[1].float()

    def col(k):  # (..., H, 1)
        return Rsf[..., k, None]

    Yx = col(0) * X0 + col(1) * X1 + col(2) * X2 + tsf[..., 0, None]
    Yy = col(3) * X0 + col(4) * X1 + col(5) * X2 + tsf[..., 1, None]
    Yz = col(6) * X0 + col(7) * X1 + col(8) * X2 + tsf[..., 2, None]
    z = torch.clamp(Yz, min=MIN_DEPTH)
    du = f * Yx / z + cx - px
    dv = f * Yy / z + cy - py
    err = torch.sqrt(du * du + dv * dv + 1e-12)
    err = torch.where(Yz < MIN_DEPTH, err + 1000.0, err)
    return torch.sum(torch.sigmoid(beta * (tau - err)), dim=-1)


def _chunks(H: int, chunk: int):
    T = int(max(1, min(chunk, H)))
    return [slice(i, min(i + T, H)) for i in range(0, H, T)]


def soft_inlier_scores_chunked(rvecs, tvecs, coords, pixels, f, c, tau, beta,
                               chunk: int = 64):
    """All-hypotheses scores of the materializing "errmap" formulation with
    the hypothesis axis tiled in ``chunk``s, so the largest live
    intermediate is one (..., chunk, N) tile (counterpart of
    ``soft_inlier_scores_chunked(impl="errmap")``; the "fused" formula's
    chunked form is :func:`_scores_plain`).  rvecs/tvecs (..., H, 3)
    axis-angle; other shapes as in :func:`soft_inlier_scores_fused`.
    Returns (..., H)."""
    return torch.cat([
        soft_inlier_score(reprojection_error_map(rvecs[..., s, :], tvecs[..., s, :],
                                                 coords, pixels, f, c), tau, beta)
        for s in _chunks(rvecs.shape[-2], chunk)
    ], dim=-1)


def broadcast_pixels(pixels: torch.Tensor, lead: tuple[int, ...]) -> torch.Tensor:
    """Kernel-layout pixels ((N, 2) shared, or (G, N, 2) over G contiguous
    groups of the flattened problems) as a tensor that broadcasts against
    coords of leading problem shape ``lead``."""
    if pixels.dim() == 2:
        return pixels
    P, G = math.prod(lead), pixels.shape[0]
    return pixels.repeat_interleave(P // G, dim=0).reshape(lead + pixels.shape[-2:])


def _scores_plain(Rs, ts, coords, pixels, f, c, tau, beta, chunk=64):
    """Plain version of the scoring kernel: the fused formula, chunked over
    hypotheses to bound memory (per-hypothesis sums are unchanged by
    chunking)."""
    px = broadcast_pixels(pixels, Rs.shape[:-3])
    return torch.cat([
        soft_inlier_scores_fused(Rs[..., s, :, :], ts[..., s, :], coords, px,
                                 f, c, tau, beta)
        for s in _chunks(Rs.shape[-3], chunk)
    ], dim=-1)


def _select_plain(Rs, ts, coords, pixels, f, c, tau, beta, chunk=64):
    """Plain version of the score+select kernel: argmax over the plain
    scores (``torch.argmax`` returns the first maximal index -- the same
    contract as the JAX package's chunked fold) and the winner's packed
    [R | t] row.  Returns (best_idx (...) int64, best_score (...),
    best_pose (..., 12))."""
    scores = _scores_plain(Rs, ts, coords, pixels, f, c, tau, beta, chunk)
    best = torch.argmax(scores, dim=-1)
    poses = _pack_poses(Rs, ts)
    pose = torch.gather(poses, -2, best[..., None, None].expand(best.shape + (1, 12)))
    return best, torch.gather(scores, -1, best[..., None])[..., 0], pose[..., 0, :]


def _pack_poses(Rs, ts):
    """(..., H, 3, 3), (..., H, 3) -> (..., H, 12) rows [R row-major | t]."""
    return torch.cat([Rs.reshape(Rs.shape[:-2] + (9,)), ts], dim=-1)


# ---------------------------------------------------------------- kernels


def _lib() -> ctypes.CDLL:
    from esac_tpu_torch import _build

    return _typed(_build.load("soft_inlier"))


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/soft_inlier.cu) with its C signatures set."""
    if not getattr(lib, "_esac_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.esac_soft_inlier_scores.argtypes = [P, P, P, P, P, I, I, I, I, I, I, F, F,
                                                P, P, P]
        lib.esac_soft_inlier_scores.restype = I
        lib.esac_soft_inlier_select.argtypes = [P, P, P, P, P, I, I, I, I, I, I, F, F,
                                                P, P, P, P, P]
        lib.esac_soft_inlier_select.restype = I
        for fn in (lib.esac_partial_blocks_per_sm, lib.esac_partial_tile):
            fn.argtypes = []
            fn.restype = I
        lib._esac_typed = True
    return lib


def _kernel_operands(Rs, ts, coords, pixels, f, c):
    """Check and pack the kernels' operands.  Raises on anything the
    kernel does not take: a non-CUDA or mixed device, a dtype other than
    float32, inconsistent shapes, a tensor that requires grad."""
    dev = Rs.device
    named = {"Rs": Rs, "ts": ts, "coords": coords, "pixels": pixels, "c": c}
    if torch.is_tensor(f):
        named["f"] = f
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, Rs on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.requires_grad:
            raise RuntimeError(
                f"{name} requires grad: the CUDA scoring kernels are "
                "forward-only in this slice")
    lead, H = Rs.shape[:-3], Rs.shape[-3]
    N = coords.shape[-2]
    if Rs.shape[-2:] != (3, 3) or ts.shape != lead + (H, 3):
        raise ValueError(f"poses: Rs {tuple(Rs.shape)}, ts {tuple(ts.shape)}")
    if coords.shape != lead + (N, 3):
        raise ValueError(f"coords {tuple(coords.shape)} != {lead + (N, 3)}")
    P = math.prod(lead)
    pix = pixels.reshape((-1,) + pixels.shape[-2:])
    G = pix.shape[0]
    if pix.shape[-2:] != (N, 2) or P % G:
        raise ValueError(f"pixels {tuple(pixels.shape)} do not fit {P} problems of {N} cells")
    if c.shape != (2,):
        raise ValueError(f"c must be (2,), got {tuple(c.shape)}")
    if not (1 <= P < 65536 and H >= 1 and N >= 1 and P * H * 12 < 2 ** 31
            and P * N * 3 < 2 ** 31):
        raise ValueError(f"unsupported problem sizes P={P} H={H} N={N}")
    fP = torch.as_tensor(f, dtype=torch.float32, device=dev).expand(lead).reshape(P)
    return dict(
        poses=_pack_poses(Rs, ts).reshape(P, H, 12).contiguous(),
        coords=coords.reshape(P, N, 3).contiguous(),
        pixels=pix.contiguous(),
        f=fP.contiguous(),
        c=c.contiguous(),
        P=P, H=H, N=N, G=G, lead=lead,
    )


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


MIN_CHUNK_CELLS = 32
CHUNK_WAVES = 4


def cell_chunks(P: int, H: int, N: int, resident_blocks: int,
                tile: int = 128, waves: int = CHUNK_WAVES) -> tuple[int, int]:
    """How the kernels' partial pass splits the N cells: ``(S, cells)``,
    chunk s covering cells [s * cells, min(N, (s + 1) * cells)).  The grid
    is P x ceil(H / tile) x S blocks; S is the most chunks that keep it
    within ``waves`` waves of the ``resident_blocks`` the card holds at
    once -- several short waves, so SMs that finish early take more blocks
    -- with at least ``MIN_CHUNK_CELLS`` cells a chunk (the last may hold
    fewer) and S = 1 where P alone fills the card.  Every cell falls in
    exactly one chunk."""
    blocks = P * -(-H // tile)
    want = max(1, waves * resident_blocks // blocks)
    cells = max(MIN_CHUNK_CELLS, -(-N // want))
    return -(-N // cells), cells


@functools.lru_cache(maxsize=None)
def _partial_shape(device_index: int) -> tuple[int, int]:
    """(resident blocks of the partial pass on the whole card, tile)."""
    lib = _lib()
    with torch.cuda.device(device_index):
        per_sm = lib.esac_partial_blocks_per_sm()
    if per_sm < 1:
        raise RuntimeError("esac_partial_blocks_per_sm: occupancy query failed")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm * sms, lib.esac_partial_tile()


def _partial_buffers(op, dev, split=None) -> dict:
    """The cell split ``(S, cells)`` -- by default :func:`cell_chunks` at
    the card's resident blocks, so both entries run the same split for one
    set of operands -- and the (P, S, H) partial-sum scratch."""
    P, H = op["P"], op["H"]
    if split is None:
        resident, tile = _partial_shape(dev.index)
        split = cell_chunks(P, H, op["N"], resident, tile)
    S, cells = split
    return dict(S=S, cells=cells,
                part=torch.empty((P, S, H), dtype=torch.float32, device=dev))


def _score_buffers(op, dev, split=None) -> dict:
    """:func:`_partial_buffers` and the (P, H) scores of the scoring kernel."""
    buf = _partial_buffers(op, dev, split)
    buf["out"] = torch.empty((op["P"], op["H"]), dtype=torch.float32, device=dev)
    return buf


def _select_buffers(op, dev, split=None) -> dict:
    """:func:`_partial_buffers` and the outputs of the score+select kernel."""
    buf = _partial_buffers(op, dev, split)
    P = op["P"]
    buf.update(best_idx=torch.empty((P,), dtype=torch.int32, device=dev),
               best_score=torch.empty((P,), dtype=torch.float32, device=dev),
               best_pose=torch.empty((P, 12), dtype=torch.float32, device=dev))
    return buf


def _common_args(op, buf, tau, beta) -> tuple:
    """The C arguments both entries share, up to the partial-sum scratch."""
    return (_ptr(op["poses"]), _ptr(op["coords"]), _ptr(op["pixels"]), _ptr(op["f"]),
            _ptr(op["c"]), op["P"], op["H"], op["N"], op["G"], buf["S"], buf["cells"],
            float(tau), float(beta), _ptr(buf["part"]))


def _launch_scores(op, buf, tau, beta, stream, lib=None) -> int:
    """Launch the scoring kernel on operands packed by
    :func:`_kernel_operands` into buffers from :func:`_score_buffers`
    (``lib``: another build of the source, for tools/kernel_bound.py);
    returns the cudaError."""
    return (lib or _lib()).esac_soft_inlier_scores(
        *_common_args(op, buf, tau, beta), _ptr(buf["out"]), stream)


def soft_inlier_scores_kernel(Rs, ts, coords, pixels, f, c, tau, beta):
    """Scores of every hypothesis: (..., H) float32.  CUDA tensors launch
    the hand-written kernel (one launch for all problems); CPU tensors take
    :func:`_scores_plain`.  Shapes as in the module docstring.  On one set
    of operands its scores at :func:`soft_inlier_score_select`'s winner
    equal that entry's best score bit for bit (the same partial sums, added
    in the same order)."""
    if not Rs.is_cuda:
        return _scores_plain(Rs, ts, coords, pixels, f, c, tau, beta)
    op = _kernel_operands(Rs, ts, coords, pixels, f, c)
    dev = Rs.device
    buf = _score_buffers(op, dev)
    with torch.cuda.device(dev):
        err = _launch_scores(op, buf, tau, beta, _stream(dev))
    soft_inlier_scores_kernel.launches += 1
    _check(err, "esac_soft_inlier_scores")
    return buf["out"].reshape(op["lead"] + (op["H"],))


soft_inlier_scores_kernel.launches = 0


def _launch_select(op, buf, tau, beta, stream, lib=None) -> int:
    """Launch the score+select kernel on operands packed by
    :func:`_kernel_operands` into buffers from :func:`_select_buffers`
    (``lib``: another build of the source, for tools/kernel_bound.py);
    returns the cudaError."""
    return (lib or _lib()).esac_soft_inlier_select(
        *_common_args(op, buf, tau, beta), _ptr(buf["best_idx"]),
        _ptr(buf["best_score"]), _ptr(buf["best_pose"]), stream)


def soft_inlier_score_select(Rs, ts, coords, pixels, f, c, tau, beta):
    """Fused score + first-max select: (best_idx (...) int64, best_score
    (...) float32, best_pose (..., 12) -- the winner's [R | t] row,
    bit-equal to the input row).  CUDA tensors launch the hand-written
    kernel (one launch for all problems); CPU tensors take
    :func:`_select_plain`."""
    if not Rs.is_cuda:
        return _select_plain(Rs, ts, coords, pixels, f, c, tau, beta)
    op = _kernel_operands(Rs, ts, coords, pixels, f, c)
    dev = Rs.device
    buf = _select_buffers(op, dev)
    with torch.cuda.device(dev):
        err = _launch_select(op, buf, tau, beta, _stream(dev))
    soft_inlier_score_select.launches += 1
    _check(err, "esac_soft_inlier_select")
    lead = op["lead"]
    return (buf["best_idx"].long().reshape(lead), buf["best_score"].reshape(lead),
            buf["best_pose"].reshape(lead + (12,)))


soft_inlier_score_select.launches = 0
