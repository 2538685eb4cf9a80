"""Float32 contractions for the geometry core, and the entry points' device
policy (counterpart of ``esac_tpu/utils/precision.py``).

The JAX package pins ``Precision.HIGHEST`` because TPU matmuls default to
bf16.  On the card the analogous hazard is TF32: a float32 convolution goes
through cuDNN in TF32 unless told otherwise, and TF32 keeps about three
decimal digits -- degrees of rotation error in 3x3 algebra.  Every entry
point therefore calls :func:`resolve_device`, which turns TF32 off for
matmuls and convolutions alike.

The second hazard is the batch: cuBLAS and ``torch.sum`` choose how to
split a product or a long sum by the size of the whole call, so one
frame's geometry could round differently in a 16-frame dispatch than
alone (on the H100 the P3P stage's batched 3x3 products did).
:func:`hmm` and :func:`fixed_sum` build their sums from ``torch.sum``
calls over at most ``GROUP`` terms -- a length the reduction handles in
one warp, or one thread, whatever the rest of the call -- so the
association depends on the summed length alone and a frame's geometry
is bit-equal in every frame bucket (chip_smoke.py phase 5 holds it at 2,
4, 16 and 64 lanes).
"""

from __future__ import annotations

import torch


# The most terms one torch.sum call adds.
GROUP = 32


def fixed_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in groups of :data:`GROUP` (zero-padded), then the
    group sums likewise, until one group is left: an association fixed by
    the summed length, so a slice's sum is bit-equal however many slices
    share the call."""
    dim %= x.dim()
    while x.shape[dim] > GROUP:
        n, pad = x.shape[dim], -x.shape[dim] % GROUP
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,) + x.shape[dim + 1:])], dim)
        x = x.reshape(x.shape[:dim] + (-1, GROUP) + x.shape[dim + 1:]).sum(dim + 1)
    return x.sum(dim)


def hmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a (..., m, k) @ b (..., k, n), leading dims broadcast: the
    (..., m, k, n) products summed over k by :func:`fixed_sum` (no TF32,
    no batch-dependent split; the geometry core's k is 3 to 6)."""
    return fixed_sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for and missing -- an entry point never
    continues on the CPU quietly; tests pass ``device="cpu"`` explicitly.
    Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``: geometry and scoring are
    float32 throughout, and the CNNs compute in the preset's dtype, never
    in TF32.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "esac_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch path on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
