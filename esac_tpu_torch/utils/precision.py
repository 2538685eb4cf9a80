"""Float32 contractions for the geometry core, and the entry points' device
policy (counterpart of ``esac_tpu/utils/precision.py``).

The JAX package pins ``Precision.HIGHEST`` because TPU matmuls default to
bf16.  On the card the analogous hazard is TF32: a float32 convolution goes
through cuDNN in TF32 unless told otherwise, and TF32 keeps about three
decimal digits -- degrees of rotation error in 3x3 algebra.  Every entry
point therefore calls :func:`resolve_device`, which turns TF32 off for
matmuls and convolutions alike.
"""

from __future__ import annotations

import torch


def hmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 matmul; TF32 is off (see :func:`resolve_device`)."""
    return torch.matmul(a, b)


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
