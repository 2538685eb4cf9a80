"""PyTorch/CUDA port of ``esac_tpu``: multi-expert ESAC relocalization on
an NVIDIA H100.

The package mirrors ``esac_tpu``'s layout so each module's counterpart is
where a reader looks for it, and keeps the JAX package's public layouts
(images NHWC, coordinates ``(..., N, 3)``, poses axis-angle ``(..., 3)``)
so the tests run the same numpy inputs through both.  It imports ``torch``
and numpy only -- never ``jax``, ``flax`` or anything under ``esac_tpu``.

Entry points (``ransac.kernel.dsac_infer[_frames]``,
``ransac.esac.esac_infer[_frames]``, ``registry.serving.make_scene_bucket_fn``)
run on the card unless the caller passes ``device="cpu"``; they raise when
CUDA is missing instead of falling back.  The two soft-inlier scoring
kernels are hand-written CUDA (``csrc/soft_inlier.cu``), built with
``nvcc`` at first use (``_build.py``).
"""
