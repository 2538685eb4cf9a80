"""Backend dispatch (counterpart of ``esac_tpu/backends``): the port's own
tensor path (``--backend jax``, the scripts' default spelling) and ``cpp``,
the self-contained C++/OpenMP hypothesis loop of ``esac_cpp/`` run on the
host, once a frame (``--backend cpp``).
"""

from esac_tpu_torch.backends.cpp import (
    cpp_available,
    esac_infer_cpp,
    esac_infer_gated_cpp,
    esac_infer_multi_cpp,
    esac_train_cpp,
)

__all__ = [
    "cpp_available",
    "esac_infer_cpp",
    "esac_infer_gated_cpp",
    "esac_infer_multi_cpp",
    "esac_train_cpp",
]
