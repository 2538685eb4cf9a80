"""Three-stage training (counterpart of ``esac_tpu/train``):

1. ``expert`` -- per-expert scene-coordinate init (coordinate or
   reprojection loss);
2. ``gating`` -- gating classifier init (cross-entropy);
3. ``e2e``    -- end-to-end expected-pose-loss training through the
   hypothesis loop (single expert, and gating + M experts).

Each factory takes the module(s) and a ``torch.optim.Optimizer`` and
returns ``step(...)``: zero the gradients, run forward and backward, step
the optimizer, return the loss as a tensor.  The gradients stay on the
parameters' ``.grad`` after the step.
"""

from esac_tpu_torch.train.e2e import make_dsac_train_step, make_esac_train_step, step_generators
from esac_tpu_torch.train.expert import (
    make_expert_reproj_train_step,
    make_expert_train_step,
    reprojection_loss,
)
from esac_tpu_torch.train.gating import make_gating_train_step

__all__ = [
    "make_dsac_train_step",
    "make_esac_train_step",
    "make_expert_reproj_train_step",
    "make_expert_train_step",
    "make_gating_train_step",
    "reprojection_loss",
    "step_generators",
]
