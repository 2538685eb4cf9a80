"""Expert and data parallelism over ``torch.distributed`` ranks
(counterpart of ``esac_tpu/parallel``).

- **EP (expert parallel)**: the experts are split over the mesh's
  ``expert`` axis; the one cross-rank collective of inference is the
  argmax all-reduce that selects the globally best hypothesis (BASELINE
  config #4: "50 experts sharded, all-reduce winning pose"), in
  ``esac_sharded``.
- **DP (data parallel)**: training frames split over the ``data`` axis
  (config #5), gradients summed across it, in ``train_sharded``.
- **Hypothesis parallel**: batched tensors within a device; never
  communicates.

Every rank is one process with one device (``multihost``): NCCL when each
rank has its own card, gloo on the CPU and for ranks that share a card.
"""

from esac_tpu_torch.parallel.esac_sharded import (
    esac_infer_routed,
    esac_infer_sharded,
    esac_infer_sharded_frames,
    make_esac_infer_routed_frames_sharded,
    make_esac_infer_sharded_frames,
    make_esac_infer_sharded_frames_dynamic,
    pad_experts_for_mesh,
    pad_gating_logits,
    route_frames_to_experts,
)
from esac_tpu_torch.parallel.mesh import batch_sharding, expert_sharding, make_mesh
from esac_tpu_torch.parallel.multihost import follow, initialize_multihost, lead, spawn_ranks
from esac_tpu_torch.parallel.train_sharded import (
    make_sharded_esac_loss,
    make_sharded_esac_train_step,
    shard_esac_params,
)

__all__ = [
    "make_mesh",
    "expert_sharding",
    "batch_sharding",
    "esac_infer_routed",
    "esac_infer_sharded",
    "esac_infer_sharded_frames",
    "follow",
    "initialize_multihost",
    "lead",
    "make_esac_infer_routed_frames_sharded",
    "make_esac_infer_sharded_frames",
    "make_esac_infer_sharded_frames_dynamic",
    "make_sharded_esac_loss",
    "make_sharded_esac_train_step",
    "pad_experts_for_mesh",
    "pad_gating_logits",
    "route_frames_to_experts",
    "shard_esac_params",
    "spawn_ranks",
]
