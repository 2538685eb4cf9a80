"""The MoE capacity dispatch of routed serving (the single-device part of
``esac_tpu/parallel/esac_sharded.py``).

:func:`route_frames_to_experts` assigns each (frame, selected expert) pair
a slot in that expert's fixed-width frame block.  The expert-sharded
programs of the JAX package (across devices, on ``torch.distributed`` in
the port) are still to port and will dispatch through the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route_frames_to_experts(selected, num_experts: int, capacity: int):
    """Assign each (frame, selected-expert) pair a slot in that expert's
    block of ``capacity`` frames, dropping overflow deterministically
    (counterpart of ``route_frames_to_experts``).

    ``selected`` (B, K): global expert ids per frame, distinct within a
    frame (:func:`~esac_tpu_torch.ransac.esac.select_topk_experts`).  Drop
    priority is frame index: frame b's slot in expert m's block is the
    number of earlier frames that also selected m, and slots >= capacity
    drop.  Padding lanes come after every real frame, so a pad lane can
    never displace a real pair: the surviving pairs of a request do not
    depend on its bucket.

    Returns ``(kept, pos, slot_frame, slot_valid)``: kept (B, K) bool, the
    pair survived; pos (B, K) int64, its slot (meaningful where kept; clamp
    before gathering); slot_frame (M, C) int64, the frame riding each slot
    (0 where invalid: finite garbage, masked downstream); slot_valid (M, C)
    bool.  One-hot, cumulative sums and comparisons only.
    """
    selected = torch.as_tensor(selected).long()
    onehot = F.one_hot(selected, num_experts)            # (B, K, M)
    mask = onehot.sum(dim=1)                             # (B, M): b selected m
    order = torch.cumsum(mask, dim=0) - mask             # earlier frames first
    kept_bm = (mask == 1) & (order < capacity)
    pos = torch.gather(order, 1, selected)
    kept = torch.gather(kept_bm, 1, selected)
    slots = torch.arange(capacity, device=selected.device)
    slot_hit = kept_bm.T[:, None, :] & (order.T[:, None, :] == slots[None, :, None])  # (M, C, B)
    return kept, pos, torch.argmax(slot_hit.long(), dim=-1), slot_hit.any(dim=-1)
