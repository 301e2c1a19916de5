"""On-device digest comparison and hit compaction.

Hit extraction has no data-dependent shapes: a fixed-capacity buffer
filled by scatter, plus the total count.  Overflow beyond the capacity
loses lane detail but never the count, and the host rescans the batch
with the CPU oracle in that case.
"""

from __future__ import annotations

import torch


def compare_single(digest: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """int32[B, W] vs int32[W] -> bool[B]."""
    return (digest == target[None, :]).all(dim=-1)


def compact_hits(found: torch.Tensor, lane_payload: torch.Tensor,
                 capacity: int):
    """(found bool[B], payload int32[B]) -> fixed-size hit buffer.

    Returns (count int32[1], lanes int32[capacity], payload
    int32[capacity]), lanes in ascending order; unused slots are -1.
    """
    device = found.device
    lane = torch.arange(found.shape[0], dtype=torch.int32, device=device)
    slot = torch.cumsum(found.to(torch.int32), 0) - 1
    # hits past the capacity and non-hits all land in the spare slot
    slot = torch.where(found & (slot < capacity), slot, capacity).long()
    lanes = torch.full((capacity + 1,), -1, dtype=torch.int32, device=device)
    payload = torch.full((capacity + 1,), -1, dtype=torch.int32,
                         device=device)
    lanes.scatter_(0, slot, lane)
    payload.scatter_(0, slot, lane_payload.to(torch.int32))
    count = found.sum(dtype=torch.int32).reshape(1)
    return count, lanes[:capacity], payload[:capacity]
