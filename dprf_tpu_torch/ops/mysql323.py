"""MySQL pre-4.1 OLD_PASSWORD() as vectorized torch ops: the plain
version of the mask kernel's mysql323 core (csrc/mask.cu,
``Mysql323Core``) and the digest of the device engine.

The reference's device engine reads the candidate's bytes and length
back from the standard big-endian single-block packing (the bit length
in word 15), so every packing path applies unchanged; so does this.
The scan runs in int64 with each value masked to 32 bits (torch's
uint32 tensors have no arithmetic), to the longest length of the batch:
a lane past its own length, or at a space or tab, keeps its state.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
#: the scan's initial state (nr, nr2, add) and the digest words' mask
NR0, NR2_0, ADD0 = 1345345333, 0x12345671, 7
MASK31 = 0x7FFFFFFF


def mysql323_digest_words(blocks: torch.Tensor) -> torch.Tensor:
    """int32[B, 16] big-endian message words (one padded block of a
    candidate of up to 55 bytes) -> int32[B, 2], the two 31-bit words."""
    B = blocks.shape[0]
    lens = (blocks[:, 15] >> 3) & 0xFF
    words = blocks[:, :14].to(torch.int64) & M32
    byts = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)],
                       dim=2).reshape(B, 56)
    nr = torch.full((B,), NR0, dtype=torch.int64, device=blocks.device)
    nr2 = torch.full_like(nr, NR2_0)
    add = torch.full_like(nr, ADD0)
    for i in range(int(lens.max()) if B else 0):
        c = byts[:, i]
        active = (i < lens) & (c != 0x20) & (c != 0x09)
        nr_n = nr ^ (((((nr & 63) + add) * c) + (nr << 8)) & M32)
        nr2_n = (nr2 + (((nr2 << 8) & M32) ^ nr_n)) & M32
        nr = torch.where(active, nr_n, nr)
        nr2 = torch.where(active, nr2_n, nr2)
        add = torch.where(active, (add + c) & M32, add)
    return torch.stack([nr & MASK31, nr2 & MASK31], dim=1).to(torch.int32)
