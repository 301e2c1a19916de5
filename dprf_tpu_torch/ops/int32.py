"""32-bit word arithmetic on int32 tensors.

torch has no arithmetic on uint32 tensors, so every 32-bit word is
carried as int32 with the same bit pattern: additions wrap modulo 2^32
exactly as uint32 ones do, and each right shift is masked back to the
bits a logical shift keeps.  Constants at or above 2^31 enter as
Python ints in int32 range, through a numpy uint32 -> int32 view.
"""

from __future__ import annotations

import numpy as np
import torch


def as_i32(words) -> tuple:
    """uint32 words (any sequence) -> Python ints with their int32 bit
    patterns, safe to add to an int32 tensor."""
    return tuple(int(w) for w in
                 np.asarray(words, dtype=np.uint32).view(np.int32))


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of 32-bit words."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x << n) | shr(x, 32 - n)


def rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return shr(x, n) | (x << (32 - n))
