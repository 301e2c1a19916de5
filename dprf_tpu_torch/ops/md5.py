"""MD5 compression (RFC 1321) as vectorized int32 torch ops (the word
conventions of ops/int32.py).  The sine-derived constants are computed
here (math.sin), not copied from a listing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dprf_tpu_torch.ops.int32 import as_i32, rotl

K = np.array([int(abs(math.sin(i + 1)) * (1 << 32)) & 0xFFFFFFFF
              for i in range(64)], dtype=np.uint32)
SHIFTS = ((7, 12, 17, 22), (5, 9, 14, 20), (4, 11, 16, 23), (6, 10, 15, 21))
INIT = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476],
                dtype=np.uint32)

#: the same constants as signed Python ints (int32 bit patterns)
_K_I32 = as_i32(K)
_INIT_I32 = as_i32(INIT)


def md5_rounds(a, b, c, d, m):
    """The 64 MD5 steps over int32 tensors of any one shape (no
    feed-forward).  m: sequence of 16 message-word tensors."""
    for i in range(64):
        rnd = i // 16
        if rnd == 0:
            f = (b & c) | (~b & d)
            g = i
        elif rnd == 1:
            f = (d & b) | (~d & c)
            g = (5 * i + 1) % 16
        elif rnd == 2:
            f = b ^ c ^ d
            g = (3 * i + 5) % 16
        else:
            f = c ^ (b | ~d)
            g = (7 * i) % 16
        tmp = a + f + _K_I32[i] + m[g]
        a, d, c, b = d, c, b, b + rotl(tmp, SHIFTS[rnd][i % 4])
    return a, b, c, d


def md5_compress(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """state int32[..., 4] x words int32[..., 16] -> int32[..., 4]."""
    a, b, c, d = md5_rounds(*(state[..., i] for i in range(4)),
                            [words[..., i] for i in range(16)])
    # Davies-Meyer feed-forward with the input chaining state
    return torch.stack([a, b, c, d], dim=-1) + state


def md5_digest_words(words: torch.Tensor) -> torch.Tensor:
    """Single-block MD5: int32[B, 16] packed message -> int32[B, 4]
    little-endian digest words (word i = digest bytes 4i..4i+3 LE)."""
    init = torch.tensor(_INIT_I32, dtype=torch.int32, device=words.device)
    state = init.expand(words.shape[:-1] + (4,))
    return md5_compress(state, words)
