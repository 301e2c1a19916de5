"""MD4 compression (RFC 1320) as vectorized int32 torch ops -- the NTLM
digest core (MD4 over UTF-16LE candidates).  Mirrors the pure-Python
oracle in engines/cpu/md4.py."""

from __future__ import annotations

import numpy as np
import torch

from dprf_tpu_torch.ops.int32 import as_i32, rotl

INIT = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476],
                dtype=np.uint32)
R2_ORDER = (0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15)
R3_ORDER = (0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15)
SHIFTS = ((3, 7, 11, 19), (3, 5, 9, 13), (3, 9, 11, 15))
K2, K3 = 0x5A827999, 0x6ED9EBA1      # both below 2^31


def md4_rounds(a, b, c, d, m):
    """The 48 MD4 steps over int32 tensors of any one shape (no
    feed-forward).  m: sequence of 16 message-word tensors."""
    for i in range(16):
        f = (b & c) | (~b & d)
        a = rotl(a + f + m[i], SHIFTS[0][i % 4])
        a, b, c, d = d, a, b, c
    for i, k in enumerate(R2_ORDER):
        g = (b & c) | (b & d) | (c & d)
        a = rotl(a + g + m[k] + K2, SHIFTS[1][i % 4])
        a, b, c, d = d, a, b, c
    for i, k in enumerate(R3_ORDER):
        h = b ^ c ^ d
        a = rotl(a + h + m[k] + K3, SHIFTS[2][i % 4])
        a, b, c, d = d, a, b, c
    return a, b, c, d


def md4_compress(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """state int32[..., 4] x words int32[..., 16] -> int32[..., 4]."""
    a, b, c, d = md4_rounds(*(state[..., i] for i in range(4)),
                            [words[..., i] for i in range(16)])
    return torch.stack([a, b, c, d], dim=-1) + state


def md4_digest_words(words: torch.Tensor) -> torch.Tensor:
    """Single-block MD4: int32[B, 16] packed message -> int32[B, 4]
    little-endian digest words."""
    init = torch.tensor(as_i32(INIT), dtype=torch.int32, device=words.device)
    return md4_compress(init.expand(words.shape[:-1] + (4,)), words)
