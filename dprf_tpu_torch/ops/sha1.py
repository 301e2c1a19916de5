"""SHA-1 compression (FIPS 180-4) as vectorized int32 torch ops: 80
unrolled steps over a rolling 16-word message schedule."""

from __future__ import annotations

import numpy as np
import torch

from dprf_tpu_torch.ops.int32 import as_i32, rotl

INIT = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476,
                 0xC3D2E1F0], dtype=np.uint32)
K = np.array([0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6],
             dtype=np.uint32)
_K_I32 = as_i32(K)


def sha1_rounds(a, b, c, d, e, m):
    """The 80 SHA-1 steps over int32 tensors of any one shape (no
    feed-forward).  m: sequence of 16 message-word tensors."""
    w = list(m)
    for t in range(80):
        if t >= 16:
            w[t % 16] = rotl(w[(t - 3) % 16] ^ w[(t - 8) % 16]
                             ^ w[(t - 14) % 16] ^ w[t % 16], 1)
        if t < 20:
            f = (b & c) | (~b & d)
        elif t < 40 or t >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (b & d) | (c & d)
        tmp = rotl(a, 5) + f + e + _K_I32[t // 20] + w[t % 16]
        a, b, c, d, e = tmp, a, rotl(b, 30), c, d
    return a, b, c, d, e


def sha1_compress(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """state int32[..., 5] x words int32[..., 16] (big-endian packed)
    -> int32[..., 5]."""
    out = sha1_rounds(*(state[..., i] for i in range(5)),
                      [words[..., i] for i in range(16)])
    return torch.stack(out, dim=-1) + state


def sha1_digest_words(words: torch.Tensor) -> torch.Tensor:
    """Single-block SHA-1: int32[B, 16] -> int32[B, 5] state words."""
    init = torch.tensor(as_i32(INIT), dtype=torch.int32, device=words.device)
    return sha1_compress(init.expand(words.shape[:-1] + (5,)), words)
