"""SHA-256 and SHA-224 compression (FIPS 180-4) as vectorized int32
torch ops.

The round constants (fractional cube roots of the first 64 primes) and
the initial states (fractional square roots of the first 8 primes; for
SHA-224 the second 32 fractional bits of those of primes 9-16) are
computed here with exact integer arithmetic, not copied from a listing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dprf_tpu_torch.ops.int32 import as_i32, rotr, shr


def _primes(n: int) -> list[int]:
    out, cand = [], 2
    while len(out) < n:
        if all(cand % p for p in out if p * p <= cand):
            out.append(cand)
        cand += 1
    return out


def _icbrt(n: int) -> int:
    lo, hi = 0, 1 << ((n.bit_length() + 2) // 3 + 1)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid ** 3 <= n:
            lo = mid
        else:
            hi = mid - 1
    return lo


_PRIMES = _primes(64)
K = np.array([_icbrt(p << 96) & 0xFFFFFFFF for p in _PRIMES],
             dtype=np.uint32)
INIT = np.array([math.isqrt(p << 64) & 0xFFFFFFFF for p in _PRIMES[:8]],
                dtype=np.uint32)
INIT224 = np.array([math.isqrt(p << 128) & 0xFFFFFFFF
                    for p in _PRIMES[8:16]], dtype=np.uint32)
_K_I32 = as_i32(K)


def sha256_rounds(a, b, c, d, e, f, g, h, m):
    """The 64 SHA-256 rounds over int32 tensors of any one shape (no
    feed-forward), with a rolling 16-word schedule.  m: sequence of 16
    message-word tensors."""
    w = list(m)
    for t in range(64):
        if t >= 16:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ shr(w15, 3)
            s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ shr(w2, 10)
            w[t % 16] = w[t % 16] + s0 + w[(t - 7) % 16] + s1
        big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + big_s1 + ch + _K_I32[t] + w[t % 16]
        big_s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = t1 + big_s0 + maj, a, b, c, d + t1, e, f, g
    return a, b, c, d, e, f, g, h


def sha256_compress(state: torch.Tensor,
                    words: torch.Tensor) -> torch.Tensor:
    """state int32[..., 8] x words int32[..., 16] (big-endian packed)
    -> int32[..., 8]."""
    out = sha256_rounds(*(state[..., i] for i in range(8)),
                        [words[..., i] for i in range(16)])
    return torch.stack(out, dim=-1) + state


def sha256_digest_words(words: torch.Tensor) -> torch.Tensor:
    """Single-block SHA-256: int32[B, 16] -> int32[B, 8] state words."""
    init = torch.tensor(as_i32(INIT), dtype=torch.int32, device=words.device)
    return sha256_compress(init.expand(words.shape[:-1] + (8,)), words)


def sha224_digest_words(words: torch.Tensor) -> torch.Tensor:
    """Single-block SHA-224: SHA-256 from its own initial state, cut to
    7 words: int32[B, 16] -> int32[B, 7]."""
    init = torch.tensor(as_i32(INIT224), dtype=torch.int32,
                        device=words.device)
    return sha256_compress(init.expand(words.shape[:-1] + (8,)),
                           words)[..., :7]
