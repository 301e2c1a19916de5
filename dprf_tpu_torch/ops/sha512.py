"""SHA-512 / SHA-384 compression (FIPS 180-4) as vectorized torch ops.

The 64-bit words are int64 tensors with the bit pattern of the uint64
words: additions wrap modulo 2^64 exactly as uint64 ones do, and each
right shift is masked back to the bits a logical shift keeps, since
torch's ``>>`` on int64 is arithmetic.  (The reference carries each
word as a (hi, lo) pair of uint32 lanes, because a TPU has no 64-bit
integer lanes; torch on the CPU and on a card has them, and
``python -m dprf_tpu_torch.tools.bench_word64`` measures the int64 form
faster than the pair form on the CPU.)

Round constants (fractional cube roots of the first 80 primes) and
initial states (fractional square roots of primes 1-8 for SHA-512,
9-16 for SHA-384) are computed with exact integer arithmetic.

Message layout, the reference's: a 128-byte block is int32[..., 32]
big-endian words; 64-bit word i is (words[2i], words[2i+1]) = (hi, lo).
Digests use the same interleaved layout, so a ">u4" reading of the
digest bytes gives the words.
"""

from __future__ import annotations

import math

import torch

from dprf_tpu_torch.ops.sha256 import _icbrt, _primes

_MASK64 = (1 << 64) - 1


def _frac64(p: int, root: int) -> int:
    """First 64 fractional bits of p**(1/root)."""
    if root == 2:
        return math.isqrt(p << 128) & _MASK64
    return _icbrt(p << 192) & _MASK64


_PRIMES = _primes(80)
K = [_frac64(p, 3) for p in _PRIMES]
INIT512 = [_frac64(p, 2) for p in _PRIMES[:8]]
INIT384 = [_frac64(p, 2) for p in _PRIMES[8:16]]
# FIPS 180-4 spot checks
assert K[0] == 0x428A2F98D728AE22 and K[79] == 0x6C44198C4A475817
assert INIT512[0] == 0x6A09E667F3BCC908
assert INIT384[0] == 0xCBBB9D5DC1059ED8


def as_i64(v: int) -> int:
    """A uint64 value -> the Python int with its int64 bit pattern."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def shr64(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of 64-bit words."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def rotr64(x: torch.Tensor, n: int) -> torch.Tensor:
    return shr64(x, n) | (x << (64 - n))


def rotl64(x: torch.Tensor, n: int) -> torch.Tensor:
    n %= 64
    return x if n == 0 else (x << n) | shr64(x, 64 - n)


def join64(words: torch.Tensor) -> torch.Tensor:
    """int32[..., 2n] (hi, lo) pairs -> int64[..., n]."""
    w = words.to(torch.int64)
    return (w[..., 0::2] << 32) | (w[..., 1::2] & 0xFFFFFFFF)


def split64(words: torch.Tensor) -> torch.Tensor:
    """int64[..., n] -> int32[..., 2n] (hi, lo) pairs, same bits."""
    hi = (words >> 32).to(torch.int32)
    lo = words.to(torch.int32)          # keeps the low 32 bits
    return torch.stack([hi, lo], dim=-1).reshape(*words.shape[:-1], -1)


def sha512_rounds(state, m):
    """The 80 SHA-512 rounds over int64 tensors of one shape (no
    feed-forward), with a rolling 16-word schedule.  state: 8 tensors;
    m: 16 message-word tensors."""
    w = list(m)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        if t >= 16:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ shr64(w15, 7)
            s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ shr64(w2, 6)
            w[t % 16] = w[t % 16] + s0 + w[(t - 7) % 16] + s1
        big_s1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + big_s1 + ch + as_i64(K[t]) + w[t % 16]
        big_s0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = t1 + big_s0 + maj, a, b, c, d + t1, e, f, g
    return a, b, c, d, e, f, g, h


def sha512_compress(init, words: torch.Tensor) -> torch.Tensor:
    """init: 8 Python ints; words int32[..., 32] (one packed block) ->
    int32[..., 16] state words after the feed-forward."""
    w = join64(words)
    state = [torch.full_like(w[..., 0], as_i64(v)) for v in init]
    out = sha512_rounds(state, [w[..., i] for i in range(16)])
    return split64(torch.stack([o + as_i64(v) for o, v in zip(out, init)],
                               dim=-1))


def sha512_digest_words(words: torch.Tensor) -> torch.Tensor:
    """int32[..., 32] packed block -> int32[..., 16] digest words."""
    return sha512_compress(INIT512, words)


def sha384_digest_words(words: torch.Tensor) -> torch.Tensor:
    """SHA-384: SHA-512 with its own IV, the digest cut to 48 bytes (the
    first six 64-bit words = 12 int32 words)."""
    return sha512_compress(INIT384, words)[..., :12]
