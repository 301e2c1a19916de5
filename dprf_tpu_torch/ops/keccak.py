"""Keccak-f[1600] and the single-block Keccak/SHA3 sponge on torch
tensors, and the scalar sponge the CPU oracles use.

The 25 64-bit lanes are int64 tensors with the uint64 bit pattern
(ops/sha512.py's word form), indexed x + 5y.  Round constants come from
the specification's LFSR and rho's offsets from its t-iteration,
generated here rather than pasted.

The device path is single-block: a candidate of at most rate - 1 bytes
absorbs as one rate block, the candidate, the variant's pad byte at its
length (0x06 for SHA3, 0x01 for the original Keccak) and 0x80 at rate -
1, merged when they meet.  ``pack_rate_block`` lays that block out as
little-endian int32 words, two to a lane (lane i = words 2i | words
2i+1 << 32), the layout the mask kernel (csrc/keccak.cu) takes.

Digest words are the BIG-endian reading of the digest bytes, so a
target's ">u4" words compare directly, while the lanes are
little-endian: word 2i is bswap(lo(lane i)), word 2i + 1 bswap(hi(lane
i)); a 224-bit digest ends on a half lane and gives its low word only.
"""

from __future__ import annotations

import numpy as np
import torch

from dprf_tpu_torch.ops.sha512 import as_i64, rotl64


def _rc_constants() -> list[int]:
    """Round constants via the Keccak LFSR (x^8+x^6+x^5+x^4+1)."""
    out = []
    r = 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            if r & 1:
                rc |= 1 << ((1 << j) - 1)
            r = ((r << 1) ^ (0x71 if r & 0x80 else 0)) & 0xFF
        out.append(rc)
    return out


RC = _rc_constants()


def _rho_offsets() -> list[int]:
    """rho's rotation offset of each lane x + 5y."""
    rho = [0] * 25
    x, y = 1, 0
    for t in range(24):
        rho[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return rho


RHO = _rho_offsets()
#: pi: lane x + 5y moves to lane y + 5((2x + 3y) mod 5)
PI = [y + 5 * ((2 * x + 3 * y) % 5) for y in range(5) for x in range(5)]


def keccak_round(lanes: list, rc: int) -> list:
    """One round of Keccak-f[1600] over 25 int64 tensors (x + 5y)."""
    c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15]
         ^ lanes[x + 20] for x in range(5)]
    d = [c[(x - 1) % 5] ^ rotl64(c[(x + 1) % 5], 1) for x in range(5)]
    b = [None] * 25
    for i in range(25):
        b[PI[i]] = rotl64(lanes[i] ^ d[i % 5], RHO[i])
    out = [b[i] ^ (~b[(i + 1) % 5 + 5 * (i // 5)]
                   & b[(i + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
    out[0] = out[0] ^ as_i64(rc)
    return out


def keccak_f(lanes: list) -> list:
    """Keccak-f[1600]: the 24 rounds over 25 int64 tensors (x + 5y)."""
    for rc in RC:
        lanes = keccak_round(lanes, rc)
    return lanes


def absorb_words(words: torch.Tensor) -> list:
    """A rate block int32[B, rate/4] (little-endian words, two to a
    lane) -> the 25 lanes of the state after the absorb, zeros past the
    rate."""
    w = words.to(torch.int64)
    lanes = [(w[:, 2 * i] & 0xFFFFFFFF) | (w[:, 2 * i + 1] << 32)
             for i in range(words.shape[1] // 2)]
    zero = torch.zeros_like(w[:, 0])
    return lanes + [zero] * (25 - len(lanes))


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of the low 32 bits of int64 x, as an int64."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def squeeze_words(lanes: list, out_bytes: int) -> torch.Tensor:
    """The first ``out_bytes`` of the state as BIG-endian int32 words:
    word 2i = bswap(lo(lane i)), word 2i + 1 = bswap(hi(lane i)); a
    half-lane tail (224 bits) gives its low word only."""
    out = []
    for w in range(-(-out_bytes // 4)):
        lane = lanes[w // 2]
        half = lane if w % 2 == 0 else lane >> 32
        out.append(_bswap32(half & 0xFFFFFFFF))
    return torch.stack(out, dim=-1).to(torch.int32)


def pack_rate_block(cand: torch.Tensor, length: int, pad_byte: int,
                    rate: int) -> torch.Tensor:
    """Fixed-length candidates uint8[B, length] -> the absorbed rate
    block int32[B, rate/4], little-endian words: the candidate, the pad
    byte at ``length`` and 0x80 at rate - 1 (merged when they meet)."""
    if not 0 <= length <= rate - 1:
        raise ValueError(f"single-block keccak at rate {rate} needs <= "
                         f"{rate - 1} bytes, got {length}")
    const = np.zeros(rate, dtype=np.uint8)
    const[length] = pad_byte
    const[rate - 1] |= 0x80
    msg = torch.as_tensor(const, device=cand.device).repeat(cand.shape[0], 1)
    msg[:, :length] = cand
    return _rate_words(msg)


def pack_rate_varlen(cand: torch.Tensor, lens: torch.Tensor, pad_byte: int,
                     rate: int) -> torch.Tensor:
    """Variable-length candidates uint8[B, L <= rate - 1] of int32[B]
    lengths (rule outputs) -> the absorbed rate block int32[B, rate/4]:
    each lane's bytes below its length, the pad byte at its length and
    0x80 ORed into byte rate - 1 (one byte 0x80 | pad at length rate - 1)."""
    batch, length = cand.shape
    if length > rate - 1:
        raise ValueError(f"single-block keccak at rate {rate} needs <= "
                         f"{rate - 1} bytes, got {length}")
    pos = torch.arange(rate, dtype=torch.int32, device=cand.device)[None, :]
    lc = lens.to(torch.int32)[:, None]
    msg = torch.zeros((batch, rate), dtype=torch.uint8, device=cand.device)
    msg[:, :length] = cand
    msg = torch.where(pos < lc, msg, 0)
    msg = torch.where(pos == lc, pad_byte, msg).to(torch.uint8)
    msg[:, rate - 1] |= 0x80
    return _rate_words(msg)


def _rate_words(msg: torch.Tensor) -> torch.Tensor:
    """A rate block's bytes uint8[B, rate] -> int32[B, rate/4]
    little-endian words."""
    grouped = msg.reshape(msg.shape[0], -1, 4).to(torch.int32)
    return (grouped[..., 0] | (grouped[..., 1] << 8)
            | (grouped[..., 2] << 16) | (grouped[..., 3] << 24))


def keccak_block_digest(words: torch.Tensor, out_bytes: int) -> torch.Tensor:
    """The absorbed rate block int32[B, rate/4] -> digest words
    int32[B, ceil(out_bytes/4)] (``squeeze_words``' layout)."""
    return squeeze_words(keccak_f(absorb_words(words)), out_bytes)


def keccak_words(cand: torch.Tensor, length: int, pad_byte: int = 0x01,
                 rate: int = 136, out_bytes: int = 32) -> torch.Tensor:
    """Single-block Keccak/SHA3 over fixed-length candidates uint8[B,
    length <= rate - 1] -> digest words int32[B, ceil(out_bytes/4)].
    pad_byte 0x01 = original Keccak, 0x06 = SHA3; rate = 200 - 2 *
    out_bytes (144/136/104/72 for 224/256/384/512)."""
    return keccak_block_digest(pack_rate_block(cand, length, pad_byte, rate),
                               out_bytes)


def _keccak_f_scalar(lanes: list[int]) -> list[int]:
    """Pure-Python keccak-f[1600] on 25 ints (x + 5y indexing)."""
    M = (1 << 64) - 1

    def rot(v, n):
        n %= 64
        return ((v << n) | (v >> (64 - n))) & M if n else v

    for rnd in range(24):
        c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15]
             ^ lanes[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ rot(c[(x + 1) % 5], 1) for x in range(5)]
        lanes = [lanes[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for i in range(25):
            b[PI[i]] = rot(lanes[i], RHO[i])
        lanes = [b[i] ^ ((~b[(i + 1) % 5 + 5 * (i // 5)] & M)
                         & b[(i + 2) % 5 + 5 * (i // 5)])
                 for i in range(25)]
        lanes[0] ^= RC[rnd]
    return lanes


def keccak_digest(data: bytes, pad_byte: int = 0x01, rate: int = 136,
                  out_bytes: int = 32) -> bytes:
    """Host scalar Keccak sponge (the CPU oracle); pad 0x01 = original
    Keccak, 0x06 = SHA3.  Multi-block (the device path is single-block;
    the oracle may see longer data)."""
    buf = bytearray(data)
    buf.append(pad_byte)
    while len(buf) % rate:
        buf.append(0)
    buf[-1] |= 0x80
    lanes = [0] * 25
    for off in range(0, len(buf), rate):
        for i in range(rate // 8):
            lanes[i] ^= int.from_bytes(buf[off + 8 * i:off + 8 * i + 8],
                                       "little")
        lanes = _keccak_f_scalar(lanes)
    full = b"".join(lanes[i].to_bytes(8, "little")
                    for i in range((out_bytes + 7) // 8))
    return full[:out_bytes]
