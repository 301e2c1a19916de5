"""Pure-Python MD4 (RFC 1320).

hashlib's OpenSSL backend no longer ships md4, but NTLM is MD4 over the
UTF-16LE password, so the oracle needs its own implementation, written
from the RFC's round structure and held against the RFC 1320 appendix
vectors in tests/test_torch_md4.py.
"""

from __future__ import annotations

import struct

_MASK = 0xFFFFFFFF

# per-round message-word orders and rotations (RFC 1320 section 3.4)
_R1_ORDER = tuple(range(16))
_R2_ORDER = (0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15)
_R3_ORDER = (0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15)
_R1_SHIFTS = (3, 7, 11, 19)
_R2_SHIFTS = (3, 5, 9, 13)
_R3_SHIFTS = (3, 9, 11, 15)


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def _compress(state: tuple, block: bytes) -> tuple:
    x = struct.unpack("<16I", block)
    a, b, c, d = state
    for i, k in enumerate(_R1_ORDER):
        f = (b & c) | (~b & d)
        a = _rotl((a + f + x[k]) & _MASK, _R1_SHIFTS[i % 4])
        a, b, c, d = d, a, b, c
    for i, k in enumerate(_R2_ORDER):
        g = (b & c) | (b & d) | (c & d)
        a = _rotl((a + g + x[k] + 0x5A827999) & _MASK, _R2_SHIFTS[i % 4])
        a, b, c, d = d, a, b, c
    for i, k in enumerate(_R3_ORDER):
        h = b ^ c ^ d
        a = _rotl((a + h + x[k] + 0x6ED9EBA1) & _MASK, _R3_SHIFTS[i % 4])
        a, b, c, d = d, a, b, c
    return ((state[0] + a) & _MASK, (state[1] + b) & _MASK,
            (state[2] + c) & _MASK, (state[3] + d) & _MASK)


def md4(data: bytes) -> bytes:
    state = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)
    msg = data + b"\x80"
    msg += b"\x00" * ((56 - len(msg)) % 64)
    msg += struct.pack("<Q", (len(data) * 8) & 0xFFFFFFFFFFFFFFFF)
    for off in range(0, len(msg), 64):
        state = _compress(state, msg[off:off + 64])
    return struct.pack("<4I", *state)
