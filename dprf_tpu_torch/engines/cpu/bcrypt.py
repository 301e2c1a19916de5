"""Pure-Python bcrypt (EksBlowfish), written from the Provos & Mazieres
"A Future-Adaptable Password Scheme" construction.

The Blowfish initial state is _blowfish_tables.py (hex digits of pi via
the BBP series), so no published table was copied.  A copy of the JAX
package's oracle (the port imports nothing of it); tests hold the two
equal and check the OpenBSD test vectors.

This oracle is slow by nature (pure Python, ~0.16 s a candidate at
cost 4 on one CPU core); use low cost factors in tests.  The throughput
path is the CUDA kernels of ops/cuda_bcrypt.py.
"""

from __future__ import annotations

import re
import struct

from dprf_tpu_torch.engines.cpu._blowfish_tables import P_INIT, S_INIT

_MASK = 0xFFFFFFFF
_MAGIC = b"OrpheanBeholderScryDoubt"   # 3 x 64-bit ECB blocks
_B64_ALPHABET = "./ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
_B64_INDEX = {c: i for i, c in enumerate(_B64_ALPHABET)}
# Only variants with $2a/$2b key semantics (NUL-terminated key, unsigned
# bytes): $2$ and $2x$ differ in key handling and would silently produce
# false negatives, so they are rejected at parse time.
_HASH_RE = re.compile(r"^\$(2[aby])\$(\d{2})\$([./A-Za-z0-9]{22})([./A-Za-z0-9]{31})$")


class _Blowfish:
    __slots__ = ("p", "s")

    def __init__(self):
        self.p = list(P_INIT)
        self.s = [list(box) for box in S_INIT]

    def _encrypt(self, left: int, right: int) -> tuple:
        p = self.p
        s0, s1, s2, s3 = self.s
        for i in range(0, 16, 2):
            left ^= p[i]
            right ^= (((s0[left >> 24] + s1[(left >> 16) & 0xFF]) & _MASK
                       ^ s2[(left >> 8) & 0xFF]) + s3[left & 0xFF]) & _MASK
            right ^= p[i + 1]
            left ^= (((s0[right >> 24] + s1[(right >> 16) & 0xFF]) & _MASK
                      ^ s2[(right >> 8) & 0xFF]) + s3[right & 0xFF]) & _MASK
        return right ^ self.p[17], left ^ self.p[16]

    def expand_key(self, key: bytes, salt_words=None) -> None:
        # XOR the cyclically-extended key (big-endian 32-bit reads over the
        # byte stream) into the P-array, then regenerate P and S by chained
        # encryption; with a salt, successive encryptions are XOR-perturbed
        # by the alternating 64-bit salt halves.
        klen = len(key)
        j = 0
        for i in range(18):
            word = 0
            for _ in range(4):
                word = ((word << 8) | key[j]) & _MASK
                j = (j + 1) % klen
            self.p[i] ^= word

        left = right = 0
        n = 0
        for i in range(0, 18, 2):
            if salt_words is not None:
                left ^= salt_words[(2 * n) % 4]
                right ^= salt_words[(2 * n + 1) % 4]
            left, right = self._encrypt(left, right)
            n += 1
            self.p[i], self.p[i + 1] = left, right
        for box in self.s:
            for i in range(0, 256, 2):
                if salt_words is not None:
                    left ^= salt_words[(2 * n) % 4]
                    right ^= salt_words[(2 * n + 1) % 4]
                left, right = self._encrypt(left, right)
                n += 1
                box[i], box[i + 1] = left, right


def _eks_setup(password: bytes, salt: bytes, cost: int) -> _Blowfish:
    if not 4 <= cost <= 31:
        raise ValueError(f"bcrypt cost out of range: {cost}")
    if len(salt) != 16:
        raise ValueError("bcrypt salt must be 16 bytes")
    # $2a/$2b semantics: NUL-terminate, then truncate to 72 bytes.
    key = (password + b"\x00")[:72]
    salt_words = struct.unpack(">4I", salt)
    bf = _Blowfish()
    bf.expand_key(key, salt_words)
    for _ in range(1 << cost):
        bf.expand_key(key)
        bf.expand_key(salt)
    return bf


def bcrypt_raw(password: bytes, salt: bytes, cost: int) -> bytes:
    """23-byte bcrypt digest (the 24th ciphertext byte is discarded)."""
    bf = _eks_setup(password, salt, cost)
    words = list(struct.unpack(">6I", _MAGIC))
    for b in range(0, 6, 2):
        left, right = words[b], words[b + 1]
        for _ in range(64):
            left, right = bf._encrypt(left, right)
        words[b], words[b + 1] = left, right
    return struct.pack(">6I", *words)[:23]


def b64_encode(data: bytes) -> str:
    out = []
    for i in range(0, len(data), 3):
        chunk = data[i:i + 3]
        acc = int.from_bytes(chunk, "big") << (8 * (3 - len(chunk)))
        for k in range(len(chunk) + 1):
            out.append(_B64_ALPHABET[(acc >> (18 - 6 * k)) & 0x3F])
    return "".join(out)


def b64_decode(text: str, nbytes: int) -> bytes:
    acc = 0
    for c in text:
        acc = (acc << 6) | _B64_INDEX[c]
    acc >>= (6 * len(text)) - 8 * nbytes
    return acc.to_bytes(nbytes, "big")


def parse_hash(text: str) -> tuple:
    """'$2b$12$<salt22><hash31>' -> (variant, cost, salt16, digest23)."""
    m = _HASH_RE.match(text.strip())
    if not m:
        raise ValueError(f"not a bcrypt hash: {text!r}")
    variant, cost, salt_s, hash_s = m.groups()
    return variant, int(cost), b64_decode(salt_s, 16), b64_decode(hash_s, 23)


def bcrypt_hash(password: bytes, salt: bytes, cost: int,
                variant: str = "2b") -> str:
    digest = bcrypt_raw(password, salt, cost)
    return f"${variant}${cost:02d}${b64_encode(salt)[:22]}{b64_encode(digest)[:31]}"
