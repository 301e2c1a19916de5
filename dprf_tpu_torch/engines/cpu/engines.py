"""CPU reference HashEngines -- the bit-exact oracles.

Every device engine must match them exactly; they are the
``--device cpu`` execution path of the CLI and verify every device hit
before it reaches the potfile.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import HashEngine
from dprf_tpu_torch.engines.cpu.md4 import md4


class _HashlibEngine(HashEngine):
    _algo: str

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        algo = self._algo
        return [hashlib.new(algo, c).digest() for c in candidates]


@register("md5")
class Md5Engine(_HashlibEngine):
    name = "md5"
    digest_size = 16
    _algo = "md5"


@register("sha1")
@register("sha-1")
class Sha1Engine(_HashlibEngine):
    name = "sha1"
    digest_size = 20
    _algo = "sha1"


@register("sha256")
@register("sha-256")
class Sha256Engine(_HashlibEngine):
    name = "sha256"
    digest_size = 32
    _algo = "sha256"


@register("ntlm")
class NtlmEngine(HashEngine):
    """NTLM: MD4 over the UTF-16LE encoding of the password."""

    name = "ntlm"
    digest_size = 16
    # 27 chars -> 54 UTF-16LE bytes, still a single MD4 block after padding
    max_candidate_len = 27

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        # candidates are raw bytes read as latin-1 text, so the UTF-16LE
        # widening is the byte interleave NTLM expects for ASCII masks
        return [md4(c.decode("latin-1").encode("utf-16-le"))
                for c in candidates]
