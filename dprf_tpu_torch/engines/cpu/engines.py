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
