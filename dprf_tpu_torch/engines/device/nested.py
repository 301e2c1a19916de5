"""Nested (double-hash) engines on torch tensors:
outer(hex(inner(password))), and MySQL 4.1+.

hashcat's md5(md5($p)) 2600, sha1(sha1($p)) 4500, md5(sha1($p)) 4400,
sha1(md5($p)) 4700, sha256(md5($p)) 20800, sha256(sha1($p)) 20700: the
outer hash takes the lowercase hex of the inner digest, made by a
vectorized nibble -> character map, with no host round trip between the
stages.  mysql41 (300) is sha1 over the raw inner sha1 digest.

Candidates feed the INNER hash, so ``pack`` follows the inner digest's
byte order; ``little_endian`` and ``digest_words`` are the OUTER
digest's, because the target table and the Bloom rows compare outer
words.  ``digest_packed`` is the plain chain the kernel (csrc/ext.cu)
is held against.  A mask job runs the nested kernel through the mask
worker (``runtime.worker.CudaMaskWorker``); a wordlist job runs the
rules kernel's nested instantiations (csrc/rules_nested.cu) through the
rules worker (``runtime.worker.CudaWordlistWorker``), the engine's
``pack_varlen`` and ``digest_packed`` its plain version.

The inner hex must fit one outer block: md5 (32 hex bytes) and sha1
(40) do; sha256's 64 would need two blocks, so sha256 is an outer stage
only.
"""

from __future__ import annotations

import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.cpu.engines import (NESTED_COMBOS,
                                                NESTED_DIGEST_SIZE,
                                                parse_mysql41)
from dprf_tpu_torch.engines.device.engines import TorchEngineBase
from dprf_tpu_torch.ops.md5 import md5_digest_words
from dprf_tpu_torch.ops.pack import pack_fixed, pack_varlen
from dprf_tpu_torch.ops.sha1 import sha1_digest_words
from dprf_tpu_torch.ops.sha256 import sha256_digest_words


def words_to_hex_bytes(words: torch.Tensor,
                       little_endian: bool) -> torch.Tensor:
    """Digest words int32[B, W] -> lowercase hex uint8[B, 8W] in the
    digest's canonical byte order."""
    shifts = (0, 8, 16, 24) if little_endian else (24, 16, 8, 0)
    byts = torch.stack([(words >> s) & 0xFF for s in shifts], dim=-1)
    byts = byts.reshape(words.shape[0], -1)            # [B, 4W]
    nibbles = torch.stack([byts >> 4, byts & 0xF], dim=-1)
    nibbles = nibbles.reshape(words.shape[0], -1)      # [B, 8W]
    return (nibbles + torch.where(nibbles < 10, ord("0"),
                                  ord("a") - 10)).to(torch.uint8)


_STAGES = {
    # algo -> (digest fn, words, little_endian)
    "md5": (md5_digest_words, 4, True),
    "sha1": (sha1_digest_words, 5, False),
    "sha256": (sha256_digest_words, 8, False),
}


class _NestedDeviceBase(TorchEngineBase):
    """A chain of the nested kernel: the kernel's mask worker, and the
    rules kernel's wordlist worker (``TorchEngineBase``'s)."""

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The nested kernel's worker (the mask worker with the nested
        chain as its core); a job the kernel does not take is refused,
        never moved to another path."""
        from dprf_tpu_torch.ops import cuda_ext
        from dprf_tpu_torch.ops.bloom import MAX_TARGETS
        from dprf_tpu_torch.runtime.worker import CudaMaskWorker
        if not cuda_ext.nested_eligible(self.name, gen, len(targets)):
            raise ValueError(
                f"{self.name}: no nested kernel for this job (it takes "
                f"1..{MAX_TARGETS} targets and masks of 1..55 positions, "
                f"got {len(targets)} targets and {gen.length} positions); "
                "use --device cpu")
        return CudaMaskWorker(self, gen, targets, batch=batch,
                              hit_capacity=hit_capacity, oracle=oracle,
                              device=self.torch_device)


class _NestedDeviceMixin(_NestedDeviceBase):
    _outer: str
    _inner: str

    def pack(self, cand: torch.Tensor, length: int) -> torch.Tensor:
        return pack_fixed(cand, length,
                          big_endian=not _STAGES[self._inner][2])

    def pack_varlen(self, cand: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
        return pack_varlen(cand, lens, big_endian=not _STAGES[self._inner][2])

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        inner_fn, _, inner_le = _STAGES[self._inner]
        outer_fn, _, outer_le = _STAGES[self._outer]
        hexb = words_to_hex_bytes(inner_fn(blocks), inner_le)
        return outer_fn(pack_fixed(hexb, 2 * NESTED_DIGEST_SIZE[self._inner],
                                   big_endian=not outer_le))


for _outer, _inner in NESTED_COMBOS:
    _name = f"{_outer}({_inner})"
    register(_name, device="cuda")(type(
        f"Torch{_outer.title()}Of{_inner.title()}Engine",
        (_NestedDeviceMixin,),
        {"name": _name,
         "digest_size": NESTED_DIGEST_SIZE[_outer],
         "digest_words": _STAGES[_outer][1],
         "little_endian": _STAGES[_outer][2],
         "__doc__": f"Nested {_outer}(hex({_inner}(password))) on torch "
                    "tensors.",
         "_outer": _outer, "_inner": _inner}))


@register("mysql41", device="cuda")
class TorchMysql41Engine(_NestedDeviceBase):
    """MySQL 4.1+ PASSWORD(): sha1(sha1(password)) over the RAW inner
    digest (hashcat 300).  Target lines are '*' + 40 hex chars.  The
    inner digest's big-endian words are the outer block's words 0-4,
    then 0x80000000 in word 5 and the bit length 160 in word 15."""

    name = "mysql41"
    digest_size = 20
    digest_words = 5
    little_endian = False

    def parse_target(self, text: str):
        return parse_mysql41(text)

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        inner = sha1_digest_words(blocks)
        block2 = torch.zeros((inner.shape[0], 16), dtype=torch.int32,
                             device=inner.device)
        block2[:, :5] = inner
        block2[:, 5] = -0x80000000                # 0x80000000 as int32
        block2[:, 15] = 160                       # 20 bytes
        return sha1_digest_words(block2)
