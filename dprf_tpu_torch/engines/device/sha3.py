"""SHA3 / Keccak device engines on torch tensors (hashcat 17300-18000):
sha3-224/256/384/512 and the original keccak-224/256/384/512, one
single-block sponge with (rate, pad byte, digest width) per variant.

The engine's ``pack`` returns the ABSORBED rate block, little-endian
int32[B, rate/4] words: the candidate, the variant's pad byte at its
length and 0x80 at rate - 1, merged when they meet (ops/keccak.py).  So
``cuda_mask.message_block`` gives the mask kernel's fixed words
unchanged, and ``digest_packed`` (Keccak-f and the squeeze) is the
plain function the kernel (csrc/keccak.cu) is held against.  Digest
words are the big-endian reading of the digest bytes (``little_endian``
False), as the targets are read.

A mask job runs the Keccak kernel through the mask worker, for one
target or a list (ops/cuda_keccak.py); a wordlist job runs the rules
kernel's sponge (ops/cuda_rules.py, csrc/rules_wide.cu: ``core``
``keccak<bits>``, one instantiation a rate, the pad byte a launch
parameter) through the wordlist worker, at the generator's max_len
(the CPU oracle's limit: 55 bytes for sha3-256 and keccak-256, rate - 1
for the others).
"""

from __future__ import annotations

import torch

from dprf_tpu_torch.engines import engine_class, register
from dprf_tpu_torch.engines.cpu.engines import KECCAK_SIZES
from dprf_tpu_torch.engines.device.engines import TorchEngineBase
from dprf_tpu_torch.ops.keccak import (keccak_block_digest, pack_rate_block,
                                       pack_rate_varlen)


class TorchKeccakEngine(TorchEngineBase):
    """The sponge for one (rate, pad byte, digest size): candidates of up
    to rate - 1 bytes, one absorbed block."""

    little_endian = False
    #: 0x06 SHA3, 0x01 Keccak: the rules kernel's launch parameter
    pad_byte: int
    _rate: int

    @property
    def core(self) -> str:
        """The rules kernel's core: ``keccak<bits>``, shared by sha3-<bits>
        and keccak-<bits>."""
        return f"keccak{8 * self.digest_size}"

    def pack(self, cand: torch.Tensor, length: int) -> torch.Tensor:
        """uint8[B, length] candidates -> the absorbed rate block,
        int32[B, rate/4] little-endian words."""
        return pack_rate_block(cand, length, self.pad_byte, self._rate)

    def pack_varlen(self, cand: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
        """uint8[B, L] rule outputs of int32[B] lengths -> the absorbed
        rate block, int32[B, rate/4] little-endian words."""
        return pack_rate_varlen(cand, lens, self.pad_byte, self._rate)

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return keccak_block_digest(blocks, self.digest_size)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The Keccak kernel's worker (the mask worker with the sponge as
        its core); a job the kernel does not take is refused, never
        moved to another path."""
        from dprf_tpu_torch.ops import cuda_keccak
        from dprf_tpu_torch.ops.bloom import MAX_TARGETS
        from dprf_tpu_torch.runtime.worker import CudaMaskWorker
        if not cuda_keccak.kernel_eligible(self.name, gen, len(targets)):
            raise ValueError(
                f"{self.name}: no Keccak kernel for this job (it takes "
                f"1..{MAX_TARGETS} targets and masks of "
                f"1..{self.max_candidate_len} positions, got "
                f"{len(targets)} targets and {gen.length} positions); "
                "use --device cpu")
        return CudaMaskWorker(self, gen, targets, batch=batch,
                              hit_capacity=hit_capacity, oracle=oracle,
                              device=self.torch_device)


def _register_keccak_device_family():
    """The 13 names of the CPU oracles' family on ``cuda``: each (bits,
    kind) gets a device class beside its oracle class, under the same
    names."""
    for bits, rate in KECCAK_SIZES:
        for kind, pad in (("sha3", 0x06), ("keccak", 0x01)):
            name = f"{kind}-{bits}"
            cpu_cls = engine_class(name, device="cpu")
            cls = type(f"Torch{kind.title()}{bits}Engine",
                       (TorchKeccakEngine,),
                       {"__doc__": cpu_cls.__doc__.replace(
                           "bare hex-digest lines", "on torch tensors"),
                        "name": name, "digest_size": bits // 8,
                        "digest_words": -(-bits // 32),
                        "max_candidate_len": rate - 1,
                        "pad_byte": pad, "_rate": rate})
            aliases = {"sha3-256": ["sha3"], f"keccak-{bits}":
                       [f"keccak{bits}"]}.get(name, [])
            for n in (name, *aliases):
                register(n, device="cuda")(cls)


_register_keccak_device_family()
