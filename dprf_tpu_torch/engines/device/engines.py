"""Torch device engines.

Each engine exposes (a) ``digest_packed``, the digest over packed
message words on any torch device, used by the fused crack step; (b)
``hash_batch``, the HashEngine host API, which round-trips bytes through
the engine's device; and (c) ``make_mask_worker``,
``make_sharded_mask_worker`` and ``make_wordlist_worker``, the CLI's
entries into the device path.

Digest word layouts match the CPU oracles bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import DeviceHashEngine, HashEngine, Target
from dprf_tpu_torch.ops.md4 import md4_digest_words
from dprf_tpu_torch.ops.md5 import md5_digest_words
from dprf_tpu_torch.ops.mysql323 import mysql323_digest_words
from dprf_tpu_torch.ops.pack import (pack_fixed, pack_fixed_wide, pack_varlen,
                                     pack_varlen_wide)
from dprf_tpu_torch.ops.sha1 import sha1_digest_words
from dprf_tpu_torch.ops.sha256 import (sha224_digest_words,
                                       sha256_digest_words)
from dprf_tpu_torch.ops.sha512 import (sha384_digest_words,
                                       sha512_digest_words)


class TorchEngineBase(DeviceHashEngine, HashEngine):
    """Packing and host-convenience layer for single-block engines.

    torch_device: where the engine's tensors live -- "cuda" (the
    default) or "cpu" when the caller asks for it."""

    #: digest words are little-endian (MD4/MD5 family) or big-endian (SHA)
    little_endian: bool = True
    #: NTLM: the candidate is widened to UTF-16LE before packing
    widen_utf16: bool = False
    max_candidate_len = 55

    def __init__(self, torch_device="cuda"):
        self.torch_device = torch.device(torch_device)

    @property
    def core(self) -> str:
        """The kernel core this engine runs on (``cuda_mask.KERNEL_CORES``,
        ``cuda_rules.KERNEL_CORES``): its own name, unless it is a line
        format that rides on another engine's core (``ldap-sha`` on
        sha1), which then names it."""
        return self.name

    def pack(self, cand: torch.Tensor, length: int) -> torch.Tensor:
        """uint8[B, length] candidates -> int32[B, 16] message words."""
        return pack_fixed(cand, length, big_endian=not self.little_endian,
                          widen=self.widen_utf16)

    def pack_varlen(self, cand: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
        """uint8[B, L] candidates of int32[B] lengths (rule outputs) ->
        int32[B, 16] message words."""
        return pack_varlen(cand, lens, big_endian=not self.little_endian,
                           widen=self.widen_utf16)

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        return self._hash_messages(candidates, self.max_candidate_len)

    def _hash_messages(self, messages: Sequence[bytes],
                       limit: int) -> list[bytes]:
        """The digests of ``messages`` (each at most ``limit`` bytes) on
        the engine's device, grouped by length."""
        out: list = [None] * len(messages)
        by_len: dict = {}
        for i, c in enumerate(messages):
            if len(c) > limit:
                raise ValueError(f"{self.name}: candidate longer than the "
                                 f"{limit}-byte single-block limit")
            by_len.setdefault(len(c), []).append(i)
        dt = "<u4" if self.little_endian else ">u4"
        for length, idx in by_len.items():
            buf = np.zeros((len(idx), length), dtype=np.uint8)
            for row, i in enumerate(idx):
                buf[row] = np.frombuffer(messages[i], dtype=np.uint8)
            cand = torch.as_tensor(buf, device=self.torch_device)
            digest = self.digest_packed(self.pack(cand, length)).cpu().numpy()
            words = digest.view(np.uint32).astype(dt)
            for row, i in enumerate(idx):
                out[i] = words[row].tobytes()[:self.digest_size]
        return out

    def _refuse_unless_eligible(self, gen, targets) -> None:
        """A mask job the kernel does not take is refused, never moved to
        another path.  A list of any length runs on one card (past
        ``cuda_mask.N_BULK`` targets the bulk probe)."""
        from dprf_tpu_torch.ops.cuda_mask import kernel_eligible
        if not kernel_eligible(self.name, gen, len(targets)):
            raise ValueError(
                f"{self.name}: no mask kernel for this job (it takes "
                f"masks of 1..{self.max_candidate_len} positions of 1..256 "
                f"characters, got {gen.length} positions); use --device "
                "cpu")

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The mask worker for this engine: the hand-written kernel's
        worker, which runs the kernel on a card and its plain version on
        CPU tensors.  A job the kernel does not take is refused, never
        moved to another path."""
        from dprf_tpu_torch.runtime.worker import CudaMaskWorker
        self._refuse_unless_eligible(gen, targets)
        return CudaMaskWorker(self, gen, targets, batch=batch,
                              hit_capacity=hit_capacity, oracle=oracle,
                              device=self.torch_device)

    def make_sharded_mask_worker(self, gen, targets, mesh: list,
                                 batch_per_device: int, hit_capacity: int,
                                 oracle=None):
        """The mask worker over a mesh of devices (parallel/mesh.py):
        the sharded runtime with the mask kernel as every shard's
        compute, for the kernel's cores (``cuda_mask.KERNEL_CORES``).
        A job the kernel does not take, or an engine without a sharded
        path yet, is refused, never run on fewer devices.  Unlike the
        reference, which sends lists of 4,096 or more to its XLA probe
        table, 2..8,192 targets run the kernel's blocked probe; a bulk
        list past 8,192 runs on one card (``--devices 1``) only."""
        from dprf_tpu_torch.ops.bloom import MAX_TARGETS
        from dprf_tpu_torch.ops.cuda_mask import KERNEL_CORES
        from dprf_tpu_torch.parallel.worker import ShardedMaskWorker
        if self.core not in KERNEL_CORES:
            raise ValueError(
                f"{self.name}: no sharded mask worker on several devices "
                f"yet (cores: {', '.join(KERNEL_CORES)}); run it with "
                "--devices 1")
        if len(targets) > MAX_TARGETS:
            raise ValueError(
                f"{self.name}: {len(targets)} targets on several devices: "
                f"the sharded mask worker takes 1..{MAX_TARGETS} targets "
                "(a bulk list runs on one card); run it with --devices 1")
        self._refuse_unless_eligible(gen, targets)
        return ShardedMaskWorker(self, gen, targets, mesh,
                                 batch_per_device=batch_per_device,
                                 hit_capacity=hit_capacity, oracle=oracle)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        """The wordlist+rules worker for this engine: the rule kernel's
        worker, which runs the kernel on a card and its plain version
        on CPU tensors, for one target or a list of any length.  A job
        the kernel does not take is refused, never moved to another
        path."""
        from dprf_tpu_torch.ops.cuda_rules import (KERNEL_CORES, MAX_STEPS,
                                                   kernel_rules_eligible)
        from dprf_tpu_torch.runtime.worker import CudaWordlistWorker
        if self.core not in KERNEL_CORES:
            raise ValueError(
                f"{self.name}: the rules kernel has no {self.core} core "
                f"(cores: {', '.join(KERNEL_CORES)}); use --device cpu for "
                "a wordlist")
        if not kernel_rules_eligible(self.name, gen, len(targets)):
            raise ValueError(
                f"{self.name}: no rules kernel for this job (it takes words "
                f"of at most {self.max_candidate_len} bytes and rules of at "
                f"most {MAX_STEPS} ops without @, E or e; got max_len "
                f"{gen.max_len}); use --device cpu")
        return CudaWordlistWorker(self, gen, targets, batch=batch,
                                  hit_capacity=hit_capacity, oracle=oracle,
                                  device=self.torch_device)


@register("md5", device="cuda")
class TorchMd5Engine(TorchEngineBase):
    name = "md5"
    digest_size = 16
    digest_words = 4
    little_endian = True

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return md5_digest_words(blocks)


@register("ntlm", device="cuda")
class TorchNtlmEngine(TorchEngineBase):
    """NTLM: MD4 over UTF-16LE.  ``pack`` widens the latin-1 candidate
    bytes (byte p -> byte 2p), as the kernel's decode does."""

    name = "ntlm"
    digest_size = 16
    digest_words = 4
    little_endian = True
    widen_utf16 = True
    # 27 chars -> 54 UTF-16LE bytes: still one MD4 block
    max_candidate_len = 27

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return md4_digest_words(blocks)


@register("sha1", device="cuda")
@register("sha-1", device="cuda")
class TorchSha1Engine(TorchEngineBase):
    name = "sha1"
    digest_size = 20
    digest_words = 5
    little_endian = False

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return sha1_digest_words(blocks)


@register("sha256", device="cuda")
@register("sha-256", device="cuda")
class TorchSha256Engine(TorchEngineBase):
    name = "sha256"
    digest_size = 32
    digest_words = 8
    little_endian = False

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return sha256_digest_words(blocks)


@register("sha224", device="cuda")
class TorchSha224Engine(TorchEngineBase):
    """SHA-224: SHA-256 with its own IV, cut to 28 bytes."""

    name = "sha224"
    digest_size = 28
    digest_words = 7
    little_endian = False

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return sha224_digest_words(blocks)


@register("sha512", device="cuda")
@register("sha-512", device="cuda")
class TorchSha512Engine(TorchEngineBase):
    """SHA-512 over one 128-byte block of 64-bit words (ops/sha512.py):
    candidates of up to 111 bytes."""

    name = "sha512"
    digest_size = 64
    digest_words = 16
    little_endian = False
    max_candidate_len = 111

    def pack(self, cand: torch.Tensor, length: int) -> torch.Tensor:
        """uint8[B, length] candidates -> int32[B, 32] message words."""
        return pack_fixed_wide(cand, length)

    def pack_varlen(self, cand: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
        """uint8[B, L] rule outputs of int32[B] lengths -> int32[B, 32]
        message words."""
        return pack_varlen_wide(cand, lens)

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return sha512_digest_words(blocks)


@register("sha384", device="cuda")
@register("sha-384", device="cuda")
class TorchSha384Engine(TorchSha512Engine):
    name = "sha384"
    digest_size = 48
    digest_words = 12

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return sha384_digest_words(blocks)


@register("ldap-sha", device="cuda")
class TorchLdapShaEngine(TorchSha1Engine):
    """LDAP {SHA} (hashcat 101): the sha1 core (mask and rules kernels,
    one target or a list) with the base64 line format."""

    name = "ldap-sha"
    core = "sha1"

    def parse_target(self, text: str) -> Target:
        from dprf_tpu_torch.engines.cpu.engines import LdapShaEngine
        return LdapShaEngine().parse_target(text)


@register("ldap-md5", device="cuda")
class TorchLdapMd5Engine(TorchMd5Engine):
    """LDAP {MD5}: the md5 core with the base64 line format."""

    name = "ldap-md5"
    core = "md5"

    def parse_target(self, text: str) -> Target:
        from dprf_tpu_torch.engines.cpu.engines import LdapMd5Engine
        return LdapMd5Engine().parse_target(text)


@register("mysql323", device="cuda")
@register("mysql-old", device="cuda")
class TorchMysql323Engine(TorchEngineBase):
    """MySQL pre-4.1 OLD_PASSWORD (hashcat 200): an add/xor/shift scan
    over the candidate's bytes (spaces and tabs skipped), two 31-bit
    words.  ``digest_packed`` reads the bytes and the length back from
    the big-endian single-block packing, as the reference's does, so it
    gives the reference's words bit for bit; the mask kernel's core
    (csrc/mask.cu) scans the same block."""

    name = "mysql323"
    digest_size = 8
    digest_words = 2
    little_endian = False

    def parse_target(self, text: str) -> Target:
        from dprf_tpu_torch.engines.cpu.engines import Mysql323Engine
        return Mysql323Engine().parse_target(text)

    def digest_packed(self, blocks: torch.Tensor) -> torch.Tensor:
        return mysql323_digest_words(blocks)
