"""7-Zip on the card (hashcat 11600), stored-coder entries: the
counterpart of the JAX package's engines/device/sevenzip.py.

The check (engines/cpu/sevenzip.py for the spec) on the card:

- **the KDF**, SHA-256 over 2^cycles units of salt || UTF-16LE(pw) ||
  LE64(i): nearly all of the work (196,609 compressions a candidate at
  7-Zip's default cycles 19 and 8 characters), on the kernel of
  csrc/sevenzip.cu (``ops/cuda_7z.sevenzip_kdf``), one launch per
  (entry, batch);
- **the verdict**, in torch on the card after the kernel, the
  reference's split: AES-256-CBC of the blocks that hold the unpacked
  bytes under each candidate's key (``ops/aes.aes_decrypt_blocks``; the
  ciphertext and IV are the entry's constants) and their CRC32
  (``crc32_batch``), compared with the stored CRC.  The CRC is the
  oracle's own digest, so a hit is exact.

An entry outside the card's envelope -- a salt over 16 bytes, a stream
that does not tile whole SHA-256 blocks, a payload over ``DATA_CAP``
bytes -- is refused, naming its hashlist line and ``--device cpu``; the
reference instead hands an over-cap payload to its CPU worker.  Masks
of 1..27 positions; wordlist jobs are refused the same way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.cpu.sevenzip import SevenZipEngine
from dprf_tpu_torch.ops.aes import aes_decrypt_blocks
from dprf_tpu_torch.ops.compare import compact_hits
from dprf_tpu_torch.ops.pack import words_to_bytes_be
from dprf_tpu_torch.runtime.worker import (GroupedSweepWorker,
                                           singleton_groups)

#: the largest encrypted payload the card's verdict takes, in bytes (the
#: reference's DPRF_7Z_DEVICE_DATA_CAP default): the AES and CRC32 loops
#: of a step run per block and byte of it
DATA_CAP = 1024

#: candidates per launch asked for at most.  At cycles 19 a candidate is
#: ~2 * 10^5 SHA-256 compressions, so a launch of ~2^18 takes seconds; on
#: the card the worker rounds it to the nearest whole number of resident
#: waves, at least one (``batch_for``), which may pass it, since a
#: partial last wave would idle most of the card for a whole candidate's
#: time.
BATCH = 1 << 18

#: CRC-32 (IEEE 802.3, the zlib polynomial) byte-step table.
_CRC_TABLE = np.zeros(256, np.int64)
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (0xEDB88320 ^ (_c >> 1)) if _c & 1 else _c >> 1
    _CRC_TABLE[_i] = _c


@functools.cache
def _crc_table(device) -> torch.Tensor:
    return torch.as_tensor(_CRC_TABLE, device=device)


def crc32_batch(data: torch.Tensor, nbytes: int) -> torch.Tensor:
    """CRC32 over the first nbytes of uint8[B, N] rows -> int64[B], a
    256-entry table gather per byte."""
    tbl = _crc_table(data.device)
    rows = data[:, :nbytes].to(torch.int64)
    c = torch.full((data.shape[0],), 0xFFFFFFFF, dtype=torch.int64,
                   device=data.device)
    for q in range(nbytes):
        c = tbl[(c ^ rows[:, q]) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def make_state_check(params: dict, device="cpu"):
    """check(int32[B, 8] SHA-256 key states on ``device``) -> int64[B],
    the recomputed CRC32: AES-256-CBC of the blocks that hold the
    unpacked bytes, the CBC xor chain a constant of the entry, then
    CRC32.  The entry's constants go to ``device`` once, here, so a check
    copies nothing from the host and never waits on the card."""
    data, iv = params["data"], params["iv"]
    unpacked = params["unpacked_len"]
    n = -(-unpacked // 16)
    blocks = np.frombuffer(data, np.uint8).reshape(-1, 16)
    prev = np.concatenate(
        [np.frombuffer((iv + bytes(16))[:16], np.uint8)[None],
         blocks[:-1]], axis=0)[:n]
    blocks = torch.as_tensor(blocks[:n].copy(), device=device)
    prev = torch.as_tensor(prev.copy(), device=device)

    def check(state: torch.Tensor) -> torch.Tensor:
        plain = aes_decrypt_blocks(words_to_bytes_be(state), blocks) ^ prev
        return crc32_batch(plain.reshape(state.shape[0], -1), unpacked)

    return check


def make_kernel_step(gen, batch: int, params: dict, hit_capacity: int,
                     device="cuda"):
    """One entry's step: the KDF kernel (its plain version on CPU
    tensors), the verdict in torch on the same device and the CRC
    compare.  step(base_digits, n_valid) -> (count int32[1], lanes
    int32[cap], None), lanes ascending, -1 past the hits.  Nothing in it
    waits on the card, so a unit's launches queue back to back."""
    from dprf_tpu_torch.ops import cuda_7z

    salt, cycles = params["salt"], params["cycles"]
    check = make_state_check(params, device)
    crc = params["crc"]
    lut = gen.charset_lut(torch.device(device))
    radices = gen.radices

    def step(base_digits, n_valid: int):
        state = cuda_7z.sevenzip_kdf(lut, radices, base_digits, n_valid,
                                     salt, cycles, batch)
        found = check(state) == crc
        count, lanes, _ = compact_hits(
            found, torch.zeros_like(found, dtype=torch.int32), hit_capacity)
        return count, lanes, None

    return step


def batch_for(gen, batch: int, device) -> int:
    """Candidates per launch: ``batch`` capped at BATCH, then on a card
    rounded to the nearest whole number of the kernel's resident waves,
    at least one, so that it may pass the cap."""
    from dprf_tpu_torch.ops import cuda_7z
    batch = min(batch, BATCH)
    if device.type != "cuda":
        return batch
    wave = cuda_7z.resident_lanes(gen.length, device)
    return wave * max(1, round(batch / wave))


class SevenZipMaskWorker(GroupedSweepWorker):
    """Mask worker over the KDF kernel and the torch verdict, the
    counterpart of the reference's SevenZipMaskWorker: each entry has its
    own step (its salt, cycles and payload), a group of one, one launch
    per (entry, batch)."""

    def __init__(self, engine, gen, targets, batch: int = BATCH,
                 hit_capacity: int = 64, oracle=None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_7z
        device = torch.device(device)
        if device.type == "cuda":
            cuda_7z.load_kernel()
        batch = batch_for(gen, batch, device)
        super().__init__(engine, gen, targets, batch, hit_capacity, oracle)
        self.groups = singleton_groups(
            [make_kernel_step(gen, batch, t.params, hit_capacity, device)
             for t in self.targets])


def entry_refusal(gen, params: dict):
    """Why the card does not take this entry, or None."""
    from dprf_tpu_torch.ops import cuda_7z
    why = cuda_7z.stream_refusal(gen.length, len(params["salt"]),
                                 params["cycles"])
    if why is None and len(params["data"]) > DATA_CAP:
        why = (f"a payload of {len(params['data'])} bytes (the card's "
               f"verdict takes at most {DATA_CAP})")
    return why


@register("7z", device="cuda")
@register("sevenzip", device="cuda")
class TorchSevenZipEngine(SevenZipEngine):
    """The device 7-Zip engine: the oracle's parsing and ``hash_batch``
    (one definition, so the oracle and the card cannot diverge), plus
    the KDF kernel's mask worker.  torch_device: "cuda" (the default) or
    "cpu", where the worker runs the kernel's plain version."""

    def __init__(self, torch_device="cuda"):
        self.torch_device = torch.device(torch_device)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The KDF kernel's worker; a job or an entry the card does not
        take is refused, never moved to another path."""
        from dprf_tpu_torch.engines.base import TargetRefused
        from dprf_tpu_torch.ops import cuda_7z
        from dprf_tpu_torch.ops.cuda_mask import mask_fits
        if not mask_fits(gen, cuda_7z.MAX_LENGTH):
            raise ValueError(
                f"{self.name}: no 7z KDF kernel for this job (it takes masks "
                f"of 1..{cuda_7z.MAX_LENGTH} positions, got "
                f"{getattr(gen, 'length', None)}); use --device cpu")
        for i, t in enumerate(targets):
            why = entry_refusal(gen, t.params)
            if why is not None:
                raise TargetRefused(i, f"{self.name}: the card does not take "
                                    f"{why}; use --device cpu")
        return SevenZipMaskWorker(self, gen, targets, batch=batch,
                                  hit_capacity=hit_capacity, oracle=oracle,
                                  device=self.torch_device)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        raise ValueError(f"{self.name}: the 7z KDF kernel takes mask jobs "
                         "only; use --device cpu for a wordlist")

