"""The blocked-Bloom probe: the bit layout of the reference's
``dprf_tpu/targets/probe.py`` (``bloom_fill``, ``kernel_bloom_geometry``)
and the host half of its probe table (``build_probe_table``,
``probe_eligible``), copied so the port never imports the reference.

Each target sets k bits inside one 512-bit block (16 uint32 words),
picked by a multiplicative hash of its digest word 0; a candidate tests
the k double-hashed bits of its own block, so the cost per candidate is
O(1) whatever the list length.  The mask kernel's probe compares
(csrc/compare.cuh ``probe_maybe``: the bitmap in shared memory for
PROBE, in global memory for BULK) and their plain version
(ops/cuda_mask.probe_found) read this layout.

A bulk list (``ProbeTable``) is the bitmap sized for a false-positive
budget (``FP_BUDGET``, the reference's default) plus the sorted digest
table the kernel verifies every survivor against.  When the two pass
the byte budget -- half the card's free memory (the reference's
``DPRF_TARGETS_HEADROOM_FRAC`` default), no cap on the CPU -- the table
is shed and the bitmap halved until it fits: the HOST-VERIFY layout,
whose survivors the worker confirms with one oracle hash each, as the
reference's ``probe_hits`` contract has it.  The reference's
``DPRF_TARGETS_*`` overrides are function arguments here
(``fp_budget=``, ``max_bytes=``), not environment knobs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from dprf_tpu_torch.ops import compare as cmp_ops

#: words per Bloom block: 16 x uint32 = 512 bits; all k probes of a
#: candidate land in the same block
BLOCK_WORDS = 16
BLOCK_BITS = BLOCK_WORDS * 32

#: Knuth multiplicative constant spreading digest word 0 over blocks
_GOLDEN = 0x9E3779B1

MAX_K = 8
#: smallest bitmap a degraded (host-verify) table keeps: 8 KiB
_MIN_BITS = 1 << 16
#: a bulk table's false-positive budget a candidate (the reference's
#: DPRF_TARGETS_FP_BUDGET default)
FP_BUDGET = 1e-4
#: the share of the card's free memory a bulk table may take (the
#: reference's DPRF_TARGETS_HEADROOM_FRAC default)
HEADROOM_FRAC = 0.5

MODE_DEVICE = "device"
MODE_HOST_VERIFY = "host-verify"


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def _geometry(n: int, m_bits: int):
    """(k, fp_est) for n keys in an m_bits bitmap."""
    k = int(round(m_bits / n * math.log(2)))
    k = min(max(k, 1), MAX_K)
    fp_est = (1.0 - math.exp(-k * n / m_bits)) ** k
    return k, fp_est


def bloom_fill(rows: np.ndarray, m_bits: int, k: int) -> np.ndarray:
    """uint32[N, W>=2] digest words -> the blocked-Bloom bitmap as
    uint32[m_bits // 32]: one 512-bit block per key picked by a
    multiplicative hash of word 0, then k probes inside the block that
    alternate between the double-hash pairs of words 0/1 and 2/3 (one
    pair carries only ~17 bits of entropy inside a block, so needing
    both to collide squares that floor away).  The bits are set in a
    byte a bit and packed, which takes 10^7 keys in seconds."""
    W = rows.shape[1]
    h1 = rows[:, 0].astype(np.uint64)
    h2 = (rows[:, 1].astype(np.uint64) | 1)
    h3 = rows[:, 2].astype(np.uint64) if W > 3 else h1
    h4 = (rows[:, 3].astype(np.uint64) | 1) if W > 3 else h2
    n_blocks = m_bits // BLOCK_BITS
    block_bits = n_blocks.bit_length() - 1
    if block_bits:
        block = ((h1 * _GOLDEN) & 0xFFFFFFFF) >> np.uint64(
            32 - block_bits)
    else:
        block = np.zeros(len(rows), dtype=np.uint64)
    base = block * np.uint64(BLOCK_BITS)
    flat = np.zeros(m_bits, dtype=np.bool_)
    for j in range(k):
        i = j >> 1
        a, b = (h3, h4) if j & 1 else (h1, h2)
        g = (a + (2 * i + 1) * b) & np.uint64(BLOCK_BITS - 1)
        flat[base + g] = True
    # bit w * 32 + b of the key space is bit b of word w (little-endian
    # packing of the bytes, then the bytes as little-endian words)
    return np.packbits(flat, bitorder="little").view("<u4").astype(
        np.uint32)


def _sized_bits(n: int, fp: float) -> int:
    """Bits of a bitmap of n keys at the false-positive budget fp: the
    classic -n ln(fp) / ln(2)^2, a power of two, at least one block."""
    fp = min(max(fp, 1e-9), 0.5)
    return max(BLOCK_BITS, _pow2ceil(int(math.ceil(
        -n * math.log(fp) / (math.log(2) ** 2)))))


def kernel_bloom_geometry(n: int, fp: float, max_bits: int):
    """(m_bits, k, fp_est) for an in-kernel probe bitmap of n keys:
    sized for the false-positive budget fp, capped at ``max_bits`` (the
    fp estimate reports what the cap buys)."""
    m_bits = min(_sized_bits(n, fp), _pow2ceil(max_bits))
    k, fp_est = _geometry(n, m_bits)
    return m_bits, k, fp_est


@dataclasses.dataclass(frozen=True)
class ProbeTable:
    """A bulk list's host-built probe structure (numpy; the workers move
    it to the card once)."""

    bits: np.ndarray         # uint32[16 << block_bits] bitmap
    block_bits: int          # log2 of the bitmap's blocks
    k: int                   # bits a candidate tests
    #: the sorted digest table (MODE_DEVICE); None in host-verify mode
    table: Optional[cmp_ops.TargetTable]
    order: np.ndarray        # sorted position -> job target index
    num_targets: int
    mode: str                # MODE_DEVICE | MODE_HOST_VERIFY
    fp_est: float            # analytic false-positive rate of ``bits``
    nbytes: int              # device bytes: bitmap + exact table


def byte_budget(device=None) -> Optional[int]:
    """Device-byte cap for a probe table: HEADROOM_FRAC of the card's
    free memory (``torch.cuda.mem_get_info``), or None (no cap) for the
    CPU or no device."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(torch.device(device))
    return int(free * HEADROOM_FRAC)


def probe_eligible(targets: Sequence, engine=None) -> bool:
    """Can this target list use a probe table: an unsalted engine,
    uniform digests of at least two whole uint32 words (the block pick
    and the double hash read words 0-1), no per-target parameters."""
    if not targets:
        return False
    if engine is not None and getattr(engine, "salted", False):
        return False
    dlen = len(targets[0].digest)
    if dlen < 8 or dlen % 4:
        return False
    return all(len(t.digest) == dlen and not t.params for t in targets)


def table_geometry(n: int, dlen: int, fp_budget: float = FP_BUDGET,
                   max_bytes: Optional[int] = None):
    """(m_bits, k, fp_est, mode) of a bulk table of n digests of dlen
    bytes: the bitmap sized for fp_budget, and the degrade rule -- past
    ``max_bytes`` the exact table is shed and the bitmap halved until it
    fits (never below 8 KiB)."""
    m_bits = _sized_bits(n, fp_budget)
    exact_bytes = n * dlen + n * 4       # words[T, W] + first[T]
    mode = MODE_DEVICE
    if max_bytes is not None and m_bits // 8 + exact_bytes > max_bytes:
        mode = MODE_HOST_VERIFY
        while m_bits > _MIN_BITS and m_bits // 8 > max_bytes:
            m_bits //= 2
    k, fp_est = _geometry(n, m_bits)
    return m_bits, k, fp_est, mode


def build_probe_table(digests: Sequence[bytes], little_endian: bool = True,
                      fp_budget: Optional[float] = None,
                      max_bytes: Optional[int] = None, device=None,
                      log=None) -> ProbeTable:
    """N raw digests -> a ProbeTable sized for the fp budget (default
    FP_BUDGET) and the byte budget (``max_bytes``, else ``byte_budget``
    of ``device``): the reference's ``build_probe_table``."""
    if not digests:
        raise ValueError("empty target list")
    dlen = len(digests[0])
    if dlen < 8 or dlen % 4:
        raise ValueError(
            "probe tables need digests of >= 2 whole uint32 words")
    return build_probe_rows(cmp_ops.digest_rows(digests, little_endian),
                            fp_budget, max_bytes, device, log)


def build_probe_rows(rows: np.ndarray, fp_budget: Optional[float] = None,
                     max_bytes: Optional[int] = None, device=None,
                     log=None) -> ProbeTable:
    """``build_probe_table`` from the digest words uint32[N, W >= 2]
    (``compare.digest_rows``)."""
    n, w = rows.shape
    if n == 0 or w < 2:
        raise ValueError("probe tables need >= 1 digest of >= 2 words")
    budget = max_bytes if max_bytes is not None else byte_budget(device)
    m_bits, k, fp_est, mode = table_geometry(
        n, 4 * w, FP_BUDGET if fp_budget is None else fp_budget, budget)
    words = bloom_fill(rows, m_bits, k)
    block_bits = (m_bits // BLOCK_BITS).bit_length() - 1
    table = None
    order = np.arange(n, dtype=np.int64)
    nbytes = words.nbytes
    if mode == MODE_DEVICE:
        table = cmp_ops.table_from_rows(rows)
        order = table.order
        nbytes += n * 4 * w + n * 4
    if log is not None:
        log.info("built probe table", targets=n, mode=mode, bits=m_bits,
                 k=k, fp=round(fp_est, 8), mbytes=round(nbytes / 1e6, 3))
    return ProbeTable(bits=words, block_bits=block_bits, k=k, table=table,
                      order=order, num_targets=n, mode=mode, fp_est=fp_est,
                      nbytes=nbytes)
