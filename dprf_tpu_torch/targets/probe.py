"""The blocked-Bloom probe bitmap: the bit layout of the reference's
``dprf_tpu/targets/probe.py`` (``bloom_fill``, ``kernel_bloom_geometry``),
copied so the port never imports the reference.

Each target sets k bits inside one 512-bit block (16 uint32 words),
picked by a multiplicative hash of its digest word 0; a candidate tests
the k double-hashed bits of its own block, so the cost per candidate is
O(1) whatever the list length.  The mask kernel's probe compare
(csrc/mask_kernel.cuh, ``probe_maybe``) and its plain version
(ops/cuda_mask.probe_found) read this layout.  The reference's XLA
``ProbeTable`` pipeline is not carried over.
"""

from __future__ import annotations

import math

import numpy as np

#: words per Bloom block: 16 x uint32 = 512 bits; all k probes of a
#: candidate land in the same block
BLOCK_WORDS = 16
BLOCK_BITS = BLOCK_WORDS * 32

#: Knuth multiplicative constant spreading digest word 0 over blocks
_GOLDEN = 0x9E3779B1

MAX_K = 8


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
    both to collide squares that floor away)."""
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
    words = np.zeros(m_bits // 32, dtype=np.uint32)
    for j in range(k):
        i = j >> 1
        a, b = (h3, h4) if j & 1 else (h1, h2)
        g = (a + (2 * i + 1) * b) & 0xFFFFFFFF
        bit = g & (BLOCK_BITS - 1)
        w = (block * BLOCK_WORDS + (bit >> np.uint64(5))).astype(np.int64)
        np.bitwise_or.at(
            words, w,
            np.uint32(1) << (bit & np.uint64(31)).astype(np.uint32))
    return words


def kernel_bloom_geometry(n: int, fp: float, max_bits: int):
    """(m_bits, k, fp_est) for an in-kernel probe bitmap of n keys:
    sized for the false-positive budget fp, capped at ``max_bits`` (the
    fp estimate reports what the cap buys)."""
    fp = min(max(fp, 1e-9), 0.5)
    m_bits = max(BLOCK_BITS, _pow2ceil(int(math.ceil(
        -n * math.log(fp) / (math.log(2) ** 2)))))
    m_bits = min(m_bits, _pow2ceil(max_bits))
    k, fp_est = _geometry(n, m_bits)
    return m_bits, k, fp_est
