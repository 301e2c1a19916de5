"""The multi-target Bloom prefilter of the mask kernel: the same bits,
from the same digests, as the reference's ``bloom_tables`` and
``bloom_found`` (dprf_tpu/ops/pallas_mask.py).

Targets are split into sets of SET_SIZE; set s, probe p is a 4096-bit
bitmap (128 uint32 words, row s * K_PROBES + p) with one bit set per
target, keyed by the 12 bits [12p, 12p + 12) of the target's own digest
word string -- targets are uniform hash outputs, so no extra hashing is
needed.  A candidate passes ("maybe") if all K_PROBES probes of any set
pass.  A real hit always passes; the kernel then verifies every maybe
exactly against the sorted target table (ops/compare.py).
"""

from __future__ import annotations

import numpy as np
import torch

#: probes per target set; 8 probes of 12 bits use digest words 0..2
K_PROBES = 8
#: targets per set: at most 1024 bits set in each 4096-bit row
SET_SIZE = 1024
#: the most targets the kernel takes (8 sets: 32 KiB of rows)
MAX_TARGETS = 8192


def n_sets(n_targets: int) -> int:
    return -(-n_targets // SET_SIZE)


def bloom_tables(twords: np.ndarray) -> np.ndarray:
    """Target digest words uint32[N, W] -> Bloom rows
    uint32[n_sets * K_PROBES, 128]."""
    n = twords.shape[0]
    if n > MAX_TARGETS:
        raise ValueError(f"the Bloom prefilter takes <= {MAX_TARGETS} "
                         f"targets, got {n}")
    table = np.zeros((n_sets(n) * K_PROBES, 128), np.uint32)
    for s in range(n_sets(n)):
        chunk = twords[s * SET_SIZE:(s + 1) * SET_SIZE].astype(np.uint64)
        for p in range(K_PROBES):
            j, sh = divmod(12 * p, 32)
            bits = chunk[:, j] >> np.uint64(sh)
            if sh > 20:
                bits |= chunk[:, j + 1] << np.uint64(32 - sh)
            bits = (bits & np.uint64(0xFFF)).astype(np.uint32)
            np.bitwise_or.at(table[s * K_PROBES + p], bits >> 5,
                             np.uint32(1) << (bits & np.uint32(31)))
    return table


def probe_bits(digest: torch.Tensor, p: int) -> torch.Tensor:
    """int32[B, W] digest words -> the 12 probe bits [12p, 12p + 12) of
    each digest's word string, as int64[B]."""
    j, sh = divmod(12 * p, 32)
    bits = (digest[:, j].to(torch.int64) & 0xFFFFFFFF) >> sh
    if sh > 20:
        bits = bits | ((digest[:, j + 1].to(torch.int64) & 0xFFFFFFFF)
                       << (32 - sh))
    return bits & 0xFFF


def bloom_found(digest: torch.Tensor, rows: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Plain prefilter: digest int32[B, W], rows int32[R, 128]
    (``bloom_tables`` as int32), valid bool[B] -> bool[B] maybes."""
    probes = [probe_bits(digest, p) for p in range(K_PROBES)]
    found = torch.zeros_like(valid)
    for s in range(rows.shape[0] // K_PROBES):
        in_set = valid
        for p, bits in enumerate(probes):
            word = rows[s * K_PROBES + p][bits >> 5]
            in_set = in_set & (((word >> (bits & 31)) & 1) == 1)
        found = found | in_set
    return found


def expected_probes(rows: np.ndarray) -> float:
    """Probes a non-matching candidate tests per set, on average, when
    testing stops at the first miss: sum over p of the chance that
    probes 0..p-1 all pass, from each row's fill.  Averaged over the
    sets and summed, it is the data-dependent work of the prefilter."""
    fill = np.unpackbits(rows.view(np.uint8), axis=1).sum(axis=1) / 4096.0
    total = 0.0
    for s in range(rows.shape[0] // K_PROBES):
        reach = 1.0
        for p in range(K_PROBES):
            total += reach
            reach *= fill[s * K_PROBES + p]
    return total
