"""Digest comparison and hit compaction.

Single target: a direct word compare.  Multi target (benchmark config
2): the targets are sorted by their digest words on the host (the
reference's ``make_target_table`` layout); a candidate is narrowed by a
search on its first word to the run of targets sharing it, and that run
is compared in full, so the compare is exact, not probabilistic.

Hit extraction has no data-dependent shapes: a fixed-capacity buffer
filled by scatter, plus the total count.  Overflow beyond the capacity
loses lane detail but never the count, and the host rescans the batch
with the CPU oracle in that case.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TargetTable:
    """The sorted multi-target table (host arrays)."""

    words: np.ndarray         # uint32[T, W] digests, sorted by word 0, 1, ...
    order: np.ndarray         # sorted position -> original target index

    @property
    def num_targets(self) -> int:
        return self.words.shape[0]

    def original_words(self) -> np.ndarray:
        """The digest words in the job's target order."""
        words = np.empty_like(self.words)
        words[self.order] = self.words
        return words

    def tensor(self, device) -> torch.Tensor:
        """The sorted words as int32[T, W] (same bit patterns)."""
        return torch.as_tensor(
            np.ascontiguousarray(self.words).view(np.int32).copy(),
            device=device)


def digest_rows(digests, little_endian: bool = True) -> np.ndarray:
    """Raw digest bytes -> uint32[N, W] words in the engine's layout
    (LE for the MD4/MD5 family, BE for SHA)."""
    if not digests:
        raise ValueError("empty target list")
    nwords = len(digests[0]) // 4
    if any(len(d) != 4 * nwords for d in digests):
        raise ValueError("inconsistent digest sizes in target list")
    buf = np.frombuffer(b"".join(digests),
                        dtype="<u4" if little_endian else ">u4")
    return buf.astype(np.uint32).reshape(len(digests), nwords)


def target_words_from_numpy(words: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32[W] target words (a row of ``digest_rows``) -> int32[W]
    tensor with the same bit patterns."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.as_tensor(words.view(np.int32).copy(), device=device)


def make_target_table(digests, little_endian: bool = True) -> TargetTable:
    """Sort the targets' digest words (word 0, then word 1, ...)."""
    return table_from_rows(digest_rows(digests, little_endian))


def sort_order(rows: np.ndarray) -> np.ndarray:
    """The stable lexicographic order of uint32[N, W] rows (word 0, then
    word 1, ...): ``np.lexsort(rows.T[::-1])``, computed as one stable
    argsort of words 0-1 as a 64-bit key, then a lexsort of the later
    words inside each run of equal keys (rare for digests), which keeps
    10^7 rows to about a second."""
    n, w = rows.shape
    if w < 3:
        return np.lexsort(rows.T[::-1])
    key = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | rows[:, 1]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    tie = np.flatnonzero(ks[1:] == ks[:-1])
    if tie.size:
        # each run of equal keys [a, b): sort its rows by words 2.. stably
        starts = tie[np.r_[True, tie[1:] != tie[:-1] + 1]]
        for a in starts:
            b = a + 1
            while b < n and ks[b] == ks[a]:
                b += 1
            run = order[a:b]
            order[a:b] = run[np.lexsort(rows[run, 2:].T[::-1])]
    return order


def table_from_rows(rows: np.ndarray) -> TargetTable:
    """The sorted table of digest words uint32[N, W] (``digest_rows``)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    order = sort_order(rows)
    return TargetTable(words=rows[order], order=order)


def compact_group_hits(found: torch.Tensor, capacity: int):
    """(found bool[B, T]: lane b hits the group's target t) -> the
    grouped kernels' hit buffers: (count int32[1], lanes int32[capacity],
    tpos int32[capacity], tcount int32[T]), the first ``capacity`` (lane,
    target) pairs in lane then target order, -1 in unused slots, and
    each target's own hit count."""
    pairs = found.nonzero().to(torch.int32)
    n = min(capacity, pairs.shape[0])
    lanes = torch.full((capacity,), -1, dtype=torch.int32,
                       device=found.device)
    tpos = torch.full_like(lanes, -1)
    lanes[:n], tpos[:n] = pairs[:n, 0], pairs[:n, 1]
    count = torch.tensor([pairs.shape[0]], dtype=torch.int32,
                         device=found.device)
    return count, lanes, tpos, found.sum(dim=0, dtype=torch.int32)


def compare_single(digest: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """int32[B, W] vs int32[W] -> bool[B]."""
    return (digest == target[None, :]).all(dim=-1)


def compare_multi(digest: torch.Tensor, table: torch.Tensor):
    """int32[B, W] digests vs the sorted table int32[T, W] -> (found
    bool[B], tpos int32[B]), tpos the first matching position in the
    sorted table."""
    t = table.shape[0]
    # the longest run of equal word 0: how many positions to compare
    window = int(torch.unique_consecutive(
        table[:, 0], return_counts=True)[1].max())
    first = table[:, 0].to(torch.int64) & 0xFFFFFFFF      # uint32 order
    pos = torch.searchsorted(first, digest[:, 0].to(torch.int64)
                             & 0xFFFFFFFF)
    found = torch.zeros(digest.shape[0], dtype=torch.bool,
                        device=digest.device)
    tpos = torch.zeros(digest.shape[0], dtype=torch.int32,
                       device=digest.device)
    for k in range(window):
        idx = torch.clamp(pos + k, max=t - 1)
        hit = (table[idx] == digest).all(dim=-1)
        tpos = torch.where(hit & ~found, idx.to(torch.int32), tpos)
        found = found | hit
    return found, tpos


def compact_hits(found: torch.Tensor, lane_payload: torch.Tensor,
                 capacity: int):
    """(found bool[B], payload int32[B]) -> fixed-size hit buffer.

    Returns (count int32[1], lanes int32[capacity], payload
    int32[capacity]), lanes in ascending order; unused slots are -1.
    """
    device = found.device
    lane = torch.arange(found.shape[0], dtype=torch.int32, device=device)
    slot = torch.cumsum(found.to(torch.int32), 0) - 1
    # hits past the capacity and non-hits all land in the spare slot
    slot = torch.where(found & (slot < capacity), slot, capacity).long()
    lanes = torch.full((capacity + 1,), -1, dtype=torch.int32, device=device)
    payload = torch.full((capacity + 1,), -1, dtype=torch.int32,
                         device=device)
    lanes.scatter_(0, slot, lane)
    payload.scatter_(0, slot, lane_payload.to(torch.int32))
    count = found.sum(dtype=torch.int32).reshape(1)
    return count, lanes[:capacity], payload[:capacity]
