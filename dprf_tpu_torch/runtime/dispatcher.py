"""Dispatcher: keyspace splitter + work-unit lease ledger.

Units are generated lazily in index order (a keyspace of 95^7 would be
~66M units -- never materialized).  The ledger tracks the outstanding
leases, a queue of pending units (the gaps of a restricted sweep), and
the completed set as merged [start, end) ranges.

This is the local single-worker ledger: leases do not expire, and rank
order, coverage digests and the retry cap of the reference's
Dispatcher are not part of it.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Optional

from dprf_tpu_torch.runtime.workunit import WorkUnit


class IntervalSet:
    """Sorted, merged set of [start, end) integer intervals."""

    def __init__(self, intervals=()):
        self._iv: list[list] = []
        for s, e in intervals:
            self.add(s, e)

    def add(self, start: int, end: int) -> None:
        if end <= start:
            return
        iv = self._iv
        # first interval that ends at or after start: it may merge
        i = bisect.bisect_left([e for _, e in iv], start)
        j = i
        while j < len(iv) and iv[j][0] <= end:
            start = min(start, iv[j][0])
            end = max(end, iv[j][1])
            j += 1
        iv[i:j] = [[start, end]]

    def covered(self) -> int:
        return sum(e - s for s, e in self._iv)

    def gaps(self, upto: int) -> list[tuple]:
        """Uncovered ranges within [0, upto)."""
        out, prev = [], 0
        for s, e in self._iv:
            if s >= upto:
                break
            if s > prev:
                out.append((prev, min(s, upto)))
            prev = max(prev, e)
        if prev < upto:
            out.append((prev, upto))
        return out

    def intervals(self) -> list[tuple]:
        return [(s, e) for s, e in self._iv]


class Dispatcher:
    """Split [0, keyspace) into WorkUnits; lease and complete them."""

    def __init__(self, keyspace: int, unit_size: int):
        if unit_size <= 0:
            raise ValueError("unit_size must be positive")
        self.keyspace = keyspace
        self.unit_size = unit_size
        self._next_start = 0
        self._next_id = 0
        #: min-heap of (start, unit_id, unit): gap units lease lowest
        #: index first
        self._pending: list[tuple] = []
        self._outstanding: dict[int, WorkUnit] = {}
        self._done = IntervalSet()

    @classmethod
    def from_completed(cls, keyspace: int, unit_size: int,
                       completed: list) -> "Dispatcher":
        """A ledger whose ``completed`` ranges are already covered (the
        ranges --skip/--limit exclude); the gaps below the last covered
        range are re-split into unit-sized pieces."""
        d = cls(keyspace, unit_size)
        for s, e in completed:
            d._done.add(s, e)
        frontier = max((e for _, e in completed), default=0)
        for s, e in d._done.gaps(frontier):
            for u in range(s, e, unit_size):
                unit = d._make_unit(u, min(unit_size, e - u))
                heapq.heappush(d._pending, (unit.start, unit.unit_id, unit))
        d._next_start = frontier
        return d

    def _make_unit(self, start: int, length: int) -> WorkUnit:
        u = WorkUnit(self._next_id, start, length)
        self._next_id += 1
        return u

    def lease(self) -> Optional[WorkUnit]:
        """The next unit, or None if nothing is left to lease."""
        if self._pending:
            unit = heapq.heappop(self._pending)[2]
        elif self._next_start < self.keyspace:
            length = min(self.unit_size, self.keyspace - self._next_start)
            unit = self._make_unit(self._next_start, length)
            self._next_start += length
        else:
            return None
        self._outstanding[unit.unit_id] = unit
        return unit

    def complete(self, unit_id: int) -> bool:
        """Mark a leased unit done; returns True iff this call covered it."""
        unit = self._outstanding.pop(unit_id, None)
        if unit is None:
            return False
        self._done.add(unit.start, unit.end)
        return True

    def exhausted(self) -> bool:
        """True when the whole keyspace is covered."""
        return self._done.covered() >= self.keyspace

    def progress(self) -> tuple:
        return self._done.covered(), self.keyspace

    def completed_intervals(self) -> list[tuple]:
        return self._done.intervals()
