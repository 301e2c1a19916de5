"""WorkUnit: a contiguous keyspace shard.

The Dispatcher carves the candidate index space [0, keyspace) into
contiguous ranges; a unit is a pure function of its range, so
reissuing one is always safe (worst case a hit is reported twice and
deduped by the coordinator).

Indices are Python ints on the host: keyspaces like 95^7 exceed 2^32,
and the device never sees a raw index (it gets a mixed-radix digit
vector instead; see generators/mask.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    unit_id: int
    start: int
    length: int

    @property
    def end(self) -> int:
        return self.start + self.length

    def __repr__(self) -> str:  # pragma: no cover
        return f"WorkUnit({self.unit_id}: [{self.start}, {self.end}))"
