"""CandidateGenerator interface.

A generator defines a keyspace [0, N) and a bijection index -> candidate
password.  The Dispatcher splits [0, N) into WorkUnits by index range,
so generators must support random access by index.

Device generators additionally decode on the device: a unit's base
index arrives as a mixed-radix digit vector (so all device arithmetic
stays int32 even for keyspaces far beyond 2^32) and a whole batch of
candidates is materialized from it without host traffic.
"""

from __future__ import annotations

import abc


class CandidateGenerator(abc.ABC):
    #: total number of candidates this generator can produce
    keyspace: int
    #: maximum candidate length in bytes
    max_length: int

    @abc.abstractmethod
    def candidate(self, index: int) -> bytes:
        """Host-side random access decode (oracle / verification path)."""

    def candidates(self, start: int, count: int) -> list[bytes]:
        return [self.candidate(i) for i in range(start, min(start + count,
                                                            self.keyspace))]
