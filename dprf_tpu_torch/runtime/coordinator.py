"""Coordinator: owns the job -- leases WorkUnits, collects hits, decides
when to stop.

Thin host code; the hot loop lives in the workers' device steps.  Every
device hit is re-hashed by the CPU oracle before it reaches the
potfile, and a unit with a rejected hit is rescanned exactly by the
oracle before it counts as covered.  The job stops when every target
is cracked or the keyspace is covered.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.runtime.dispatcher import Dispatcher
from dprf_tpu_torch.runtime.potfile import Potfile
from dprf_tpu_torch.runtime.worker import CpuWorker, Hit
from dprf_tpu_torch.utils.logging import Log


@dataclasses.dataclass
class JobSpec:
    engine: str
    device: str
    attack: str                 # "mask" or "wordlist"
    attack_arg: str             # the mask string or the wordlist path
    keyspace: int


@dataclasses.dataclass
class JobResult:
    found: dict                  # target_index -> plaintext bytes
    tested: int
    elapsed: float
    exhausted: bool
    #: device hits the oracle rejected (0 on a healthy run)
    rejected: int = 0

    @property
    def rate(self) -> float:
        return self.tested / self.elapsed if self.elapsed > 0 else 0.0


class Coordinator:
    #: units submitted ahead of the oldest unresolved one: 2 overlaps
    #: one unit's flag readback with the next unit's compute
    PIPELINE_DEPTH = 2
    #: seconds between progress callbacks
    PROGRESS_INTERVAL_S = 5.0

    def __init__(self, spec: JobSpec, targets: Sequence[Target],
                 dispatcher: Dispatcher, worker,
                 potfile: Optional[Potfile] = None,
                 progress_cb: Optional[Callable] = None,
                 oracle=None, log: Optional[Log] = None):
        self.spec = spec
        self.targets = list(targets)
        self.dispatcher = dispatcher
        self.worker = worker
        self.potfile = potfile
        self.progress_cb = progress_cb
        #: CPU oracle HashEngine that re-hashes every device hit; None
        #: = trust the worker (the CPU path, where the worker IS the
        #: oracle)
        self.oracle = oracle
        self.log = log or Log()
        self.rejected = 0
        self.found: dict[int, bytes] = {}

    def preload_found(self) -> None:
        """Mark targets the potfile already cracked, so no keyspace is
        spent rediscovering them."""
        if self.potfile is None:
            return
        for i, t in enumerate(self.targets):
            plain = self.potfile.get(t.raw)
            if plain is not None:
                self.found.setdefault(i, plain)

    def _all_found(self) -> bool:
        return len(self.found) >= len(self.targets)

    def _record(self, hit: Hit) -> bool:
        """Record one hit; returns False (and records nothing) if the
        oracle re-hash rejects it."""
        if hit.target_index in self.found:
            return True
        target = self.targets[hit.target_index]
        if self.oracle is not None and not self.oracle.verify(hit.plaintext,
                                                              target):
            self.rejected += 1
            self.log.warn("rejected unverifiable device hit; rescanning "
                          "unit with the CPU oracle",
                          target=target.raw[:32], cand_index=hit.cand_index)
            return False
        self.found[hit.target_index] = hit.plaintext
        if self.potfile is not None:
            self.potfile.add(target.raw, hit.plaintext)
        return True

    def _finish_unit(self, unit, hits) -> None:
        """Record a unit's hits; any rejected hit means the device path
        is suspect for this range, so the whole unit is rescanned by the
        CPU oracle (whose hits verify by construction)."""
        rejected = False
        for hit in hits:
            rejected |= not self._record(hit)
        if rejected:
            rescan = CpuWorker(self.oracle, self.worker.gen, self.targets)
            for hit in rescan.process(unit):
                self._record(hit)

    def run(self) -> JobResult:
        t0 = time.perf_counter()
        tested0 = self.dispatcher.progress()[0]
        last_report = t0
        queue: list = []          # (unit, pending), oldest first
        while not self._all_found():
            while len(queue) < self.PIPELINE_DEPTH:
                unit = self.dispatcher.lease()
                if unit is None:
                    break
                queue.append((unit, self.worker.submit(unit)))
            if not queue:
                break             # keyspace covered
            unit, pending = queue.pop(0)
            hits = pending.resolve()
            if hits:
                self._finish_unit(unit, hits)
            self.dispatcher.complete(unit.unit_id)
            now = time.perf_counter()
            if self.progress_cb and \
                    now - last_report >= self.PROGRESS_INTERVAL_S:
                last_report = now
                done, total = self.dispatcher.progress()
                self.progress_cb(done, total, len(self.found),
                                 (done - tested0) / max(now - t0, 1e-9))
        elapsed = time.perf_counter() - t0
        done, _ = self.dispatcher.progress()
        return JobResult(found=dict(self.found), tested=done - tested0,
                         elapsed=elapsed,
                         exhausted=self.dispatcher.exhausted(),
                         rejected=self.rejected)
