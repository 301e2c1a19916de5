"""WPA2-PMKID on the card: the iterated-KDF path (benchmark config 5).

PMKID digests depend on per-target parameters (the ESSID salts the
PBKDF2, the AP/STA MACs make the PMKID message), and the PMK depends
only on (passphrase, ESSID).  So targets are grouped by ESSID and each
group is one launch series of the PMKID kernel (ops/cuda_pbkdf2.py):
per candidate the 4096-iteration PBKDF2 runs once, and each target of
the group costs one more HMAC and a 4-word compare.  A typical job has
one ESSID and a handful of targets: ~16.4 k SHA-1 compressions per
candidate.

The reference routes a job between its Pallas kernel (which recomputes
the PMK per target) and an XLA step (which shares it per ESSID); the
grouped kernel computes what both compute, so there is one path.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.engines.cpu.engines import Pmkid2Engine
from dprf_tpu_torch.ops import cuda_pbkdf2
from dprf_tpu_torch.runtime.worker import CpuWorker, Hit
from dprf_tpu_torch.runtime.workunit import WorkUnit

#: candidates per launch.  A candidate at 4096 iterations is 16,390
#: SHA-1 compressions; the kernel runs 1.99 M candidates/s on an H100
#: 80GB HBM3 at 700 W (chip_smoke.py, PERF.md), so a launch of 2^19
#: takes 0.26 s: long enough that the host's work per launch is noise,
#: short enough for prompt progress and hits.  (The reference caps its
#: TPU batch at 2^15.)
BATCH = 1 << 19


@register("wpa2-pmkid", device="cuda")
@register("pmkid", device="cuda")
class TorchPmkidEngine(Pmkid2Engine):
    """The device PMKID engine: the oracle's target parsing (hashcat
    16800 lines), ``hash_batch`` and ``iterations`` (one definition, so
    the oracle and the kernel cannot diverge), plus the kernel's mask
    worker.  torch_device: "cuda" (the default) or "cpu", where the
    worker runs the kernel's plain version."""

    def __init__(self, torch_device="cuda"):
        self.torch_device = torch.device(torch_device)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The PMKID kernel's worker; a job the kernel does not take is
        refused, never moved to another path."""
        lens = [len(t.params["essid"]) for t in targets]
        if not cuda_pbkdf2.pmkid_kernel_eligible(gen, lens):
            raise ValueError(
                f"{self.name}: no PMKID kernel for this job (it takes masks "
                f"of 1..{cuda_pbkdf2.MAX_LENGTH} positions and ESSIDs of "
                f"1..{cuda_pbkdf2.MAX_ESSID} bytes); use --device cpu")
        return CudaPmkidWorker(self, gen, targets, batch=min(batch, BATCH),
                               hit_capacity=hit_capacity, oracle=oracle,
                               device=self.torch_device)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        raise ValueError(f"{self.name}: the PMKID kernel takes mask jobs "
                         "only; use --device cpu for a wordlist")


def _group_targets(targets: Sequence[Target]) -> dict:
    """ESSID -> the indices of its targets, in job order."""
    by_essid: dict[bytes, list[int]] = {}
    for i, t in enumerate(targets):
        by_essid.setdefault(t.params["essid"], []).append(i)
    return by_essid


class _PendingPmkid:
    """A unit whose launches are all queued: per ESSID group, the
    batches' results and the group's hit count summed on the device, so
    resolving a unit without hits reads one scalar per group."""

    __slots__ = ("worker", "unit", "groups")

    def __init__(self, worker, unit, groups):
        self.worker = worker
        self.unit = unit
        self.groups = groups

    def resolve(self) -> list[Hit]:
        hits: list[Hit] = []
        for tidx, queued, flag in self.groups:
            if flag is None or int(flag.item()) == 0:
                continue
            for bstart, result in queued:
                hits.extend(self.worker._batch_hits(bstart, result, tidx,
                                                    self.unit))
        return sorted(hits, key=lambda h: (h.cand_index, h.target_index))


class CudaPmkidWorker:
    """Mask worker over the PMKID kernel: one launch per (ESSID group,
    batch), queued asynchronously; every (lane, target) hit decodes to
    a Hit, so a lane that matches two targets gives two hits.  On a card
    the kernel builds at construction, so a build failure raises here;
    with ``device="cpu"`` each batch runs the kernel's plain version."""

    def __init__(self, engine, gen, targets: Sequence[Target],
                 batch: int = BATCH, hit_capacity: int = 64, oracle=None,
                 device="cuda"):
        self.engine = engine
        self.gen = gen
        self.targets = list(targets)
        self.hit_capacity = hit_capacity
        self.oracle = oracle
        self.batch = self.stride = batch
        #: launches this worker has queued
        self.dispatched = 0
        device = torch.device(device)
        if device.type == "cuda":
            cuda_pbkdf2.load_kernel()
        self.groups = [
            (tidx, cuda_pbkdf2.make_pmkid_step(
                gen, essid, [self.targets[i] for i in tidx],
                engine.iterations, batch, hit_capacity, device=device))
            for essid, tidx in _group_targets(self.targets).items()]

    def submit(self, unit: WorkUnit) -> _PendingPmkid:
        groups = []
        for tidx, step in self.groups:
            queued, flag = [], None
            for bstart in range(unit.start, unit.end, self.stride):
                n_valid = min(self.stride, unit.end - bstart)
                result = step(self.gen.digits(bstart), n_valid)
                self.dispatched += 1
                flag = result[0] if flag is None else flag + result[0]
                queued.append((bstart, result))
            groups.append((tidx, queued, flag))
        return _PendingPmkid(self, unit, groups)

    def process(self, unit: WorkUnit) -> list[Hit]:
        return self.submit(unit).resolve()

    def _batch_hits(self, bstart: int, result, tidx: list,
                    unit: WorkUnit) -> list[Hit]:
        count, lanes, ts = result
        count = int(count.item())
        if count == 0:
            return []
        if count > lanes.shape[0]:
            return self._rescan(bstart, tidx, unit)
        return [Hit(tidx[t], bstart + lane, self.gen.candidate(bstart + lane))
                for lane, t in zip(lanes.tolist(), ts.tolist()) if lane >= 0]

    def _rescan(self, bstart: int, tidx: list, unit: WorkUnit) -> list[Hit]:
        """Exact oracle rescan of one overflowed batch of one group."""
        if self.oracle is None:
            raise RuntimeError(
                f"hit buffer overflow (> {self.hit_capacity}) and no "
                "oracle engine to rescan with; raise hit_capacity")
        end = min(bstart + self.stride, unit.end)
        hits = CpuWorker(self.oracle, self.gen,
                         [self.targets[i] for i in tidx]).process(
            WorkUnit(-1, bstart, end - bstart))
        return [Hit(tidx[h.target_index], h.cand_index, h.plaintext)
                for h in hits]
