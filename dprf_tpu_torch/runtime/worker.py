"""Workers: WorkUnit -> generate candidates -> hash -> report hits.

CudaMaskWorker is the card's path: one hand-written kernel launch per
batch (ops/cuda_mask.py), queued asynchronously on the current stream
so the card never drains between batches; a unit's hits are resolved
after the whole unit is queued, and only hit buffers cross back to the
host.  On CPU tensors (``--device torch-cpu``) the same worker runs the
kernel's plain PyTorch version.

CpuWorker is the reference path (``--device cpu``): the oracle engine
over host-materialized candidates.  It also rescans a batch exactly
when a device hit buffer overflows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from dprf_tpu_torch.engines.base import HashEngine, Target
from dprf_tpu_torch.generators.base import CandidateGenerator
from dprf_tpu_torch.runtime.workunit import WorkUnit


@dataclasses.dataclass(frozen=True)
class Hit:
    target_index: int      # position in the job's target list
    cand_index: int        # global keyspace index
    plaintext: bytes


class PendingUnit:
    """A WorkUnit whose device work is fully enqueued but not yet
    resolved.  ``flag`` is the unit's hit count summed on the device
    across its batches, so ``resolve()`` costs one scalar readback for a
    unit without hits and fetches the batches' hit buffers only when it
    is nonzero.  Holding a PendingUnit while submitting the next unit
    overlaps that readback with the next unit's compute."""

    __slots__ = ("worker", "unit", "queued", "flag")

    def __init__(self, worker, unit, queued, flag):
        self.worker = worker
        self.unit = unit
        self.queued = queued
        self.flag = flag

    def resolve(self) -> list["Hit"]:
        if self.flag is None or int(self.flag.item()) == 0:
            return []
        hits: list[Hit] = []
        for start, result in self.queued:
            hits.extend(self.worker._batch_hits(start, result, self.unit))
        return hits


class CpuWorker:
    """Oracle-engine worker (unsalted engines)."""

    #: candidates hashed per oracle call
    CHUNK = 2048

    def __init__(self, engine: HashEngine, gen: CandidateGenerator,
                 targets: Sequence[Target]):
        self.engine = engine
        self.gen = gen
        self.targets = list(targets)
        self._digest_map = {t.digest: i for i, t in enumerate(self.targets)}

    def process(self, unit: WorkUnit) -> list[Hit]:
        hits: list[Hit] = []
        for start in range(unit.start, unit.end, self.CHUNK):
            n = min(self.CHUNK, unit.end - start)
            cands = self.gen.candidates(start, n)
            for j, d in enumerate(self.engine.hash_batch(cands)):
                ti = self._digest_map.get(d)
                if ti is not None:
                    hits.append(Hit(ti, start + j, cands[j]))
        return hits

    def submit(self, unit: WorkUnit) -> "_ResolvedUnit":
        """Host loop, no device stream to overlap: runs now."""
        return _ResolvedUnit(self.process(unit))


class _ResolvedUnit:
    __slots__ = ("hits",)

    def __init__(self, hits):
        self.hits = hits

    def resolve(self):
        return self.hits


class MaskWorkerBase:
    """Shared machinery of the fused-step mask workers.

    Subclasses call ``_setup_targets`` and then set ``self.step`` and
    ``self.stride`` (keyspace indices per step call).  A step takes
    (base digits of the batch's first candidate as a host list,
    n_valid) and returns (count int32[1], lanes int32[cap], tpos
    int32[cap]) on the device, still being computed.
    """

    def _setup_targets(self, engine, gen, targets: Sequence[Target],
                       hit_capacity: int,
                       oracle: Optional[HashEngine]) -> np.ndarray:
        """Single target: returns its uint32 digest words."""
        self.engine = engine
        self.gen = gen
        self.targets = list(targets)
        self.hit_capacity = hit_capacity
        self.oracle = oracle
        #: batches this worker has dispatched (one step call each)
        self.dispatched = 0
        if len(self.targets) != 1:
            raise ValueError(
                f"the torch mask workers take one target, got "
                f"{len(self.targets)}; use --device cpu for a list")
        dt = "<u4" if engine.little_endian else ">u4"
        return np.frombuffer(self.targets[0].digest,
                             dtype=dt).astype(np.uint32)

    def submit(self, unit: WorkUnit) -> PendingUnit:
        """Enqueue every batch of the unit and return a PendingUnit.
        The unit's hit flag is summed on the device, so a unit without
        hits costs exactly one scalar readback."""
        queued = []
        flag = None
        for bstart in range(unit.start, unit.end, self.stride):
            n_valid = min(self.stride, unit.end - bstart)
            result = self.step(self.gen.digits(bstart), n_valid)
            self.dispatched += 1
            flag = result[0] if flag is None else flag + result[0]
            queued.append((bstart, result))
        return PendingUnit(self, unit, queued, flag)

    def process(self, unit: WorkUnit) -> list[Hit]:
        return self.submit(unit).resolve()

    def _decode_lanes(self, bstart: int, lanes_np) -> list[Hit]:
        """Hit-buffer lanes -> Hit records (lane -1 = unused slot); the
        kernel appends hits in no fixed order, so they are sorted."""
        gidxs = [bstart + int(lane) for lane in sorted(lanes_np) if lane >= 0]
        return [Hit(0, g, self.gen.candidate(g)) for g in gidxs]

    def _rescan(self, bstart: int, unit: WorkUnit) -> list[Hit]:
        """Exact host rescan of one overflowed batch (more hits than the
        device hit buffer holds)."""
        if self.oracle is None:
            raise RuntimeError(
                f"hit buffer overflow (> {self.hit_capacity}) and no "
                "oracle engine to rescan with; raise hit_capacity")
        end = min(bstart + self.stride, unit.end)
        sub = WorkUnit(-1, bstart, end - bstart)
        return CpuWorker(self.oracle, self.gen, self.targets).process(sub)

    def _batch_hits(self, bstart: int, result, unit: WorkUnit) -> list[Hit]:
        count, lanes, _ = result
        count = int(count.item())
        if count == 0:
            return []
        if count > lanes.shape[0]:
            return self._rescan(bstart, unit)
        return self._decode_lanes(bstart, lanes.cpu().numpy())


class CudaMaskWorker(MaskWorkerBase):
    """Mask worker over the hand-written md5 mask kernel
    (ops/cuda_mask.py), the counterpart of the reference's
    PallasMaskWorker: decode, hash, compare and hit append happen in one
    launch per batch.  On a card the kernel builds at construction, so a
    build failure raises here and never mid-job; with ``device="cpu"``
    each batch runs the kernel's plain version instead."""

    def __init__(self, engine, gen, targets: Sequence[Target],
                 batch: int = 1 << 24, hit_capacity: int = 64,
                 oracle: Optional[HashEngine] = None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_mask

        words = self._setup_targets(engine, gen, targets, hit_capacity,
                                    oracle)
        device = torch.device(device)
        if device.type == "cuda":
            cuda_mask.load_kernel()
        self.batch = self.stride = batch
        self.step = cuda_mask.make_cuda_mask_crack_step(
            gen, words, batch, hit_capacity, device=device)
