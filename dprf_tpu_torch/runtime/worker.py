"""Workers: WorkUnit -> generate candidates -> hash -> report hits.

CudaMaskWorker is the card's path: one hand-written kernel launch per
batch (ops/cuda_mask.py), for one target or a list, queued
asynchronously on the current stream so the card never drains between
batches; a unit's hits are resolved after the whole unit is queued, and
only hit buffers cross back to the host.  On CPU tensors (``--device torch-cpu``) the same worker runs the
kernel's plain PyTorch version.

CpuWorker is the reference path (``--device cpu``): the oracle engine
over host-materialized candidates.  It also rescans a batch exactly
when a device hit buffer overflows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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
    int32[cap]) on the device, still being computed; a multi-target
    step adds n_maybe int32[1], its Bloom prefilter's survivors.
    """

    def _setup_targets(self, engine, gen, targets: Sequence[Target],
                       hit_capacity: int, oracle: Optional[HashEngine]):
        """One target: returns its uint32 digest words.  A list:
        returns the sorted ``TargetTable``; hits' table positions map
        back to the job's target index through its ``order``."""
        from dprf_tpu_torch.ops.compare import digest_rows, make_target_table

        self.engine = engine
        self.gen = gen
        self.targets = list(targets)
        self.hit_capacity = hit_capacity
        self.oracle = oracle
        #: batches this worker has dispatched (one step call each)
        self.dispatched = 0
        #: Bloom survivors summed on the device (multi-target steps)
        self._maybes = None
        self.multi = len(self.targets) > 1
        digests = [t.digest for t in self.targets]
        if self.multi:
            self.table = make_target_table(digests, engine.little_endian)
            self._order = self.table.order
            return self.table
        return digest_rows(digests, engine.little_endian)[0]

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
            if len(result) > 3:
                self._maybes = result[3] if self._maybes is None \
                    else self._maybes + result[3]
            queued.append((bstart, result))
        return PendingUnit(self, unit, queued, flag)

    def process(self, unit: WorkUnit) -> list[Hit]:
        return self.submit(unit).resolve()

    def n_maybe(self) -> Optional[int]:
        """Candidates that passed the Bloom prefilter over every batch
        so far (a multi-target job), else None.  Reads the device."""
        return None if self._maybes is None else int(self._maybes.item())

    def _decode_lanes(self, bstart: int, lanes_np, tpos_np) -> list[Hit]:
        """Hit-buffer lanes -> Hit records (lane -1 = unused slot); a
        multi-target hit's table position maps to the job's target
        index through the table's order.  The kernel appends hits in no
        fixed order, so they are sorted by lane."""
        hits = []
        for lane, tp in sorted(zip(lanes_np.tolist(), tpos_np.tolist())):
            if lane < 0:
                continue
            gidx = bstart + lane
            ti = int(self._order[tp]) if self.multi else 0
            hits.append(Hit(ti, gidx, self.gen.candidate(gidx)))
        return hits

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
        count, lanes, tpos = result[:3]
        count = int(count.item())
        if count == 0:
            return []
        if count > lanes.shape[0]:
            return self._rescan(bstart, unit)
        return self._decode_lanes(bstart, lanes.cpu().numpy(),
                                  tpos.cpu().numpy())


class CudaMaskWorker(MaskWorkerBase):
    """Mask worker over the hand-written mask kernel (ops/cuda_mask.py),
    the counterpart of the reference's PallasMaskWorker: decode, hash,
    compare and hit append happen in one launch per batch.  A list of
    targets runs the multi-target kernel, which verifies its Bloom
    survivors on the card, so only real hits come back.  On a card the
    kernel builds at construction, so a build failure raises here and
    never mid-job; with ``device="cpu"`` each batch runs the kernel's
    plain version instead."""

    def __init__(self, engine, gen, targets: Sequence[Target],
                 batch: int = 1 << 24, hit_capacity: int = 64,
                 oracle: Optional[HashEngine] = None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_mask

        tgt = self._setup_targets(engine, gen, targets, hit_capacity,
                                  oracle)
        device = torch.device(device)
        if device.type == "cuda":
            cuda_mask.load_kernel()
        self.batch = self.stride = batch
        make = cuda_mask.make_cuda_multi_crack_step if self.multi \
            else cuda_mask.make_cuda_mask_crack_step
        self.step = make(engine.name, gen, tgt, batch, hit_capacity,
                         device=device)
