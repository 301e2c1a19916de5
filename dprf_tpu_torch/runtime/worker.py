"""Workers: WorkUnit -> generate candidates -> hash -> report hits.

CudaMaskWorker is the card's mask path: one hand-written kernel launch
per batch (ops/cuda_mask.py), for one target or a list of any length
(past ``cuda_mask.N_BULK`` targets the bulk probe over a probe table,
targets/probe.py), queued asynchronously on the current stream so the
card never drains between batches; a core's unit goes out as
loop-superstep windows (ops/superstep.py), whose launches share one set
of hit buffers.  A unit's hits are resolved after the whole unit is
queued, and only hit buffers cross back to the host.
CudaWordlistWorker is the wordlist+rules path, one rule-kernel launch
per word window (ops/cuda_rules.py), for one target or a list.
GroupedSweepWorker sweeps a mask once per group of targets that each
reshape the work (salts, tickets, ESSIDs), GroupedWordlistWorker a
wordlist the same way through the rules kernel's group tails.  On CPU
tensors (``--device torch-cpu``) they run their kernel's plain PyTorch
version.

A dispatch whose hits overflow its hit buffer is relaunched once on the
card with a buffer of exactly its count; only a relaunch that cannot
hold them either goes to the exact oracle rescan.  A survivor of a bulk
list's host-verify layout (table position -1) is confirmed by one
oracle hash, and a false one is dropped here (``rejected_survivors``).

CpuWorker is the reference path (``--device cpu``): the oracle engine
over host-materialized candidates.  It also rescans a batch exactly
when a relaunch cannot hold its hits.
"""

from __future__ import annotations

import dataclasses
import time
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
    resolved.  ``queued`` holds (start, result) per dispatch, decoded by
    the worker's ``_batch_hits``.  ``flag`` is the unit's hit count
    summed on the device across its dispatches, so ``resolve()`` costs
    one scalar readback for a unit without hits and fetches the hit
    buffers only when it is nonzero.  Holding a PendingUnit while
    submitting the next unit overlaps that readback with the next
    unit's compute."""

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


def word_cover_range(unit: WorkUnit, n_rules: int) -> tuple:
    """Covering word range [w_start, w_end) of a keyspace-index unit
    (index = word * n_rules + rule; ceil on the end)."""
    return unit.start // n_rules, -(-unit.end // n_rules)


def wordlist_lane_to_gidx(lane: int, ws: int, word_batch: int,
                          n_rules: int) -> int:
    """Rule-major step lane (r * word_batch + b) -> global keyspace index
    for a step whose word window starts at ws."""
    r, b = divmod(lane, word_batch)
    return (ws + b) * n_rules + r


class CpuWorker:
    """Oracle-engine worker; a salted engine (bcrypt, wpa2-pmkid) hashes
    every candidate once per target, with that target's params."""

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
            # a rule that rejects leaves a hole (None): never hashed
            pairs = [(start + j, c)
                     for j, c in enumerate(self.gen.candidates(start, n))
                     if c is not None]
            cands = [c for _, c in pairs]
            if self.engine.salted:
                for ti, t in enumerate(self.targets):
                    digests = self.engine.hash_batch(cands, params=t.params)
                    hits.extend(Hit(ti, gidx, cand) for (gidx, cand), d
                                in zip(pairs, digests) if d == t.digest)
                continue
            digests = self.engine.hash_batch(cands)
            for (gidx, cand), d in zip(pairs, digests):
                ti = self._digest_map.get(d)
                if ti is not None:
                    hits.append(Hit(ti, gidx, cand))
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

    A worker with a window (``window_batches`` above 1) sends a unit
    out as windows of up to that many batches through ``_window``, each
    with one set of hit buffers, its last batch partial; the others one
    step per batch.  A dispatch is queued as ((first index, span),
    result).  A dispatch that overflows its hit buffers is relaunched
    with a buffer of its count (``_relaunch``).  A window that fails to
    launch raises: there is no fallback to per-batch dispatch.
    """

    #: most batches of one window (the int32 lane budget applies on top)
    SUPER_CAP = 256
    #: batches of one dispatch; a worker with a window raises it
    window_batches = 1

    def _setup_targets(self, engine, gen, targets: Sequence[Target],
                       hit_capacity: int, oracle: Optional[HashEngine],
                       device=None, bulk: bool = False):
        """One target: returns its uint32 digest words.  A list:
        returns the sorted ``TargetTable``; hits' table positions map
        back to the job's target index through its ``order``.  With
        ``bulk`` (a one-card kernel worker), a list of more than
        ``cuda_mask.N_BULK`` targets returns its ``probe.ProbeTable``,
        sized for ``device``'s free memory; its host-verify layout needs
        the oracle."""
        from dprf_tpu_torch.ops.compare import digest_rows, make_target_table

        self.engine = engine
        self.gen = gen
        self.targets = list(targets)
        self.hit_capacity = hit_capacity
        self.oracle = oracle
        #: batches this worker has dispatched (one step call each, a
        #: window's launches included), and its windows
        self.dispatched = 0
        self.windows = 0
        #: overflowing dispatches relaunched on the card, and batches
        #: the oracle rescanned because a relaunch could not hold them
        self.relaunches = 0
        self.rescans = 0
        #: host-verify survivors the oracle rejected
        self.rejected_survivors = 0
        #: a bulk list's probe table (else None) and its build seconds
        self.probe_table = None
        self.table_seconds = 0.0
        #: prefilter survivors summed on the device (multi-target steps)
        self._maybes = None
        self.multi = len(self.targets) > 1
        digests = [t.digest for t in self.targets]
        if self.multi and bulk and self._bulk_list():
            from dprf_tpu_torch.targets import probe
            t0 = time.perf_counter()
            pt = probe.build_probe_table(digests, engine.little_endian,
                                         device=device)
            self.table_seconds = time.perf_counter() - t0
            if pt.mode == probe.MODE_HOST_VERIFY:
                if oracle is None:
                    raise ValueError(
                        f"{len(digests)} targets: the probe table's "
                        "host-verify layout needs an oracle engine")
                self._digest_map = {t.digest: i
                                    for i, t in enumerate(self.targets)}
            self.probe_table = pt
            self._order = pt.order
            return pt
        if self.multi:
            self.table = make_target_table(digests, engine.little_endian)
            self._order = self.table.order
            return self.table
        return digest_rows(digests, engine.little_endian)[0]

    def _bulk_list(self) -> bool:
        """A list past ``cuda_mask.N_BULK`` targets: the bulk probe,
        which needs unsalted digests of at least two whole words."""
        from dprf_tpu_torch.ops.cuda_mask import N_BULK
        from dprf_tpu_torch.targets import probe
        if len(self.targets) <= N_BULK:
            return False
        if not probe.probe_eligible(self.targets, self.engine):
            raise ValueError(
                f"{self.engine.name}: {len(self.targets)} targets need the "
                "bulk probe, which takes unsalted digests of at least 8 "
                "bytes")
        return True

    def _window(self, base_digits, n_valid: int):
        """One dispatch over the lanes [0, n_valid) from
        ``base_digits``: the step, for a worker without a window."""
        return self.step(base_digits, n_valid)

    def _queue(self, queued: list, start, result, flag, batches: int = 1):
        """Record one dispatch of ``batches`` batches; returns the
        unit's flag with its count added on the device."""
        self.dispatched += batches
        queued.append((start, result))
        if self.multi:
            maybes = self._maybes_of(result)
            self._maybes = maybes if self._maybes is None \
                else self._maybes + maybes
        return result[0] if flag is None else flag + result[0]

    def _maybes_of(self, result):
        """A list's step result -> its prefilter survivors, int32[1]."""
        return result[3]

    def submit(self, unit: WorkUnit) -> PendingUnit:
        """Enqueue the unit as dispatches of up to ``window_batches``
        batches and return a PendingUnit.  The unit's hit flag is
        summed on the device, so a unit without hits costs exactly one
        scalar readback."""
        queued = []
        flag = None
        span = self.window_batches * self.stride
        for pos in range(unit.start, unit.end, span):
            n_valid = min(span, unit.end - pos)
            flag = self._queue(queued, (pos, n_valid),
                               self._window(self.gen.digits(pos), n_valid),
                               flag, -(-n_valid // self.stride))
        return PendingUnit(self, unit, queued, flag)

    def process(self, unit: WorkUnit) -> list[Hit]:
        return self.submit(unit).resolve()

    def n_maybe(self) -> Optional[int]:
        """Candidates that passed the Bloom prefilter over every batch
        so far (a multi-target job), else None.  Reads the device."""
        return None if self._maybes is None else int(self._maybes.item())

    def _hit(self, gidx: int, tp: int) -> list[Hit]:
        """The Hit of a reported lane at keyspace index ``gidx`` and table
        position ``tp``: a list's position maps to the job's target
        index through the table's order; -1, a survivor of the
        host-verify layout, is confirmed by one oracle hash, and a false
        one dropped (counted in ``rejected_survivors``)."""
        plain = self.gen.candidate(gidx)
        if not self.multi:
            return [Hit(0, gidx, plain)]
        if tp >= 0:
            return [Hit(int(self._order[tp]), gidx, plain)]
        ti = self._digest_map.get(self.oracle.hash_batch([plain])[0])
        if ti is None:
            self.rejected_survivors += 1
            return []
        return [Hit(ti, gidx, plain)]

    def _decode_lanes(self, bstart: int, lanes_np, tpos_np) -> list[Hit]:
        """Hit-buffer lanes -> Hit records (lane -1 = unused slot),
        through ``_hit``.  The kernel appends hits in no fixed order, so
        they are sorted by lane."""
        hits = []
        for lane, tp in sorted(zip(lanes_np.tolist(), tpos_np.tolist())):
            if lane >= 0:
                hits.extend(self._hit(bstart + lane, tp))
        return hits

    def _rescan(self, bstart: int, unit: WorkUnit,
                span: Optional[int] = None) -> list[Hit]:
        """Exact host rescan of one overflowed dispatch (a batch, or
        ``span`` indices) whose relaunch could not hold its hits."""
        if self.oracle is None:
            raise RuntimeError(
                f"hit buffer overflow (> {self.hit_capacity}) and no "
                "oracle engine to rescan with; raise hit_capacity")
        self.rescans += 1
        end = min(bstart + (span or self.stride), unit.end)
        sub = WorkUnit(-1, bstart, end - bstart)
        return CpuWorker(self.oracle, self.gen, self.targets).process(sub)

    def _relaunch(self, bstart: int, span: int, capacity: int):
        """The dispatch over [bstart, bstart + span) once more on the
        card, into fresh hit buffers of ``capacity`` hits: through the
        loop superstep for a worker with a window, else one step call
        with that capacity.  Returns its result, still being computed."""
        self.relaunches += 1
        self.dispatched += -(-span // self.stride)
        digits = self.gen.digits(bstart)
        if self.window_batches == 1:
            return self.step(digits, span, cap=capacity)
        from dprf_tpu_torch.ops.cuda_mask import hit_buffers
        from dprf_tpu_torch.ops.superstep import loop_super_step
        return loop_super_step(self.step, self.batch, digits, span,
                               hit_buffers(self.multi, capacity,
                                           self.device))

    def _batch_hits(self, window, result, unit: WorkUnit) -> list[Hit]:
        """One dispatch over ``window`` = (first index, span) -> Hit
        records; an overflowed dispatch is relaunched with a buffer of
        its count, and rescanned by the oracle only if that relaunch
        overflows too."""
        bstart, span = window
        count, lanes, tpos = result[:3]
        count = int(count.item())
        if count == 0:
            return []
        if count > lanes.shape[0]:
            count, lanes, tpos = self._relaunch(bstart, span, count)[:3]
            if int(count.item()) > lanes.shape[0]:
                return self._rescan(bstart, unit, span)
        return self._decode_lanes(bstart, lanes.cpu().numpy(),
                                  tpos.cpu().numpy())

    def _redrive(self, bstart: int, span: int, unit: WorkUnit) -> list[Hit]:
        """An overflowed window runs again batch by batch through the
        device step, so an exact rescan, if one is needed, covers one
        batch, not the window."""
        hits: list[Hit] = []
        end = min(bstart + span, unit.end)
        for bs in range(bstart, end, self.stride):
            nv = min(self.stride, end - bs)
            self.dispatched += 1
            hits.extend(self._batch_hits(
                (bs, nv), self.step(self.gen.digits(bs), nv), unit))
        return hits


class CudaMaskWorker(MaskWorkerBase):
    """Mask worker over the hand-written mask kernel (ops/cuda_mask.py),
    the counterpart of the reference's PallasMaskWorker: decode, hash,
    compare and hit append happen in one launch per batch.  A list of
    targets runs the multi-target kernel, which verifies its Bloom
    survivors on the card, so only real hits come back.  On a card the
    kernel builds at construction, so a build failure raises here and
    never mid-job; with ``device="cpu"`` each batch runs the kernel's
    plain version instead.  A nested chain or mysql41 (ops/cuda_ext.py)
    and a sha3/keccak sponge (ops/cuda_keccak.py) run their
    instantiations of the same kernel body, with the same steps'
    contract, so hit decode, table order and rescan are these."""

    def __init__(self, engine, gen, targets: Sequence[Target],
                 batch: int = 1 << 24, hit_capacity: int = 64,
                 oracle: Optional[HashEngine] = None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_ext, cuda_keccak, cuda_mask

        device = torch.device(device)
        kernels = cuda_ext if engine.name in cuda_ext.NESTED_NAMES \
            else cuda_keccak if engine.name in cuda_keccak.NAMES \
            else cuda_mask
        tgt = self._setup_targets(engine, gen, targets, hit_capacity,
                                  oracle, device,
                                  bulk=kernels is cuda_mask)
        if device.type == "cuda":
            kernels.load_kernel()
        self.batch = self.stride = batch
        self.device = device
        make = kernels.make_cuda_multi_crack_step if self.multi \
            else kernels.make_cuda_mask_crack_step
        self.step = make(engine.name, gen, tgt, batch, hit_capacity,
                         device=device)
        if engine.core in cuda_mask.KERNEL_CORES:
            from dprf_tpu_torch.ops.superstep import max_inner
            self.window_batches = max_inner(batch, self.SUPER_CAP)

    def _window(self, base_digits, n_valid: int):
        """A core's window: its launches of the per-batch step (it takes
        the window offset and appends to the window's buffers) into
        buffers of the reference's window capacity, the hit capacity
        times the launches, at most 1,024 and never below the hit
        capacity.  The nested and Keccak instantiations have no window
        (``window_batches`` 1) and keep one step a batch, as in the
        reference."""
        if self.window_batches == 1:
            return self.step(base_digits, n_valid)
        from dprf_tpu_torch.ops.cuda_mask import hit_buffers
        from dprf_tpu_torch.ops.superstep import loop_super_step
        launches = -(-n_valid // self.batch)
        cap = max(self.hit_capacity, min(self.hit_capacity * launches, 1024))
        self.windows += 1
        return loop_super_step(self.step, self.batch, base_digits, n_valid,
                               hit_buffers(self.multi, cap, self.device))


class PendingSweep:
    """A unit of a grouped sweep whose launches are all queued: per
    group, its batches' results and its hit count summed on the device,
    and the sum over them, so resolving a unit without hits reads one
    scalar."""

    __slots__ = ("worker", "unit", "batches", "results", "flags")

    def __init__(self, worker, unit, batches, results, flags):
        self.worker = worker
        self.unit = unit
        self.batches = batches
        self.results = results
        self.flags = flags

    def resolve(self) -> list[Hit]:
        if not self.flags:
            return []
        flags = torch.cat(self.flags)
        if int(flags.sum().item()) == 0:
            return []
        hits: list[Hit] = []
        for gi in torch.nonzero(flags).flatten().tolist():
            for (bstart, _), result in zip(self.batches, self.results[gi]):
                hits.extend(self.worker._batch_hits(gi, bstart, result,
                                                    self.unit))
        return sorted(hits, key=lambda h: (h.cand_index, h.target_index))


def singleton_groups(steps: Sequence) -> list:
    """Per-target steps (one a target, in job order) as
    ``GroupedSweepWorker.groups``: each target a group of one."""
    return [([ti], step) for ti, step in enumerate(steps)]


class GroupedSweepWorker:
    """A mask sweep once per group of targets, for engines whose targets
    each reshape the work (a salt, a ticket, an ESSID, an entry): every
    batch of a unit once per group, one step call each, queued
    asynchronously, the unit's hit count summed on the device over every
    launch.  A hit is a (lane, target position) pair whose
    ``target_index`` is the target's position in the job; a batch whose
    hits overflow the hit buffer is rescanned exactly by the oracle for
    the targets whose own count (``tcount``) its recorded hits do not
    cover, and only for those.  A target that shares no work with
    another is a group of one (``singleton_groups``).  The counterpart
    of the reference's per-target sweep (PerTargetSweepSetup), with the
    same hits.

    Subclasses set ``self.groups``: (the group's target indices in the
    job, step(base digits, n_valid) -> (count int32[1], lanes int32[cap],
    tpos int32[cap], tcount int32[T]) on the device, still being
    computed).  A group of one may give None for tpos; a step without
    tcount (a 3-tuple) has every target of its group rescanned when its
    batch overflows.  With ``confirm`` set, every reported lane is a
    *maybe* of a prefilter: the oracle verifies it before it becomes a
    Hit, and ``n_maybe()`` counts the ones it rejected."""

    #: the step's lanes are prefilter maybes the oracle confirms
    confirm = False

    def __init__(self, engine, gen, targets: Sequence[Target], batch: int,
                 hit_capacity: int, oracle: Optional[HashEngine]):
        self.engine = engine
        self.gen = gen
        self.targets = list(targets)
        self.hit_capacity = hit_capacity
        self.oracle = oracle
        self.batch = self.stride = batch
        #: step calls this worker has queued
        self.dispatched = 0
        #: reported lanes the oracle rejected
        self.rejected_maybes = 0
        #: overflowing dispatches relaunched on the card (a wordlist
        #: sweep's), and the oracle rescans of what a buffer missed
        self.relaunches = 0
        self.rescans = 0
        if self.confirm and oracle is None:
            raise ValueError("a prefilter's maybes need an oracle engine")

    def _windows(self, unit: WorkUnit) -> list:
        """A unit's dispatches, each (its first index, its step's
        arguments): the mask's batches, (base digits, n_valid)."""
        return [(b, (self.gen.digits(b), min(self.stride, unit.end - b)))
                for b in range(unit.start, unit.end, self.stride)]

    def _index(self, start: int, lane: int) -> int:
        """The keyspace index of a dispatch's hit lane."""
        return start + lane

    def _span(self, start: int, unit: WorkUnit) -> tuple:
        """The keyspace indices [a, b) of a dispatch within its unit."""
        return start, min(start + self.stride, unit.end)

    def submit(self, unit: WorkUnit) -> PendingSweep:
        batches = self._windows(unit)
        results, flags = [], []
        for _, step in self.groups:
            out = [step(*args) for _, args in batches]
            self.dispatched += len(out)
            results.append(out)
            if out:
                flags.append(sum(r[0] for r in out))
        return PendingSweep(self, unit, batches, results, flags)

    def process(self, unit: WorkUnit) -> list[Hit]:
        return self.submit(unit).resolve()

    def n_maybe(self) -> Optional[int]:
        """Maybes the oracle rejected so far (a prefilter's worker),
        else None."""
        return self.rejected_maybes if self.confirm else None

    def _batch_hits(self, gi: int, bstart: int, result,
                    unit: WorkUnit) -> list[Hit]:
        count, lanes, tpos = result[:3]
        count = int(count.item())
        if count == 0:
            return []
        tidx = self.groups[gi][0]
        n = min(count, lanes.shape[0])
        at = tpos[:n].tolist() if tpos is not None else [0] * n
        pairs = sorted((lane, t) for lane, t in zip(lanes[:n].tolist(), at)
                       if lane >= 0)
        overflow = set()
        if count > len(pairs):
            if len(result) < 4:
                overflow = set(range(len(tidx)))
            else:
                recorded = [0] * len(tidx)
                for _, t in pairs:
                    recorded[t] += 1
                overflow = {t for t, k in enumerate(result[3].tolist())
                            if k > recorded[t]}
        hits = []
        verdicts = {}   # the oracle's, once per (candidate, target)
        for lane, t in pairs:
            gidx = self._index(bstart, lane)
            if t in overflow or not unit.start <= gidx < unit.end:
                continue
            plain = self.gen.candidate(gidx)
            if self.confirm:
                if (plain, t) not in verdicts:
                    verdicts[plain, t] = self.oracle.verify(
                        plain, self.targets[tidx[t]])
                if not verdicts[plain, t]:
                    self.rejected_maybes += 1
                    continue
            hits.append(Hit(tidx[t], gidx, plain))
        if overflow:
            hits.extend(self._rescan([tidx[t] for t in sorted(overflow)],
                                     bstart, unit))
        return hits

    def _rescan(self, tis: list, bstart: int, unit: WorkUnit) -> list[Hit]:
        """Exact oracle rescan of one overflowed dispatch for the job's
        targets ``tis``, and no other."""
        if self.oracle is None:
            raise RuntimeError(
                f"hit buffer overflow (> {self.hit_capacity}) and no "
                "oracle engine to rescan with; raise hit_capacity")
        self.rescans += 1
        start, end = self._span(bstart, unit)
        hits = CpuWorker(self.oracle, self.gen,
                         [self.targets[i] for i in tis]).process(
            WorkUnit(-1, start, end - start))
        return [Hit(tis[h.target_index], h.cand_index, h.plaintext)
                for h in hits]


class GroupedWordlistWorker(GroupedSweepWorker):
    """The grouped sweep over a wordlist under its rules: the
    counterpart of the reference's per-target wordlist sweep
    (SaltedWordlistWorker, PhpassWordlistWorker.process).  A unit runs
    as windows of ``word_batch`` words of its covering word range
    (``word_cover_range``), one launch of the rules kernel's group tail
    per (group, window), its lanes rule-major (r * word_batch + b,
    ``wordlist_lane_to_gidx``); a hit outside the unit is dropped.  An
    overflowing (group, window) is relaunched once on the card with a
    buffer of its count (``relaunch_cap`` hits at most); only what that
    cannot hold is rescanned by the oracle, over the unit's part of the
    window, for the targets whose own count its recorded hits miss.

    Subclasses set ``self.groups`` as GroupedSweepWorker's, each step
    taking (ws, n_valid_words) and ``cap=`` a call's hit capacity."""

    #: most hits a relaunch's buffers take (8 bytes a hit); a window
    #: with more goes to the oracle rescan as it is
    relaunch_cap = 1 << 24

    def __init__(self, engine, gen, targets: Sequence[Target], batch: int,
                 hit_capacity: int, oracle: Optional[HashEngine]):
        from dprf_tpu_torch.ops.cuda_rules import WARP
        super().__init__(engine, gen, targets, batch, hit_capacity, oracle)
        #: words per launch: batch candidates over the rules, a multiple
        #: of a warp so each warp of a launch shares one rule
        self.word_batch = max(WARP, batch // gen.n_rules // WARP * WARP)
        self.stride = self.word_batch * gen.n_rules

    def _windows(self, unit: WorkUnit) -> list:
        w_start, w_end = word_cover_range(unit, self.gen.n_rules)
        w_end = min(w_end, self.gen.n_words)
        return [(ws, (ws, min(self.word_batch, w_end - ws)))
                for ws in range(w_start, w_end, self.word_batch)]

    def _index(self, ws: int, lane: int) -> int:
        return wordlist_lane_to_gidx(lane, ws, self.word_batch,
                                     self.gen.n_rules)

    def _span(self, ws: int, unit: WorkUnit) -> tuple:
        R = self.gen.n_rules
        return (max(unit.start, ws * R),
                min(unit.end, (ws + self.word_batch) * R))

    def _batch_hits(self, gi: int, ws: int, result,
                    unit: WorkUnit) -> list[Hit]:
        """A (group, window)'s hits; an overflowing one is first
        relaunched on the card into buffers of its count."""
        count = int(result[0].item())
        if result[1].shape[0] < count <= self.relaunch_cap:
            self.relaunches += 1
            self.dispatched += 1
            w_end = min(word_cover_range(unit, self.gen.n_rules)[1],
                        self.gen.n_words)
            result = self.groups[gi][1](
                ws, min(self.word_batch, w_end - ws), cap=count)
        return super()._batch_hits(gi, ws, result, unit)


class WordlistWorkerBase(MaskWorkerBase):
    """Wordlist hit decoding and rescan.  Subclasses set
    ``self.word_batch`` (words per step, the lanes' stride between
    rules) and queue ``((ws, n_words), result)`` per step."""

    def _collect_word_hits(self, lanes_np, tpos_np, ws: int,
                           unit: WorkUnit) -> list[Hit]:
        """Rule-major step lanes (and a list's table positions) -> the
        unit's Hit records, by keyspace index, through ``_hit``; a hit
        outside the unit (a word window covers whole words, a unit need
        not) is dropped."""
        R = self.gen.n_rules
        hits: list[Hit] = []
        for gidx, tp in sorted(
                (wordlist_lane_to_gidx(int(lane), ws, self.word_batch, R),
                 int(tp)) for lane, tp in zip(lanes_np, tpos_np)
                if lane >= 0):
            if unit.start <= gidx < unit.end:
                hits.extend(self._hit(gidx, tp))
        return hits

    def _rescan_words(self, ws: int, nw: int, unit: WorkUnit) -> list[Hit]:
        """Exact oracle rescan of one overflowed word window, in
        keyspace-index coordinates clipped to the unit."""
        if self.oracle is None:
            raise RuntimeError(
                f"hit buffer overflow (> {self.hit_capacity}) and no "
                "oracle engine to rescan with; raise hit_capacity")
        self.rescans += 1
        R = self.gen.n_rules
        start = max(unit.start, ws * R)
        end = min(unit.end, (ws + nw) * R)
        sub = WorkUnit(-1, start, end - start)
        return CpuWorker(self.oracle, self.gen, self.targets).process(sub)

    def _batch_hits(self, window, result, unit: WorkUnit) -> list[Hit]:
        """One word window's hits; an overflowed window is relaunched
        on the card with a buffer of its count, and rescanned by the
        oracle only if that relaunch overflows too."""
        ws, nw = window
        count, lanes, tpos = result[:3]
        count = int(count.item())
        if count == 0:
            return []
        if count > lanes.shape[0]:
            self.relaunches += 1
            self.dispatched += 1
            count, lanes, tpos = self.step(ws, nw, cap=count)[:3]
            if int(count.item()) > lanes.shape[0]:
                return self._rescan_words(ws, nw, unit)
        return self._collect_word_hits(lanes.cpu().numpy(),
                                       tpos.cpu().numpy(), ws, unit)


class CudaWordlistWorker(WordlistWorkerBase):
    """Wordlist+rules worker over the hand-written rule kernel
    (ops/cuda_rules.py), the counterpart of the reference's
    PallasWordlistWorker (one target) and DeviceWordlistWorker (a list):
    rule interpretation, hash and compare -- exact for one target, the
    probe and the verify on the card for a list -- in one launch per
    word window.  The packed word table
    goes to the device once, at construction; a step takes a window
    (ws, n_valid_words) of at most ``word_batch`` words under every rule.
    Units need not be rule-aligned: a unit runs over the words it
    covers and drops the hits outside it.  On a card the kernel builds
    at construction; with ``device="cpu"`` each step runs the kernel's
    plain version."""

    def __init__(self, engine, gen, targets: Sequence[Target],
                 batch: int = 1 << 24, hit_capacity: int = 64,
                 oracle: Optional[HashEngine] = None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_rules

        device = torch.device(device)
        tgt = self._setup_targets(engine, gen, targets, hit_capacity,
                                  oracle, device, bulk=True)
        if device.type == "cuda":
            cuda_rules.load_kernel(cuda_rules.source_of(engine.core))
        #: words per step: batch candidates over the rules, a multiple
        #: of a warp so each warp of a launch shares one rule
        self.word_batch = max(cuda_rules.WARP,
                              batch // gen.n_rules // cuda_rules.WARP
                              * cuda_rules.WARP)
        self.stride = self.word_batch * gen.n_rules
        self.step = cuda_rules.make_cuda_rules_crack_step(
            engine.name, gen, tgt, self.word_batch, hit_capacity,
            device=device)

    def submit(self, unit: WorkUnit) -> PendingUnit:
        """Enqueue one step per word window of the unit's covering word
        range; the unit's hit flag is summed on the device."""
        w_start, w_end = word_cover_range(unit, self.gen.n_rules)
        w_end = min(w_end, self.gen.n_words)
        queued = []
        flag = None
        for ws in range(w_start, w_end, self.word_batch):
            nw = min(self.word_batch, w_end - ws)
            flag = self._queue(queued, (ws, nw), self.step(ws, nw), flag)
        return PendingUnit(self, unit, queued, flag)
