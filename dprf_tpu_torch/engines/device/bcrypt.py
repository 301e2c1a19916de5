"""bcrypt on the card: the memory-hard path (benchmark config 4).

bcrypt is salted with a per-target cost, so one computation cannot
serve a target list: the workers sweep the keyspace once per target.
A batch's EksBlowfish state (P, 4 KB of S-boxes per candidate) lives on
the card from ``setup`` to ``finish`` (ops/cuda_bcrypt.py), and the
2**cost loop between them runs in launches of bounded length
(``ChunkedEks``), so progress and hits stay prompt at any cost.

Not ported from the reference: ``_route_bcrypt``,
``measure_eks_rates`` and ``RoutedCpuBcryptWorker``, which hand a job
to the CPU oracle when it measures faster than the device.  On
``--device cuda`` that would hide the device; ``--device cpu`` is the
oracle's path.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.engines.cpu.engines import BcryptEngine
from dprf_tpu_torch.ops import blowfish as bf
from dprf_tpu_torch.ops import cuda_bcrypt
from dprf_tpu_torch.rules import device as rules_device
from dprf_tpu_torch.runtime.worker import (CpuWorker, Hit, _ResolvedUnit,
                                           word_cover_range,
                                           wordlist_lane_to_gidx)
from dprf_tpu_torch.runtime.workunit import WorkUnit

#: candidates per step on CPU tensors (the reference's default batch);
#: on the card a step is one wave of the bcrypt kernels
#: (``cuda_bcrypt.resident_batch``: 4,224 on an H100)
CPU_BATCH = 1 << 12


@register("bcrypt", device="cuda")
class TorchBcryptEngine(BcryptEngine):
    """The device bcrypt engine: the oracle's hash parsing ($2a/$2b/$2y
    lines, cost 4..31), ``hash_batch`` through the kernels, and the
    kernels' mask and wordlist workers.  torch_device: "cuda" (the
    default) or "cpu", where everything runs the plain version."""

    def __init__(self, torch_device="cuda"):
        self.torch_device = torch.device(torch_device)

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError("bcrypt needs target params (salt, cost)")
        if any(len(c) > self.max_candidate_len for c in candidates):
            raise ValueError("bcrypt: candidate longer than 72 bytes")
        B = len(candidates)
        L = max(max((len(c) for c in candidates), default=1), 1)
        buf = np.zeros((B, L), dtype=np.uint8)
        lens = np.zeros((B,), dtype=np.int32)
        for i, c in enumerate(candidates):
            buf[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
            lens[i] = len(c)
        dev = self.torch_device
        key = bf.key_words_from_candidates(torch.as_tensor(buf, device=dev),
                                           torch.as_tensor(lens, device=dev))
        salt = bf.salt_to_words(params["salt"])
        P, S = cuda_bcrypt.eks_setup(key, salt)
        P, S = cuda_bcrypt.eks_advance(P, S, key, bf.salt18_words(salt),
                                       _n_rounds(params["cost"]))
        _, _, digest = cuda_bcrypt.eks_finish(P, S, None, B, np.zeros(6), 0)
        return bf.words_to_digests(digest.cpu().numpy())

    def _batch(self, batch: int) -> int:
        if self.torch_device.type == "cuda":
            return min(batch, cuda_bcrypt.resident_batch(self.torch_device))
        return min(batch, CPU_BATCH)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        if not hasattr(gen, "charsets") or \
                not 1 <= gen.length <= self.max_candidate_len:
            raise ValueError(f"bcrypt: masks of 1..{self.max_candidate_len} "
                             "positions; use --device cpu")
        return BcryptMaskWorker(self, gen, targets, batch=self._batch(batch),
                                hit_capacity=hit_capacity, oracle=oracle)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        if gen.max_len > self.max_candidate_len:
            raise ValueError(f"bcrypt: words of at most "
                             f"{self.max_candidate_len} bytes; use --device "
                             "cpu")
        return BcryptWordlistWorker(self, gen, targets,
                                    batch=self._batch(batch),
                                    hit_capacity=hit_capacity, oracle=oracle)


def _n_rounds(cost: int) -> int:
    """2**cost, the cost loop's trip count.  Cost 31 (valid in the
    format, ~2e9 rounds) overflows the kernels' int32 count: refused,
    never wrapped into a loop that finds nothing."""
    if not 4 <= cost <= 30:
        raise ValueError(
            f"bcrypt cost {cost} outside the device engine's range 4..30 "
            "(2**31 rounds exceed the kernels' int32 round count; use "
            "--device cpu)")
    return 1 << cost


def _target_args(target: Target):
    """Target -> (salt_words uint32[4], n_rounds, target_words
    uint32[6])."""
    return (bf.salt_to_words(target.params["salt"]),
            _n_rounds(target.params["cost"]),
            bf.digest_to_words(target.digest))


class ChunkedEks:
    """Drives the 2**cost loop in launches of bounded length, the state
    on the device between them.

    The first launch is one round (it absorbs the kernels' build and
    first-launch costs, untimed); the next is CALIBRATE_ROUNDS, timed
    (``torch.cuda.synchronize``) to learn seconds per round; later ones
    grow toward ``dispatch_s``, at most GROWTH_CAP times the largest so
    far, so one optimistic estimate cannot overshoot.  Once calibrated,
    a remainder that fits one launch with headroom is issued without a
    sync, so the next batch's setup queues behind it.
    """

    CALIBRATE_ROUNDS = 16
    GROWTH_CAP = 8
    #: seconds per launch: long enough that the per-launch host work is
    #: noise, short enough for prompt progress (a cost-12 batch on the
    #: card takes seconds)
    DISPATCH_S = 1.5

    def __init__(self, dispatch_s: Optional[float] = None, advance=None):
        """``advance(P, S, key_words, salt18, n) -> (P, S)`` defaults to
        ``cuda_bcrypt.eks_advance``."""
        self.dispatch_s = self.DISPATCH_S if dispatch_s is None \
            else dispatch_s
        self._advance = advance or cuda_bcrypt.eks_advance
        self._per_round: Optional[float] = None   # EMA, seconds/round
        self._last_chunk = self.CALIBRATE_ROUNDS
        #: launches issued and their round counts (the last run's)
        self.chunks: list[int] = []

    @staticmethod
    def _sync(t: torch.Tensor) -> None:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def _next_chunk(self, remaining: int) -> int:
        if self._per_round is None:
            return min(remaining, self.CALIBRATE_ROUNDS)
        want = max(1, int(self.dispatch_s / self._per_round))
        return min(remaining, want, self._last_chunk * self.GROWTH_CAP)

    def run(self, P, S, key_words, salt18, total_rounds: int,
            on_chunk=None):
        """Advance (P, S) by ``total_rounds``; returns the final state.
        ``on_chunk(done, total)`` is called after each launch."""
        self.chunks = []
        done = 0
        if self._per_round is None and total_rounds > 0:
            P, S = self._advance(P, S, key_words, salt18, 1)
            self._sync(S)
            done = 1
            self.chunks.append(1)
            if on_chunk is not None:
                on_chunk(done, total_rounds)
        elif (self._per_round is not None and total_rounds > 0
              and total_rounds * self._per_round <= 0.75 * self.dispatch_s):
            self.chunks.append(total_rounds)
            P, S = self._advance(P, S, key_words, salt18, total_rounds)
            if on_chunk is not None:
                on_chunk(total_rounds, total_rounds)
            return P, S
        while done < total_rounds:
            chunk = self._next_chunk(total_rounds - done)
            t0 = time.perf_counter()
            P, S = self._advance(P, S, key_words, salt18, chunk)
            self._sync(S)
            per = (time.perf_counter() - t0) / chunk
            self._per_round = per if self._per_round is None \
                else 0.5 * self._per_round + 0.5 * per
            done += chunk
            self.chunks.append(chunk)
            self._last_chunk = max(self._last_chunk, chunk)
            if on_chunk is not None:
                on_chunk(done, total_rounds)
        return P, S


class _BcryptWorkerBase:
    """The per-target sweep shared by the mask and wordlist workers:
    setup, the chunked cost loop and finish, per target and batch."""

    def __init__(self, engine, gen, targets: Sequence[Target], batch: int,
                 hit_capacity: int, oracle):
        self.engine = engine
        self.gen = gen
        self.targets = list(targets)
        self.hit_capacity = hit_capacity
        self.oracle = oracle
        self.batch = batch
        self.device = engine.torch_device
        self._targs = [_target_args(t) for t in self.targets]
        if self.device.type == "cuda":
            cuda_bcrypt.load_kernel()
        self.chunker = ChunkedEks()
        #: state batches this worker has run through finish
        self.dispatched = 0

    def _chain(self, key, valid, n_valid: int, ti: int):
        """One batch's whole bcrypt chain against target ti: (count,
        lanes) of its finish, read back."""
        salt_w, n_rounds, tgt = self._targs[ti]
        P, S = cuda_bcrypt.eks_setup(key, salt_w)
        P, S = self.chunker.run(P, S, key, bf.salt18_words(salt_w), n_rounds)
        count, lanes, _ = cuda_bcrypt.eks_finish(P, S, valid, n_valid, tgt,
                                                 self.hit_capacity)
        self.dispatched += 1
        return int(count.item()), lanes.cpu().tolist()

    def _rescan(self, start: int, end: int, ti: int) -> list[Hit]:
        if self.oracle is None:
            raise RuntimeError(
                f"hit buffer overflow (> {self.hit_capacity}) and no "
                "oracle engine to rescan with; raise hit_capacity")
        hits = CpuWorker(self.oracle, self.gen, [self.targets[ti]]).process(
            WorkUnit(-1, start, end - start))
        return [Hit(ti, h.cand_index, h.plaintext) for h in hits]

    def submit(self, unit: WorkUnit) -> _ResolvedUnit:
        """Every launch of a batch waits on the chunking's syncs, so the
        unit runs now."""
        return _ResolvedUnit(self.process(unit))


class BcryptMaskWorker(_BcryptWorkerBase):
    """Mask sweep: per target and batch, decode the candidates and
    their key words on the device, then the chain."""

    def __init__(self, engine, gen, targets, batch: int = CPU_BATCH,
                 hit_capacity: int = 64, oracle=None):
        super().__init__(engine, gen, targets, batch, hit_capacity, oracle)
        self.stride = batch
        self._lut = gen.charset_lut(self.device)
        self._lens = torch.full((batch,), gen.length, dtype=torch.int32,
                                device=self.device)

    def process(self, unit: WorkUnit) -> list[Hit]:
        hits: list[Hit] = []
        for ti in range(len(self.targets)):
            for bstart in range(unit.start, unit.end, self.stride):
                n_valid = min(self.stride, unit.end - bstart)
                cand = self.gen.decode_batch(self.gen.digits(bstart),
                                             self._lut, self.batch)
                key = bf.key_words_from_candidates(cand, self._lens)
                count, lanes = self._chain(key, None, n_valid, ti)
                if count > self.hit_capacity:
                    hits.extend(self._rescan(bstart, bstart + n_valid, ti))
                    continue
                hits.extend(Hit(ti, bstart + lane,
                                self.gen.candidate(bstart + lane))
                            for lane in sorted(lanes) if lane >= 0)
        return hits


class BcryptWordlistWorker(_BcryptWorkerBase):
    """Wordlist(+rules) sweep: per target and word window, every rule
    applied on the device (rules/device.py, rule-major lanes), then the
    chain over words x rules."""

    def __init__(self, engine, gen, targets, batch: int = CPU_BATCH,
                 hit_capacity: int = 64, oracle=None):
        self.word_batch = max(1, batch // gen.n_rules)
        super().__init__(engine, gen, targets, self.word_batch * gen.n_rules,
                         hit_capacity, oracle)
        self.stride = self.batch
        buf, lens = gen.packed_words()
        self._words = torch.as_tensor(buf, device=self.device)
        self._wlens = torch.as_tensor(lens, device=self.device)

    def _expand(self, ws: int, nw: int):
        """Words [ws, ws + nw) under every rule, padded to word_batch:
        (cand uint8[R * word_batch, max_len], lens, valid)."""
        B, L = self.word_batch, self.gen.max_len
        w = torch.zeros((B, L), dtype=torch.uint8, device=self.device)
        ln = torch.zeros((B,), dtype=torch.int32, device=self.device)
        w[:nw] = self._words[ws:ws + nw]
        ln[:nw] = self._wlens[ws:ws + nw]
        in_window = torch.arange(B, device=self.device) < nw
        return (torch.cat(x) for x in zip(*(
            rules_device.apply_rule(w, ln, in_window, ops, L)
            for ops in self.gen.rules)))

    def process(self, unit: WorkUnit) -> list[Hit]:
        R = self.gen.n_rules
        w_start, w_end = word_cover_range(unit, R)
        w_end = min(w_end, self.gen.n_words)
        hits: list[Hit] = []
        for ti in range(len(self.targets)):
            for ws in range(w_start, w_end, self.word_batch):
                nw = min(self.word_batch, w_end - ws)
                cand, lens, valid = self._expand(ws, nw)
                key = bf.key_words_from_candidates(cand, lens)
                count, lanes = self._chain(key, valid, self.batch, ti)
                if count > self.hit_capacity:
                    hits.extend(self._rescan(max(unit.start, ws * R),
                                             min(unit.end, (ws + nw) * R),
                                             ti))
                    continue
                for gidx in sorted(wordlist_lane_to_gidx(lane, ws,
                                                         self.word_batch, R)
                                   for lane in lanes if lane >= 0):
                    if unit.start <= gidx < unit.end:
                        hits.append(Hit(ti, gidx, self.gen.candidate(gidx)))
        return hits
