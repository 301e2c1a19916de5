"""The grouped kernels of the port -- the salted kernel (a group of
salted targets a launch, ops/cuda_ext.py, csrc/salted.cuh) and the
Kerberos kernel (a group of tickets of one msg_type a launch,
ops/cuda_krb5.py, csrc/krb5.cu) -- and their workers
(runtime/worker.GroupedSweepWorker) against the reference, which sweeps
one target a launch: the reference's Kerberos filter run eagerly per
ticket and its CpuWorker (tests/test_torch_salted.py holds the salted
groups against ``pallas_ext.emulate_ext_kernel``).  Exact equality of
the hit sets; the overflow rescan per target; the reciprocal decode's
arithmetic.

On the CPU the steps run the kernels' plain PyTorch versions, because
their tensors lie on the CPU (what ``--device torch-cpu`` runs);
tests/test_torch_cuda.py holds the CUDA kernels against them on a card.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.engines.cpu import krb5 as ref_krb5
from dprf_tpu.engines.device import krb5 as ref_dkrb5
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.cpu.krb5 import der, encrypt
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_ext, cuda_krb5, cuda_mask
from dprf_tpu_torch.runtime.worker import (GroupedSweepWorker,
                                          singleton_groups)
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke


def test_decode_reciprocals_are_exact():
    """For every radix 1..256, umulhi(2 s, rcp) >> sh is s // r at the
    quotient's edges (every multiple of r and its neighbours up to
    2^16), at the top of the range the lane arithmetic keeps s below
    (2^31) and at seeded points; rcp fits 32 bits."""
    rng = np.random.default_rng(31)
    top = np.uint64((1 << 31) - 1)
    for r in range(1, 257):
        (rcp,), (sh,) = cuda_mask.decode_reciprocals([r])
        assert 0 < rcp < 1 << 32 and r <= 1 << sh < 2 * r
        near = np.arange(0, 1 << 16, dtype=np.uint64)
        s = np.concatenate([near, top - near,
                            rng.integers(0, 1 << 31, 4096).astype(np.uint64),
                            (top // np.uint64(r)) * np.uint64(r)
                            + np.arange(-1, 2, dtype=np.int64)
                            .astype(np.uint64)])
        s = s[s <= top]
        q = ((s * np.uint64(2) * np.uint64(rcp)) >> np.uint64(32)) \
            >> np.uint64(sh)
        assert (q == s // np.uint64(r)).all(), r


def test_salted_groups_and_rows():
    """ps targets share one layout (groups of at most SALTED_GROUP, in
    job order); sp targets group by salt length, shortest first.  A row
    is the target's fixed words, its digest words and, for md5, word 0
    less the IV's; an sp group of mixed lengths is refused."""
    salts = [b"x" * n for n in (5, 0, 5, 32, 0, 7)]
    assert cuda_ext.salted_groups("md5-ps", salts) == [[0, 1, 2, 3, 4, 5]]
    assert cuda_ext.salted_groups("sha1-sp", salts) == [[1, 4], [0, 2], [5],
                                                        [3]]
    many = [b"s"] * (cuda_ext.SALTED_GROUP + 3)
    groups = cuda_ext.salted_groups("sha256-sp", many)
    assert [len(g) for g in groups] == [cuda_ext.SALTED_GROUP, 3]
    assert sum(groups, []) == list(range(len(many)))
    words = [0x01234567, 0x89ABCDEF, 5, 6]
    rows = cuda_ext.salted_rows("md5-ps", 6, [(b"ab", words),
                                              (b"", [7, 8, 9, 10])])
    assert rows.shape == (2, cuda_ext.SALTED_ROW) and rows.dtype == np.uint32
    assert tuple(rows[0, :16]) == cuda_ext.salted_block("md5-ps", 6, b"ab")
    assert list(rows[0, 16:20]) == words
    assert rows[0, 20] == (words[0] - 0x67452301) % (1 << 32)
    rows = cuda_ext.salted_rows("sha1-sp", 6, [(b"ab", [1, 2, 3, 4, 5])])
    assert list(rows[0, 16:21]) == [1, 2, 3, 4, 5] and rows[0, 21] == 0
    with pytest.raises(ValueError, match="one length"):
        cuda_ext.salted_rows("sha1-sp", 6, [(b"ab", [0] * 5),
                                            (b"abc", [0] * 5)])
    with pytest.raises(ValueError, match="target words"):
        cuda_ext.salted_rows("sha1-sp", 6, [(b"ab", [0] * 4)])


def _salted_lines(variant, gen, plants, rng):
    """hexdigest:$HEX[salt] lines of seeded salts, one per (keyspace
    index or None, salt length)."""
    oracle = get_engine(variant)
    lines = []
    for p, n in plants:
        salt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        plain = gen.candidate(p) if p is not None else b"not-in-the-mask"
        d = oracle.hash_batch([plain], params={"salt": salt})[0]
        lines.append(f"{d.hex()}:$HEX[{salt.hex()}]")
    return lines


def _spy_rescans(monkeypatch) -> list:
    """Record each oracle rescan as (its job targets, batch start)."""
    rescans = []
    rescan = GroupedSweepWorker._rescan

    def spy(self, tis, bstart, unit):
        rescans.append((tuple(tis), bstart))
        return rescan(self, tis, bstart, unit)

    monkeypatch.setattr(GroupedSweepWorker, "_rescan", spy)
    return rescans


def _one_slot(step):
    """A group's step whose hit buffer holds one (lane, target) pair:
    the kernel's and the plain version's first slot, the counts whole."""
    def narrow(base_digits, n_valid):
        count, lanes, tpos, tcount = step(base_digits, n_valid)
        return count, lanes[:1], tpos[:1], tcount
    return narrow


def _salted_job(variant):
    """md5-ps / sha256-sp over ?l^3: four targets with 4-byte salts,
    three planted in batch 0 of 2048, and the reference CpuWorker's
    hits."""
    rng = np.random.default_rng(37)
    gen = MaskGenerator("?l?l?l")
    lines = _salted_lines(variant, gen, [(17, 4), (None, 4), (900, 4),
                                         (1200, 4)], rng)
    oracle = get_engine(variant)
    ref = ref_get_engine(variant)
    want = sorted((h.target_index, h.cand_index) for h in RefCpuWorker(
        ref, RefMaskGenerator("?l?l?l"),
        [ref.parse_target(ln) for ln in lines]).process(
            RefWorkUnit(0, 0, gen.keyspace)))
    assert want == [(0, 17), (2, 900), (3, 1200)]
    return gen, oracle, [oracle.parse_target(ln) for ln in lines], want


@pytest.mark.parametrize("variant", ["md5-ps", "sha256-sp"])
def test_salted_group_overflow_rescans_only_its_targets(variant,
                                                        monkeypatch):
    """Four targets of one group, three of them hit in one batch and the
    hit buffer holds one: the worker keeps the recorded hit and rescans
    exactly the targets whose own count it does not cover, in one oracle
    pass; the hits are the reference CpuWorker's."""
    gen, oracle, targets, want = _salted_job(variant)
    dev = get_engine(variant, "cuda", torch_device="cpu")
    w = dev.make_mask_worker(gen, targets, batch=2048, hit_capacity=1,
                             oracle=oracle)
    assert [g[0] for g in w.groups] == [[0, 1, 2, 3]]
    w.groups = [(idx, _one_slot(step)) for idx, step in w.groups]
    rescans = _spy_rescans(monkeypatch)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert sorted((h.target_index, h.cand_index) for h in hits) == want
    assert all(h.plaintext == gen.candidate(h.cand_index) for h in hits)
    # batch 0 holds three hits, the one at lane 17 recorded: targets 2
    # and 3 rescanned; the other batches hold none
    assert rescans == [((2, 3), 0)]
    assert w.dispatched == -(-gen.keyspace // 2048)


@pytest.mark.parametrize("variant", ["md5-ps", "sha256-sp"])
def test_salted_hit_buffer_holds_cap_per_target(variant, monkeypatch):
    """A hit capacity of one a target: three of a group's four targets
    hit in one batch, more than the capacity, and the group's buffer
    (capacity x 4) holds them all; nothing is rescanned."""
    gen, oracle, targets, want = _salted_job(variant)
    dev = get_engine(variant, "cuda", torch_device="cpu")
    w = dev.make_mask_worker(gen, targets, batch=2048, hit_capacity=1,
                             oracle=oracle)
    rescans = _spy_rescans(monkeypatch)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert sorted((h.target_index, h.cand_index) for h in hits) == want
    assert rescans == []


def _ticket_line(password: bytes, asrep: bool, body_len: int,
                 seed: int) -> str:
    """A valid etype-23 line: RFC 4757 run forward over an 8-byte
    confounder and a DER ticket, as a KDC makes one."""
    rng = random.Random(seed)
    body = bytes(rng.randrange(256) for _ in range(body_len))
    plain = bytes(rng.randrange(256) for _ in range(8)) + \
        der(0x79 if asrep else 0x63, der(0x30, body))
    chk, edata = encrypt(password, 8 if asrep else 2, plain)
    if asrep:
        return f"$krb5asrep$23$user@EX.COM:{chk.hex()}${edata.hex()}"
    return f"$krb5tgs$23$*svc$EX.COM$http/web*${chk.hex()}${edata.hex()}"


def test_krb5_groups_of_both_msg_types_match_reference():
    """Tickets of msg_type 2 (TGS) and 8 (AS-REP) in one list, planted
    at the batch's first lane, its last valid lane and a seeded lane,
    and tickets no candidate opens: ``krb5_groups`` makes one group per
    msg_type, and each group's step gives exactly the (lane, ticket)
    survivors of the reference's filter run per ticket over the
    reference's decoded candidates."""
    rng = np.random.default_rng(41)
    mask = "?l?d?l"
    gen, rgen = MaskGenerator(mask), RefMaskGenerator(mask)
    batch, start = 256, 1024
    n_valid = batch - 5
    lane = int(rng.integers(1, n_valid - 1))
    spec = [(False, 0), (True, n_valid - 1), (False, lane), (True, 0),
            (False, None)]
    lines = [_ticket_line(gen.candidate(start + p) if p is not None
                          else b"nope", asrep, 60 + 7 * i, i)
             for i, (asrep, p) in enumerate(spec)]
    targets = [get_engine("krb5asrep" if asrep else "krb5tgs")
               .parse_target(ln) for (asrep, _), ln in zip(spec, lines)]
    tgts = [cuda_krb5.target_kernel_args(t) for t in targets]
    groups = cuda_krb5.krb5_groups(tgts)
    assert groups == [[0, 2, 4], [1, 3]]
    assert [tgts[g[0]].msg_type for g in groups] == [2, 8]

    cand = rgen.decode_batch(jnp.asarray(rgen.digits(start), jnp.int32),
                             rgen.flat_charsets, batch)
    lens = jnp.full((batch,), gen.length, jnp.int32)
    want = set()
    for i, (asrep, _) in enumerate(spec):
        ref = (ref_krb5.Krb5AsRepEngine() if asrep
               else ref_krb5.Krb5TgsEngine()).parse_target(lines[i])
        tw, tn, cw, cn, c4, mk, ex = ref_dkrb5._targs([ref])[0]
        word = np.asarray(ref_dkrb5.krb5_filter_batch(
            cand, lens, tw, tn, cw, cn, c4, mk))[:n_valid, 0]
        want |= {(int(x), i) for x in np.nonzero(word == int(ex[0]))[0]}
    planted = {(p, i) for i, (_, p) in enumerate(spec) if p is not None}
    assert planted <= want

    got = set()
    for idx in groups:
        step = cuda_krb5.make_krb5_step(gen, [tgts[i] for i in idx], batch,
                                        16, device="cpu")
        count, lanes, tpos, tcount = step(gen.digits(start), n_valid)
        pairs = {(int(a), idx[int(b)]) for a, b in zip(lanes.tolist(),
                                                       tpos.tolist())
                 if a >= 0}
        assert int(count) == len(pairs) == int(tcount.sum())
        got |= pairs
    assert got == want


def _krb5_job():
    """Three TGS tickets over ?d?d?l, two planted in batch 0 of 1024."""
    gen = MaskGenerator("?d?d?l")
    tgs = get_engine("krb5tgs")
    plants = (5, 700, 2000)
    targets = [tgs.parse_target(_ticket_line(gen.candidate(p), False,
                                             60 + i, i))
               for i, p in enumerate(plants)]
    return gen, tgs, targets


def test_krb5_worker_overflow_rescans_only_its_tickets(monkeypatch):
    """Three TGS tickets, two planted in one batch, a hit buffer of one:
    the recorded survivor is confirmed, the other ticket alone is
    rescanned by the oracle; the found set is every plant."""
    gen, tgs, targets = _krb5_job()
    dev = get_engine("krb5tgs", "cuda", torch_device="cpu")
    w = dev.make_mask_worker(gen, targets, batch=1024, hit_capacity=1,
                             oracle=tgs)
    w.groups = [(idx, _one_slot(step)) for idx, step in w.groups]
    rescans = _spy_rescans(monkeypatch)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert [(h.target_index, h.cand_index) for h in hits] == \
        [(0, 5), (1, 700), (2, 2000)]
    # lane 5 (ticket 0) holds the slot; ticket 1 alone is rescanned
    assert rescans == [((1,), 0)]
    assert w.dispatched == 3 and w.n_maybe() == 0


def test_krb5_hit_buffer_holds_cap_per_ticket(monkeypatch):
    """A hit capacity of one a ticket: two of a group's three tickets
    open in one batch, more than the capacity, and the group's buffer
    (capacity x 3) holds both; nothing is rescanned."""
    gen, tgs, targets = _krb5_job()
    dev = get_engine("krb5tgs", "cuda", torch_device="cpu")
    w = dev.make_mask_worker(gen, targets, batch=1024, hit_capacity=1,
                             oracle=tgs)
    rescans = _spy_rescans(monkeypatch)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert [(h.target_index, h.cand_index) for h in hits] == \
        [(0, 5), (1, 700), (2, 2000)]
    assert rescans == [] and w.n_maybe() == 0


def test_singleton_and_whole_group_rescans(monkeypatch):
    """The grouped worker's two other step forms: a per-target step
    (count, lanes, None) as a group of one, and a group's step without
    per-target counts, whose overflow rescans its whole group; the
    recorded lane of a rescanned target is not reported twice."""
    gen = MaskGenerator("?d?d")
    oracle = get_engine("md5")
    targets = [oracle.parse_target(oracle.hash_batch([gen.candidate(p)])[0]
                                   .hex()) for p in (7, 42, 99)]
    i32 = dict(dtype=torch.int32)

    def per_target(base_digits, n_valid):
        return (torch.tensor([2], **i32), torch.tensor([7], **i32), None)

    def no_tcount(base_digits, n_valid):
        return (torch.tensor([3], **i32), torch.tensor([42], **i32),
                torch.tensor([0], **i32))

    w = GroupedSweepWorker(oracle, gen, targets, 100, 1, oracle)
    w.groups = singleton_groups([per_target]) + [([1, 2], no_tcount)]
    rescans = _spy_rescans(monkeypatch)
    hits = w.process(WorkUnit(0, 0, 100))
    assert [(h.target_index, h.cand_index) for h in hits] == \
        [(0, 7), (1, 42), (2, 99)]
    assert rescans == [((0,), 0), ((1, 2), 0)]
    assert w.dispatched == 2


def test_salted_worker_is_the_reference_sweep_at_a_group_past_the_cap():
    """More ps targets than one launch takes (SALTED_GROUP + 2, plants
    in both chunks, the unreachable rest a miss) on CPU tensors: two
    groups, and the hits the reference CpuWorker finds."""
    rng = np.random.default_rng(43)
    gen = MaskGenerator("?l?l")
    oracle = get_engine("md5-ps")
    n = cuda_ext.SALTED_GROUP + 2
    plants = {0: 3, n - 1: 675, 100: 0}
    targets, want = [], []
    for i in range(n):
        salt = bytes(rng.integers(0, 256, int(rng.integers(0, 33)),
                                  dtype=np.uint8))
        plain = gen.candidate(plants[i]) if i in plants else b"~"
        d = oracle.hash_batch([plain], params={"salt": salt})[0]
        targets.append(oracle.parse_target(f"{d.hex()}:$HEX[{salt.hex()}]"))
        if i in plants:
            want.append((i, plants[i]))
    dev = get_engine("md5-ps", "cuda", torch_device="cpu")
    w = dev.make_mask_worker(gen, targets, batch=1024, hit_capacity=8,
                             oracle=oracle)
    assert [len(g[0]) for g in w.groups] == [cuda_ext.SALTED_GROUP, 2]
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert sorted((h.target_index, h.cand_index) for h in hits) == \
        sorted(want)
