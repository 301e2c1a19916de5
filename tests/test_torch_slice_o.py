"""Slice O on the CPU: the rules kernel's wide cores (sha512 and sha384
over SHA-512's 128-byte block, the Keccak sponge at its four rates) and
sha512's salted tails (ps, sp, MSSQL 2012's UTF-16LE), csrc/rules_wide.cu.

Their plain versions against the reference on the same seeded inputs:
every kept (word, rule) candidate is the reference's rule interpreter's,
and its digest words -- a salted tail's per target -- the reference
oracle's, for words at the name's max_len, rules that grow a word past
it (they reject), salts of 0 and 32 bytes, and a sponge's word of rate -
1 bytes (the pad byte and 0x80 in one byte).  Then csrc/rules_wide.cu
itself, built for the CPU with g++ as tests/test_torch_rules_host.py
builds csrc/rules.cu: every kept candidate's digest through a bulk list
that holds them all behind a full bitmap (so each lane reports the table
position of its own digest), one planted target on the short-message
path and on the full one, a list's shared-memory probe, and the group
tails, each held to the plain version.  The workers' and the CLI's hit
sets are held against the reference's in test_torch_slice_o_*.py.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.rules.cpu import apply_rule as ref_apply_rule
from dprf_tpu.rules.parser import parse_rule as ref_parse_rule
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_ext, cuda_mask, cuda_rules
from dprf_tpu_torch.ops.compare import digest_rows, make_target_table
from dprf_tpu_torch.rules.parser import parse_rule

import test_torch_rules_host as rules_host

pytestmark = pytest.mark.smoke

#: rules: case maps, appends and prepends, a reversal, duplications (past
#: max_len for a long word: rejected), a rejection ("<6"), a truncation, a
#: substitution, an insert and an overwrite at positions past short words
RULES = [":", "c", "u $1", "r", "d", "$! ^#", "]", "T0", "<6", "'8", "sa@",
         "i3Z", "o0X", "p2", "{ $a $b"]
#: a core of each width and kind: (engine, max_len)
CORES = [("sha512", 111), ("sha384", 64), ("sha3-224", 143),
         ("keccak-256", 135), ("sha3-384", 103), ("keccak-512", 71)]


def _words(max_len: int, seed: int) -> list:
    """A few words, and a random one at lengths 0, 1, 15-17 and max_len -
    2 .. max_len, in all bytes and in printable ones."""
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"Bravo9", b"charlie"]
    for n in (0, 1, 15, 16, 17, max_len - 2, max_len - 1, max_len):
        for lo, hi in ((0, 256), (32, 127)):
            words.append(bytes(rng.integers(lo, hi, n, dtype=np.uint8)))
    return words


def _job(max_len: int, seed: int):
    """(generator, words, the reference's candidates by lane, the word
    batch): lane = r * wb + b over every word."""
    words = _words(max_len, seed)
    gen = WordlistRulesGenerator(words, [parse_rule(r) for r in RULES],
                                 max_len)
    wb = -(-len(words) // 32) * 32
    want = {}
    for r, line in enumerate(RULES):
        for b, w in enumerate(words):
            c = ref_apply_rule(w, ref_parse_rule(line), max_len)
            if c is not None:
                want[r * wb + b] = c
    return gen, words, want, wb


def _tables(gen):
    buf, lens = gen.packed_words()
    return (torch.as_tensor(buf), torch.as_tensor(lens),
            *cuda_rules.rule_tables(gen.rules))


def _as_bytes(words, little_endian: bool, n_bytes: int) -> bytes:
    return np.asarray(words, np.int32).view(np.uint32).astype(
        "<u4" if little_endian else ">u4").tobytes()[:n_bytes]


@pytest.mark.parametrize("engine,max_len", CORES)
def test_core_digests_match_the_reference(engine, max_len):
    """Every lane kept where the reference's interpreter keeps it, its
    digest the reference oracle's (a word of max_len bytes under ":" is
    the sponge's n = rate - 1 where max_len is rate - 1)."""
    gen, words, want, wb = _job(max_len, max_len)
    eng = get_engine(engine, "cuda", torch_device="cpu")
    digest, valid = cuda_rules._digest_plain(eng, *_tables(gen), 0,
                                             len(words), wb)
    kept = {int(i) for i in np.flatnonzero(valid.numpy())}
    assert kept == set(want)
    assert any(len(c) == max_len for c in want.values())
    assert any(len(w) + 1 > max_len for w in words)    # "$!" rejects
    got = [_as_bytes(digest[lane].numpy(), False, eng.digest_size)
           for lane in sorted(want)]
    assert got == ref_get_engine(engine).hash_batch(
        [want[lane] for lane in sorted(want)])


#: the sha512 tails: (engine, max_len, the targets' salts)
SALTED = [("sha512-ps", 79, [b"", b"x" * 32, b"NaCl"]),
          ("sha512-sp", 79, [b"q" * 32, b"q" * 32]),
          ("sha512-sp", 79, [b"", b""]),
          ("mssql2012", 53, [b"\x01\x02\x03\x04", b"\xfe\xff\x00\x01"])]


@pytest.mark.parametrize("engine,max_len,salts", SALTED)
def test_salted_tail_digests_match_the_reference(engine, max_len, salts):
    """Each (kept candidate, target) digest of a sha512 tail's plain
    version equals the reference oracle's, salts of 0 and 32 bytes beside
    words at max_len (a candidate and its salt fill the 111-byte block)."""
    gen, words, want, wb = _job(max_len, len(engine))
    dev = get_engine(engine, "cuda", torch_device="cpu")
    ref = ref_get_engine(engine)
    cand, clen, kept = cuda_rules._expand_plain(*_tables(gen), 0, len(words),
                                                wb)
    rows = cuda_ext.salted_rule_rows(dev.variant, [
        (s, [0] * 16) for s in salts], max_len)
    assert cuda_ext.rule_row_salts(dev.variant, rows) == salts
    digests = cuda_ext.salted_rule_digests(
        dev.variant, cand, clen, torch.as_tensor(rows.view(np.int32)))
    lanes = sorted(want)
    assert [int(i) for i in np.flatnonzero(kept.numpy())] == lanes
    for t, salt in enumerate(salts):
        got = [_as_bytes(digests[lane, t].numpy(), False, 64)
               for lane in lanes]
        assert got == ref.hash_batch([want[lane] for lane in lanes],
                                     params={"salt": salt}), (engine, salt)


def test_wide_rows_hold_the_salt_where_the_kernel_reads_it():
    """sha512's compact rows: the salt from word 0 (ps with its marker),
    the digest from word 9, the bits at 25; a salt past the block beside
    max_len raises."""
    rows = cuda_ext.salted_rule_rows("sha512-ps", [(b"ab", list(range(16)))],
                                     79)
    assert rows.shape == (1, cuda_ext.WIDE_SALTED_RULE_ROW)
    assert rows[0, :2].tolist() == [0x61628000, 0]
    assert rows[0, 9:25].tolist() == list(range(16))
    assert rows[0, 25] == 16
    sp = cuda_ext.salted_rule_rows("sha512-sp", [(b"abcde", [0] * 16)], 79)
    assert sp[0, :2].tolist() == [0x61626364, 0x65000000]
    with pytest.raises(ValueError, match="exceeds"):
        cuda_ext.salted_rule_rows("sha512-ps", [(b"x" * 32, [0] * 16)], 80)
    assert cuda_rules.tail_geometry("sha512-ps-utf16") == (
        cuda_ext.SALTED_GROUP, cuda_ext.WIDE_SALTED_RULE_ROW, 2,
        cuda_ext.WIDE_BLOCK_LIMIT)


# ---- csrc/rules_wide.cu built for the CPU ------------------------------

@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/rules_wide.cu built for the CPU (test_torch_rules_host.py's
    shim, its __launch_bounds__ taking the sponge's second argument)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build csrc/rules_wide.cu for the CPU")
    shim = rules_host.SHIM
    rules_host.SHIM = shim.replace("#define __launch_bounds__(x)",
                                   "#define __launch_bounds__(...)")
    try:
        so = rules_host.build_host(tmp_path_factory.mktemp("rules_wide_host"),
                                   "rules_wide")
    finally:
        rules_host.SHIM = shim
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = ctypes.POINTER(cuda_rules._WideRulesArgs)
    so.dprf_rules_launch.argtypes = [i32, i32, ptr, ptr, ptr, ptr, args, ptr,
                                     ptr, i32, i32, i32, ptr]
    so.dprf_rules_list_launch.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, args,
        ctypes.POINTER(cuda_mask.MultiArgs), ptr, ptr, ptr, ptr, i32, i32,
        i32, i32, ptr]
    so.dprf_rules_group_launch.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, ctypes.POINTER(cuda_rules._RulesArgs),
        ctypes.POINTER(cuda_rules._GroupArgs), i32, i32, i32, ptr]
    for fn in (so.dprf_rules_shared_bytes, ):
        fn.argtypes = [i32, ctypes.POINTER(i32)]
    so.dprf_rules_group_shared_bytes.argtypes = [i32, i32,
                                                 ctypes.POINTER(i32)]
    so.emu_set_long.argtypes = [i32]
    so.emu_take.argtypes = [ptr]
    return so


def _drain(so) -> None:
    """Drop the emulation's records of the candidates it took."""
    recs = np.zeros((so.emu_records(), 16), np.int32)
    so.emu_take(recs.ctypes.data)


class HostJob:
    """A job's kernel inputs as numpy arrays (padded rows), the plain
    version's digests and kept lanes, and the launch's parameters."""

    def __init__(self, engine, max_len, seed, run=5):
        self.gen, self.words, self.want, self.wb = _job(max_len, seed)
        self.eng = get_engine(engine, "cuda", torch_device="cpu")
        buf, lens = self.gen.packed_words()
        self.table = cuda_rules.pad_rows(torch.as_tensor(buf)).numpy()
        self.lens = np.ascontiguousarray(lens, np.int32)
        self.bc = np.ascontiguousarray(cuda_rules.encode_rules(
            self.gen.rules, cuda_rules.MAX_STEPS))
        self.n_ops = np.array([len(r) for r in self.gen.rules], np.int32)
        self.max_len, self.run = max_len, run
        self.nv, self.n_rules = len(self.words), len(RULES)
        self.grid = cuda_rules.launch_grid(self.nv, self.n_rules, run)

    def args(self, target=()):
        words = [int(w) & 0xFFFFFFFF for w in target]
        return cuda_rules._WideRulesArgs(
            self.max_len, self.n_rules, self.wb, 0, self.nv,
            (ctypes.c_uint32 * 8)(), self.run,
            (ctypes.c_uint32 * 16)(*words), getattr(self.eng, "pad_byte", 0))

    def plain_digests(self):
        digest, valid = cuda_rules._digest_plain(
            self.eng, *_tables(self.gen), 0, self.nv, self.wb)
        return digest.numpy().view(np.uint32), valid.numpy()

    def list_launch(self, so, mode, bits, block_bits, k, table, cap):
        count = np.zeros(1, np.int32)
        n_maybe = np.zeros(1, np.int32)
        lanes = np.full(cap, -1, np.int32)
        tpos = np.full(cap, -1, np.int32)
        margs = cuda_mask.MultiArgs(bits.ctypes.data, table.ctypes.data, 0,
                                    table.shape[0], block_bits, k)
        smem = ctypes.c_int(0)
        core = cuda_rules.KERNEL_CORES[self.eng.core]
        assert so.dprf_rules_shared_bytes(core, ctypes.byref(smem)) == 0
        smem = smem.value + (bits.nbytes if mode == cuda_mask.PROBE else 0)
        assert smem <= so.emu_smem_bytes()
        assert so.dprf_rules_list_launch(
            core, mode, 0, self.table.ctypes.data, self.lens.ctypes.data,
            self.bc.ctypes.data, self.n_ops.ctypes.data,
            ctypes.byref(self.args()), ctypes.byref(margs), count.ctypes.data,
            lanes.ctypes.data, tpos.ctypes.data, n_maybe.ctypes.data, cap,
            self.grid, cuda_rules.THREADS, smem, None) == 0
        _drain(so)
        return int(count[0]), lanes, tpos, int(n_maybe[0])


@pytest.mark.parametrize("engine,max_len", CORES)
def test_host_kernel_digests_every_candidate(lib, engine, max_len):
    """A bulk list of every kept candidate's digest behind a full bitmap:
    each kept lane, and only those, reports the table position of the
    plain version's digest for it; then one target, planted, on both
    paths, and a list's shared-memory probe, equal to the plain
    version."""
    job = HostJob(engine, max_len, max_len)
    digest, valid = job.plain_digests()
    lanes_kept = [int(i) for i in np.flatnonzero(valid)]
    assert lanes_kept == sorted(job.want)
    rows = np.unique(digest[lanes_kept], axis=0)
    table = np.ascontiguousarray(rows[np.lexsort(rows.T[::-1])])
    full = np.full(16, 0xFFFFFFFF, np.uint32)
    cap = len(valid)
    count, lanes, tpos, n_maybe = job.list_launch(lib, cuda_mask.BULK, full,
                                                  0, 1, table, cap)
    got = {int(a): int(b) for a, b in zip(lanes, tpos) if a >= 0}
    assert count == n_maybe == len(lanes_kept) == len(got)
    assert sorted(got) == lanes_kept
    assert all((table[got[lane]] == digest[lane]).all() for lane in got)

    eng = job.eng
    plain_c = {lane: c for lane, c in job.want.items()}
    long_lane = max(plain_c, key=lambda x: (len(plain_c[x]), x))
    for lane, long_path in ((min(plain_c), False), (long_lane, True)):
        target = digest[lane]
        want = sorted(x for x in lanes_kept if (digest[x] == target).all())
        lib.emu_set_long(int(long_path))
        try:
            cnt = np.zeros(1, np.int32)
            out = np.full(64, -1, np.int32)
            assert lib.dprf_rules_launch(
                cuda_rules.KERNEL_CORES[eng.core], 0, job.table.ctypes.data,
                job.lens.ctypes.data, job.bc.ctypes.data,
                job.n_ops.ctypes.data, ctypes.byref(job.args(target)),
                cnt.ctypes.data, out.ctypes.data, 64, job.grid,
                cuda_rules.THREADS, None) == 0
            _drain(lib)
        finally:
            lib.emu_set_long(0)
        assert (int(cnt[0]), sorted(x for x in out if x >= 0)) == \
            (len(want), want), (lane, long_path)

    # a list of 5 planted digests and 3 no candidate reaches, the probe
    rng = np.random.default_rng(len(engine))
    picks = rng.choice(lanes_kept, 5, replace=False)
    digests = [_as_bytes(digest[p].view(np.int32), False, eng.digest_size)
               for p in picks] + [rng.bytes(eng.digest_size)
                                  for _ in range(3)]
    tt = make_target_table(digests, eng.little_endian)
    bits, block_bits, k = cuda_mask.probe_rows(tt.words)
    got = job.list_launch(lib, cuda_mask.PROBE, bits, block_bits, k,
                          np.ascontiguousarray(tt.words), 256)
    buf, lens = job.gen.packed_words()
    bc, n_ops = cuda_rules.rule_tables(job.gen.rules)
    pc, pl, pt, pm = cuda_rules.rules_list_plain(
        eng.name, cuda_mask.PROBE, torch.as_tensor(buf),
        torch.as_tensor(lens), bc, n_ops, 0, job.nv,
        torch.as_tensor(bits.view(np.int32)), block_bits, k,
        tt.tensor("cpu"), 256, job.wb)
    assert (got[0], got[3]) == (int(pc), int(pm))
    assert sorted((int(a), int(b)) for a, b in zip(got[1], got[2])
                  if a >= 0) == sorted(
        (int(a), int(b)) for a, b in zip(pl, pt) if a >= 0)
    assert got[0] >= 5


@pytest.mark.parametrize("engine,max_len,salts", SALTED)
def test_host_group_tail_matches_plain(lib, engine, max_len, salts):
    """A group of the plants' salted digests (one a target) and a target
    no candidate reaches: the host-built tail's count, (lane, target)
    pairs and per-target counts equal ``rules_group_plain``'s, and each
    plant's lanes are among its target's hits."""
    job = HostJob("sha512", max_len, len(engine) + 1)
    dev = get_engine(engine, "cuda", torch_device="cpu")
    oracle = get_engine(engine)
    rng = np.random.default_rng(max_len)
    pool = sorted(set(job.want.values()))
    plants = [pool[int(i)] for i in rng.choice(len(pool), len(salts),
                                               replace=False)]
    group = [(s, [int(w) for w in digest_rows(oracle.hash_batch(
        [p], params={"salt": s}), False)[0]]) for s, p in zip(salts, plants)]
    group.append((salts[0], [int(w) for w in digest_rows(
        [rng.bytes(64)], False)[0]]))
    rows = cuda_ext.salted_rule_rows(dev.variant, group, max_len).view(
        np.int32)
    shift = len(salts[0]) if dev.order == "sp" else 0
    T, cap = rows.shape[0], 512
    count = np.zeros(1, np.int32)
    lanes = np.full(cap, -1, np.int32)
    tpos = np.full(cap, -1, np.int32)
    tcount = np.zeros(T, np.int32)
    args = cuda_rules._RulesArgs(max_len, job.n_rules, job.wb, 0, job.nv,
                                 (ctypes.c_uint32 * 8)(), job.run)
    gargs = cuda_rules._GroupArgs(
        rows.ctypes.data, count.ctypes.data, lanes.ctypes.data,
        tpos.ctypes.data, tcount.ctypes.data, T, shift, 0, 0, cap)
    tid = cuda_rules.GROUP_TAILS[dev.variant]
    smem = ctypes.c_int(0)
    assert lib.dprf_rules_group_shared_bytes(tid, T, ctypes.byref(smem)) == 0
    assert smem.value <= lib.emu_smem_bytes()
    assert lib.dprf_rules_group_launch(
        tid, 0, job.table.ctypes.data, job.lens.ctypes.data,
        job.bc.ctypes.data, job.n_ops.ctypes.data, ctypes.byref(args),
        ctypes.byref(gargs), job.grid, cuda_rules.THREADS, smem.value,
        None) == 0
    _drain(lib)
    words, lens, bc, n_ops = cuda_rules.job_tables(job.gen, "cpu")
    pc, pl, pt, ptc = cuda_rules.rules_group_plain(
        dev.variant, words, lens, bc, n_ops, 0, job.nv, torch.as_tensor(rows),
        cap, job.wb, shift=shift)
    got = sorted((int(a), int(b)) for a, b in zip(lanes, tpos) if a >= 0)
    assert (int(count[0]), got, tcount.tolist()) == (
        int(pc), sorted((int(a), int(b)) for a, b in zip(pl, pt) if a >= 0),
        ptc.tolist())
    for t, p in enumerate(plants):
        assert {(lane, t) for lane, c in job.want.items() if c == p} <= \
            set(got), (t, p)
    assert tcount[T - 1] == 0


@pytest.mark.parametrize("core", ["sha512", "keccak224", "keccak256"])
def test_rules_bounds_take_the_wide_cores(core):
    """``opcount.rules_ops`` counts a wide core's candidates as its mask
    bound counts one of their length (the core to digest word 0 and a
    compare), and the sha512 tails' bound each target's own salt."""
    from dprf_tpu_torch.ops import opcount
    counts = {3: 7, 111 if core == "sha512" else 135: 2}
    got = opcount.rules_ops(core, counts)
    want = [0, 0, 0]
    for length, n in counts.items():
        w = opcount.core_work(core, length, 1)
        want = [want[0] + n * (w["alu"] + 1), want[1] + n * w["add"],
                want[2] + n * w["fma"]]
    assert (got.alu, got.add, got.fma) == tuple(want)
    salts = [b"", b"q" * 32]
    tail = opcount.rules_salted_ops("sha512-ps", {3: 1}, salts)
    pairs = [opcount.salted_pair_work("sha512-ps", 3, s) for s in salts]
    assert tail.alu == sum(p.alu for p in pairs) > 0
