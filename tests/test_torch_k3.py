"""The host side of slice K3's redesigned rule kernel, on the CPU: the
partition of a launch into runs of rules (ops/cuda_rules.rule_runs,
launch_grid, thread_work, the index math csrc/rules.cu does), the word
table with its rows padded to 16 bytes, and numpy mirrors of the
kernel's word formulas -- the SWAR case maps and byte compares, a byte at
a position, the mask and 0x80 marker at the length, the ntlm widen and
the SHA byte swap -- held against the reference's rule interpreter
(dprf_tpu/rules/cpu.apply_rule) and message packing
(dprf_tpu/ops/pack.pack_varlen).

The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py phase 8); here its host mirrors run.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.ops import pack as ref_pack
from dprf_tpu.rules import cpu as ref_cpu
from dprf_tpu.rules import parser as ref_parser
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_rules

from test_torch_rules import RULES, WORDS

pytestmark = pytest.mark.smoke

MAX_LENS = (16, 27, 55)
U32 = 0xFFFFFFFF


# ---- the partition --------------------------------------------------------

#: (n_valid, n_rules): windows cut mid-warp and mid-block, rule counts
#: that no run length divides
PARTITIONS = [(1, 1), (31, 7), (33, 64), (255, 105), (257, 64),
              (1000, 13), (2048, 3)]


@pytest.mark.parametrize("n_valid,n_rules", PARTITIONS)
@pytest.mark.parametrize("wave", [1, 7, 1056])
def test_runs_cover_every_lane_once(n_valid, n_rules, wave):
    """Over the launch's blocks and threads, as the kernel derives them:
    every (word, rule) of the window exactly once, a warp's threads one
    run of rules (so one rule at every step), runs of at most MAX_RUN,
    and a launch of at least MIN_WAVES waves where it has the lanes."""
    run = cuda_rules.rule_runs(n_valid, n_rules, wave)
    assert 1 <= run <= min(n_rules, cuda_rules.MAX_RUN)
    grid = cuda_rules.launch_grid(n_valid, n_rules, run)
    bx = cuda_rules.word_blocks(n_valid)
    assert grid >= min(cuda_rules.MIN_WAVES * wave, bx * n_rules)
    seen = np.zeros((n_rules, n_valid), np.int32)
    for block in range(grid):
        for warp in range(cuda_rules.THREADS // cuda_rules.WARP):
            runs = set()
            for lane in range(cuda_rules.WARP):
                work = cuda_rules.thread_work(
                    block, warp * cuda_rules.WARP + lane, n_valid, n_rules,
                    run)
                if work is None:
                    continue
                b, rules = work
                if b < n_valid:
                    runs.add((rules.start, rules.stop))
                    seen[rules.start:rules.stop, b] += 1
                else:
                    assert len(rules) == 0
            assert len(runs) <= 1
    assert (seen == 1).all()


def test_small_launches_take_runs_of_one_rule():
    """A window that fills fewer than MIN_WAVES waves even at one rule a
    thread gets runs of one rule; best64 over 2^18 words on an H100's
    wave (6 blocks of 256 on 132 SMs) gets runs of ten."""
    assert cuda_rules.rule_runs(32, 64, 1056) == 1
    assert cuda_rules.rule_runs(1 << 18, 64, 6 * 132) == 10
    assert cuda_rules.rule_runs(1 << 18, 100000, 792) == cuda_rules.MAX_RUN


# ---- the word table --------------------------------------------------------

@pytest.mark.parametrize("max_len", [1, 15, 16, 17, 27, 55])
def test_padded_table_is_packed_words_then_zeros(max_len):
    rng = np.random.default_rng(max_len)
    words = [bytes(rng.integers(1, 256, int(n), dtype=np.uint8))
             for n in rng.integers(0, max_len + 1, 40)]
    buf, lens = WordlistRulesGenerator(words, [()], max_len).packed_words()
    table = cuda_rules.pad_rows(torch.as_tensor(buf)).numpy()
    row = cuda_rules.row_bytes(max_len)
    assert row % 16 == 0 and row - 16 < max_len <= row
    assert table.shape == (len(words), row) and table.dtype == np.uint8
    assert (table[:, :max_len] == buf).all()
    assert not table[:, max_len:].any()


# ---- numpy mirrors of the word formulas ------------------------------------

def byte_perm(x, y, sel):
    """__byte_perm: byte i of the result is byte (sel >> 4i) & 7 of the
    eight bytes y:x."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(
        x, np.uint64)
    out = np.zeros(np.shape(both), np.uint64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(
            8 * i)
    return out.astype(np.uint32)


def shl_c(x, s):
    """x << s, 0 for s >= 32 (funnelshift_lc; s >= 0 here)."""
    s = np.asarray(s, np.int64)
    out = (np.uint64(x) << np.minimum(s, 32).astype(np.uint64)) \
        & np.uint64(U32)
    return np.where(s >= 32, 0, out).astype(np.uint32)


def below(k, x):
    """The bytes of word k below position x, as a byte mask."""
    return (~shl_c(U32, np.maximum(8 * (np.asarray(x) - 4 * k), 0))
            ).astype(np.uint32)


def letters(x, lo):
    t = x & np.uint32(0x7F7F7F7F)
    a = (t + np.uint32((0x80 - lo) * 0x01010101)) & np.uint32(U32)
    z = (t + np.uint32((0x80 - lo - 26) * 0x01010101)) & np.uint32(U32)
    return ((a & ~z & ~x & np.uint32(0x80808080)) >> np.uint32(2)).astype(
        np.uint32)


def swar_lower(x):
    return x ^ letters(x, 0x41)


def swar_upper(x):
    return x ^ letters(x, 0x61)


def swar_toggle(x):
    return x ^ letters(x | np.uint32(0x20202020), 0x61)


def zero_bytes(x):
    t = ((x & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) & np.uint32(
        U32)
    return (~(t | x | np.uint32(0x7F7F7F7F))).astype(np.uint32)


def eq_mask(x, c):
    return ((zero_bytes(x ^ np.uint32(c * 0x01010101)) >> np.uint32(7))
            * np.uint32(0xFF)).astype(np.uint32)


def to_words(word: bytes, nw: int):
    """The kernel's layout: byte p in word p >> 2 at bits 8 * (p & 3)."""
    buf = np.zeros(4 * nw, np.uint8)
    buf[:len(word)] = np.frombuffer(word, np.uint8)
    return buf.view("<u4").astype(np.uint32)


def from_words(w, n: int) -> bytes:
    return w.astype("<u4").tobytes()[:n]


def byte_at(w, p):
    """The kernel's byte p: word p >> 2, shifted by 8 * (p & 3); its
    shared-memory offset p * 256 - (p & 3) * 255 is (p >> 2) * 1024 +
    (p & 3)."""
    assert p * 256 - (p & 3) * 255 == (p >> 2) * 1024 + (p & 3)
    return int(byte_perm(w[p >> 2], 0, 0x4440 | (p & 3)))


def kernel_blocks(words: np.ndarray, lens: np.ndarray, engine: str):
    """The message blocks the kernel hashes for candidates (words
    uint32[C, nw] in the kernel's layout, lens int[C]): the words masked
    at n, 0x80 at n, then per core the words as they are (md5), byte
    swapped (SHA) or widened (ntlm), and the bit length."""
    c, nw = words.shape
    k = np.arange(nw)[None, :]
    n = lens[:, None]
    w = words & below(k, n)
    w = w | np.where(k == n >> 2, shl_c(0x80, 8 * (n & 3)), 0).astype(
        np.uint32)
    m = np.zeros((c, 16), np.uint32)
    if engine == "ntlm":
        m[:, 0:2 * nw:2] = byte_perm(w, 0, 0x4140)
        m[:, 1:2 * nw:2] = byte_perm(w, 0, 0x4342)
        m[:, 14] = 16 * lens
    elif engine == "md5":
        m[:, :nw] = w
        m[:, 14] = 8 * lens
    else:
        m[:, :nw] = byte_perm(w, 0, 0x0123)
        m[:, 15] = 8 * lens
    return m


def _mirror_words(max_len):
    """WORDS and a random word of every length 0..max_len, each at most
    max_len bytes."""
    rng = np.random.default_rng(max_len)
    words = [w for w in WORDS if len(w) <= max_len]
    return words + [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                    for n in range(max_len + 1)]


@functools.cache
def _candidates(max_len):
    """The reference's candidates of _mirror_words under RULES."""
    rules = ref_parser.parse_rules(RULES, on_error="skip")
    return sorted({c for word in _mirror_words(max_len) for ops in rules
                   if (c := ref_cpu.apply_rule(word, ops, max_len))
                   is not None})


def _ref(word, line, max_len):
    return ref_cpu.apply_rule(word, ref_parser.parse_rule(line), max_len)


@pytest.mark.parametrize("max_len", MAX_LENS)
def test_swar_maps_match_the_reference(max_len):
    """The case maps and the byte compares on the words that hold the n
    bytes, against the reference's l, u, t, c, C, s, !, / and %."""
    nw = (max_len + 4) // 4
    subs = [(ord("e"), ord("3")), (0, ord("Q")), (ord("a"), 0)]
    for word in _mirror_words(max_len):
        n = len(word)
        w = to_words(word, nw)
        k = np.arange(nw)
        for line, f in (("l", swar_lower), ("u", swar_upper),
                        ("t", swar_toggle)):
            assert from_words(f(w), n) == _ref(word, line, max_len)
        lo, up = swar_lower(w), swar_upper(w)
        cap = np.where(k == 0, (lo & 0xFFFFFF00) | (up & 0xFF), lo)
        inv = np.where(k == 0, (up & 0xFFFFFF00) | (lo & 0xFF), up)
        assert from_words(cap.astype(np.uint32), n) == \
            _ref(word, "c", max_len)
        assert from_words(inv.astype(np.uint32), n) == \
            _ref(word, "C", max_len)
        for c1, c2 in subs:
            m = eq_mask(w, c1)
            if c1 == 0:
                m &= below(k, n)
            got = (w & ~m) | (np.uint32(c2 * 0x01010101) & m)
            ops = (ref_parser.Op(ref_parser.Opcode.SUBSTITUTE, c1, c2),)
            assert from_words(got.astype(np.uint32), n) == \
                ref_cpu.apply_rule(word, ops, max_len)
        # counts over the words that hold the n bytes, less the zeros
        # past n when counting zeros
        kn = (n + 3) // 4
        for c in (0, ord("e"), ord("x"), ord("l")):
            cnt = sum(bin(int(z)).count("1") for z in
                      zero_bytes(w[:kn] ^ np.uint32(c * 0x01010101)))
            cnt -= 0 if c else 4 * kn - n
            assert cnt == word.count(bytes([c]))


@pytest.mark.parametrize("engine,max_len", [
    (e, m) for e in ("md5", "ntlm", "sha256") for m in MAX_LENS
    if not (e == "ntlm" and m > 27)])
def test_block_matches_the_reference_pack(engine, max_len):
    """A byte at a position, the mask and marker at n, the ntlm widen and
    the SHA byte swap against pack_varlen, for every word of
    _mirror_words and every candidate the reference makes of them under
    RULES."""
    nw = (max_len + 4) // 4
    for word in _mirror_words(max_len):
        w = to_words(word, nw)
        assert bytes(byte_at(w, p) for p in range(len(word))) == word
    cands = _candidates(max_len)
    buf = np.zeros((len(cands), 4 * nw), np.uint8)
    for i, c in enumerate(cands):
        buf[i, :len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in cands], np.int64)
    if engine == "ntlm":
        ref = ref_pack.pack_varlen(
            ref_pack.utf16le_widen(jnp.asarray(buf[:, :max_len])),
            jnp.asarray(2 * lens, jnp.int32))
    else:
        ref = ref_pack.pack_varlen(jnp.asarray(buf[:, :max_len]),
                                   jnp.asarray(lens, jnp.int32),
                                   big_endian=engine != "md5")
    got = kernel_blocks(buf.view("<u4").astype(np.uint32), lens, engine)
    assert (got == np.asarray(ref).astype(np.uint32)).all()
