"""The kernel's least-work count (ops/opcount.py), the numerator of the
bound chip_smoke.py prints: its symbolic cores compute the real hashes,
fixed message words fold away, and the pipe balance is the closed form
its docstring states.  Exact equality throughout."""

import struct

import numpy as np
import pytest
import torch

from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.ops import cuda_mask, opcount
from dprf_tpu_torch.ops.opcount import Var, Work

ENGINES = ["md5", "ntlm", "sha1", "sha256"]


def _var():
    return Var("alu", 0, [])


@pytest.mark.parametrize("engine", ENGINES)
def test_symbolic_core_computes_the_hash(engine):
    """Over fixed words the counted formulas are the core itself."""
    eng = cuda_mask.device_engine(engine)
    rng = np.random.default_rng(7)
    for length in (0, 1, 7, eng.max_candidate_len):
        cand = rng.integers(32, 127, length, dtype=np.uint8)
        block = eng.pack(torch.as_tensor(cand).reshape(1, length), length)
        words = [int(w) for w in block.numpy()[0].view(np.uint32)]
        state = opcount.state_words(engine, words)
        init = opcount.CORES[eng.name][1]
        digest = struct.pack(("<" if eng.little_endian else ">")
                             + f"{len(state)}I",
                             *((s + int(i)) & 0xFFFFFFFF
                               for s, i in zip(state, init)))
        assert digest == get_engine(engine).hash_batch([cand.tobytes()])[0]


def test_fold_rules():
    v = _var()
    assert opcount.add(3, 4) == 7
    assert opcount.add(v, 0) is v                  # a zero term vanishes
    assert opcount.add(v, 5, 7).n == 1             # constants fold into one
    assert opcount.add(v, v, v, 1).n == 2          # four terms: two IADD3
    assert opcount.xor(v, v, v, v).n == 2
    assert opcount.rotl(0x80000000, 1) == 1
    assert opcount.logic(opcount._choose, 1, 2, 3) == 2


def test_every_word_variable_gives_the_textbook_count():
    """All 16 words depend on the candidate: only the constant initial
    state folds.  sha256: 63 full rounds of 10 ALU ops (6 SHF and 4
    LOP3) and 4 IADD3, round 0 three adds, 48 schedule words of 8 ALU
    ops and 2 IADD3.  md5: 64 steps of LOP3 + IADD3 + LEA.HI with a
    second IADD3 for the word, less what the constant state folds in
    steps 0-3."""
    words = [_var() for _ in range(16)]
    assert opcount.tally(opcount.state_words("sha256", words)) == {
        "alu": 63 * 10 + 48 * 8, "add": 3 + 63 * 4 + 48 * 2, "fma": 0}
    assert opcount.tally(opcount.state_words("md5", words)) == {
        "alu": 1 + 63 * 2, "add": 4 + 60 * 2, "fma": 0}


def test_fixed_words_and_unread_steps_cost_nothing():
    # ?a^7: only words 0 and 1 hold candidate bytes.  sha256's schedule
    # words 16-30 take a fixed word's sigma0 or sigma1 (W16 s1(W14),
    # W17 both, W18-W30 s0(W3..W15)): 16 sigmas of 4 ALU ops fold away
    full = opcount.tally(opcount.state_words("sha256",
                                             [_var() for _ in range(16)]))
    assert opcount.core_work("sha256", 7, 8)["alu"] == full["alu"] - 16 * 4
    # a single target reads digest word 0: md5 skips steps 61-63
    assert opcount.core_work("md5", 6, 1)["alu"] == \
        opcount.core_work("md5", 6, 4)["alu"] - 6


def test_ops_per_candidate_at_the_measured_masks():
    assert opcount.ops_per_candidate("md5", 6) == Work(128, 73, 12)
    assert opcount.ops_per_candidate("ntlm", 7) == Work(97, 60, 14)
    assert opcount.ops_per_candidate("sha1", 7) == Work(410, 162, 14)
    assert opcount.ops_per_candidate("sha-256", 7) == Work(958, 336, 14)
    multi = opcount.ops_per_candidate("ntlm", 7, True, probes=1.0)
    # words 1-2 add md4 steps 45-47, then the feed-forward and a probe
    assert multi == Work(107, 66, 14)


def test_slots_balance_the_adds_between_pipes():
    assert Work(10, 0, 0).slots == 10
    assert Work(0, 3, 0).slots == 2            # two on the ALU, one as 2 IMAD
    assert Work(0, 0, 5).slots == 5
    assert Work(10, 100, 4).slots == pytest.approx((20 + 4 + 200) / 3)
    assert Work(100, 10, 0).slots == 100


def test_rule_kernel_counts_at_fixed_lengths():
    """A rule-kernel candidate of length n: the core to digest word 0
    with that length's padding and bit length folded, plus one compare.
    An 8-byte candidate differs from ?a^8 only in the decode the rule
    kernel does not count."""
    assert opcount.rules_ops("md5", {8: 1}) == Work(122, 67, 0)
    assert opcount.rules_ops("ntlm", {8: 1}) == Work(90, 53, 0)
    assert opcount.rules_ops("sha1", {8: 1}) == Work(404, 155, 0)
    assert opcount.rules_ops("sha256", {8: 1}) == Work(951, 330, 0)
    for engine in ENGINES:
        mask = opcount.ops_per_candidate(engine, 8)
        assert opcount.rules_ops(engine, {8: 1}) == \
            Work(mask.alu - 8, mask.add - 8, mask.fma - 16)
        # an empty candidate is a constant block: only the compare
        assert opcount.rules_ops(engine, {0: 1}) == Work(1, 0, 0)
        assert opcount.rules_ops(engine, {8: 3, 0: 2}) == Work(
            3 * opcount.rules_ops(engine, {8: 1}).alu + 2,
            3 * opcount.rules_ops(engine, {8: 1}).add, 0)


def test_rule_lengths_and_the_averaged_count():
    """Lengths over a toy list x rules, rejections left out (at max_len
    24: "d" of a 20-byte word, "<5" of 8- and 20-byte words, "p3" of
    both), and the work summed over them."""
    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.rules import parse_rule
    gen = WordlistRulesGenerator(
        [b"abc", b"password", b"x" * 20],
        [parse_rule(r) for r in (":", "d", "$1 $2", "<5", "p3")], max_len=24)
    lengths = opcount.rule_lengths(*gen.packed_words(), gen.rules, 24)
    assert lengths == {3: 2, 5: 1, 6: 1, 8: 1, 10: 1, 12: 1, 16: 1, 20: 1,
                       22: 1}
    assert lengths == {n: sum(1 for i in range(gen.keyspace)
                              if len(gen.candidate(i) or b"\0" * 99) == n)
                       for n in lengths}
    assert opcount.rules_ops("md5", lengths) == Work(1220, 695, 0)
    assert opcount.rules_ops("sha256", lengths) == Work(9498, 3307, 0)


def test_sha1_from_any_state_is_the_compression():
    """Over fixed words and a fixed chaining state the counted SHA-1 is
    ops/sha1.sha1_compress (HMAC's compressions chain from keyed
    states)."""
    from dprf_tpu_torch.ops import sha1
    rng = np.random.default_rng(11)
    state = [int(x) for x in rng.integers(0, 2 ** 32, 5, dtype=np.uint64)]
    words = [int(x) for x in rng.integers(0, 2 ** 32, 16, dtype=np.uint64)]
    out = [(a + b) & 0xFFFFFFFF
           for a, b in zip(opcount._sha1(words, state), state)]
    want = sha1.sha1_compress(
        torch.as_tensor(np.array(state, np.uint32).view(np.int32)),
        torch.as_tensor(np.array(words, np.uint32).view(np.int32)))
    assert out == [int(x) for x in want.numpy().view(np.uint32)]


def test_pmkid_and_bcrypt_counts():
    """PMKID at 4096 iterations: 16,390 compressions (4 key states, 2
    fixed first blocks, 16,384 of 20-byte messages incl. one target),
    the 20-byte ones at 416 ALU + 165 IADD3 with the padding folded.
    bcrypt: 16 rounds x 521 encryptions x 2 ExpandKeys per cost round
    (+ setup, finish), 10 slots a round."""
    assert opcount.pmkid_compressions(4096) == {"key": 4, "first": 2,
                                                "block20": 16384}
    v = [_var() for _ in range(16)]
    block20 = v[:5] + [0x80000000] + [0] * 9 + [672]
    assert opcount.sha1_compress_work(True, block20) == \
        {"alu": 416, "add": 165, "fma": 0}
    assert opcount.pmkid_ops(8, 4096) == Work(6858894, 2704330, 16)
    assert opcount.BCRYPT_ROUND.slots == 10
    assert opcount.bcrypt_rounds(4096, True, True) == 68299920
    lim = opcount.bcrypt_bound(32, 16 * 521, 1, 1e9, 32)
    assert lim["shared"] == 32 * 16 * 521 * 4 / 32 / 1e9
    assert lim["latency"] == 16 * 521 * opcount.BCRYPT_ROUND_LATENCY / 1e9


def _digest(engine: str, words: list) -> bytes:
    """The symbolic core over fixed words, with its feed-forward, as
    digest bytes."""
    eng = cuda_mask.device_engine(engine)
    state = opcount.state_words(engine, words)
    init = opcount.CORES[eng.name][1]
    return struct.pack(("<" if eng.little_endian else ">") + f"{len(state)}I",
                       *((s + int(i)) & 0xFFFFFFFF
                         for s, i in zip(state, init)))


@pytest.mark.parametrize("name", ["md5(md5)", "sha1(sha1)", "md5(sha1)",
                                  "sha1(md5)", "sha256(md5)",
                                  "sha256(sha1)"])
def test_symbolic_nested_chain_computes_the_hash(name):
    """Over fixed words the counted chain -- the inner core over the
    job's block (``cuda_ext.nested_block`` with the candidate's bytes),
    the hex of its digest, the outer core over the hex block -- is the
    oracle's nested hash."""
    from dprf_tpu_torch.ops import cuda_ext
    from dprf_tpu_torch.ops.pack import pack_fixed
    outer, inner = cuda_ext.NESTED_COMBOS[name]
    rng = np.random.default_rng(17)
    for length in (1, 7, 55):
        cand = rng.integers(32, 127, length, dtype=np.uint8)
        eng = cuda_mask.device_engine(inner)
        words = eng.pack(torch.as_tensor(cand).reshape(1, length),
                         length).numpy()[0].view(np.uint32)
        block = cuda_ext.nested_block(name, length)
        # the candidate's words over the job's fixed words
        assert all((b & w) == b for b, w in zip(block, words))
        hexd = _digest(inner, [int(w) for w in words]).hex().encode()
        block2 = pack_fixed(torch.as_tensor(np.frombuffer(hexd, np.uint8)
                                            .copy()).reshape(1, -1), len(hexd), big_endian=not
                            cuda_mask.device_engine(outer).little_endian)
        got = _digest(outer, [int(w) for w in
                              block2.numpy()[0].view(np.uint32)])
        assert got == get_engine(name).hash_batch([cand.tobytes()])[0]


@pytest.mark.parametrize("variant", ["md5-ps", "md5-sp", "sha1-ps",
                                     "sha1-sp", "sha256-ps", "sha256-sp"])
def test_symbolic_salted_core_computes_the_hash(variant):
    """A target's fixed words (``cuda_ext.salted_block``: its salt,
    marker and bit length) with the candidate's bytes placed at [0, L)
    (ps) or [S, S + L) (sp) are the message, and through the symbolic
    core give the oracle's salted hash; every word the count takes as
    constant is the message's own."""
    from dprf_tpu_torch.ops import cuda_ext
    algo, order = cuda_ext.split_salted(variant)
    eng = cuda_mask.device_engine(algo)
    rng = np.random.default_rng(19)
    for length, n in ((1, 0), (6, 3), (6, 11), (23, 32)):
        salt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        cand = bytes(rng.integers(32, 127, length, dtype=np.uint8))
        first = 0 if order == "ps" else n
        full_msg = cand + salt if order == "ps" else salt + cand
        full = eng.pack(torch.as_tensor(np.frombuffer(full_msg, np.uint8)
                                        .copy()).reshape(1, -1),
                        len(full_msg)).numpy()[0].view(np.uint32)
        block = cuda_ext.salted_block(variant, length, salt)
        varying = range(first // 4, (first + length - 1) // 4 + 1)
        # the count's constant words are the message's own
        assert all(block[w] == full[w] for w in range(16)
                   if w not in varying)
        assert all(block[w] | full[w] == full[w] for w in varying)
        assert _digest(algo, [int(w) for w in full]) == get_engine(
            variant).hash_batch([cand], params={"salt": salt})[0]


def test_nested_and_salted_counts():
    """The counts chip_smoke.py's bounds use.  A nested candidate: the
    decode, the inner core with every digest word and its feed-forward,
    HEX_WORD per inner word (9 ALU, 4 IADD3, 2 IMAD), the outer core up
    to the compared words.  A salted one: the core with the target's
    salt folded, the candidate's words variable."""
    assert opcount.HEX_WORD == Work(9, 4, 2)
    assert opcount.nested_ops("md5(md5)", 7) == Work(292, 185, 22)
    assert opcount.nested_ops("sha1(sha1)", 7) == Work(869, 345, 24)
    assert opcount.nested_ops("sha256(sha1)", 7) == Work(1438, 526, 24)
    assert opcount.nested_ops("mysql41", 6) == Work(820, 324, 12)
    # words 0-2 of the outer md5: three more steps, their feed-forward,
    # one Bloom probe
    assert opcount.nested_ops("md5(md5)", 7, True, probes=1.0) == \
        Work(302, 192, 22)
    # ps at [0, 6) is the unsalted md5 of ?l^6 (salt words are constants)
    assert opcount.salted_ops("md5-ps", 6, b"x" * 11) == \
        opcount.ops_per_candidate("md5", 6)
    assert opcount.salted_ops("md5-sp", 6, b"x" * 11) == Work(124, 73, 12)
    assert opcount.salted_ops("sha256-sp", 6, b"x" * 11) == \
        Work(937, 329, 12)


def test_grouped_counts():
    """The grouped kernels' counts.  Salted: a group of one is the
    per-target count; a group of T shares the decode (one add, two IMAD
    and one ALU op a position) T ways and keeps the core and compare
    per hash.  krb5: a group of one ticket is the per-ticket count; at
    T tickets the decode, the NT hash and K1's six compressions are
    shared T ways, K3's two compressions, RC4 and the compare stay per
    ticket, as do RC4's shared accesses (the decode's table reads are
    shared)."""
    for variant in ("md5-ps", "sha1-sp", "sha256-ps"):
        one = opcount.salted_ops(variant, 6, b"x" * 11)
        assert opcount.salted_ops(variant, 6, b"x" * 11, group=1) == one
        for t in (2, 32, 256):
            got = opcount.salted_ops(variant, 6, b"x" * 11, group=t)
            assert got == Work(one.alu - 6 + 6 / t, one.add - 6 + 6 / t,
                               one.fma - 12 + 12 / t)
    assert opcount.salted_ops("md5-ps", 6, b"x" * 11, 32) == \
        Work(122 + 6 / 32, 67 + 6 / 32, 12 / 32)
    one = opcount.krb5_ops(8)
    assert opcount.krb5_ops(8, 1) == one == Work(1961, 1236, 16)
    v = [_var() for _ in range(4)]
    key = opcount.md5_compress_work(False, v + [0x36363636] * 12)
    inner = opcount.md5_compress_work(True, [2, 0x80] + [0] * 12
                                      + [(64 + 4) * 8, 0])
    outer = opcount.md5_compress_work(True, v + [0x80] + [0] * 9
                                      + [640, 0])
    shared = {p: 4 * key[p] + inner[p] + outer[p] for p in key}
    for t in (2, 100, 128):
        got = opcount.krb5_ops(8, t)
        md4_and_decode = {
            "alu": one.alu - 4 * key["alu"] - 2 * inner["alu"]
            - 2 * outer["alu"] - 16 - 268 * 3 - 4 * 4 - 2,
            "add": one.add - 4 * key["add"] - 2 * inner["add"]
            - 2 * outer["add"] - 268 * 2 - 4 * 2,
            "fma": one.fma}
        per_ticket_alu = one.alu - shared["alu"] - md4_and_decode["alu"]
        assert got.alu == pytest.approx(
            per_ticket_alu + (shared["alu"] + md4_and_decode["alu"]) / t)
        assert got.fma == pytest.approx(16 / t)
        assert got.slots < one.slots
    lim1 = opcount.krb5_bound(1 << 24, 8, 132, 1.98e9)
    lim = opcount.krb5_bound(1 << 24, 8, 132, 1.98e9, 100)
    assert lim["shared"] == pytest.approx(
        ((1 << 24) * 100 * opcount.RC4_SHARED + (1 << 24) * 8)
        / (132 * 32 * 1.98e9))
    assert lim["issue"] == pytest.approx(
        (1 << 24) * 100 * opcount.krb5_ops(8, 100).slots
        / (132 * 64 * 1.98e9))
    assert lim["shared"] < 100 * lim1["shared"]


@pytest.mark.parametrize("engine", ["sha512", "sha384", "sha3-224",
                                    "keccak-256", "sha3-384", "keccak512"])
def test_symbolic_wide_core_computes_the_hash(engine):
    """Over fixed words the 64-bit counts -- sha512 / sha384 on (hi, lo)
    pairs with the 64-bit feed-forward, Keccak-f over the absorbed rate
    block and its squeeze -- are the oracle's hash."""
    eng = get_engine(engine, "cuda", torch_device="cpu")
    rng = np.random.default_rng(23)
    for length in (0, 1, 7, eng.max_candidate_len):
        cand = rng.integers(32, 127, length, dtype=np.uint8)
        block = eng.pack(torch.as_tensor(cand).reshape(1, length), length)
        words = [int(w) for w in block.numpy()[0].view(np.uint32)]
        state = opcount.state_words(engine, words)
        if opcount.is_sponge(eng):
            digest = struct.pack(f">{len(state)}I", *state)
        else:
            init = opcount.CORES[eng.name][1]
            digest = b"".join(
                (((state[2 * i] << 32 | state[2 * i + 1]) + v)
                 & (1 << 64) - 1).to_bytes(8, "big")
                for i, v in enumerate(init))[:eng.digest_size]
        assert digest == get_engine(engine).hash_batch([cand.tobytes()])[0]


def test_64_bit_fold_rules():
    v = _var()
    assert opcount.add64((1, 0xFFFFFFFF), (0, 1)) == (2, 0)
    hi, lo = opcount.add64((v, 0), (1, 5))             # fixed low halves
    assert lo == 5 and hi.n == 1
    hi, lo = opcount.add64((v, v), (v, v))
    assert (hi.n, lo.n) == (1, 1) and lo in hi.deps   # IADD3, IADD3.X
    hi, lo = opcount.add64((3, v), (4, 0))             # a lone low term
    assert hi == 7 and lo is v
    assert opcount.rotr64((v, 7), 32) == (7, v)        # a swap is free
    hi, lo = opcount.rotr64((v, 7), 40)
    assert (hi.n, lo.n) == (1, 1)
    assert opcount.rotl64((0x80000000, 0), 1) == (0, 1)
    assert opcount.xor64((v, 1), (v, 2), (v, 4))[1] == 7
    assert opcount.shr64((0, 0x100), 8) == (0, 1)


def test_wide_counts_at_the_measured_masks():
    """The counts chip_smoke.py's bounds use for ?a^7: sha512 ~2.5 times
    sha256's 958 slots; Keccak-f ~4,300 slots, all ALU, the same at
    every rate (the capacity lanes are zero, the rate's padding fixed)."""
    assert opcount.ops_per_candidate("sha512", 7) == Work(2428, 851, 14)
    assert opcount.ops_per_candidate("sha-384", 7) == Work(2428, 851, 14)
    for name, alu in (("sha3-224", 4284), ("sha3-256", 4285),
                      ("keccak-384", 4284), ("keccak512", 4284)):
        assert opcount.ops_per_candidate(name, 7) == Work(alu, 7, 14)
    # a list: lanes 0-1 for words 0-2, one probe, no feed-forward
    multi = opcount.ops_per_candidate("sha3-256", 7, True, probes=1.0)
    assert multi.add == 7 and multi.alu > 4285 + 5


def test_md5_from_any_state_is_the_compression():
    """Over fixed words and a fixed chaining state the counted MD5 is
    ops/md5.md5_compress (the HMAC-MD5 compressions of the krb5 kernel
    chain from keyed states)."""
    from dprf_tpu_torch.ops import md5
    rng = np.random.default_rng(12)
    state = [int(x) for x in rng.integers(0, 2 ** 32, 4, dtype=np.uint64)]
    words = [int(x) for x in rng.integers(0, 2 ** 32, 16, dtype=np.uint64)]
    out = [(a + b) & 0xFFFFFFFF
           for a, b in zip(opcount._md5(words, state), state)]
    want = md5.md5_compress(
        torch.as_tensor(np.array(state, np.uint32).view(np.int32)),
        torch.as_tensor(np.array(words, np.uint32).view(np.int32)))
    assert out == [int(x) for x in want.numpy().view(np.uint32)]


def test_krb5_and_kdf_counts():
    """krb5: one MD4 block, 8 MD5 compressions (4 key states from the IV,
    2 inner over a message fixed per launch or ticket, 2 outer), 268 RC4
    steps and 4 kept bytes; its shared accesses; the two limits.  A
    group of one ticket counts the per-ticket launch's work: K3's inner
    and outer per ticket, the rest per candidate.  The KDF: the PMKID
    count without the PMK's states and targets, one PBKDF2 block for 4
    words, two for 8 (8,194 and 16,386 compressions at 4096)."""
    per_cand, per_ticket = (opcount.krb5_compressions(t)
                            for t in (False, True))
    assert per_cand == {"key": 4, "inner": 1, "outer": 1}
    assert per_ticket == {"key": 0, "inner": 1, "outer": 1}
    assert {k: per_cand[k] + per_ticket[k] for k in per_cand} == \
        {"key": 4, "inner": 2, "outer": 2}
    v = [_var() for _ in range(4)]
    assert opcount.md5_compress_work(True, v + [0x80] + [0] * 9
                                     + [640, 0]) == \
        {"alu": 128, "add": 84, "fma": 0}
    assert opcount.krb5_ops(8) == Work(1961, 1236, 16)
    assert opcount.RC4_SHARED == 64 + 4 * 268 + 4
    lim = opcount.krb5_bound(1 << 24, 8, 132, 1.98e9)
    assert lim["shared"] == (1 << 24) * (opcount.RC4_SHARED + 8) / (
        132 * 32 * 1.98e9)
    assert lim["issue"] == (1 << 24) * opcount.krb5_ops(8).slots / (
        132 * 64 * 1.98e9)
    assert [sum(opcount.kdf_compressions(4096, n).values())
            for n in (4, 8)] == [8194, 16386]
    assert opcount.kdf_ops(8, 4096, 4) == Work(3429033, 1352004, 16)
    assert opcount.kdf_ops(8, 4096, 8) == Work(6857204, 2703684, 16)


def test_sha256_from_any_state_is_the_compression():
    """Over fixed words and a fixed chaining state the counted SHA-256 is
    ops/sha256.sha256_compress (the 7-Zip KDF's compressions chain)."""
    from dprf_tpu_torch.ops import sha256
    rng = np.random.default_rng(13)
    state = [int(x) for x in rng.integers(0, 2 ** 32, 8, dtype=np.uint64)]
    words = [int(x) for x in rng.integers(0, 2 ** 32, 16, dtype=np.uint64)]
    out = [(a + b) & 0xFFFFFFFF
           for a, b in zip(opcount._sha256(words, state), state)]
    want = sha256.sha256_compress(
        torch.as_tensor(np.array(state, np.uint32).view(np.int32)),
        torch.as_tensor(np.array(words, np.uint32).view(np.int32)))
    assert out == [int(x) for x in want.numpy().view(np.uint32)]


@pytest.mark.parametrize("length,salt_len,cycles", [(8, 0, 19), (3, 0, 8),
                                                    (8, 16, 10), (1, 4, 7)])
def test_sevenzip_counts(length, salt_len, cycles):
    """The KDF's compressions are the blocks hashlib's SHA-256 runs over
    the stream (it ends on a block boundary, so one padding block
    follows), each a compression with every word and the state variable:
    1,024 ALU + 360 IADD3; the bound is its slots over the pipes."""
    unit = salt_len + 2 * length + 8
    stream = unit << cycles
    assert stream % 64 == 0
    n = opcount.sevenzip_compressions(length, salt_len, cycles)
    assert n == stream // 64 + 1 == -(-(stream + 9) // 64)
    v = [_var() for _ in range(16)]
    assert opcount.sha256_compress_work(True, v) == \
        {"alu": 1024, "add": 360, "fma": 0}
    work = opcount.sevenzip_ops(length, salt_len, cycles)
    assert work == Work(1024 * n + length, 360 * n + length, 2 * length)
    lim = opcount.sevenzip_bound(1 << 18, length, salt_len, cycles, 132,
                                 1.98e9)
    assert lim == {"issue": (1 << 18) * work.slots / (132 * 64 * 1.98e9)}


def test_pdf_counts():
    """PDF: RC4's shared accesses a candidate, 64 + 256 x 4 + kept x 5 a
    run (R2 one run of 4 kept bytes: 1,108; R3+ 20 of 16: 23,360); the
    MD5 compressions (2, and 50 more for the stretch); the two limits."""
    assert opcount.pdf_shared(2) == 64 + 256 * 4 + 4 * 5 == 1108
    assert opcount.pdf_shared(3) == 20 * (64 + 256 * 4 + 16 * 5) == 23360
    assert opcount.pdf_compressions(2) == {"block1": 1, "block2": 1,
                                           "stretch": 0}
    assert sum(opcount.pdf_compressions(3).values()) == 52
    r2, r3 = opcount.pdf_ops(6, 2, 5), opcount.pdf_ops(6, 3, 16)
    assert r3.alu > 20 * 256 * opcount.RC4_STEP.alu > r2.alu > \
        256 * opcount.RC4_STEP.alu
    for rev, key_len in ((2, 5), (3, 5), (3, 16)):
        lim = opcount.pdf_bound(1 << 24, 6, rev, key_len, 132, 1.98e9)
        assert lim["shared"] == (1 << 24) * (opcount.pdf_shared(rev) + 6) / (
            132 * 32 * 1.98e9)
        assert lim["issue"] == (1 << 24) * opcount.pdf_ops(
            6, rev, key_len).slots / (132 * 64 * 1.98e9)
