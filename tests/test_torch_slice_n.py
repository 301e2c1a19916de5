"""Slice N on the CPU: the rules kernel's new cores (sha224, mysql323, the
nested chains) and its group tails (the salted variants, Kerberos etype
23) in plain PyTorch, against the reference on the same seeded numpy
inputs.  Every kept (word, rule) candidate and its digest words -- a
salted tail's per target -- equal the reference's rule interpreter's and
oracle's; every worker's (target, keyspace index, plaintext) hits equal
the reference CpuWorker's; a rejecting rule among the rules, plants at
the first, the last and a seeded (word, rule) position.  The reference's
XLA wordlist workers (DeviceWordlistWorker, SaltedWordlistWorker,
Krb5WordlistWorker), whose compiles take seconds each, are held against
the port end to end, one name a family, in test_torch_slice_n_jax*.py.
No interpret mode runs here.
"""

import numpy as np
import pytest
import torch

from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.generators.wordlist import \
    WordlistRulesGenerator as RefWordlistRulesGenerator
from dprf_tpu.rules.cpu import apply_rule as ref_apply_rule
from dprf_tpu.rules.parser import parse_rule as ref_parse_rule
from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.cpu.krb5 import der, encrypt
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_ext, cuda_rules
from dprf_tpu_torch.rules.parser import parse_rule
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

#: a few words (an empty one, one at max_len's edge for the salted
#: cores) and rules: case maps, appends, a reversal, a duplication, and
#: "<6", which rejects a word of 6 or more bytes
WORDS = [b"alpha", b"", b"Bravo9", b"charlie", b"d3lta", b"x" * 20,
         b"echo", b"f"]
RULES = [":", "c", "u $1", "r", "d", "<6", "$! ^#", "T0 ]"]
NEW_CORES = [c for c in cuda_rules.KERNEL_CORES if c not in
             ("md5", "ntlm", "sha1", "sha256")]


def _gens(max_len):
    return (WordlistRulesGenerator(WORDS, [parse_rule(r) for r in RULES],
                                   max_len),
            RefWordlistRulesGenerator(WORDS, [ref_parse_rule(r)
                                              for r in RULES], max_len))


def _plants(gen, seed):
    """The first, the last and a seeded keyspace index whose rule keeps
    its candidate, each candidate once."""
    rng = np.random.default_rng(seed)
    out = []
    for i in [0, gen.keyspace - 1] + [int(x) for x in rng.integers(
            1, gen.keyspace - 1, 8)]:
        c = gen.candidate(i)
        if c is not None and c not in [gen.candidate(j) for j in out]:
            out.append(i)
    return out[:3]


def _hits(hits):
    return sorted((h.target_index, h.cand_index, h.plaintext) for h in hits)


@pytest.mark.parametrize("engine", NEW_CORES)
def test_core_digests_and_hits_match_the_reference(engine):
    """Every (word, rule) lane of a window: kept where the reference's
    rule interpreter keeps it, and its digest words the reference
    oracle's; the worker over two targets (one a plant) finds the
    reference CpuWorker's hits."""
    gen, ref_gen = _gens(55)
    eng = get_engine(engine, "cuda", torch_device="cpu")
    buf, lens = gen.packed_words()
    bc, n_ops = cuda_rules.rule_tables(gen.rules)
    wb = 32
    digest, valid = cuda_rules._digest_plain(
        eng, torch.as_tensor(buf), torch.as_tensor(lens), bc, n_ops, 0,
        len(WORDS), wb)
    ref_oracle = ref_get_engine(engine)
    dt = "<u4" if eng.little_endian else ">u4"
    for r, rule in enumerate(ref_gen.rules):
        for b, word in enumerate(WORDS):
            c = ref_apply_rule(word, rule, 55)
            lane = r * wb + b
            assert bool(valid[lane]) == (c is not None), (word, r)
            if c is not None:
                assert digest[lane].numpy().view(np.uint32).astype(dt) \
                    .tobytes() == ref_oracle.hash_batch([c])[0]
    _check_worker(engine, gen, ref_gen, _lines(engine, [
        gen.candidate(_plants(gen, len(engine))[-1]), b"\x7fnot-a-word"]))


def _check_worker(engine, gen, ref_gen, lines):
    """The port's wordlist worker on CPU tensors finds the reference
    CpuWorker's hits."""
    oracle = get_engine(engine)
    targets = [oracle.parse_target(t) for t in lines]
    ref_t = [ref_get_engine(engine).parse_target(t) for t in lines]
    unit = (0, gen.keyspace)
    worker = get_engine(engine, "cuda", torch_device="cpu") \
        .make_wordlist_worker(gen, targets, 256, 8, oracle)
    got = _hits(worker.process(WorkUnit(0, *unit)))
    ref_worker = RefCpuWorker(ref_get_engine(engine), ref_gen, ref_t)
    assert got == _hits(ref_worker.process(RefWorkUnit(0, *unit)))
    assert len(got) >= 1
    return worker, got


def _lines(engine, cands):
    oracle = get_engine(engine)
    out = []
    for c in cands:
        d = oracle.hash_batch([c])[0]
        out.append("*" + d.hex().upper() if engine == "mysql41" else d.hex())
    return out


#: the salted names: (engine, max_len, the targets' salts)
SALTED = [("md5-ps", 23, [b"", b"s", b"NaCl:\x00", b"x" * 32]),
          ("md5-sp", 23, [b"pepper", b"PEPPER"]),
          ("sha1-ps", 23, [b"ab", b"\xff" * 31]),
          ("sha1-sp", 23, [b"", b""]),
          ("sha256-ps", 23, [b"salt", b"t" * 9]),
          ("sha256-sp", 23, [b"q" * 32]),
          ("postgres", 23, [b"admin", b"svc"]),
          ("mssql2000", 25, [b"\x01\x02\x03\x04"]),
          ("mssql2005", 25, [b"\xfe\xff\x00\x01", b"abcd"])]


def _salted_line(engine, digest, salt):
    if engine.startswith("mssql"):
        case = digest.hex() if engine == "mssql2000" else ""
        return f"0x0100{salt.hex()}{case}{digest.hex()}".upper()
    if engine == "postgres":
        return f"md5{digest.hex()}:{salt.decode()}"
    return f"{digest.hex()}:$HEX[{salt.hex()}]"


@pytest.mark.parametrize("engine,max_len,salts", SALTED)
def test_salted_tail_matches_the_reference(engine, max_len, salts):
    """Each (kept candidate, target) digest of the salted tail's plain
    version equals the reference oracle's; the worker (its groups: every
    ps target, sp by salt length) finds the reference CpuWorker's hits,
    one plant a target and a last target no candidate reaches."""
    gen, ref_gen = _gens(max_len)
    oracle = get_engine(engine)
    dev = get_engine(engine, "cuda", torch_device="cpu")
    plants = _plants(gen, len(engine))
    lines = []
    for i, salt in enumerate(salts + [b"zzzz"]):
        c = gen.candidate(plants[i % len(plants)]) if i < len(salts) \
            else b"\x7f" * 3
        lines.append(_salted_line(engine, oracle.hash_batch(
            [c], params={"salt": salt})[0], salt))
    targets = [oracle.parse_target(t) for t in lines]
    buf, lens = gen.packed_words()
    bc, n_ops = cuda_rules.rule_tables(gen.rules)
    cand, clen, kept = cuda_rules._expand_plain(
        torch.as_tensor(buf), torch.as_tensor(lens), bc, n_ops, 0,
        len(WORDS), 32)
    ref_oracle = ref_get_engine(engine)
    dt = "<u4" if dev.algo == "md5" else ">u4"
    for t in targets:
        rows = cuda_ext.salted_rule_rows(dev.variant, [
            (t.params["salt"], [0] * dev.digest_words)], max_len)
        digests = cuda_ext.salted_rule_digests(
            dev.variant, cand, clen, torch.as_tensor(rows.view(np.int32)),
            dev.byte_map is not None)[:, 0]
        for lane in np.flatnonzero(kept.numpy()):
            c = bytes(cand[lane, :clen[lane]].numpy())
            want = ref_oracle.hash_batch([c], params=t.params)[0]
            got = digests[lane].numpy().view(np.uint32).astype(dt).tobytes()
            assert got == want[-len(got):], (c, t.raw)
    _, hits = _check_worker(engine, gen, ref_gen, lines)
    assert {h[0] for h in hits} == set(range(len(salts)))


def _ticket(password, asrep, seed):
    rng = np.random.default_rng(seed)
    plain = bytes(rng.integers(0, 256, 8, dtype=np.uint8)) + der(
        0x79 if asrep else 0x63, der(0x30, bytes(rng.integers(
            0, 256, 60 + seed, dtype=np.uint8))))
    chk, edata = encrypt(password, 8 if asrep else 2, plain)
    if asrep:
        return f"$krb5asrep$23$u@R:{chk.hex()}${edata.hex()}"
    return f"$krb5tgs$23$*u$R$s*${chk.hex()}${edata.hex()}"


@pytest.mark.parametrize("engine", ["krb5tgs", "krb5asrep"])
def test_krb5_tail_matches_the_reference(engine):
    """The Kerberos tail's worker (tickets grouped by msg_type, every
    maybe confirmed by the oracle) finds the reference CpuWorker's hits:
    a ticket a plant, and one no candidate opens; no false maybe."""
    gen, ref_gen = _gens(27)
    plants = _plants(gen, 7)
    lines = [_ticket(gen.candidate(p), engine == "krb5asrep", i)
             for i, p in enumerate(plants)] + [
        _ticket(b"no such word", engine == "krb5asrep", 9)]
    worker, hits = _check_worker(engine, gen, ref_gen, lines)
    assert len(hits) >= len(plants) and worker.n_maybe() == 0


def test_group_rows_and_refusals():
    """The salted rows hold each salt (ps with its marker) where the
    kernel reads it; a salt past the block beside max_len and a mixed sp
    group raise; the tails' launch counts exist; a sha512 salted
    wordlist whose candidate and salt pass the 128-byte block is refused
    naming --device cpu (one that fits has a worker, csrc/rules_wide.cu's
    tail); the kernel's wrapper refuses CPU tensors and the plain version
    a tail it has not."""
    rows = cuda_ext.salted_rule_rows("md5-ps", [(b"ab", [1, 2, 3, 4])], 23)
    at = cuda_ext.RULE_SALT_AT
    assert rows[0, at:at + 2].tolist() == [0x00806261, 0]
    assert rows[0, cuda_ext.RULE_DIGEST_AT:cuda_ext.RULE_DIGEST_AT + 4] \
        .tolist() == [1, 2, 3, 4]
    assert rows[0, cuda_ext.RULE_SALT_BITS] == 16
    sp = cuda_ext.salted_rule_rows("sha1-sp", [(b"ab", [0] * 5)], 23)
    assert sp[0, at] == 0x61620000
    with pytest.raises(ValueError, match="exceeds"):
        cuda_ext.salted_rule_rows("md5-ps", [(b"x" * 32, [0] * 4)], 24)
    with pytest.raises(ValueError, match="one length"):
        cuda_ext.salted_rule_rows("md5-sp", [(b"a", [0] * 4),
                                             (b"ab", [0] * 4)], 23)
    assert {f"{t}_rules" for t in cuda_rules.GROUP_TAILS} <= \
        set(cuda_rules.launches)
    dev = get_engine("sha512-ps", "cuda", torch_device="cpu")
    target = get_engine("sha512-ps").parse_target("00" * 64 + ":salt")
    with pytest.raises(ValueError, match="--device cpu"):
        dev.make_wordlist_worker(_gens(108)[0], [target], 256, 8)
    gen, _ = _gens(23)
    assert dev.make_wordlist_worker(gen, [target], 256, 8).groups
    words, lens, bc, n_ops = cuda_rules.job_tables(gen, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rules.rules_group_kernel("md5-ps", words, lens, bc, n_ops, 0, 1,
                                      torch.as_tensor(rows.view(np.int32)),
                                      8, 32)
    with pytest.raises(ValueError, match="no rules group tail"):
        cuda_rules.rules_group_plain("sha224-ps", words, lens, bc, n_ops, 0,
                                     1, torch.as_tensor(rows.view(np.int32)),
                                     8, 32)


#: the C types of csrc/rules*.cu's dispatch switches, by core or tail name
C_TYPES = {"Md5Core": "md5", "Md4Core": "ntlm", "Sha1Core": "sha1",
           "Sha256Core": "sha256", "Sha224Core": "sha224",
           "Mysql323Core": "mysql323", "Md5OfMd5": "md5(md5)",
           "Sha1OfSha1": "sha1(sha1)", "Md5OfSha1": "md5(sha1)",
           "Sha1OfMd5": "sha1(md5)", "Sha256OfMd5": "sha256(md5)",
           "Sha256OfSha1": "sha256(sha1)", "Mysql41": "mysql41",
           "Md5Ps": "md5-ps", "Md5Sp": "md5-sp", "Sha1Ps": "sha1-ps",
           "Sha1Sp": "sha1-sp", "Sha256Ps": "sha256-ps",
           "Sha256Sp": "sha256-sp", "Sha1PsUtf16": "sha1-ps-utf16",
           "Krb5Tail": "krb5", "Sha512Core": "sha512", "Sha384Core": "sha384",
           "Keccak224": "keccak224", "Keccak256": "keccak256",
           "Keccak384": "keccak384", "Keccak512": "keccak512",
           "Sha512Ps": "sha512-ps", "Sha512Sp": "sha512-sp",
           "Sha512PsUtf16": "sha512-ps-utf16"}


def _switch(src: str, macro: str) -> dict:
    """The cases of ``macro``'s switch in csrc/``src``.cu: {case: the
    CALL's two arguments}."""
    import os
    import re
    path = os.path.join(os.path.dirname(cuda_rules.__file__), "..", "csrc",
                        f"{src}.cu")
    text = open(path).read()
    body = text[text.index(f"#define {macro}(CALL)"):]
    body = body[:body.index("default:")]
    return {int(c): (a, b) for c, a, b in re.findall(
        r"case (\d+): return CALL\((\w+), (\w+)\);", body)}


@pytest.mark.parametrize("src", sorted(cuda_rules.CORE_SOURCES))
def test_each_source_dispatches_its_table_cores(src):
    """Each source's switches take exactly the ids its cores have in
    ``KERNEL_CORES`` (one target: the id; a list: id * 4 + mode), and
    each id the core of that name, so the table and the C side cannot
    drift apart."""
    ids = {cuda_rules.KERNEL_CORES[c]: c
           for c in cuda_rules.CORE_SOURCES[src]}
    single = _switch(src, "DPRF_DISPATCH")
    assert {i: (C_TYPES[t], m) for i, (t, m) in single.items()} == \
        {i: (c, "kSingle") for i, c in ids.items()}
    lists = _switch(src, "DPRF_LIST_DISPATCH")
    assert {i: (C_TYPES[t], m) for i, (t, m) in lists.items()} == \
        {i * 4 + mode: (c, m) for i, c in ids.items()
         for mode, m in ((2, "kProbe"), (3, "kBulk"))}
    assert all(cuda_rules.source_of(c) == src for c in ids.values())


def test_group_source_dispatches_the_tail_table():
    """Each tail source's switch (csrc/rules_group.cu, csrc/rules_wide.cu):
    each of its tails' ids of ``GROUP_TAILS``, with the core of
    ``TAIL_CORES`` holding its candidate."""
    for src, tails in cuda_rules.TAIL_SOURCES.items():
        cases = _switch(src, "DPRF_GROUP_DISPATCH")
        assert {i: (C_TYPES[core], C_TYPES[tail])
                for i, (core, tail) in cases.items()} == \
            {cuda_rules.GROUP_TAILS[t]: (cuda_rules.TAIL_CORES[t], t)
             for t in tails}
        assert all(cuda_rules.source_of(t) == src for t in tails)


@pytest.mark.parametrize("variant", ["md5-ps", "sha1-sp", "sha1-ps-utf16"])
def test_salted_bounds_fold_each_targets_own_salt(variant):
    """A group's rows give back its salts; the rules tail's bound is,
    pair by pair, the mask rows' per-pair work (``salted_ops`` less its
    decode share) with the target's own salt -- a salt with a zero word
    or repeated words included, whose folds differ from another salt's."""
    from dprf_tpu_torch.ops import opcount
    salts = [b"\x00\x00\x00\x00", b"abcdabcd", b"\x01\x02\x03\x04"]
    if variant.endswith("-sp"):
        salts = [s[:4] for s in salts]
    group = [(s, [0] * (4 if variant.startswith("md5") else 5))
             for s in salts]
    rows = cuda_ext.salted_rule_rows(variant, group, 16)
    assert cuda_ext.rule_row_salts(variant, rows) == salts
    assert cuda_ext.rule_row_salts(
        variant, torch.as_tensor(rows.view(np.int32))) == salts
    counts = {3: 7, 9: 2}
    got = opcount.rules_salted_ops(variant, counts, salts)
    want = [0.0, 0.0, 0.0]
    for length, n in counts.items():
        for s in salts:
            w = opcount.salted_ops(variant, length, s, group=1)
            want = [want[0] + n * (w.alu - length),
                    want[1] + n * (w.add - length),
                    want[2] + n * (w.fma - 2 * length)]
    assert (got.alu, got.add, got.fma) == pytest.approx(tuple(want))
