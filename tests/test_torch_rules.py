"""The port's rule engine against the reference's: the parser on every
line of the built-in sets, the oracle interpreter (rules/cpu.py) and
the plain device interpreter (rules/device.py, the rule kernel's plain
version) on every supported opcode and on best64, the kernel's bytecode
and its job eligibility.  Exact equality throughout."""

import os
import re

import numpy as np
import pytest
import torch

from dprf_tpu.generators.wordlist import \
    WordlistRulesGenerator as RefWordlistRulesGenerator
from dprf_tpu.ops import pallas_rules as ref_pallas_rules
from dprf_tpu.rules import cpu as ref_cpu
from dprf_tpu.rules import parser as ref_parser
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_rules
from dprf_tpu_torch.rules import cpu, device, parser

# the reference's Pallas module is imported for its bytecode encoder
# only; nothing here compiles
pytestmark = pytest.mark.smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the word set and opcode list of the reference's rule-kernel tests
WORDS = ([b"alpha", b"bravo", b"s3cret", b"Delta", b"echo99",
          b"FOXtrot", b"g0lf!", b"hotellll", b"in", b"j", b"",
          b"aAzZ09!~", b"xxxxxxxxxxxxxxxx"]
         + [b"w%02d" % i for i in range(19)])
RULES = [":", "l", "u", "c", "C", "t", "T2", "r", "d", "p2", "f",
         "{", "}", "[", "]", "D2", "x12", "O12", "i2X", "o2Y", "'3",
         "se3", "z2", "Z2", "q", "k", "K", "*03", "L2", "R2", "+2",
         "-2", ".2", ",2", "y2", "Y2", "$!", "^#", "<5", ">3", "_6",
         "!x", "/e", "(a", ")o", "=1e", "%2e", "c $1 $2 $3", "u r ]",
         # the ops the kernel refuses, and positions past any word
         "@l", "E", "e-", "TZ", "oZa", "=Za", "x0Z", "*0Z", "p9"]


def _ops(ops):
    return [(int(o.opcode), o.p1, o.p2) for o in ops]


def _rule_lines(name):
    with open(parser.resolve_rules_path(name), encoding="latin-1") as fh:
        return fh.read().splitlines()


@pytest.mark.parametrize("name", parser.BUILTIN_RULESETS)
def test_parser_matches_reference_on_builtin_sets(name):
    lines = _rule_lines(name)
    got = parser.parse_rules(lines)
    want = ref_parser.parse_rules(lines)
    assert [_ops(r) for r in got] == [_ops(r) for r in want]
    assert [_ops(r) for r in parser.load_rules(name)] == \
        [_ops(r) for r in ref_parser.load_rules(name)]
    with open(parser.resolve_rules_path(name), "rb") as fh, \
            open(ref_parser.resolve_rules_path(name), "rb") as ref:
        assert fh.read() == ref.read()


def test_parser_bad_lines():
    lines = [":", "Q", "$", "x1", "i5", "# comment", "", "  ", "sab",
             "*0a", "'B"]
    got = parser.parse_rules(lines, on_error="skip")
    assert [_ops(r) for r in got] == \
        [_ops(r) for r in ref_parser.parse_rules(lines, on_error="skip")]
    assert len(got) == 3
    for bad in ("Q", "$", "x1", "*0a", ""):
        with pytest.raises(ValueError):
            parser.parse_rule(bad)
        with pytest.raises(ValueError):
            ref_parser.parse_rule(bad)
    with pytest.raises(ValueError, match="no usable rules"):
        parser.parse_rules(["# only", "Q"], on_error="skip")
    with pytest.raises(FileNotFoundError):
        parser.resolve_rules_path("no-such-set")


def _device(words, rules, max_len):
    """rules/device.py over the words, one rule at a time ->
    per rule, per word: the candidate bytes or None."""
    B = len(words)
    w = np.zeros((B, max_len), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, word in enumerate(words):
        w[i, :len(word)] = np.frombuffer(word, np.uint8)
        lens[i] = len(word)
    out = []
    for ops in rules:
        cw, cl, cv = device.apply_rule(
            torch.as_tensor(w), torch.as_tensor(lens),
            torch.ones(B, dtype=torch.bool), ops, max_len)
        cw, cl, cv = cw.numpy(), cl.numpy(), cv.numpy()
        # the zero-tail invariant, on valid and rejected lanes alike
        assert all(not cw[i, cl[i]:].any() for i in range(B))
        assert (cl <= max_len).all()
        out.append([cw[i, :cl[i]].tobytes() if cv[i] else None
                    for i in range(B)])
    return out


def _check_interpreters(words, lines, max_len):
    rules = [parser.parse_rule(r) for r in lines]
    want = [[ref_cpu.apply_rule(word, ref_parser.parse_rule(r), max_len)
             for word in words] for r in lines]
    got_cpu = [[cpu.apply_rule(word, ops, max_len) for word in words]
               for ops in rules]
    assert got_cpu == want
    assert _device(words, rules, max_len) == want
    return want


def test_interpreters_match_reference_on_every_opcode():
    want = _check_interpreters(WORDS, RULES, 16)
    # the cases exercise both outcomes: some words reject, most do not
    assert any(None in row for row in want)
    assert sum(c is not None for row in want for c in row) > 40 * len(WORDS)


@pytest.mark.parametrize("max_len", [16, 55])
def test_interpreters_match_reference_on_best64(max_len):
    rng = np.random.default_rng(max_len)
    words = [bytes(rng.integers(32, 127, int(n), dtype=np.uint8))
             for n in rng.integers(0, 15, 60)]
    words += [b"password", b"Pa55w0rd", b"x" * 15, b"abcdefgh"]
    lines = [ln for ln in _rule_lines("best64")
             if ln.strip() and not ln.startswith("#")]
    assert len(lines) == 64
    want = _check_interpreters(words, lines, max_len)
    rejected = sum(c is None for row in want for c in row)
    assert (rejected > 0) == (max_len == 16)


def test_encode_rules_matches_reference_on_best64():
    rules = parser.load_rules("best64")
    ref_rules = ref_parser.load_rules("best64")
    got = cuda_rules.encode_rules(rules)
    assert got.shape == (64, 8, 3)
    assert np.array_equal(got, ref_pallas_rules.encode_rules(ref_rules))
    assert np.array_equal(cuda_rules.encode_rules(rules, 12),
                          ref_pallas_rules.encode_rules(ref_rules, 12))
    bc, n_ops = cuda_rules.rule_tables(rules)
    assert bc.shape == (64, cuda_rules.MAX_STEPS, 3)
    assert n_ops.tolist() == [len(r) for r in rules]
    assert [_ops(r) for r in cuda_rules.decode_rules(bc, n_ops)] == \
        [_ops(r) for r in rules]
    assert cuda_rules.SUPPORTED == frozenset(
        parser.Opcode(int(o)) for o in ref_pallas_rules.SUPPORTED)


def test_kernel_opcodes_match_the_parser():
    """csrc/rules_kernel.cuh's opcode numbers (the kernel of
    csrc/rules.cu and its other sources) are rules/parser.Opcode's, and
    it names every op the kernel takes."""
    with open(os.path.join(REPO, "dprf_tpu_torch", "csrc",
                           "rules_kernel.cuh")) as fh:
        src = fh.read()
    enum = {m.group(1): int(m.group(2))
            for m in re.finditer(r"\bOP_(\w+) = (\d+),", src)}
    assert enum == {op.name: int(op) for op in cuda_rules.SUPPORTED}


@pytest.mark.parametrize("engine,targets,rules,max_len,ok", [
    ("md5", 1, ["$1", ":"], 55, True),
    ("sha1", 1, ["+0 +0 +0 +0 +0 +0 +0 +0"], 55, True),
    ("ntlm", 1, ["$1"], 27, True),
    ("ntlm", 1, ["$1"], 28, False),          # past ntlm's one block
    ("md5", 1, ["$1"], 56, False),
    # a list: the port's kernel takes it (the reference's Pallas kernel
    # does not; its lists run its XLA pipeline); the id is the case's
    # from when the port refused lists too
    pytest.param("md5", 2, ["$1"], 55, True, id="md5-2-rules5-55-False"),
    ("md5", 1, ["@a"], 55, False),           # PURGE
    ("md5", 1, ["E"], 55, False),            # TITLE
    ("md5", 1, ["es"], 55, False),           # TITLE_SEP
    ("md5", 1, ["$1 $2 $3 $4 $5 $6 $7 $8 $9"], 55, False),   # 9 ops
    # the wide cores (csrc/rules_wide.cu) take these since the port's
    # 64-bit and sponge rules cores; the ids are the cases' from when
    # the port refused them
    pytest.param("sha512", 1, ["$1"], 55, True,
                 id="sha512-1-rules10-55-False"),
    pytest.param("sha384", 1, ["$1"], 55, True,
                 id="sha384-1-rules11-55-False"),
    pytest.param("sha3-256", 1, ["$1"], 55, True,
                 id="sha3-256-1-rules12-55-False"),
    pytest.param("keccak-256", 1, ["$1"], 55, True,
                 id="keccak-256-1-rules13-55-False"),
    pytest.param("keccak224", 1, ["$1"], 55, True,
                 id="keccak224-1-rules14-55-False"),
    ("md5crypt", 1, ["$1"], 55, False),      # no such engine
])
def test_kernel_rules_eligible(engine, targets, rules, max_len, ok):
    def gens(mod, parse):
        return mod([b"word"], [parse(r) for r in rules], max_len=max_len)
    gen = gens(WordlistRulesGenerator, parser.parse_rule)
    assert cuda_rules.kernel_rules_eligible(engine, gen, targets) is ok
    if engine in ("md5", "ntlm", "sha1"):
        # the reference agrees for one target (it refuses sha256 off the
        # TPU, and its kernel has a sha512 core); it sends a list to its
        # XLA pipeline
        ref = gens(RefWordlistRulesGenerator, ref_parser.parse_rule)
        assert ref_pallas_rules.kernel_rules_eligible(
            engine, ref, targets) is (ok and targets == 1)
