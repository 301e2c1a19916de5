"""The least work one candidate takes in the mask kernel (csrc/mask.cu)
and in the rule kernel (csrc/rules.cu): the operation count behind the
bound that chip_smoke.py prints beside each kernel's time.

Each core runs here once, in Python, over the job's message block with
symbolic words: a word that holds candidate bytes is a ``Var``, every
other word (zeros, the 0x80 marker, the bit length) is its uint32
value.  An operation whose inputs are all fixed is a constant of the
job and costs nothing, and a zero term of a sum or xor vanishes.  An
operation on a ``Var`` costs what it takes in Hopper's instruction
forms, by pipe:

- ``alu``: LOP3 (any logic function of up to 3 inputs), SHF (a rotate
  or shift), LEA.HI (md5's ``b + rotl(x, s)``), ISETP (a compare): the
  INT32 pipe only;
- ``add``: IADD3, a sum of up to 3 terms: the INT32 pipe, or two IMAD
  on the FMA pipe;
- ``fma``: IMAD (the decode's quotient by a multiply-high and its
  remainder by a multiply-subtract): the FMA pipe only.

Only what the compared digest words depend on counts.  A single target
needs digest word 0 (the others only for the rare candidate whose word
0 matches), so md5 and md4 skip their last three steps; the Bloom
prefilter reads words 0-2.  Each mask position costs its decode: one
add, two IMAD and one ALU op placing the byte.

A rule-kernel candidate counts the core for its own length (its
padding and bit length are constants of that length, so they fold as in
the mask count) and one compare, and nothing for the rule
interpretation, which keeps the count a lower bound; a rejected
candidate costs nothing.  ``rules_ops`` sums this over the lengths the
job's words and rules yield (``rule_lengths``).

Run on fixed words alone, the same code computes the core, so a test
holds the counted formulas to the real hash.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import operator

import numpy as np
import torch

from dprf_tpu_torch.ops import md4, md5, sha1, sha256
from dprf_tpu_torch.ops.cuda_mask import device_engine, message_block
from dprf_tpu_torch.rules import device as rules_device

M32 = 0xFFFFFFFF


class Var:
    """A value that depends on the candidate: ``n`` instructions on
    ``pipe`` make it from ``deps``."""

    __slots__ = ("pipe", "n", "deps")

    def __init__(self, pipe: str, n: int, deps):
        self.pipe, self.n = pipe, n
        self.deps = [d for d in deps if isinstance(d, Var)]


def _fold(pipe: str, op, terms):
    """A sum or xor of any number of terms, three to an instruction."""
    var = [t for t in terms if isinstance(t, Var)]
    const = functools.reduce(
        op, (t for t in terms if not isinstance(t, Var)), 0) & M32
    if not var:
        return const
    n = len(var) + (const != 0)
    return var[0] if n == 1 else Var(pipe, n // 2, var)


def add(*terms):
    return _fold("add", operator.add, terms)


def xor(*terms):
    return _fold("alu", operator.xor, terms)


def logic(fn, *terms):
    """One LOP3: ``fn`` of up to three inputs."""
    if any(isinstance(t, Var) for t in terms):
        return Var("alu", 1, terms)
    return fn(*terms) & M32


def rotl(x, n: int):
    if isinstance(x, Var):
        return Var("alu", 1, [x])
    return ((x << n) | (x >> (32 - n))) & M32


def rotr(x, n: int):
    return rotl(x, 32 - n)


def shr(x, n: int):
    return Var("alu", 1, [x]) if isinstance(x, Var) else x >> n


def rotl_add(x, n: int, b):
    """md5's ``b + rotl(x, n)``: one LEA.HI."""
    if isinstance(x, Var):
        return Var("alu", 1, [x, b])
    return add(b, rotl(x, n))


def _choose(x, y, z):
    return z ^ (x & (y ^ z))


def _majority(x, y, z):
    return (x & y) | (z & (x | y))


def _parity(x, y, z):
    return x ^ y ^ z


def _md5_g(x, y, z):
    return _choose(z, x, y)


def _md5_i(x, y, z):
    return y ^ (x | ~z)


def _md5(m):
    a, b, c, d = (int(v) for v in md5.INIT)
    for i in range(64):
        rnd = i // 16
        fn, g = ((_choose, i), (_md5_g, (5 * i + 1) % 16),
                 (_parity, (3 * i + 5) % 16), (_md5_i, 7 * i % 16))[rnd]
        tmp = add(a, logic(fn, b, c, d), int(md5.K[i]), m[g])
        a, d, c, b = d, c, b, rotl_add(tmp, md5.SHIFTS[rnd][i % 4], b)
    return [a, b, c, d]


def _md4(m):
    a, b, c, d = (int(v) for v in md4.INIT)
    for i in range(48):
        rnd, j = divmod(i, 16)
        fn, g, k = ((_choose, j, 0), (_majority, md4.R2_ORDER[j], md4.K2),
                    (_parity, md4.R3_ORDER[j], md4.K3))[rnd]
        tmp = rotl(add(a, logic(fn, b, c, d), m[g], k), md4.SHIFTS[rnd][j % 4])
        a, b, c, d = d, tmp, b, c
    return [a, b, c, d]


def _sha1(m):
    w = list(m)
    a, b, c, d, e = (int(v) for v in sha1.INIT)
    for t in range(80):
        if t >= 16:
            w[t % 16] = rotl(xor(w[(t - 3) % 16], w[(t - 8) % 16],
                                 w[(t - 14) % 16], w[t % 16]), 1)
        fn = (_choose, _parity, _majority, _parity)[t // 20]
        tmp = add(rotl(a, 5), logic(fn, b, c, d), e, int(sha1.K[t // 20]),
                  w[t % 16])
        a, b, c, d, e = tmp, a, rotl(b, 30), c, d
    return [a, b, c, d, e]


def _sha256(m):
    w = list(m)
    a, b, c, d, e, f, g, h = (int(v) for v in sha256.INIT)
    for t in range(64):
        if t >= 16:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = xor(rotr(w15, 7), rotr(w15, 18), shr(w15, 3))
            s1 = xor(rotr(w2, 17), rotr(w2, 19), shr(w2, 10))
            w[t % 16] = add(w[t % 16], s0, w[(t - 7) % 16], s1)
        t1 = add(h, xor(rotr(e, 6), rotr(e, 11), rotr(e, 25)),
                 logic(_choose, e, f, g), int(sha256.K[t]), w[t % 16])
        a_next = add(t1, xor(rotr(a, 2), rotr(a, 13), rotr(a, 22)),
                     logic(_majority, a, b, c))
        h, g, f, e, d, c, b, a = g, f, e, add(d, t1), c, b, a, a_next
    return [a, b, c, d, e, f, g, h]


#: each core's rounds (no feed-forward) and its initial state, by
#: device engine name
CORES = {"md5": (_md5, md5.INIT), "ntlm": (_md4, md4.INIT),
         "sha1": (_sha1, sha1.INIT), "sha256": (_sha256, sha256.INIT)}


def state_words(engine_name: str, words) -> list:
    """The core's state words after its rounds, before the
    feed-forward: uint32 ints where ``words`` are all ints, else
    ``Var`` where a word depends on the candidate."""
    return CORES[device_engine(engine_name).name][0](list(words))


def tally(outputs) -> dict:
    """Instructions per pipe that ``outputs`` depend on, each once."""
    count = {"alu": 0, "add": 0, "fma": 0}
    seen = set()
    stack = [v for v in outputs if isinstance(v, Var)]
    while stack:
        v = stack.pop()
        if id(v) not in seen:
            seen.add(id(v))
            count[v.pipe] += v.n
            stack.extend(v.deps)
    return count


@dataclasses.dataclass(frozen=True)
class Work:
    """Instructions one candidate needs, by pipe."""

    alu: float
    add: float
    fma: float

    @property
    def slots(self) -> float:
        """The least issue slots of one 64-lane pipe per candidate.  An
        SM runs 64 lanes of INT32-pipe and 64 lanes of IMAD work per
        clock (CUDA C++ Programming Guide, arithmetic instruction
        throughput, compute capability 9.0), and each IADD3 may go to
        either pipe, as two IMAD on the FMA pipe.  Balancing the adds
        between the pipes gives max(alu, fma, (2 alu + fma + 2 add) / 3)."""
        return max(self.alu, self.fma,
                   (2 * self.alu + self.fma + 2 * self.add) / 3)


@functools.lru_cache(maxsize=None)
def core_work(engine_name: str, length: int, words_needed: int) -> dict:
    """The core's instructions per pipe for a ``length``-position mask,
    counting what digest words 0..words_needed-1 depend on."""
    eng = device_engine(engine_name)
    block = list(message_block(eng.name, length))
    msg_bytes = length * (2 if eng.widen_utf16 else 1)
    for w in range(-(-msg_bytes // 4)):
        block[w] = Var("alu", 0, [])      # the decode counts its own work
    return tally(state_words(eng.name, block)[:words_needed])


def ops_per_candidate(engine_name: str, length: int, multi: bool = False,
                      probes: float = 0.0, maybes: float = 0.0,
                      n_targets: int = 1) -> Work:
    """The least work of one candidate of a ``length``-position mask.

    Single target: the decode, the core up to digest word 0 and one
    compare (the feed-forward folds into the target word).  Multi
    target: the decode, the core up to words 0-2, their feed-forward
    adds, ``probes`` Bloom probes per candidate (this run's data:
    ``bloom.expected_probes``) at 5 ALU ops each (align the digest
    bits, word offset and mask, shift the row word, test), and for
    each of ``maybes`` survivors per candidate a binary search of
    ceil(log2(n_targets + 1)) steps at 4 each plus a compare per digest
    word."""
    core = core_work(engine_name, length, 3 if multi else 1)
    alu = core["alu"] + length
    add_ = core["add"] + length
    fma = core["fma"] + 2 * length
    if not multi:
        return Work(alu + 1, add_, fma)
    search = int(np.ceil(np.log2(n_targets + 1)))
    words = device_engine(engine_name).digest_words
    return Work(alu + 5 * probes + maybes * (4 * search + words),
                add_ + 3, fma)


def rule_lengths(words: np.ndarray, lens: np.ndarray, rules,
                 max_len: int) -> dict:
    """{length: candidates} over words (uint8[N, max_len], int32[N]) x
    rules, rejected candidates left out: rules/device.py, the rule
    kernel's plain interpreter, on CPU tensors."""
    w = torch.as_tensor(words)
    ln = torch.as_tensor(lens)
    counts = collections.Counter()
    for ops in rules:
        _, out, valid = rules_device.apply_rule(
            w, ln, torch.ones_like(ln, dtype=torch.bool), ops, max_len)
        counts.update(out[valid].tolist())
    return dict(sorted(counts.items()))


def rules_ops(engine_name: str, length_counts: dict) -> Work:
    """The least work of the rule kernel's candidates, summed: for each
    candidate of ``length_counts`` ({length: candidates}, from
    ``rule_lengths``), the core up to digest word 0 at its length and
    one compare; nothing for the rule interpretation."""
    alu = add_ = fma = 0
    for length, n in length_counts.items():
        core = core_work(engine_name, length, 1)
        alu += n * (core["alu"] + 1)
        add_ += n * core["add"]
        fma += n * core["fma"]
    return Work(alu, add_, fma)
