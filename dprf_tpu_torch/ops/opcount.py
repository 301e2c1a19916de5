"""The least work one candidate takes in the mask kernel (csrc/mask.cu,
csrc/keccak.cu), the rule kernel (csrc/rules.cu), the PMKID and KDF
kernels (csrc/pbkdf2.cu), the bcrypt kernels (csrc/bcrypt.cu), the
Kerberos RC4 kernel (csrc/krb5.cu), the 7-Zip KDF kernel
(csrc/sevenzip.cu) and the PDF kernel (csrc/pdf.cu): the operation count
behind the bound that chip_smoke.py prints beside each kernel's time.

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
prefilter reads words 0-2, the blocked probe words 0-1 and, once its
first bit passes, 2-3 (``probe_ops``).  Each mask position costs its
decode: one add, two IMAD and one ALU op placing the byte.

A rule-kernel candidate counts the core for its own length (its
padding and bit length are constants of that length, so they fold as in
the mask count) and one compare, and nothing for the rule
interpretation, which keeps the count a lower bound; a rejected
candidate costs nothing.  ``rules_ops`` sums this over the lengths the
job's words and rules yield (``rule_lengths``).

The 64-bit cores (sha512 / sha384, Keccak-f) count on (hi, lo) pairs
of such words, in Hopper's 32-bit forms: a 64-bit add of up to three
terms is one IADD3 a half (the high half takes the low half's carry, so
it depends on it), a rotate one SHF a half (by 32 a swap, free), a
logic function of up to three inputs one LOP3 a half.  Keccak's
squeeze byte swap is not counted: the target's words can be swapped
instead.

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

from dprf_tpu_torch.ops import keccak, md4, md5, sha1, sha256, sha512
from dprf_tpu_torch.ops.cuda_mask import device_engine, message_block
from dprf_tpu_torch.ops.pack import pack_fixed
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


def _md5(m, state=None):
    a, b, c, d = (int(v) for v in md5.INIT) if state is None else state
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


def _sha1(m, state=None):
    w = list(m)
    a, b, c, d, e = (int(v) for v in sha1.INIT) if state is None else state
    for t in range(80):
        if t >= 16:
            w[t % 16] = rotl(xor(w[(t - 3) % 16], w[(t - 8) % 16],
                                 w[(t - 14) % 16], w[t % 16]), 1)
        fn = (_choose, _parity, _majority, _parity)[t // 20]
        tmp = add(rotl(a, 5), logic(fn, b, c, d), e, int(sha1.K[t // 20]),
                  w[t % 16])
        a, b, c, d, e = tmp, a, rotl(b, 30), c, d
    return [a, b, c, d, e]


def _sha256(m, state=None):
    w = list(m)
    a, b, c, d, e, f, g, h = (int(v) for v in sha256.INIT) \
        if state is None else state
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


# ---- 64-bit words: (hi, lo) pairs of 32-bit halves ------------------------

def _is_var(x) -> bool:
    return isinstance(x, Var)


def add64(*terms):
    """A 64-bit sum of (hi, lo) pairs: IADD3 on the low halves, IADD3.X
    on the high ones, which then depend on the low sum's carry."""
    los = [t[1] for t in terms]
    his = [t[0] for t in terms]
    if not any(_is_var(x) for x in los + his):
        v = sum((h << 32) | lo for h, lo in terms)
        return (v >> 32) & M32, v & M32
    lo = add(*los)
    if not _is_var(lo):
        carry = sum(x for x in los) >> 32
        return add(*his, carry), lo
    if any(lo is x for x in los):        # a lone variable term: no carry
        return add(*his), lo
    hi = Var("add", lo.n, [*his, lo])
    return hi, lo


def xor64(*terms):
    return xor(*(t[0] for t in terms)), xor(*(t[1] for t in terms))


def logic64(fn, *terms):
    """One LOP3 a half: ``fn`` of up to three pairs."""
    return (logic(fn, *(t[0] for t in terms)),
            logic(fn, *(t[1] for t in terms)))


def _funnel(a, b, n: int):
    """The low 32 bits of (b:a) >> n, one SHF."""
    if _is_var(a) or _is_var(b):
        return Var("alu", 1, [a, b])
    return ((b << 32 | a) >> n) & M32


def rotr64(x, n: int):
    hi, lo = x
    n %= 64
    if n >= 32:
        hi, lo, n = lo, hi, n - 32
    if n == 0:
        return hi, lo
    return _funnel(hi, lo, n), _funnel(lo, hi, n)


def rotl64(x, n: int):
    return rotr64(x, 64 - n % 64)


def shr64(x, n: int):
    """A logical right shift by n < 32: SHF on each half."""
    hi, lo = x
    return shr(hi, n), _funnel(lo, hi, n)


def _pairs(init) -> list:
    return [(v >> 32, v & M32) for v in init]


def _sha512(m, init=sha512.INIT512):
    """The 80 SHA-512 rounds over 32 message words (64-bit word i is
    (m[2i], m[2i+1])), rolling schedule; returns the 16 state words
    before the feed-forward, high half first."""
    w = [(m[2 * i], m[2 * i + 1]) for i in range(16)]
    a, b, c, d, e, f, g, h = _pairs(init)
    for t in range(80):
        if t >= 16:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = xor64(rotr64(w15, 1), rotr64(w15, 8), shr64(w15, 7))
            s1 = xor64(rotr64(w2, 19), rotr64(w2, 61), shr64(w2, 6))
            w[t % 16] = add64(w[t % 16], s0, w[(t - 7) % 16], s1)
        t1 = add64(h, xor64(rotr64(e, 14), rotr64(e, 18), rotr64(e, 41)),
                   logic64(_choose, e, f, g), _pairs([sha512.K[t]])[0],
                   w[t % 16])
        a_next = add64(t1, xor64(rotr64(a, 28), rotr64(a, 34),
                                 rotr64(a, 39)),
                       logic64(_majority, a, b, c))
        h, g, f, e, d, c, b, a = g, f, e, add64(d, t1), c, b, a, a_next
    return [x for pair in (a, b, c, d, e, f, g, h) for x in pair]


def _chi(x, y, z):
    return x ^ (~y & z)


def _bswap(x):
    return int.from_bytes((x & M32).to_bytes(4, "little"), "big")


def _keccak(m, rate: int, out_words: int):
    """Keccak-f[1600] over the absorbed rate block (lane i = m[2i] |
    m[2i+1] << 32, zero past the rate) and the squeeze: ``out_words``
    digest words, big-endian (a byte swap, uncounted, of each half)."""
    zero = (0, 0)
    a = [(m[2 * i + 1], m[2 * i]) if i < rate // 8 else zero
         for i in range(25)]
    for rc in keccak.RC:
        c = [xor64(*(a[x + 5 * y] for y in range(5))) for x in range(5)]
        d = [xor64(c[(x - 1) % 5], rotl64(c[(x + 1) % 5], 1))
             for x in range(5)]
        b = [None] * 25
        for i in range(25):
            b[keccak.PI[i]] = rotl64(xor64(a[i], d[i % 5]), keccak.RHO[i])
        a = [logic64(_chi, b[i], b[(i + 1) % 5 + 5 * (i // 5)],
                     b[(i + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] = xor64(a[0], (rc >> 32, rc & M32))
    out = []
    for k in range(out_words):
        half = a[k // 2][1 - k % 2]
        out.append(half if _is_var(half) else _bswap(half))
    return out


def shl(x, n: int):
    return Var("alu", 1, [x]) if isinstance(x, Var) else (x << n) & M32


def _byte(m, q: int):
    """Candidate byte q of big-endian message words: one PRMT (or SHF)
    for a word that depends on the candidate."""
    w, sh = m[q >> 2], 8 * (3 - (q & 3))
    return Var("alu", 1, [w]) if isinstance(w, Var) else (w >> sh) & 0xFF


def _mad(a, b, c):
    """a * b + c: one IMAD."""
    if any(isinstance(t, Var) for t in (a, b, c)):
        return Var("fma", 1, [a, b, c])
    return (a * b + c) & M32


def _mysql323(m):
    """MySQL's OLD_PASSWORD scan over the candidate's bytes, to the
    length the bit length of word 15 gives (csrc/mask.cu,
    ``Mysql323Core``): a step a byte, (nr & 63) + add, its product with
    the byte plus nr << 8, the xor into nr; (nr2 << 8) ^ nr added to
    nr2; the byte added to add.  The skip of a space or tab (its
    compares and selects) is not counted here: ``mysql323_ops`` adds it
    for the positions whose charset holds one.  Returns the two digest
    words, each masked to 31 bits (a LOP3)."""
    nr, nr2, acc = 1345345333, 0x12345671, 7
    for q in range(int(m[15]) >> 3):
        c = _byte(m, q)
        nr = xor(nr, _mad(add(logic(lambda x: x & 63, nr), acc), c,
                          shl(nr, 8)))
        nr2 = add(nr2, xor(shl(nr2, 8), nr))
        acc = add(acc, c)
    return [logic(lambda x: x & 0x7FFFFFFF, nr),
            logic(lambda x: x & 0x7FFFFFFF, nr2)]


#: each core's rounds (no feed-forward) and its initial state, by
#: device engine core (sha512/384: the eight 64-bit words; mysql323's
#: scan has no feed-forward and starts from its own constants)
CORES = {"md5": (_md5, md5.INIT), "ntlm": (_md4, md4.INIT),
         "sha1": (_sha1, sha1.INIT), "sha256": (_sha256, sha256.INIT),
         "sha224": (lambda m: _sha256(m, [int(v) for v in sha256.INIT224]),
                    sha256.INIT224),
         "sha512": (_sha512, sha512.INIT512),
         "sha384": (functools.partial(_sha512, init=sha512.INIT384),
                    sha512.INIT384),
         "mysql323": (_mysql323, None)}


def _engine(engine_name: str):
    """The device engine of a mask-kernel core or a sha3/keccak name."""
    from dprf_tpu_torch.ops import cuda_keccak
    if engine_name.lower() in cuda_keccak.NAMES:
        return cuda_keccak.keccak_engine(engine_name)
    return device_engine(engine_name)


def is_sponge(eng) -> bool:
    return hasattr(eng, "_rate")


def state_words(engine_name: str, words) -> list:
    """The core's state words after its rounds, before the
    feed-forward (a sponge's squeezed digest words): uint32 ints where
    ``words`` are all ints, else ``Var`` where a word depends on the
    candidate."""
    eng = _engine(engine_name)
    if is_sponge(eng):
        return _keccak(list(words), eng._rate, eng.digest_words)
    return CORES[eng.core][0](list(words))


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
    eng = _engine(engine_name)
    block = list(message_block(eng.name, length))
    msg_bytes = length * (2 if eng.widen_utf16 else 1)
    for w in range(-(-msg_bytes // 4)):
        block[w] = Var("alu", 0, [])      # the decode counts its own work
    return tally(state_words(eng.name, block)[:words_needed])


#: one lane's step inside a run of the mask kernel (csrc/mask_kernel.cuh):
#: the lane's add and the charset byte placed in its word
DECODE_STEP = Work(alu=1, add=1, fma=0)


def decode_work(length: int, run: float = 1) -> Work:
    """The decode's least work a lane when a thread takes runs of
    ``run`` lanes on average (``cuda_mask.mean_run``): the run's first
    lane decodes every position (an add, two IMAD and an ALU op each),
    each other lane one ``DECODE_STEP``.  A run of 1 is a full decode a
    lane."""
    rest = 1 - 1 / run
    return Work(length / run + rest * DECODE_STEP.alu,
                length / run + rest * DECODE_STEP.add,
                2 * length / run + rest * DECODE_STEP.fma)


def ops_per_candidate(engine_name: str, length: int, multi: bool = False,
                      probes: float = 0.0, maybes: float = 0.0,
                      n_targets: int = 1, run: float = 1) -> Work:
    """The least work of one candidate of a ``length``-position mask.

    Single target: the decode (``decode_work`` at runs of ``run``
    lanes), the core up to digest word 0 and one compare (the
    feed-forward folds into the target word).  Multi target: the
    decode, the core up to words 0-2, their feed-forward adds,
    ``probes`` Bloom probes per candidate (this run's data:
    ``bloom.expected_probes``) at 5 ALU ops each (align the digest
    bits, word offset and mask, shift the row word, test), and for
    each of ``maybes`` survivors per candidate a binary search of
    ceil(log2(n_targets + 1)) steps at 4 each plus a compare per digest
    word.  A sponge has no feed-forward, nor has mysql323's scan."""
    eng = _engine(engine_name)
    core = core_work(engine_name, length, 3 if multi else 1)
    dec = decode_work(length, run)
    alu = core["alu"] + dec.alu
    add_ = core["add"] + dec.add
    fma = core["fma"] + dec.fma
    if not multi:
        return Work(alu + 1, add_, fma)
    search = int(np.ceil(np.log2(n_targets + 1)))
    return Work(alu + 5 * probes + maybes * (4 * search + eng.digest_words),
                add_ + (0 if no_feed_forward(eng) else 3), fma)


def no_feed_forward(eng) -> bool:
    """A sponge's squeezed words and mysql323's scan are the digest:
    no feed-forward add."""
    return is_sponge(eng) or eng.core == "mysql323"


#: a byte's skip test and its selects in the mysql323 scan: two compares
#: (a space, a tab) and three selects (nr, nr2, add)
MYSQL323_SKIP = Work(alu=2 + 3, add=0, fma=0)


def mysql323_ops(gen, probe: tuple = None, maybes: float = 0.0,
                 n_targets: int = 1) -> Work:
    """The least work of one mysql323 candidate of the mask generator
    ``gen``: ``ops_per_candidate`` (one target) or ``probe_ops`` (a
    list: ``probe`` = (fill, k) of this run's bitmap) over the scan of
    ``_mysql323``, at the mask template's runs of lanes, plus the skip
    test and its selects (``MYSQL323_SKIP``) for every position whose
    charset holds a space or a tab: where none does, no lane skips and
    the scan needs no test."""
    from dprf_tpu_torch.ops.cuda_mask import lanes_a_run
    run = lanes_a_run("mysql323", gen.radices)
    if probe is None:
        work = ops_per_candidate("mysql323", gen.length, run=run)
    else:
        work = probe_ops("mysql323", gen.length, *probe, maybes, n_targets,
                         run)
    skips = sum(1 for cs in gen.charsets
                if 0x20 in bytes(cs) or 0x09 in bytes(cs))
    return Work(work.alu + skips * MYSQL323_SKIP.alu, work.add, work.fma)


def probe_fill(words: np.ndarray) -> float:
    """The share of a probe bitmap's bits set (``cuda_mask.probe_rows``'
    uint32 words): the chance that one bit a non-matching candidate
    tests passes."""
    return float(np.unpackbits(np.ascontiguousarray(words).view(np.uint8))
                 .mean())


def probe_ops(engine_name: str, length: int, fill: float, k: int,
              maybes: float = 0.0, n_targets: int = 1,
              run: float = 1) -> Work:
    """The least work of one candidate of a ``length``-position mask
    under the blocked probe (csrc/mask_kernel.cuh ``probe_maybe``),
    from this run's bitmap ``fill`` (``probe_fill``).

    The decode (``decode_work``); the core up to digest words 0-1 and
    their feed-forward
    adds, and for the share ``fill`` of candidates whose first bit
    passes, words 2-3 and theirs; the block (one IMAD, one shift) and
    the two odd pair ends (two LOP3); each bit tested (sum over j < k
    of fill^j: testing stops at the first miss) 4 ALU ops (the bit, its
    word offset, the shift of the word, the test) and its index a +
    (2i + 1) b, an add for the first two bits and an IMAD after; each
    survivor's search as ``ops_per_candidate``'s.  A sponge has no
    feed-forward."""
    eng = _engine(engine_name)
    w2 = core_work(engine_name, length, 2)
    w4 = core_work(engine_name, length, 4)

    def words(pipe: str) -> float:
        return w2[pipe] + fill * (w4[pipe] - w2[pipe])

    reach = [fill ** j for j in range(k)]
    search = int(np.ceil(np.log2(n_targets + 1)))
    feed = 0 if no_feed_forward(eng) else 2 + 2 * fill
    dec = decode_work(length, run)
    return Work(words("alu") + dec.alu + 3 + 4 * sum(reach)
                + maybes * (4 * search + eng.digest_words),
                words("add") + dec.add + feed + sum(reach[:2]),
                words("fma") + dec.fma + 1 + sum(reach[2:]))


def rules_list_ops(engine_name: str, length_counts: dict, fill: float,
                   k: int, maybes: float = 0.0, n_targets: int = 1) -> Work:
    """The least work of the rule kernel's candidates under a list's
    probe, summed over ``length_counts`` (``rule_lengths``): each
    candidate's core up to digest words 0-1 at its length, and words 2-3
    for the share ``fill`` whose first bit passes, their feed-forward
    adds, the block and the bits it tests as ``probe_ops`` counts them,
    and each survivor's search (``maybes`` a candidate); nothing for the
    rule interpretation."""
    from dprf_tpu_torch.ops import cuda_ext
    digest_words = 5 if engine_name == "mysql41" else \
        _engine(cuda_ext.NESTED_COMBOS[engine_name][0]
                if engine_name in cuda_ext.NESTED_COMBOS
                else engine_name).digest_words
    no_feed = engine_name not in cuda_ext.NESTED_NAMES and \
        no_feed_forward(_engine(engine_name))
    reach = [fill ** j for j in range(k)]
    search = int(np.ceil(np.log2(n_targets + 1)))
    feed = 0 if no_feed else 2 + 2 * fill
    per = Work(3 + 4 * sum(reach) + maybes * (4 * search + digest_words),
               feed + sum(reach[:2]), 1 + sum(reach[2:]))
    alu = add_ = fma = 0.0
    for length, n in length_counts.items():
        w2 = rule_core_work(engine_name, length, 2)
        w4 = rule_core_work(engine_name, length, 4)
        alu += n * (w2["alu"] + fill * (w4["alu"] - w2["alu"]) + per.alu)
        add_ += n * (w2["add"] + fill * (w4["add"] - w2["add"]) + per.add)
        fma += n * (w2["fma"] + fill * (w4["fma"] - w2["fma"]) + per.fma)
    return Work(alu, add_, fma)


#: the L2 cache of an H100 (NVIDIA's data sheet): a bulk bitmap up to
#: this size stays resident while a launch probes it
L2_BYTES = 50 * 1024 * 1024


def bulk_ops(engine_name: str, length: int, fill: float, k: int,
             maybes: float = 0.0, n_targets: int = 1,
             run: float = 1) -> Work:
    """The least work of one candidate under the bulk probe
    (csrc/compare.cuh ``probe_maybe<W, true>``, the bitmap in global
    memory), counted as ``probe_ops``: the same bits tested, the block's
    address one 64-bit IMAD where the shared-memory probe takes one
    32-bit IMAD, and each survivor's search over the list's
    ``n_targets``."""
    return probe_ops(engine_name, length, fill, k, maybes, n_targets, run)


def bulk_bytes(n_targets: int, digest_words: int, block_bits: int,
               host_verify: bool = False) -> int:
    """The bytes a bulk launch must move, each input read once: the
    bitmap (16 << block_bits words) and, but in the host-verify layout,
    the sorted table (n_targets x digest_words words); the hit buffers
    it writes are a few bytes.  Set beside ``L2_BYTES``: a bitmap of up
    to 50 MB is read from L2 after its first touch."""
    table = 0 if host_verify else n_targets * digest_words * 4
    return 64 * (1 << block_bits) + table


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
    ``rule_lengths``), the core up to digest word 0 at its length (a
    nested chain's inner core, hex map and outer core, ``nested_work``)
    and one compare; nothing for the rule interpretation."""
    alu = add_ = fma = 0
    for length, n in length_counts.items():
        core = rule_core_work(engine_name, length, 1)
        alu += n * (core["alu"] + 1)
        add_ += n * core["add"]
        fma += n * core["fma"]
    return Work(alu, add_, fma)


def rule_core_work(engine_name: str, length: int, words_needed: int) -> dict:
    """``core_work`` of a rules kernel core at a candidate's length: a
    nested chain's (``nested_work``) or a plain core's."""
    from dprf_tpu_torch.ops import cuda_ext
    if engine_name in cuda_ext.NESTED_NAMES:
        return nested_work(engine_name, length, words_needed)
    return core_work(engine_name, length, words_needed)


# ---- the nested and salted chains (csrc/ext.cu) ---------------------------

#: the lowercase hex of one 32-bit digest word (4 bytes -> 8 characters,
#: two outer message words) in its least form, four nibbles a register:
#: split the low and high nibbles (LOP3; SHF + LOP3), map each nibble
#: word by n + 0x30303030 + 39 * (((n + 0x06060606) >> 4) & 0x01010101)
#: (IADD3, SHF, LOP3, IMAD, IADD3), interleave the two character words
#: into the two message words (2 PRMT)
HEX_WORD = Work(alu=1 + 2 + 2 * 2 + 2, add=2 * 2, fma=2)


def _core_work(core: str, block, var_words, words_needed: int) -> dict:
    """The instructions of ``core`` over ``block`` (16 uint32 ints) with
    the words ``var_words`` depending on the candidate, counting what
    state words 0..words_needed-1 depend on."""
    block = list(block)
    for w in var_words:
        block[w] = Var("alu", 0, [])
    return tally(state_words(core, block)[:words_needed])


def _decode_and_compare(length: int, multi: bool, digest_words: int,
                        probes: float, maybes: float, n_targets: int,
                        core: dict, run: float = 1) -> Work:
    """``ops_per_candidate``'s decode and compare around ``core``: the
    decode at runs of ``run`` lanes (``decode_work``); one target a
    compare, a list the feed-forward of words 0-2, the Bloom probes and
    the survivors' search."""
    dec = decode_work(length, run)
    alu = core["alu"] + dec.alu
    add_ = core["add"] + dec.add
    fma = core["fma"] + dec.fma
    if not multi:
        return Work(alu + 1, add_, fma)
    search = int(np.ceil(np.log2(n_targets + 1)))
    return Work(alu + 5 * probes + maybes * (4 * search + digest_words),
                add_ + 3, fma)


def nested_ops(name: str, length: int, multi: bool = False,
               probes: float = 0.0, maybes: float = 0.0,
               n_targets: int = 1, run: float = 1) -> Work:
    """The least work of one candidate of a nested chain
    (``cuda_ext.NESTED_NAMES``) over a ``length``-position mask: the
    decode; the chain (``nested_work``) up to the compared words (word 0
    for one target, 0-2 for the Bloom probes); the compare as
    ``ops_per_candidate``."""
    from dprf_tpu_torch.ops import cuda_ext
    outer = "sha1" if name == "mysql41" else cuda_ext.NESTED_COMBOS[name][0]
    return _decode_and_compare(length, multi,
                               device_engine(outer).digest_words, probes,
                               maybes, n_targets,
                               nested_work(name, length, 3 if multi else 1),
                               run)


@functools.lru_cache(maxsize=None)
def nested_work(name: str, length: int, words_needed: int) -> dict:
    """The instructions of a nested chain over a candidate of ``length``
    bytes, by pipe: the inner core over its block (fixed words folded),
    every digest word and its feed-forward add; the hex map of every
    inner digest word (``HEX_WORD``; mysql41 takes the raw words); the
    outer core over the 8 or 10 hex words (5 for mysql41) with its
    padding folded, up to digest words 0..words_needed-1."""
    from dprf_tpu_torch.ops import cuda_ext
    outer, inner = ("sha1", "sha1") if name == "mysql41" \
        else cuda_ext.NESTED_COMBOS[name]
    iw = device_engine(inner).digest_words
    block = cuda_ext.nested_block(name, length)
    work = _core_work(inner, block, range(-(-length // 4)), iw)
    work["add"] += iw
    if name == "mysql41":
        block2 = [0] * 5 + [0x80000000] + [0] * 9 + [160]
        var2 = range(5)
    else:
        block2 = list(pack_fixed(torch.zeros((1, 8 * iw), dtype=torch.uint8),
                                 8 * iw, big_endian=not device_engine(
                                     outer).little_endian)
                      .numpy()[0].view(np.uint32))
        var2 = range(2 * iw)
        work["alu"] += iw * HEX_WORD.alu
        work["add"] += iw * HEX_WORD.add
        work["fma"] += iw * HEX_WORD.fma
    outer_work = _core_work(outer, [int(w) for w in block2], var2,
                            words_needed)
    return {k: work[k] + outer_work[k] for k in work}


def salted_ops(variant: str, length: int, salt: bytes,
               group: int = 1) -> Work:
    """The least work of one hash of a salted variant
    (``cuda_ext.SALTED_VARIANTS``), one (candidate, target) pair of a
    ``length``-position mask and a target's ``salt``, in a launch whose
    ``group`` targets share each candidate's decode (csrc/salted.cuh):
    the pair's core and compare (``salted_pair_work``); the decode once
    per candidate, 1 / ``group`` of it a pair.  The kernel's move of an
    ``sp`` candidate by S bytes is not counted: it is not needed work."""
    core = salted_pair_work(variant, length, bytes(salt))
    share = length / group
    return Work(core.alu + share, core.add + share, core.fma + 2 * share)


@functools.lru_cache(maxsize=None)
def salted_pair_work(variant: str, length: int, salt: bytes) -> Work:
    """One (candidate, target) pair of a salted variant: the core up to
    digest word 0 with the target's ``salt``, padding and bit length
    folded as constants and the candidate's ``length`` bytes variable --
    at [0, L) for ``ps``, [S, S + L) for ``sp``, [0, 2L) for a UTF-16LE
    variant -- and one compare."""
    from dprf_tpu_torch.ops import cuda_ext
    algo, order = cuda_ext.split_salted(variant)
    width = cuda_ext.salted_geometry(variant)[3]
    first = 0 if order == "ps" else len(salt)
    block = cuda_ext.salted_block(variant, length, salt)
    core = _core_work(algo, block, range(
        first // 4, (first + width * length - 1) // 4 + 1), 1)
    return Work(core["alu"] + 1, core["add"], core["fma"])


def rules_salted_ops(variant: str, length_counts: dict, salts) -> Work:
    """The least work of the rules kernel's salted tail
    (csrc/rules_group.cu) over a group of targets with ``salts``, summed
    over the candidates of ``length_counts`` (``rule_lengths``): each
    (candidate, target) pair's ``salted_pair_work`` with the target's own
    salt; nothing for the rule interpretation or the salt's move to the
    candidate's length, which a fixed length would not need."""
    alu = add_ = fma = 0.0
    for length, n in length_counts.items():
        for salt in salts:
            w = salted_pair_work(variant, length, bytes(salt))
            alu += n * w.alu
            add_ += n * w.add
            fma += n * w.fma
    return Work(alu, add_, fma)


# ---- the PMKID kernel ------------------------------------------------------

def sha1_compress_work(state_var: bool, message) -> dict:
    """One SHA-1 compression with its feed-forward, by pipe: the
    chaining state all ``Var`` (state_var) or the IV, over ``message``
    (16 words, each an int or a ``Var``)."""
    state = [Var("alu", 0, []) for _ in range(5)] if state_var else None
    out = _sha1(list(message), state)
    if state_var:
        out = [add(o, s) for o, s in zip(out, state)]
    return tally(out)


def pmkid_compressions(iterations: int, n_targets: int = 1) -> dict:
    """SHA-1 compressions of one candidate, by kind: ``key`` the four
    HMAC key states (passphrase and PMK, from the IV), ``first`` the two
    U1 inner blocks (salt || INT(i), a message fixed per job), ``block20``
    the HMAC compressions over a 20-byte message: U1's outer, 2 x
    (iterations - 1) per PBKDF2 block, and 2 per target."""
    return {"key": 4, "first": 2,
            "block20": 2 * (1 + 2 * (iterations - 1)) + 2 * n_targets}


def pmkid_ops(length: int, iterations: int, n_targets: int = 1) -> Work:
    """The least work of one PMKID candidate: its decode, every
    compression with every message word variable but the truly constant
    ones (the 0x80 marker, zeros and bit length of a 20-byte block; the
    job's fixed first blocks), the 5 xors of T per iteration and block,
    and 4 compares per target."""
    v = [Var("alu", 0, []) for _ in range(16)]
    block20 = v[:5] + [0x80000000] + [0] * 9 + [(64 + 20) * 8]
    first = [1] * 16                      # fixed per job: folds
    per = {"key": sha1_compress_work(False, v),
           "first": sha1_compress_work(True, first),
           "block20": sha1_compress_work(True, block20)}
    alu = add_ = fma = 0
    for kind, n in pmkid_compressions(iterations, n_targets).items():
        alu += n * per[kind]["alu"]
        add_ += n * per[kind]["add"]
        fma += n * per[kind]["fma"]
    alu += 2 * 5 * (iterations - 1) + 4 * n_targets + length
    return Work(alu, add_ + length, fma + 2 * length)


def kdf_compressions(iterations: int, n_words: int) -> dict:
    """SHA-1 compressions of one KDF candidate, by kind (as
    ``pmkid_compressions``): the two key states, then per PBKDF2 block
    (one for n_words <= 5, else two) its U1 inner block and 1 + 2 x
    (iterations - 1) over a 20-byte message."""
    blocks = 1 if n_words <= 5 else 2
    return {"key": 2, "first": blocks,
            "block20": blocks * (1 + 2 * (iterations - 1))}


def kdf_ops(length: int, iterations: int, n_words: int) -> Work:
    """The least work of one KDF candidate: its decode, the compressions
    counted as ``pmkid_ops`` counts them and the 5 xors of T per
    iteration and block; the output words are stores."""
    v = [Var("alu", 0, []) for _ in range(16)]
    block20 = v[:5] + [0x80000000] + [0] * 9 + [(64 + 20) * 8]
    per = {"key": sha1_compress_work(False, v),
           "first": sha1_compress_work(True, [1] * 16),
           "block20": sha1_compress_work(True, block20)}
    alu = add_ = fma = 0
    for kind, n in kdf_compressions(iterations, n_words).items():
        alu += n * per[kind]["alu"]
        add_ += n * per[kind]["add"]
        fma += n * per[kind]["fma"]
    blocks = 1 if n_words <= 5 else 2
    alu += blocks * 5 * (iterations - 1) + length
    return Work(alu, add_ + length, fma + 2 * length)


# ---- the Kerberos RC4 kernel -----------------------------------------------

def md5_compress_work(state_var: bool, message) -> dict:
    """One MD5 compression with its feed-forward, by pipe: the chaining
    state all ``Var`` (state_var) or the IV, over ``message`` (16 words,
    each an int or a ``Var``)."""
    iv = [int(v) for v in md5.INIT]
    state = [Var("alu", 0, []) for _ in range(4)] if state_var else iv
    out = _md5(list(message), state)
    return tally([add(o, s) for o, s in zip(out, state)])


#: one RC4 step's least instructions: j's sum (IADD3) and its & 255
#: (LOP3), then S[j]'s shared-memory address, (j >> 2) * 4 * threads +
#: (j & 3) + the thread's base (two ALU ops, an IADD3); S[i]'s address
#: is a constant offset of the base
RC4_STEP = Work(alu=3, add=2, fma=0)
#: a kept output byte: (S[i] + S[j]) & 255 (IADD3, LOP3), its address
#: (two ALU ops, an IADD3), its place in the word (PRMT)
RC4_OUT_BYTE = Work(alu=4, add=2, fma=0)
#: shared-memory accesses of one candidate's RC4: 64 word stores of the
#: initial state, two loads and two stores a step (256 + 12 steps), a
#: load per kept output byte (4)
RC4_SHARED = 64 + 4 * (256 + 12) + 4
#: shared memory serves 32 accesses a clock per SM (one warp's, without
#: bank conflicts)
SHARED_READS_PER_SM_CLOCK = 32


def krb5_compressions(per_ticket: bool = False) -> dict:
    """The MD5 compressions of the krb5 kernel, by kind: ``key`` an HMAC
    key state (a 16-byte key from the IV), ``inner`` an inner hash over
    a message fixed per launch or ticket (msg_type, the checksum),
    ``outer`` an outer hash over the 16-byte inner digest.  Once per
    candidate: K1 = HMAC-MD5(NT, msg_type) (two key states, an inner and
    an outer hash) and K1's two key states; per ticket (``per_ticket``):
    K3's inner and outer hash over the checksum."""
    if per_ticket:
        return {"key": 0, "inner": 1, "outer": 1}
    return {"key": 4, "inner": 1, "outer": 1}


def krb5_ops(length: int, n_tickets: int = 1, decode: bool = True) -> Work:
    """The least issue work of one (candidate, ticket) pair of the krb5
    kernel, in a launch whose ``n_tickets`` tickets share each
    candidate's work (csrc/krb5.cu).  Per ticket: K3's two MD5
    compressions, the 16 key bytes' extracts, RC4's 256 + 12 steps and 4
    kept bytes, and the masked compare (LOP3, ISETP).  Per candidate,
    1 / ``n_tickets`` of it a pair: the decode, the MD4 block over the
    widened candidate with its feed-forward and six MD5 compressions (K1
    and its key states); the decode only with ``decode`` (the rules
    kernel has none)."""
    md4_block = list(message_block("ntlm", length))
    for w in range(-(-2 * length // 4)):
        md4_block[w] = Var("alu", 0, [])
    nt = _md4(md4_block)
    cand = tally([add(o, int(s)) for o, s in zip(nt, md4.INIT)])
    v = [Var("alu", 0, []) for _ in range(4)]
    per = {"key": md5_compress_work(False, v + [0x36363636] * 12),
           "inner": md5_compress_work(True, [2, 0x80] + [0] * 12
                                      + [(64 + 4) * 8, 0]),
           "outer": md5_compress_work(True, v + [0x80] + [0] * 9
                                      + [(64 + 16) * 8, 0])}
    ticket = {pipe: 0 for pipe in cand}
    for work, per_ticket in ((cand, False), (ticket, True)):
        for kind, n in krb5_compressions(per_ticket).items():
            for pipe in work:
                work[pipe] += n * per[kind][pipe]
    steps = 256 + 12
    share = 1 / n_tickets
    dec = length if decode else 0
    return Work(ticket["alu"] + 16 + steps * RC4_STEP.alu
                + 4 * RC4_OUT_BYTE.alu + 2 + share * (cand["alu"] + dec),
                ticket["add"] + steps * RC4_STEP.add + 4 * RC4_OUT_BYTE.add
                + share * (cand["add"] + dec),
                ticket["fma"] + share * (cand["fma"] + 2 * dec))


def krb5_bound(batch: int, length: int, sms: int, clock_hz: float,
               n_tickets: int = 1) -> dict:
    """Two limits on a launch of ``batch`` candidates over a group of
    ``n_tickets`` tickets, in seconds: ``issue``, ``krb5_ops``'s slots a
    pair (64 lanes a pipe per SM per clock); ``shared``, RC4's
    shared-memory accesses a pair and the decode's table reads a
    candidate at 32 per SM per clock."""
    pairs = batch * n_tickets
    issue = pairs * krb5_ops(length, n_tickets).slots / (sms * 64 * clock_hz)
    shared = (pairs * RC4_SHARED + batch * length) / (
        sms * SHARED_READS_PER_SM_CLOCK * clock_hz)
    return {"issue": issue, "shared": shared}


def rules_krb5_bound(length_counts: dict, n_tickets: int, sms: int,
                     clock_hz: float) -> dict:
    """``krb5_bound``'s two limits on a launch of the rules kernel's
    Kerberos tail over the candidates of ``length_counts``
    (``rule_lengths``) and a group of ``n_tickets``: ``issue``, each
    pair's ``krb5_ops`` without a decode; ``shared``, RC4's accesses a
    pair."""
    pairs = sum(length_counts.values()) * n_tickets
    issue = sum(n * n_tickets * krb5_ops(length, n_tickets, False).slots
                for length, n in length_counts.items())
    return {"issue": issue / (sms * 64 * clock_hz),
            "shared": pairs * RC4_SHARED / (
                sms * SHARED_READS_PER_SM_CLOCK * clock_hz)}


# ---- the bcrypt kernels ----------------------------------------------------

#: one Feistel round's least instructions: per S-box read a byte
#: extract and an address (LEA), F's middle xor, and one LOP3 that xors
#: F and the P word into the other half, on the INT32 pipe; F's two adds
BCRYPT_ROUND = Work(alu=4 * 2 + 1 + 1, add=2, fma=0)
#: S-box reads of one round
BCRYPT_ROUND_READS = 4
#: the dependent chain of one round in cycles, for the latency limit:
#: extract, address, the shared read (~30 cycles, an assumed Hopper
#: figure, not measured), two adds and two xors at ~4 cycles each
BCRYPT_ROUND_LATENCY = 6 * 4 + 30


def bcrypt_rounds(cost_rounds: int = 0, setup: bool = False,
                  finish: bool = False) -> int:
    """Feistel rounds of one candidate: 16 per encryption, 521
    encryptions per ExpandKey, two ExpandKeys per cost round; setup is
    one ExpandKey, finish 3 x 64 encryptions."""
    enc = 2 * 521 * cost_rounds + 521 * setup + 3 * 64 * finish
    return 16 * enc


def bcrypt_bound(batch: int, rounds: int, sms: int, clock_hz: float,
                 threads_per_sm: int) -> dict:
    """Three limits on ``batch`` candidates of ``rounds`` Feistel rounds
    each, in seconds: ``shared``, the S-box reads at 32 per SM per
    clock; ``issue``, BCRYPT_ROUND's slots (64 lanes a pipe per SM per
    clock); ``latency``, each candidate's serial chain at
    BCRYPT_ROUND_LATENCY cycles a round, threads_per_sm chains an SM
    at once (the shared memory a block takes decides it), waves of
    sms * threads_per_sm candidates."""
    shared = batch * rounds * BCRYPT_ROUND_READS / (
        sms * SHARED_READS_PER_SM_CLOCK * clock_hz)
    issue = batch * rounds * BCRYPT_ROUND.slots / (sms * 64 * clock_hz)
    waves = -(-batch // (sms * threads_per_sm))
    latency = waves * rounds * BCRYPT_ROUND_LATENCY / clock_hz
    return {"shared": shared, "issue": issue, "latency": latency}


# ---- the 7-Zip KDF kernel --------------------------------------------------

def sha256_compress_work(state_var: bool, message) -> dict:
    """One SHA-256 compression with its feed-forward, by pipe: the
    chaining state all ``Var`` (state_var) or the IV, over ``message``
    (16 words, each an int or a ``Var``)."""
    iv = [int(v) for v in sha256.INIT]
    state = [Var("alu", 0, []) for _ in range(8)] if state_var else iv
    out = _sha256(list(message), state)
    return tally([add(o, s) for o, s in zip(out, state)])


def sevenzip_compressions(length: int, salt_len: int, cycles: int) -> int:
    """SHA-256 compressions of one 7-Zip KDF candidate: the 2^cycles
    units of salt || UTF-16LE(pw) || LE64(i) in 64-byte blocks, then the
    padding block (the stream ends on a block boundary)."""
    unit = salt_len + 2 * length + 8
    return (unit << cycles) // 64 + 1


def sevenzip_ops(length: int, salt_len: int, cycles: int) -> Work:
    """The least work of one 7-Zip KDF candidate: its decode and every
    compression with all 16 message words and the chaining state
    variable (the stream's words mix the password, the salt and the
    running counter, so none folds; the padding block's fixed words are
    not worth the distinction at ~10^5 compressions); gathering a block
    from the stream is not counted."""
    v = [Var("alu", 0, []) for _ in range(16)]
    per = sha256_compress_work(True, v)
    n = sevenzip_compressions(length, salt_len, cycles)
    return Work(n * per["alu"] + length, n * per["add"] + length,
                n * per["fma"] + 2 * length)


def sevenzip_bound(batch: int, length: int, salt_len: int, cycles: int,
                   sms: int, clock_hz: float) -> dict:
    """The issue limit on ``batch`` 7-Zip KDF candidates, in seconds:
    ``sevenzip_ops``'s slots at 64 lanes a pipe per SM per clock."""
    work = sevenzip_ops(length, salt_len, cycles)
    return {"issue": batch * work.slots / (sms * 64 * clock_hz)}


# ---- the PDF kernel --------------------------------------------------------

def pdf_rc4(rev: int) -> tuple:
    """(RC4 runs, kept output bytes a run) of one PDF candidate: R2 one
    run and 4 bytes, R3+ 20 runs of 16."""
    return (1, 4) if rev == 2 else (20, 16)


def pdf_shared(rev: int) -> int:
    """Shared-memory accesses of one candidate's RC4: per run 64 word
    stores of the initial state, two loads and two stores a step (256
    key-schedule steps and one output step per kept byte) and a load per
    kept byte."""
    runs, kept = pdf_rc4(rev)
    return runs * (64 + 4 * 256 + 5 * kept)


def pdf_compressions(rev: int) -> dict:
    """MD5 compressions of one candidate, by kind: ``block1`` Algorithm
    2's first block (pad32(password) || O, from the IV), ``block2`` the
    document's second block (fixed words, a variable state), ``stretch``
    R3+'s 50 over digest[:key_len] from the IV."""
    return {"block1": 1, "block2": 1, "stretch": 0 if rev == 2 else 50}


def pdf_ops(length: int, rev: int, key_len: int) -> Work:
    """The least issue work of one PDF candidate: the decode, the MD5
    compressions (O, block 2 and the stretch's padding words fold as
    job constants), per RC4 run the key's xor with the pass (one LOP3 a
    key word, R3+ only), one extract a key byte, 256 + kept steps and the
    kept bytes (each xored into U for R3+), and the compare."""
    block1 = [Var("alu", 0, []) if 4 * w < length else 1 for w in range(8)]
    v = [Var("alu", 0, []) for _ in range(4)]
    nw = -(-key_len // 4)
    stretch = v[:nw] + [0x80] * (key_len % 4 == 0) + \
        [0] * (14 - nw - (key_len % 4 == 0)) + [8 * key_len, 0]
    per = {"block1": md5_compress_work(False, block1 + [1] * 8),
           "block2": md5_compress_work(True, [1] * 16),
           "stretch": md5_compress_work(False, stretch)}
    work = {"alu": length, "add": length, "fma": 2 * length}
    for kind, n in pdf_compressions(rev).items():
        for pipe in work:
            work[pipe] += n * per[kind][pipe]
    runs, kept = pdf_rc4(rev)
    steps = 256 + kept
    xor_pass = 0 if rev == 2 else nw
    xor_u = 0 if rev == 2 else kept
    work["alu"] += runs * (xor_pass + key_len + steps * RC4_STEP.alu
                           + kept * RC4_OUT_BYTE.alu + xor_u) \
        + (1 if rev == 2 else 4)
    work["add"] += runs * (steps * RC4_STEP.add + kept * RC4_OUT_BYTE.add)
    return Work(work["alu"], work["add"], work["fma"])


def pdf_bound(batch: int, length: int, rev: int, key_len: int, sms: int,
              clock_hz: float) -> dict:
    """Two limits on ``batch`` PDF candidates, in seconds: ``issue``,
    ``pdf_ops``'s slots (64 lanes a pipe per SM per clock); ``shared``,
    RC4's shared-memory accesses and the decode's table reads at 32 per
    SM per clock."""
    issue = batch * pdf_ops(length, rev, key_len).slots / (
        sms * 64 * clock_hz)
    shared = batch * (pdf_shared(rev) + length) / (
        sms * SHARED_READS_PER_SM_CLOCK * clock_hz)
    return {"issue": issue, "shared": shared}
