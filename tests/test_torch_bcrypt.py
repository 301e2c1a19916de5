"""Config 4 in miniature: the port's bcrypt path against the JAX package.
The plain EksBlowfish stages (the bcrypt kernels' plain version,
ops/blowfish.py) against the reference on the same seeded inputs at a
batch of 4 (the jnp cost rounds; setup and the digest against the
reference oracle's own ExpandKey and encryptions); ChunkedEks's
launches against one reference call; the cost range; the oracle copy
and the host helpers; the wordlist and mask workers' lanes, partial
batches and rescan.  The plain chain is ~10^5
torch ops per ExpandKey, so no test here runs a whole cost-4 chain:
the kernels' chain is held to the oracle at cost 4 and 5 on the card
(chip_smoke.py, tests/test_torch_cuda.py).  Exact equality throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.engines.cpu import bcrypt as ref_bcrypt
from dprf_tpu.ops import blowfish as ref_bf
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.cpu import bcrypt
from dprf_tpu_torch.engines.device import bcrypt as dev_bcrypt
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import blowfish, cuda_bcrypt
from dprf_tpu_torch.rules import parser
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

SALT = bytes(range(16))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def state():
    """Four seeded passwords and a salt; the reference's setup (its
    oracle's salted ExpandKey, pure Python: a jitted jnp stage costs
    seconds of compile on one core), then its jitted jnp eks_rounds
    from that state (1, then 1 more), and the digest after 1 round."""
    rng = np.random.default_rng(4)
    pws = [bytes(rng.integers(1, 256, int(n), dtype=np.uint8))
           for n in (0, 5, 40, 72)]
    salt = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    sw = ref_bf.salt_to_words(salt)
    P0, S0 = [], []
    for pw in pws:
        bf = ref_bcrypt._Blowfish()
        bf.expand_key((pw + b"\0")[:72], [int(w) for w in sw])
        P0.append(bf.p)
        S0.append([w for box in bf.s for w in box])
    P0, S0 = np.array(P0, np.uint32), np.array(S0, np.uint32)
    buf = np.zeros((4, 72), np.uint8)
    for i, pw in enumerate(pws):
        buf[i, :len(pw)] = np.frombuffer(pw, np.uint8)
    lens = np.array([len(pw) for pw in pws], np.int32)
    kw = np.asarray(ref_bf.key_words_from_candidates(jnp.asarray(buf),
                                                     jnp.asarray(lens)))
    s18 = ref_bf.salt18_words(jnp.asarray(sw))
    rounds = jax.jit(ref_bf.eks_rounds)
    P1, S1 = rounds(jnp.asarray(P0), jnp.asarray(S0), jnp.asarray(kw), s18,
                    jnp.int32(1))
    P2, S2 = rounds(P1, S1, jnp.asarray(kw), s18, jnp.int32(1))
    # the digest: the oracle's final stage (64 encryptions of each magic
    # block) from the jnp state, in pure Python
    dw = []
    for p, sbox in zip(np.asarray(P1), np.asarray(S1)):
        bf = ref_bcrypt._Blowfish()
        bf.p = [int(x) for x in p]
        bf.s = [[int(x) for x in sbox[i:i + 256]] for i in range(0, 1024, 256)]
        words = [int(x) for x in ref_bf.MAGIC_WORDS]
        for b in range(0, 6, 2):
            for _ in range(64):
                words[b], words[b + 1] = bf._encrypt(words[b], words[b + 1])
        dw.append(words)
    dw = np.array(dw, np.uint32)
    return {"buf": buf, "lens": lens, "kw": kw, "sw": sw,
            "s18": np.asarray(s18), "P0": P0, "S0": S0,
            **{k: np.asarray(v) for k, v in
               (("P1", P1), ("S1", S1), ("P2", P2), ("S2", S2), ("dw", dw))}}


def test_setup_and_digest_match_reference(state):
    """The key words, setup (fresh P/S and the salted ExpandKey) and the
    digest with its 23-byte compare and lane mask, exact."""
    kw = blowfish.key_words_from_candidates(torch.as_tensor(state["buf"]),
                                            torch.as_tensor(state["lens"]))
    assert (_u32(kw) == state["kw"]).all()
    P, S = cuda_bcrypt.eks_setup(kw, state["sw"])
    assert (_u32(P) == state["P0"]).all() and (_u32(S) == state["S0"]).all()
    assert (blowfish.salt18_words(state["sw"]) == state["s18"]).all()
    P1, S1 = _t(state["P1"]), _t(state["S1"])
    target = blowfish.digest_to_words(
        blowfish.words_to_digests(state["dw"][2:3])[0])
    count, lanes, digest = cuda_bcrypt.eks_finish(P1, S1, None, 4, target, 8)
    assert (_u32(digest) == state["dw"]).all()
    assert int(count) == 1 and lanes.tolist()[:2] == [2, -1]
    valid = torch.tensor([True, True, False, True])
    count, _, _ = cuda_bcrypt.eks_finish(P1, S1, valid, 4, target, 8)
    assert int(count) == 0
    count, _, _ = cuda_bcrypt.eks_finish(P1, S1, None, 2, target, 8)
    assert int(count) == 0


def test_chunked_rounds_match_reference(state):
    """Two cost rounds through ChunkedEks (a 1-round launch, then the
    calibrated rest) equal the reference's jnp eks_rounds: its n = 1
    after the first launch, n = 1 twice at the end."""
    seen = []

    def advance(*args):
        seen.append(cuda_bcrypt.eks_advance(*args))
        return seen[-1]

    chunker = dev_bcrypt.ChunkedEks(dispatch_s=60.0, advance=advance)
    P, S = chunker.run(_t(state["P0"]), _t(state["S0"]), _t(state["kw"]),
                       state["s18"], 2)
    assert chunker.chunks == [1, 1]
    assert (_u32(seen[0][0]) == state["P1"]).all()
    assert (_u32(seen[0][1]) == state["S1"]).all()
    assert (_u32(P) == state["P2"]).all() and (_u32(S) == state["S2"]).all()


def test_chunking_grows_toward_the_budget():
    """Calibrated, a chain splits into launches of at most dispatch_s
    each, growing by at most GROWTH_CAP, and one that fits goes in one
    launch without a sync; the state is carried through every launch."""
    calls = []

    def advance(P, S, key, salt18, n):
        calls.append(n)
        return P + n, S

    chunker = dev_bcrypt.ChunkedEks(dispatch_s=1.0, advance=advance)
    P = torch.zeros((1, 18), dtype=torch.int32)
    S = torch.zeros((1, 1024), dtype=torch.int32)
    chunker._per_round = 1e-3                     # calibrated: 1 ms a round
    chunker._last_chunk = 16
    P2, _ = chunker.run(P, S, None, None, 4096)
    assert calls[0] == 128 and sum(calls) == 4096 and int(P2[0, 0]) == 4096
    for i, n in enumerate(calls[1:], 1):          # grows at most 8x
        assert n <= 8 * max(calls[:i])
    calls.clear()
    P3, _ = chunker.run(P, S, None, None, 7)       # fits: one launch
    assert calls == [7] and chunker.chunks == [7] and int(P3[0, 0]) == 7


def test_n_rounds_range():
    assert dev_bcrypt._n_rounds(4) == 16
    assert dev_bcrypt._n_rounds(30) == 1 << 30
    for cost in (3, 31):
        with pytest.raises(ValueError, match="--device cpu"):
            dev_bcrypt._n_rounds(cost)


@pytest.mark.parametrize("length", [0, 1, 7, 71, 72, 80])
def test_key_words_match_reference(length):
    rng = np.random.default_rng(length)
    cand = rng.integers(1, 256, (3, max(length, 1)), dtype=np.uint8)
    lens = np.full(3, length, np.int32)
    got = blowfish.key_words_from_candidates(torch.as_tensor(cand),
                                             torch.as_tensor(lens))
    want = ref_bf.key_words_from_candidates(jnp.asarray(cand),
                                            jnp.asarray(lens))
    assert (_u32(got) == np.asarray(want)).all()


def test_host_helpers_and_oracle_copy_match_reference():
    rng = np.random.default_rng(9)
    digest = bytes(rng.integers(0, 256, 23, dtype=np.uint8))
    assert (blowfish.salt_to_words(SALT) == ref_bf.salt_to_words(SALT)).all()
    assert (blowfish.digest_to_words(digest)
            == ref_bf.digest_to_words(digest)).all()
    words = rng.integers(0, 2 ** 32, (3, 6), dtype=np.uint64).astype(np.uint32)
    assert blowfish.words_to_digests(words) == ref_bf.words_to_digests(words)
    assert blowfish.words_to_digests(words.view(np.int32)) == \
        ref_bf.words_to_digests(words)
    assert (blowfish.P0 == ref_bf.P0).all() and (blowfish.S0 == ref_bf.S0).all()
    assert bcrypt.bcrypt_raw(b"hunter2", SALT, 4) == \
        ref_bcrypt.bcrypt_raw(b"hunter2", SALT, 4)
    line = ref_bcrypt.bcrypt_hash(b"x", SALT, 4, "2y")
    assert bcrypt.parse_hash(line) == ref_bcrypt.parse_hash(line)
    eng = get_engine("bcrypt")
    t = eng.parse_target(
        "$2a$05$CCCCCCCCCCCCCCCCCCCCC.E5YPO9kmyuRGyh0XouQYb4YMJKvyOeW")
    assert eng.verify(b"U*U", t)
    for bad in ("$2x$05$" + "C" * 53, "$2a$03$" + "C" * 53):
        with pytest.raises(ValueError):
            eng.parse_target(bad)


@pytest.fixture
def stub_chain(monkeypatch):
    """The workers' plumbing on CPU tensors with the key schedule left
    out: setup made "P = the key words, S = the initial boxes", advance
    the identity, so a "digest" is finish over that.  Returns (chain,
    oracle): chain(cands) -> those digests, and an oracle engine whose
    hash_batch is the same chain (for the rescan)."""
    S0 = torch.as_tensor(blowfish.S0.view(np.int32))

    def setup(key, salt_words):
        return key.clone(), S0.expand(key.shape[0], 1024).clone()

    monkeypatch.setattr(cuda_bcrypt, "eks_setup", setup)
    monkeypatch.setattr(cuda_bcrypt, "eks_advance",
                        lambda P, S, key, salt18, n: (P, S))

    def chain(cands):
        buf = np.zeros((len(cands), 72), np.uint8)
        for i, c in enumerate(cands):
            buf[i, :len(c)] = np.frombuffer(c, np.uint8)
        key = blowfish.key_words_from_candidates(
            torch.as_tensor(buf),
            torch.as_tensor(np.array([len(c) for c in cands], np.int32)))
        return blowfish.words_to_digests(
            blowfish.bcrypt_digest_words(*setup(key, None)).numpy())

    oracle = get_engine("bcrypt")
    monkeypatch.setattr(type(oracle), "hash_batch",
                        lambda self, cands, params=None: chain(cands))
    return chain, oracle


def _stub_target(chain, oracle, plain: bytes):
    line = bcrypt.bcrypt_hash(b"-", SALT, 4)[:29] + \
        bcrypt.b64_encode(chain([plain])[0])[:31]
    return oracle.parse_target(line)


def test_wordlist_worker_lanes_rules_and_rescan(stub_chain):
    """Rule-major lanes map to keyspace indices, a unit that cuts a
    word's rules drops the hits outside it, and hit capacity 0 sends the
    window to the oracle rescan (an oracle of the same chain)."""
    chain, oracle = stub_chain
    rules = [parser.parse_rule(r) for r in ("u", "$1")]
    gen = WordlistRulesGenerator([b"beta", b"gamma", b"delta"], rules,
                                 max_len=72)
    plant = gen.index_of(1, 0)                       # "GAMMA"
    target = _stub_target(chain, oracle, b"GAMMA")
    dev = get_engine("bcrypt", "cuda", torch_device="cpu")
    for cap, unit, want in ((8, WorkUnit(0, 0, gen.keyspace), [plant]),
                            (8, WorkUnit(1, plant + 1, 3), []),
                            (0, WorkUnit(2, 1, gen.keyspace - 1), [plant])):
        w = dev.make_wordlist_worker(gen, [target], batch=4,
                                     hit_capacity=cap, oracle=oracle)
        assert w.word_batch == 2 and w.stride == 4
        hits = w.submit(unit).resolve()
        assert [(h.target_index, h.cand_index, h.plaintext)
                for h in hits] == [(0, i, b"GAMMA") for i in want]


def test_mask_worker_lanes_partial_batch_and_rescan(stub_chain):
    """The mask worker over x?l in batches of 16 (the last holds 10): a
    target at the first index and one at the last valid lane of the
    partial batch are found; a unit that ends one short leaves the
    second lane decoded but past n_valid, so it is not reported; hit
    capacity 0 recovers both by the oracle rescan.  (Two bytes: a key
    whose NUL-terminated period divides 4 makes all 18 P words equal,
    and the stub's 64 encryptions then return the magic for any key.)"""
    chain, oracle = stub_chain
    gen = MaskGenerator("x?l")
    targets = [_stub_target(chain, oracle, p) for p in (b"xa", b"xz")]
    dev = get_engine("bcrypt", "cuda", torch_device="cpu")
    both = [(0, 0, b"xa"), (1, 25, b"xz")]
    for cap, unit, want in ((8, WorkUnit(0, 0, 26), both),
                            (8, WorkUnit(1, 0, 25), both[:1]),
                            (0, WorkUnit(2, 0, 26), both)):
        w = dev.make_mask_worker(gen, targets, batch=16, hit_capacity=cap,
                                 oracle=oracle)
        assert w.stride == 16
        hits = w.submit(unit).resolve()
        assert [(h.target_index, h.cand_index, h.plaintext)
                for h in hits] == want
