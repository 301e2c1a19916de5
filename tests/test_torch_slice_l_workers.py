"""Slice L's workers in the port against the reference's CpuWorker on
the same targets, on the CPU (``torch-cpu``: each launch runs its
kernel's plain version): targets planted at the first, the last and a
seeded keyspace index for sha224 and mysql323 at one target and in a
list (mysql323's lists on the blocked probe), ldap-sha and ldap-md5 on
the sha1 and md5 cores (a mask list, a wordlist with rules, the sharded
runtime), a group of sha512-ps targets with salts of 0..32 bytes,
sha512-sp at two salt lengths, and mssql2000 with a lowercase plant
under ``?a``, whose other cases hit too.  Exact equality of the hit
sets.
"""

import base64

import numpy as np
import pytest

from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.generators.wordlist import \
    WordlistRulesGenerator as RefWordlistRulesGenerator
from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_ext, cuda_mask
from dprf_tpu_torch.parallel import make_mesh
from dprf_tpu_torch.rules import load_rules
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

BATCH = 4096


def _line(name: str, digest: bytes, salt: bytes = b"") -> str:
    """A target line of ``name`` in its own format."""
    if name in ("ldap-sha", "ldap-md5"):
        return "{" + name[5:].upper() + "}" + base64.b64encode(digest).decode()
    if name == "ldap-ssha512":
        return "{SSHA512}" + base64.b64encode(digest + salt).decode()
    if name.startswith("mssql"):
        tag = "0200" if name == "mssql2012" else "0100"
        pre = digest.hex() if name == "mssql2000" else ""
        return f"0x{tag}{salt.hex()}{pre}{digest.hex()}"
    if salt or name.endswith(("-ps", "-sp")):
        return f"{digest.hex()}:$HEX[{salt.hex()}]"
    return digest.hex()


def _job(name, mask, plants, salts=None, custom=None):
    """Targets of ``name`` for the candidates at ``plants`` (None: a
    candidate outside the mask), each with its salt: (port targets,
    reference targets, lines)."""
    gen = MaskGenerator(mask, custom)
    oracle = get_engine(name)
    lines = []
    for i, p in enumerate(plants):
        salt = salts[i] if salts else b""
        plain = gen.candidate(p) if p is not None else b"\x01~not-in-mask"
        params = {"salt": salt} if oracle.salted else None
        lines.append(_line(name, oracle.hash_batch([plain], params)[0],
                           salt))
    return ([oracle.parse_target(ln) for ln in lines],
            [ref_get_engine(name).parse_target(ln) for ln in lines], lines)


def _reference(name, gen_ref, ref_targets, start, length):
    return sorted((h.target_index, h.cand_index, h.plaintext) for h in
                  RefCpuWorker(ref_get_engine(name), gen_ref, ref_targets)
                  .process(RefWorkUnit(0, start, length)))


def _hits(hits):
    return sorted((h.target_index, h.cand_index, h.plaintext) for h in hits)


def _mask_case(name, mask, plants, salts=None, custom=None, sharded=0,
               cap=8):
    gen = MaskGenerator(mask, custom)
    targets, ref_targets, _ = _job(name, mask, plants, salts, custom)
    dev = get_engine(name, "cuda", torch_device="cpu")
    oracle = get_engine(name)
    if sharded:
        w = dev.make_sharded_mask_worker(
            gen, targets, make_mesh(devices=["cpu"] * sharded), BATCH,
            hit_capacity=cap, oracle=oracle)
    else:
        w = dev.make_mask_worker(gen, targets, BATCH, hit_capacity=cap,
                                 oracle=oracle)
    got = _hits(w.process(WorkUnit(0, 0, gen.keyspace)))
    want = _reference(name, RefMaskGenerator(mask, custom), ref_targets, 0,
                      gen.keyspace)
    assert got == want
    return got, w


@pytest.mark.parametrize("name", ["sha224", "mysql323", "mysql-old"])
def test_one_target_and_a_list(name):
    """One target at the last index; a list planted at the first, the
    last and a seeded index, and a target no candidate reaches."""
    gen = MaskGenerator("?l?d?l")
    rnd = int(np.random.default_rng(len(name)).integers(1, gen.keyspace - 1))
    got, w = _mask_case(name, "?l?d?l", [gen.keyspace - 1])
    assert [g[1] for g in got] == [gen.keyspace - 1]
    got, w = _mask_case(name, "?l?d?l", [0, gen.keyspace - 1, rnd, None])
    assert sorted(g[1] for g in got) == sorted([0, gen.keyspace - 1, rnd])
    if name != "sha224":              # mysql323 lists: the blocked probe
        assert w.n_maybe() >= 3
        assert type(w).__name__ == "CudaMaskWorker"


def test_mysql323_skips_spaces_and_tabs():
    """A mask whose charsets hold a space and a tab: the candidates that
    differ only by them collide, as the oracle says, and all hit."""
    got, _ = _mask_case("mysql323", "?1?l?1", [5], custom={1: b"a \t"})
    assert len(got) > 1


@pytest.mark.parametrize("name", ["ldap-sha", "ldap-md5"])
def test_ldap_plain_schemes_on_their_cores(name):
    """A list of {SHA} / {MD5} lines on the sha1 / md5 core, one target
    on the rules kernel's core over a wordlist with best64, and the
    sharded runtime over 4 CPU shards."""
    gen = MaskGenerator("?l?l?d")
    cuda_mask.reset_launches()
    _mask_case(name, "?l?l?d", [0, gen.keyspace - 1, 777])
    core = get_engine(name, "cuda").core
    assert cuda_mask.launches[f"{core}_mask_multi"] == 0   # the CPU: plain
    _mask_case(name, "?l?l?d", [gen.keyspace - 1], sharded=4)
    _mask_case(name, "?l?l?d", [0, 4321, None], sharded=4)
    words = [b"alpha", b"bravo", b"Pass1", b"zulu99"]
    rules = load_rules("best64")
    wgen = WordlistRulesGenerator(words, rules, 55)
    plant = wgen.keyspace - 3
    oracle = get_engine(name)
    line = _line(name, oracle.hash_batch([wgen.candidate(plant)])[0])
    dev = get_engine(name, "cuda", torch_device="cpu")
    w = dev.make_wordlist_worker(wgen, [oracle.parse_target(line)], 1024,
                                 hit_capacity=8, oracle=oracle)
    got = _hits(w.process(WorkUnit(0, 0, wgen.keyspace)))
    want = sorted((h.target_index, h.cand_index, h.plaintext) for h in
                  RefCpuWorker(ref_get_engine(name),
                               RefWordlistRulesGenerator(words, rules, 55),
                               [ref_get_engine(name).parse_target(line)])
                  .process(RefWorkUnit(0, 0, wgen.keyspace)))
    assert got == want and plant in [g[1] for g in got]


def test_sha512_ps_group_of_every_salt_length():
    """A sha512-ps group of 33 targets, salts of 0..32 bytes (one
    launch a batch), plants at the first, the last and a seeded index
    under the empty, the longest and a middle salt."""
    gen = MaskGenerator("?l?d")
    rng = np.random.default_rng(512)
    salts = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
             for n in range(cuda_ext.SALT_MAX + 1)]
    plants = [None] * len(salts)
    plants[0], plants[32], plants[16] = 0, gen.keyspace - 1, 123
    got, w = _mask_case("sha512-ps", "?l?d", plants, salts)
    assert [(g[0], g[1]) for g in got] == \
        [(0, 0), (16, 123), (32, gen.keyspace - 1)]
    assert [len(idx) for idx, _ in w.groups] == [33]


def test_sha512_sp_at_two_salt_lengths():
    """sha512-sp targets of two salt lengths: two groups, one launch a
    group and batch."""
    gen = MaskGenerator("?l?d")
    salts = [b"ab", b"cd", b"x" * 32]
    got, w = _mask_case("sha512-sp", "?l?d", [0, None, gen.keyspace - 1],
                        salts)
    assert [(g[0], g[1]) for g in got] == [(0, 0), (2, gen.keyspace - 1)]
    assert sorted(len(idx) for idx, _ in w.groups) == [1, 2]


def test_ldap_ssha512_and_mssql2012_on_the_wide_core():
    """{SSHA512} lines and MSSQL 2012 logins hit on sha512's wide
    variants."""
    gen = MaskGenerator("?d?l")
    _mask_case("ldap-ssha512", "?d?l", [0, gen.keyspace - 1],
               [b"s\x00lt", b"12345678"])
    _mask_case("mssql2012", "?d?l", [7, gen.keyspace - 1],
               [b"\x01\x02\x03\x04", b"abcd"])


def test_mssql2000_finds_every_case_of_a_lowercase_plant():
    """A login planted as lowercase under ?a?a: every case variant of it
    hits (the digest is of the uppercase), as the reference's oracle
    says; the reported plaintexts decode from the original charsets."""
    gen = MaskGenerator("?a?a")
    plant = gen.index_of(b"qz") if hasattr(gen, "index_of") else next(
        i for i in range(gen.keyspace) if gen.candidate(i) == b"qz")
    got, _ = _mask_case("mssql2000", "?a?a", [plant, None],
                        [b"\xde\xad\xbe\xef", b"salt"])
    assert sorted(g[2] for g in got) == [b"QZ", b"Qz", b"qZ", b"qz"]
    _mask_case("mssql2005", "?a?a", [plant], [b"\xde\xad\xbe\xef"])
