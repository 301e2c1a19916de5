"""Slice L in the port -- sha224, mysql323, LDAP {SHA}/{MD5}, the sha512
salts and MSSQL 2000/2005/2012 -- against the reference: the digest
words (``sha224_digest_words``, ``JaxMysql323Engine.digest_packed``), the
salted kernel's new variants' plain versions (``_salted_concat``, the
MSSQL engines' ``pre_salt``, then the digest), the oracles, the engine
names and the refusals on the card.  Inputs come from numpy seeds;
equality is exact throughout.

On the CPU the kernels' plain versions run, because their tensors lie on
the CPU; tests/test_torch_cuda.py and chip_smoke.py hold the kernels
against them on a card.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.engines import engine_names as ref_engine_names
from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.engines.device.engines import JaxMysql323Engine
from dprf_tpu.engines.device.salted import _salted_concat
from dprf_tpu.ops import pack as ref_pack
from dprf_tpu.ops.sha256 import INIT224 as REF_INIT224
from dprf_tpu.ops.sha256 import sha224_digest_words as ref_sha224
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import engine_names, get_engine
from dprf_tpu_torch.engines.cpu.engines import mysql323_words
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_ext, cuda_mask, opcount
from dprf_tpu_torch.ops.pack import pack_varlen
from dprf_tpu_torch.ops.sha256 import INIT224, sha224_digest_words

pytestmark = pytest.mark.smoke

#: the 13 names of slice L
SLICE_NAMES = {"sha224", "ldap-sha", "ldap-md5", "mysql323", "mysql-old",
               "sha512-ps", "sha512-sp", "ldap-ssha512", "ssha512",
               "mssql2000", "mssql2005", "mssql2012", "mssql2014"}


def _u32(t: torch.Tensor) -> list:
    return t.numpy().view(np.uint32).tolist()


def _candidates(rng, lengths) -> list:
    """Seeded candidates of the given lengths over bytes 1..255 with
    spaces and tabs mixed in."""
    pool = np.concatenate([np.arange(1, 256), [0x20] * 40, [0x09] * 40])
    return [bytes(rng.choice(pool, n).astype(np.uint8)) for n in lengths]


def _packed(cands) -> torch.Tensor:
    """Big-endian single blocks of the candidates (their bit length in
    word 15): int32[B, 16]."""
    width = max(len(c) for c in cands)
    buf = np.zeros((len(cands), width), np.uint8)
    for row, c in zip(buf, cands):
        row[:len(c)] = np.frombuffer(c, np.uint8)
    return pack_varlen(torch.as_tensor(buf), torch.as_tensor(
        [len(c) for c in cands], dtype=torch.int32), big_endian=True)


def test_sha224_digest_words_match_the_reference():
    """Random blocks and packed candidates of 0, 1, 27 and 55 bytes:
    the port's words equal the reference's, and hashlib's digest."""
    rng = np.random.default_rng(224)
    assert INIT224.tolist() == np.asarray(REF_INIT224).tolist()
    cands = _candidates(rng, [0, 1, 27, 55, 9])
    blocks = np.concatenate([
        _packed(cands).numpy().view(np.uint32),
        rng.integers(0, 1 << 32, (59, 16), dtype=np.uint32)])
    got = _u32(sha224_digest_words(torch.as_tensor(blocks.view(np.int32))))
    assert got == np.asarray(ref_sha224(jnp.asarray(blocks))).tolist()
    assert [np.asarray(w, ">u4").tobytes() for w in got[:len(cands)]] == \
        [hashlib.sha224(c).digest() for c in cands]


def test_mysql323_digest_words_match_the_reference():
    """The device engine's digest_packed on blocks of candidates of 0, 1,
    27 and 55 bytes and random lengths, spaces and tabs among the
    bytes: the reference's words bit for bit, and the oracle's."""
    rng = np.random.default_rng(323)
    cands = _candidates(rng, [0, 1, 27, 55, *rng.integers(0, 56, 60)])
    cands.append(b" \t \t")
    words = _packed(cands)
    dev = get_engine("mysql323", "cuda", torch_device="cpu")
    got = _u32(dev.digest_packed(words))
    ref = JaxMysql323Engine().digest_packed(
        jnp.asarray(words.numpy().view(np.uint32)))
    assert got == np.asarray(ref).tolist()
    assert got == [list(mysql323_words(c)) for c in cands]
    assert dev.hash_batch(cands) == get_engine("mysql323").hash_batch(cands)


#: per new salted variant: its mask (the widened ones of half the
#: positions, so every reference call of one core shares its shapes and
#: its compile), at salts of 0, 4 and 32 bytes; a batch of BATCH lanes
SALTED_CASES = {"sha512-ps": "?l?d?l?u?l?d", "sha512-sp": "?l?d?l?u?l?d",
                "sha1-ps-utf16": "?a?l?d", "sha512-ps-utf16": "?a?l?d"}
SALT_LENS = (0, 4, 32)
BATCH = 96


@pytest.fixture(scope="module")
def ref_salted():
    """The reference's device function of a salted job: the candidate
    bytes (pre-widened for MSSQL) through ``_salted_concat`` (its static
    salt buffer SALT_MAX), ``pack_varlen`` and ``digest_packed`` of the
    base engine; sha512's under one jit per (order, width) (its rounds
    are a fori_loop, quick to compile), sha1's eagerly (its unrolled
    rounds take seconds of XLA compile)."""
    fns = {}

    def run(algo, order, cand, salt):
        eng = ref_get_engine(algo, "jax")
        batch, width = cand.shape
        key = (algo, order, width)
        if key not in fns:
            def fn(c, s, n):
                byts, lens = _salted_concat(c, width, s, n, order, batch)
                return eng.digest_packed(eng.pack_varlen(byts, lens))
            fns[key] = jax.jit(fn) if algo == "sha512" else fn
        buf = np.zeros(cuda_ext.SALT_MAX, np.uint8)
        buf[:len(salt)] = np.frombuffer(salt, np.uint8)
        return np.asarray(fns[key](jnp.asarray(cand), jnp.asarray(buf),
                                   jnp.int32(len(salt)))).tolist()

    return run


@pytest.mark.parametrize("variant", sorted(SALTED_CASES))
def test_salted_variant_plain_matches_the_reference(variant, ref_salted):
    """The plain version's digest of every lane of a batch under a
    target's row (``salted_candidate_words``, ``salted_row_digest``:
    what ``salted_plain`` compares) at salts of 0, 4 and 32 bytes equals
    the reference's device function on the same candidates, and the CPU
    oracle's digest."""
    algo, order = cuda_ext.split_salted(variant)
    gen = MaskGenerator(SALTED_CASES[variant])
    rng = np.random.default_rng(sum(variant.encode()))
    batch = BATCH
    start = int(rng.integers(0, gen.keyspace - batch))
    lut = gen.charset_lut("cpu")
    cand = np.stack([np.frombuffer(gen.candidate(start + i), np.uint8)
                     for i in range(batch)])
    if cuda_ext.widened(variant):
        cand = np.asarray(ref_pack.utf16le_widen(jnp.asarray(cand)))
    for n in SALT_LENS:
        salt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        shift = n if order == "sp" else 0
        words = cuda_ext.salted_candidate_words(
            variant, lut, gen.radices, gen.digits(start), batch, shift)
        row = torch.as_tensor(cuda_ext.salted_rows(
            variant, gen.length, [(salt, [0] * (16 if algo == "sha512"
                                               else 5))]).view(np.int32))[0]
        got = _u32(cuda_ext.salted_row_digest(variant, words, row))
        assert got == ref_salted(algo, order, cand, salt), (variant, n)
        want = [hashlib.new(algo, (c.tobytes() + salt) if order == "ps"
                            else salt + c.tobytes()).digest() for c in cand]
        assert [np.asarray(w, ">u4").tobytes() for w in got] == want


@pytest.mark.parametrize("name", ["mssql2000", "mssql2005", "mssql2012"])
def test_mssql_plain_matches_the_reference_engine(name, ref_salted):
    """The MSSQL engines' path: the job's charset tables mapped by the
    engine's byte map (2000: ASCII uppercase), the UTF-16LE variant, a
    4-byte salt; the same digests as the reference engine's ``pre_salt``,
    then ``_salted_concat``, and as the port's and the reference's CPU
    oracles, for a mask with lower- and uppercase letters."""
    gen = MaskGenerator("?a?l?u")
    dev = get_engine(name, "cuda", torch_device="cpu")
    ref = ref_get_engine(name, "jax")
    rng = np.random.default_rng(len(name))
    batch, salt = BATCH, bytes(rng.integers(0, 256, 4, dtype=np.uint8))
    start = int(rng.integers(0, gen.keyspace - batch))
    plains = [gen.candidate(start + i) for i in range(batch)]
    cand = np.asarray(ref.pre_salt(jnp.asarray(np.stack(
        [np.frombuffer(p, np.uint8) for p in plains]))))
    lut = cuda_ext.mapped_lut(gen, "cpu", dev.byte_map)
    words = cuda_ext.salted_candidate_words(dev.variant, lut, gen.radices,
                                            gen.digits(start), batch, 0)
    row = torch.as_tensor(cuda_ext.salted_rows(dev.variant, gen.length, [
        (salt, [0] * dev.digest_words)]).view(np.int32))[0]
    got = _u32(cuda_ext.salted_row_digest(dev.variant, words, row))
    assert got == ref_salted(dev.algo, "ps", cand, salt)
    digests = [np.asarray(w, ">u4").tobytes() for w in got]
    params = {"salt": salt}
    assert digests == get_engine(name).hash_batch(plains, params=params)
    assert digests == ref_get_engine(name).hash_batch(plains, params=params)
    assert digests == dev.hash_batch(plains, params=params)


def test_salted_rows_place_the_widened_candidate_and_the_salt():
    """A UTF-16LE variant's fixed words: the salt at byte 2L, the marker
    after it, the bit length (2L + S) * 8; sha512's rows are 48 words,
    the block's 32 then the digest's 16."""
    salt = b"\x01\x02\x03\x04"
    block = cuda_ext.salted_block("sha1-ps-utf16", 3, salt)
    msg = b"".join(int(w).to_bytes(4, "big") for w in block)
    assert msg[:6] == bytes(6) and msg[6:11] == salt + b"\x80"
    assert int(block[15]) == (2 * 3 + 4) * 8
    rows = cuda_ext.salted_rows("sha512-ps-utf16", 3, [(salt, [7] * 16)])
    assert rows.shape == (1, cuda_ext.SALTED_WIDE_ROW)
    assert rows[0, 31] == (2 * 3 + 4) * 8 and rows[0, 32:].tolist() == [7] * 16
    with pytest.raises(ValueError, match="exceeds the 55-byte block"):
        cuda_ext.salted_rows("sha1-ps-utf16", 26, [(salt, [0] * 5)])


def test_engine_names_of_the_slice():
    """The 13 names of slice L on cuda and on the port's cpu, every one a
    name of the reference's device engines; 73 names in all."""
    cuda, cpu = set(engine_names("cuda")), set(engine_names("cpu"))
    assert SLICE_NAMES <= cuda == cpu
    assert SLICE_NAMES <= set(ref_engine_names("jax"))
    assert len(cuda) == 73


def test_cores_keep_their_instantiation_names():
    """ldap-sha and ldap-md5 run the sha1 and md5 cores: their launches
    count under ``sha1_mask``, ``md5_rules`` and the like; mysql323 has
    no Bloom-sets instantiation, so its lists run the probe."""
    assert get_engine("ldap-sha", "cuda").core == "sha1"
    assert cuda_mask.device_engine("ldap-md5").core == "md5"
    assert cuda_mask.kernel_eligible("ldap-sha", MaskGenerator("?l"), 9)
    assert "mysql323_mask_multi" not in cuda_mask.launches
    assert {"sha224_mask", "sha224_mask_multi", "sha224_mask_probe",
            "mysql323_mask", "mysql323_mask_probe"} <= set(cuda_mask.launches)
    assert {"sha512-ps_group", "sha512-sp_group", "sha1-ps-utf16_group",
            "sha512-ps-utf16_group"} <= set(cuda_ext.launches)
    with pytest.raises(ValueError, match="Bloom sets"):
        cuda_mask.check_tables(cuda_mask.device_engine("mysql323"),
                               None, None, "cpu")


def test_mysql323_bound_counts_the_skip_where_a_charset_holds_one():
    """The mysql323 bound: the scan, and a skip test only at positions
    whose charset holds a space or a tab."""
    plain = opcount.mysql323_ops(MaskGenerator("?l?l?l"))
    spaced = opcount.mysql323_ops(MaskGenerator("?l?1?l", {1: b"ab \t"}))
    assert spaced.alu == plain.alu + opcount.MYSQL323_SKIP.alu
    assert (spaced.add, spaced.fma) == (plain.add, plain.fma)


@pytest.mark.parametrize("argv", [
    ["sha224", "-a", "wordlist", "W", "H224"],
    ["mysql323", "-a", "wordlist", "W", "H323"],
    ["sha512-ps", "-a", "wordlist", "W", "HPSW"],
    ["mssql2005", "?l" * 26, "HMS"],
    ["sha512-ps", "?l" * 108, "HPS"],
    ["sha3-224", "?l", "HMANY"]])
def test_device_cuda_refuses_what_the_kernels_do_not_take(
        tmp_path, capsys, monkeypatch, argv):
    """On --device cuda (torch made to report a card: the refusals come
    before any launch): a mask past a variant's block and more than
    8,192 targets of a Keccak engine (a sha224 list of any length runs on
    the card) exit 2 naming --device cpu.  A sha224, mysql323 or sha512
    salted wordlist, refused before the rules kernel took their cores
    (sha512-ps's since csrc/rules_wide.cu), runs (on --device torch-cpu,
    the kernel's plain version) and finds its plant."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    runs = argv[-1] in ("H224", "H323", "HPSW")
    plant = None
    if runs:
        params = {"salt": b"salt"} if argv[0] == "sha512-ps" else None
        plant = get_engine(argv[0]).hash_batch([b"alpha"], params)[0].hex()
        plant += ":salt" if params else ""
    files = {
        "W": "alpha\n", "H224": f"{plant}\n", "H323": f"{plant}\n",
        "HPS": "00" * 64 + ":salt\n", "HPSW": f"{plant}\n",
        "HMS": "0x0100" + "00" * 24 + "\n",
        "HMANY": "".join(f"{i:056x}\n" for i in range(8193))}
    args = []
    for a in argv[1:]:
        if a in files:
            (tmp_path / a).write_text(files[a])
            a = str(tmp_path / a)
        args.append(a)
    if runs:
        assert port_main(["crack", *args, "--engine", argv[0], "--device",
                          "torch-cpu", "--no-potfile", "-q"]) == 0
        assert capsys.readouterr().out == f"{plant}:alpha\n"
        return
    assert port_main(["crack", *args, "--engine", argv[0],
                      "--no-potfile"]) == 2
    err = capsys.readouterr().err
    assert "--device cpu" in err and "needs an NVIDIA card" not in err
