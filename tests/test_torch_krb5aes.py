"""Kerberos AES etypes 17/18 (krb5tgs-aes 19600/19700, krb5pa
19800/19900, krb5asrep-aes 32100) in the port (ops/aes.py,
engines/cpu/krb5aes.py, the KDF kernel's wrapper in ops/cuda_pbkdf2.py,
engines/device/krb5aes.py) against the reference (its AES, n-fold,
string-to-key, CTS, DER filter, the KDF kernel's lane function
``pbkdf2_lanes`` run eagerly, ``make_krb5aes_check``, the oracle and the
CLI) and against hashlib and the RFC vectors.  Exact equality
throughout.  Iterations are lowered through the engines' class
attribute on both sides, as the reference's tests lower them.

On the CPU the worker's step runs the KDF kernel's plain version;
tests/test_torch_cuda.py holds the kernel against it on a card.
"""

import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.cli import main as ref_main
from dprf_tpu.engines.cpu import krb5aes as ref_cpu
from dprf_tpu.engines.device import krb5aes as ref_dev
from dprf_tpu.ops import aes as ref_aes
from dprf_tpu.ops import hmac_sha1 as ref_hmac
from dprf_tpu.ops.pallas_pbkdf2 import pbkdf2_lanes
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.cpu import krb5aes
from dprf_tpu_torch.engines.cpu.krb5 import der
from dprf_tpu_torch.engines.cpu.krb5aes import (USAGE_AS_REP,
                                                USAGE_PA_TIMESTAMP,
                                                USAGE_TGS_REP_TICKET,
                                                cts_decrypt, cts_encrypt,
                                                encrypt, nfold,
                                                string_to_key)
from dprf_tpu_torch.engines.device import krb5aes as dev
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import aes, cuda_pbkdf2, hmac_sha1
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

USAGES = (USAGE_PA_TIMESTAMP, USAGE_TGS_REP_TICKET, USAGE_AS_REP)


@pytest.fixture
def low_iterations(monkeypatch):
    monkeypatch.setattr(krb5aes._Krb5AesEngine, "iterations", 3)
    monkeypatch.setattr(ref_cpu._Krb5AesEngine, "iterations", 3)
    return 3


def _plain(usage: int, body_len: int, seed: int, tag: int = None) -> bytes:
    """A 16-byte confounder and a DER blob of the usage's shape."""
    rng = random.Random(seed * 100 + body_len)
    body = bytes(rng.randrange(256) for _ in range(body_len))
    if tag is None:
        tag = {USAGE_TGS_REP_TICKET: 0x63, USAGE_AS_REP: 0x79,
               USAGE_PA_TIMESTAMP: 0x30}[usage]
    inner = der(0xA0 if usage == USAGE_PA_TIMESTAMP else 0x30, body)
    return bytes(rng.randrange(256) for _ in range(16)) + der(tag, inner)


def _line(pw: bytes, tag_name: str, etype: int, usage: int, body_len: int,
          iterations: int, seed: int = 0, user: str = "svc",
          realm: str = "EX.COM") -> str:
    """A valid hash line: RFC 3962 run forward over ``_plain``."""
    chk, edata = encrypt(pw, (realm + user).encode(),
                         16 if etype == 17 else 32, usage,
                         _plain(usage, body_len, seed), iterations)
    return f"${tag_name}${etype}${user}${realm}${chk.hex()}${edata.hex()}"


def test_aes_vectors_and_reference():
    """FIPS-197 C.1 / C.3; the scalar and batch forms against the
    reference's on seeded keys and blocks."""
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    for key, ct in ((bytes(range(16)), "69c4e0d86a7b0430d8cdb78070b4c55a"),
                    (bytes(range(32)), "8ea2b7ca516745bfeafc49904b496089")):
        assert aes.aes_encrypt_block(key, pt).hex() == ct
        assert aes.aes_decrypt_block(key, bytes.fromhex(ct)) == pt
    rng = np.random.default_rng(6)
    for kl in (16, 32):
        keys = rng.integers(0, 256, (5, kl), dtype=np.uint8)
        blocks = rng.integers(0, 256, (5, 16), dtype=np.uint8)
        enc = aes.aes_encrypt_block_batch(torch.as_tensor(keys),
                                          torch.as_tensor(blocks)).numpy()
        ref_enc = np.asarray(ref_aes.aes_encrypt_block_batch(
            jnp.asarray(keys), jnp.asarray(blocks)))
        dec = aes.aes_decrypt_blocks(torch.as_tensor(keys), blocks[:2])
        ref_dec = np.asarray(ref_aes.aes_decrypt_blocks(jnp.asarray(keys),
                                                        blocks[:2]))
        assert (enc == ref_enc).all() and (dec.numpy() == ref_dec).all()
        for k, b, e in zip(keys, blocks, enc):
            assert e.tobytes() == ref_aes.aes_encrypt_block(k.tobytes(),
                                                            b.tobytes())
            assert aes.aes_decrypt_block(k.tobytes(), e.tobytes()) == \
                b.tobytes()


def test_rfc3961_3962_vectors():
    """n-fold, string-to-key (iteration counts that run fast) and the
    AES-128 CBC-CS3 vectors of RFC 3962 appendix B."""
    assert nfold(b"012345", 8).hex() == "be072631276b1955"
    assert nfold(b"password", 7).hex() == "78a07b6caf85fa"
    assert nfold(b"kerberos", 16).hex() == "6b65726265726f737b9b5b2b93132b93"
    assert nfold(b"Rough Consensus, and Running Code", 8).hex() == \
        "bb6ed30870b7f0e0"
    assert nfold(b"password", 21).hex() == \
        "59e4a8ca7c0385c3c37b3f6d2000247cb6e6bd5b3e"
    s = b"ATHENA.MIT.EDUraeburn"
    assert string_to_key(b"password", s, 16, 1).hex() == \
        "42263c6e89f4fc28b8df68ee09799f15"
    assert string_to_key(b"password", s, 32, 1).hex() == \
        "fe697b52bc0d3ce14432ba036a92e65bbb52280990a2fa27883998d72af30161"
    assert string_to_key(b"password", s, 16, 2).hex() == \
        "c651bf29e2300ac27fa469d693bdda13"
    key = bytes.fromhex("636869636b656e207465726979616b69")
    for pt, want in [
            ("I would like the ", "c6353568f2bf8cb4d8a580362da7ff7f97"),
            ("I would like the General Gau's ",
             "fc00783e0efdb2c1d445d4c8eff7ed2297687268d6ecccc0c07b25e25ecfe5"),
            ("I would like the General Gau's C",
             "39312523a78662d5be7fcbcc98ebf5a8"
             "97687268d6ecccc0c07b25e25ecfe584"),
            ("I would like the General Gau's Chicken, please,",
             "97687268d6ecccc0c07b25e25ecfe584b3fffd940c16a18c1b5549d2f838029e"
             "39312523a78662d5be7fcbcc98ebf5"),
            ("I would like the General Gau's Chicken, please, ",
             "97687268d6ecccc0c07b25e25ecfe5849dad8bbb96c4cdc03bc103e1a194bbd8"
             "39312523a78662d5be7fcbcc98ebf5a8")]:
        assert cts_encrypt(key, pt.encode()).hex() == want
        assert cts_decrypt(key, bytes.fromhex(want)) == pt.encode()


@pytest.mark.parametrize("body_len", [20, 60, 125, 126, 200, 252, 253,
                                      400, 65530, 70_000])
def test_der_filter_words_aes_every_form(body_len):
    """Every length form and usage, the AS-REP 0x7A tag too: the
    reference's words, and the true plaintext matches."""
    for usage in USAGES:
        for tag in ([0x79, 0x7A] if usage == USAGE_AS_REP else [None]):
            plain = _plain(usage, body_len, 1, tag)
            got = dev.der_filter_words_aes(len(plain), usage)
            assert got == ref_dev.der_filter_words_aes(len(plain), usage)
            expected, mask = got
            assert int.from_bytes(plain[16:20], "little") & mask == expected


def test_kdf_plain_matches_pbkdf2_lanes_and_hashlib():
    """The KDF kernel's plain version against the reference kernel's
    lane function (eager, 3 iterations, 8 words: T1 and T2) and hashlib
    at 4 and 8 words,
    salts of 1, 14 and 51 bytes; the salt blocks against the reference."""
    gen = MaskGenerator("?l?d?d?l")
    start, n = 4321, 128
    lut = gen.charset_lut()
    cands = [gen.candidate(start + i) for i in range(n)]
    byts = [jnp.asarray(np.array([c[p] for c in cands], np.uint32)
                        .reshape(1, 128)) for p in range(4)]
    for salt in (b"s", b"EXAMPLE.COMsvc", b"r" * 51):
        for i in (1, 2):
            assert (hmac_sha1.salt_block(salt, i)
                    == ref_hmac.salt_block(salt, i)).all()
        for n_words in (4, 8):
            got = cuda_pbkdf2.kdf_plain(lut, gen.radices, gen.digits(start),
                                        n, salt, 3, n_words, 256)
            got = got.numpy().view(np.uint32)
            assert got.shape == (n, n_words)
            if len(salt) == 14 and n_words == 8:
                with jax.disable_jit():
                    out = pbkdf2_lanes(byts, list(salt), len(salt),
                                       jnp.int32(3), n_words, (1, 128))
                want = np.stack([np.asarray(w).reshape(128) for w in out], 1)
                assert (got == want).all()
            for i in (0, n - 1):
                dk = hashlib.pbkdf2_hmac("sha1", cands[i], salt, 3,
                                         4 * n_words)
                assert got[i].tobytes() == np.frombuffer(
                    dk, ">u4").astype(np.uint32).tobytes()


def test_check_matches_reference():
    """``make_krb5aes_check`` on random 16- and 32-byte base keys against
    the reference's: each usage, both key widths, both length forms."""
    rng = np.random.default_rng(8)
    for usage, body_len, kl in ((USAGE_PA_TIMESTAMP, 60, 32),
                                (USAGE_TGS_REP_TICKET, 300, 16),
                                (USAGE_AS_REP, 300, 32)):
        edata = bytes(rng.integers(0, 256, 16 + body_len + 4,
                                   dtype=np.uint8))
        params = {"usage": usage, "edata": edata}
        base = rng.integers(0, 256, (6, kl), dtype=np.uint8)
        got = dev.make_krb5aes_check(params)(torch.as_tensor(base))
        want = ref_dev.make_krb5aes_check(params)(jnp.asarray(base))
        assert (got.numpy().view(np.uint32) == np.asarray(want)).all()


def test_filter_is_pbkdf2_then_the_check():
    """``make_krb5aes_filter`` (the plain path in one function) on
    candidates of several lengths equals hashlib's PBKDF2 followed by
    the check, at both key widths."""
    rng = np.random.default_rng(9)
    cand = rng.integers(32, 127, (6, 12), dtype=np.uint8)
    lens = np.array([1, 5, 8, 11, 12, 3], np.int32)
    edata = bytes(rng.integers(0, 256, 120, dtype=np.uint8))
    for kl in (16, 32):
        params = {"salt": b"EX.COMsvc", "key_len": kl,
                  "usage": USAGE_AS_REP, "edata": edata}
        got = dev.make_krb5aes_filter(params, 3)(torch.as_tensor(cand),
                                                 torch.as_tensor(lens))
        base = np.stack([np.frombuffer(hashlib.pbkdf2_hmac(
            "sha1", c[:n].tobytes(), b"EX.COMsvc", 3, kl), np.uint8)
            for c, n in zip(cand, lens)])
        want = dev.make_krb5aes_check(params)(torch.as_tensor(base))
        assert torch.equal(got, want)


def test_target_args_match_reference(low_iterations):
    """Each ticket's per-target arguments: the masked expectation against
    the reference's ``_expected_word``, salt and key width from the
    parsed line, the same on both oracles."""
    for tag, usage, etype in (("krb5tgs", USAGE_TGS_REP_TICKET, 18),
                              ("krb5asrep", USAGE_AS_REP, 17)):
        line = _line(b"pw", tag, etype, usage, 100, low_iterations,
                     user="WS01$", realm="CORP.LOCAL")
        name = {"krb5tgs": "krb5tgs-aes", "krb5asrep": "krb5asrep-aes"}[tag]
        t = get_engine(name).parse_target(line)
        rt = ref_cpu.Krb5TgsAesEngine().parse_target(line) \
            if tag == "krb5tgs" else \
            ref_cpu.Krb5AsRepAesEngine().parse_target(line)
        assert (t.raw, t.digest, t.params) == (rt.raw, rt.digest, rt.params)
        assert t.params["salt"] == b"CORP.LOCALWS01$"
        assert dev.expected_word(t.params) == int(np.asarray(
            ref_dev._expected_word(rt)).view(np.int32)[0])
        assert get_engine(name).verify(b"pw", t)


def test_worker_finds_planted_and_confirms_maybes(low_iterations,
                                                  monkeypatch):
    """Targets at the first index, the last (the last valid lane of a
    partial batch) and a short-form one, etype 17 and 18; hit capacity 0
    sends each to the oracle rescan; a
    prefilter that passes every lane has its false lanes dropped and
    counted."""
    gen = MaskGenerator("?d?d")
    last = gen.keyspace - 1
    eng = get_engine("krb5tgs-aes")
    targets = [eng.parse_target(_line(gen.candidate(i), "krb5tgs", et,
                                      USAGE_TGS_REP_TICKET, bl,
                                      low_iterations, seed=i))
               for i, et, bl in ((0, 18, 300), (last, 17, 100),
                                 (77, 18, 60))]
    want = [(0, 0), (2, 77), (1, last)]
    for cap in (8, 0):
        d = get_engine("krb5tgs-aes", "cuda", torch_device="cpu")
        w = d.make_mask_worker(gen, targets, batch=64, hit_capacity=cap,
                               oracle=eng)
        hits = w.process(WorkUnit(0, 0, gen.keyspace))
        assert [(h.target_index, h.cand_index) for h in hits] == want
        assert w.dispatched == 3 * 2
    w = d.make_mask_worker(gen, targets[:1], batch=100, hit_capacity=100,
                           oracle=eng)

    def always(base_digits, n_valid):
        return (torch.tensor([n_valid], dtype=torch.int32),
                torch.arange(100, dtype=torch.int32), None)

    monkeypatch.setattr(w, "groups", [([0], always)])
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert [(h.cand_index, h.plaintext) for h in hits] == [(0, b"00")]
    assert w.n_maybe() == gen.keyspace - 1


def _crack(main, device, tmp_path, capsys, engine, lines, mask="?d?d?d",
           extra=()):
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    pot = tmp_path / f"{device}.pot"
    rc = main(["crack", mask, str(hashfile), "--engine", engine,
               "--device", device, "--potfile", str(pot), *extra])
    out, err = capsys.readouterr()
    pots = sorted(pot.read_text().splitlines()) if pot.exists() else []
    return rc, sorted(out.splitlines()), pots, err


@pytest.mark.parametrize("engine,tag,usage", [
    ("krb5tgs-aes", "krb5tgs", USAGE_TGS_REP_TICKET),
    ("krb5asrep17", "krb5asrep", USAGE_AS_REP)])
def test_cli_matches_reference_cli(engine, tag, usage, tmp_path, capsys,
                                   low_iterations):
    """crack --device torch-cpu (the port) against the reference's crack
    --device cpu: the same found lines and potfile, etype 17 and 18
    tickets of the smallest DER form the card takes, planted early in
    ?d?d?d so that small units stop the oracle's sweep."""
    lines = [_line(b"000", tag, 18, usage, 60, low_iterations, 1),
             _line(b"001", tag, 17, usage, 61, low_iterations, 2,
                   user="other")]
    got = _crack(port_main, "torch-cpu", tmp_path, capsys, engine, lines,
                 extra=["--batch", "512"])
    want = _crack(ref_main, "cpu", tmp_path, capsys, engine, lines,
                  extra=["--unit-size", "2", "--unit-seconds", "0", "-q"])
    assert got[:3] == want[:3] and got[0] == 0 and len(got[1]) == 2
    assert "rejected=0" in got[3] and "maybes=" in got[3]


def test_envelope_and_wordlist_refusals(tmp_path, capsys, low_iterations):
    """A Pre-Auth timestamp under 64 bytes, a salt over 51 bytes and a
    wordlist job exit 2 naming --device cpu, the first two naming their
    hashlist line; --device cpu runs the short one."""
    short = _line(b"123", "krb5pa", 18, USAGE_PA_TIMESTAMP, 20,
                  low_iterations)
    ok = _line(b"124", "krb5pa", 18, USAGE_PA_TIMESTAMP, 70, low_iterations)
    rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys,
                           "krb5pa", [ok, short])
    assert rc == 2 and "line 2" in err and "--device cpu" in err
    long_salt = _line(b"1", "krb5tgs", 17, USAGE_TGS_REP_TICKET, 70,
                      low_iterations, user="u" * 40, realm="R" * 12)
    rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys,
                           "krb5tgs17", ["# a comment", long_salt])
    assert rc == 2 and "line 2" in err and "--device cpu" in err
    words = tmp_path / "w.txt"
    words.write_text("123\n")
    rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys,
                           "krb5tgs-aes", [ok.replace("krb5pa", "krb5tgs")],
                           mask=str(words), extra=["-a", "wordlist"])
    assert rc == 2 and "--device cpu" in err
    rc, out, _, _ = _crack(port_main, "cpu", tmp_path, capsys, "krb5pa",
                           [short], mask="?d?d?d",
                           extra=["--unit-size", "128"])
    assert rc == 0 and out == [f"{short}:123"]


@pytest.mark.parametrize("etype,usage", [(17, USAGE_AS_REP),
                                         (18, USAGE_TGS_REP_TICKET),
                                         (18, USAGE_PA_TIMESTAMP)])
def test_encrypt_inverts_the_reference_check(etype, usage):
    """The port's forward RFC 3962 (the test lines' maker) is what the
    reference's oracle checks: its checksum recomputed, its plaintext
    decrypted."""
    key_len, salt = 16 if etype == 17 else 32, b"EX.COMsvc"
    plain = _plain(usage, 70, 5)
    chk, edata = encrypt(b"pw", salt, key_len, usage, plain, 3)
    assert ref_cpu.krb5_aes_checksum(b"pw", salt, key_len, usage, edata,
                                     3) == chk
    ke, _ = ref_cpu.usage_keys(ref_cpu.string_to_key(b"pw", salt, key_len,
                                                     3), usage)
    assert ref_cpu.cts_decrypt(ke, edata) == plain


@pytest.mark.parametrize("cap", [0, 2, 4, 8])
def test_kdf_step_lanes_are_the_first_hits(cap, monkeypatch):
    """The step's count and lanes, made on the device without a host
    sync: every hit counted, the first ``cap`` lanes ascending, -1 past
    them (the check stubbed to hit lanes 3, 5, 9 and 40 of 50)."""
    gen = MaskGenerator("?d?d")
    t = get_engine("krb5tgs-aes").parse_target(
        _line(b"00", "krb5tgs", 17, USAGE_TGS_REP_TICKET, 100, 1))
    want = [3, 5, 9, 40]

    def check_of(params):
        def check(base):
            out = torch.full((base.shape[0], 1), -7, dtype=torch.int32)
            out[want] = dev.expected_word(params)
            return out
        return check

    monkeypatch.setattr(dev, "make_krb5aes_check", check_of)
    step = dev.make_kdf_step(gen, 64, t.params, cap, 1, "cpu")
    count, lanes, _ = step(gen.digits(0), 50)
    assert count.tolist() == [4] and count.dtype == torch.int32
    assert lanes.tolist() == (want[:cap] + [-1] * cap)[:cap]
