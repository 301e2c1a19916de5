"""End to end: the port's CLI (``--device torch-cpu`` and ``--device
cpu``) against the reference CLI (``--device tpu`` on CPU XLA) on the
same planted ?l?l?l hashlists -- one md5 target, and benchmark config 2
in miniature (1,000 NTLM targets) -- the found set and the potfile must
be equal, byte for byte."""

import hashlib
import random

import pytest

from dprf_tpu.cli import main as ref_main
from dprf_tpu_torch.cli import main as port_main

MASK = "?l?l?l"


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _crack(main, tmp_path, capsys, device, plain, tag, extra=()):
    digest = hashlib.md5(plain).hexdigest()
    hashfile = tmp_path / f"{tag}.txt"
    hashfile.write_text(f"# planted\n{digest}\n")
    pot = tmp_path / f"{tag}.pot"
    rc, out = _run(main, ["crack", MASK, str(hashfile), "--engine", "md5",
                          "--device", device, "--potfile", str(pot),
                          "--batch", "1024", "--unit-size", "4096", "-q",
                          *extra], capsys)
    found = sorted(ln for ln in out.splitlines() if ":" in ln)
    return rc, found, pot.read_text() if pot.exists() else ""


@pytest.fixture(scope="module")
def ref_results(tmp_path_factory):
    """The reference CLI's results, once per planted word and flags."""
    return {}


@pytest.mark.parametrize("device", ["torch-cpu", "cpu"])
@pytest.mark.parametrize("plain,extra,found", [
    (b"aaa", (), True),                     # first index
    (b"zzz", (), True),                     # last index, partial batch
    (b"qjx", (), True),                     # index 11073
    (b"qjx", ("--skip", "12000"), False),
    (b"qjx", ("--skip", "100", "--limit", "12000"), True),
])
def test_found_set_and_potfile_match_reference(tmp_path, capsys, device,
                                               plain, extra, found,
                                               ref_results):
    key = (plain, extra)
    if key not in ref_results:
        ref_results[key] = _crack(ref_main, tmp_path, capsys, "tpu", plain,
                                  "ref", extra)
    want = ref_results[key]
    got = _crack(port_main, tmp_path, capsys, device, plain, "port", extra)
    assert got == want
    if found:
        assert want[0] == 0
        assert want[1] == [f"{hashlib.md5(plain).hexdigest()}:"
                           f"{plain.decode()}"]
    else:
        assert want[0] == 1 and want[1] == [] and want[2] == ""


def test_potfile_preload_skips_cracked(tmp_path, capsys):
    digest = hashlib.md5(b"abc").hexdigest()
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(digest + "\n")
    pot = tmp_path / "p.pot"
    pot.write_text(f"{digest}:abc\n")
    rc, out = _run(port_main, ["crack", MASK, str(hashfile), "--engine",
                               "md5", "--device", "torch-cpu", "--potfile",
                               str(pot), "-q"], capsys)
    assert rc == 0 and out.splitlines() == [f"{digest}:abc"]
    assert pot.read_text() == f"{digest}:abc\n"


def test_engines_and_keyspace(capsys):
    names = ("7z, bcrypt, keccak-224, keccak-256, keccak-384, keccak-512, "
             "keccak224, keccak256, keccak384, keccak512, krb5asrep, "
             "krb5asrep-aes, krb5asrep17, krb5asrep18, krb5pa, krb5pa17, "
             "krb5pa18, krb5tgs, krb5tgs-aes, krb5tgs17, krb5tgs18, ldap-md5, "
             "ldap-sha, ldap-smd5, ldap-ssha, ldap-ssha512, md5, md5(md5), "
             "md5(sha1), md5-ps, md5-sp, mssql2000, mssql2005, mssql2012, "
             "mssql2014, mysql-old, mysql323, mysql41, ntlm, oracle-11g, "
             "oracle11, pdf, pmkid, postgres, postgres-md5, sevenzip, sha-1, "
             "sha-256, sha-384, sha-512, sha1, sha1(md5), sha1(sha1), sha1-ps, "
             "sha1-sp, sha224, sha256, sha256(md5), sha256(sha1), sha256-ps, "
             "sha256-sp, sha3, sha3-224, sha3-256, sha3-384, sha3-512, sha384, "
             "sha512, sha512-ps, sha512-sp, ssha, ssha512, wpa2-pmkid")
    assert _run(port_main, ["engines"], capsys) == \
        (0, f"cpu: {names}\ncuda: {names}\n")
    assert _run(port_main, ["keyspace", "?l?l?l?l?l?l"], capsys) == \
        (0, "308915776\n")
    assert _run(port_main, ["keyspace", "?1?d", "--custom1", "abc"],
                capsys) == (0, "30\n")


@pytest.fixture(scope="module")
def ntlm_list(tmp_path_factory):
    """Config 2 in miniature (tests/test_multi_target.py's list): 60
    planted ?l?l?l passwords and 940 fillers outside the keyspace, in a
    shuffled 1,000-hash NTLM list; and the reference CLI's result."""
    from dprf_tpu_torch.engines import get_engine
    from dprf_tpu_torch.generators.mask import MaskGenerator
    rng = random.Random(42)
    gen = MaskGenerator(MASK)
    oracle = get_engine("ntlm")
    planted = [gen.candidate(i)
               for i in sorted(rng.sample(range(gen.keyspace), 60))]
    fillers = [f"xx{i:06d}".encode() for i in range(940)]
    digests = [d.hex() for d in oracle.hash_batch(planted + fillers)]
    rng.shuffle(digests)
    tmp = tmp_path_factory.mktemp("ntlm1k")
    hashfile = tmp / "ntlm1k.txt"
    hashfile.write_text("\n".join(digests) + "\n")
    return hashfile, planted


def _crack_list(main, hashfile, pot, device, capsys):
    rc, out = _run(main, ["crack", MASK, str(hashfile), "--engine", "ntlm",
                          "--device", device, "--potfile", str(pot),
                          "--batch", "2048", "--unit-size", "8192", "-q"],
                   capsys)
    return rc, sorted(out.splitlines()), pot.read_text()


@pytest.mark.parametrize("device", ["torch-cpu", "cpu"])
def test_config2_miniature_matches_reference(tmp_path, capsys, device,
                                             ntlm_list, ref_results):
    hashfile, planted = ntlm_list
    if "ntlm1k" not in ref_results:
        ref_results["ntlm1k"] = _crack_list(ref_main, hashfile,
                                            tmp_path / "ref.pot", "tpu",
                                            capsys)
    want = ref_results["ntlm1k"]
    got = _crack_list(port_main, hashfile, tmp_path / "port.pot", device,
                      capsys)
    assert got == want
    assert want[0] == 0 and len(want[1]) == 60
    assert sorted(ln.split(":", 1)[1].encode() for ln in want[1]) == \
        sorted(planted)


@pytest.mark.parametrize("engine", ["ntlm", "sha1", "sha256"])
def test_bench_takes_its_miss_target_from_the_engine(capsys, engine):
    """bench sweeps against the engine's own digest of a string longer
    than the mask (an md5 digest would not even parse as a sha target),
    and finds nothing."""
    import json
    rc, out = _run(port_main, ["bench", "--engine", engine, "--mask", "?l?l",
                               "--device", "torch-cpu", "--seconds", "0.05",
                               "-q"], capsys)
    assert rc == 0
    res = json.loads(out.splitlines()[-1])
    assert (res["engine"], res["hits"]) == (engine, 0)
    assert res["candidates"] >= 26 * 26


@pytest.fixture(scope="module")
def config3_list(tmp_path_factory):
    """Config 3 in miniature: a 200-word list of 1-12 lowercase letters,
    and two candidates of it under best64 to plant: word 5 under a
    two-op rule, the last word under the last rule."""
    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.rules import load_rules
    rng = random.Random(3)
    words = [bytes(rng.choice(b"abcdefghijklmnopqrstuvwxyz")
                   for _ in range(rng.randint(1, 12))) for _ in range(200)]
    path = tmp_path_factory.mktemp("config3") / "words.txt"
    path.write_bytes(b"\n".join(words) + b"\n")
    gen = WordlistRulesGenerator(words, load_rules("best64"))
    planted = [gen.candidate(gen.index_of(5, 40)),
               gen.candidate(gen.index_of(199, 63))]
    return path, planted


def _crack_words(main, words, hashfile, pot, device, capsys):
    rc, out = _run(main, ["crack", "--engine", "sha256", "-a", "wordlist",
                          str(words), str(hashfile), "--rules", "best64",
                          "--device", device, "--potfile", str(pot), "-q"],
                   capsys)
    return rc, sorted(out.splitlines()), \
        pot.read_text() if pot.exists() else ""


@pytest.mark.parametrize("device", ["torch-cpu", "cpu"])
@pytest.mark.parametrize("which", [0, 1])
def test_config3_miniature_matches_reference(tmp_path, capsys, device, which,
                                             config3_list, ref_results):
    """crack --engine sha256 -a wordlist --rules best64, one planted
    target a job (the rule kernel takes one target): the found set and
    the potfile equal the reference CLI's."""
    words, planted = config3_list
    plain = planted[which]
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(hashlib.sha256(plain).hexdigest() + "\n")
    key = ("config3", which)
    if key not in ref_results:
        ref_results[key] = _crack_words(ref_main, words, hashfile,
                                        tmp_path / "ref.pot", "cpu", capsys)
    want = ref_results[key]
    got = _crack_words(port_main, words, hashfile, tmp_path / "port.pot",
                       device, capsys)
    assert got == want
    line = f"{hashlib.sha256(plain).hexdigest()}:{plain.decode()}"
    assert want == (0, [line], line + "\n")


def test_config3_target_list(tmp_path, capsys, config3_list):
    """Two targets: --device cpu finds both, as the reference does, and
    so does torch-cpu, whose rule kernel takes a list (the probe and the
    verify of its plain version): the same found set and potfile."""
    words, planted = config3_list
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("".join(hashlib.sha256(p).hexdigest() + "\n"
                                for p in planted))
    want = _crack_words(ref_main, words, hashfile, tmp_path / "ref.pot",
                        "cpu", capsys)
    assert want[0] == 0 and len(want[1]) == 2
    for device in ("cpu", "torch-cpu"):
        rc, out, pot = _crack_words(port_main, words, hashfile,
                                    tmp_path / f"port-{device}.pot", device,
                                    capsys)
        assert (rc, out, sorted(pot.splitlines())) == \
            (want[0], want[1], sorted(want[2].splitlines())), device


def test_config3_keyspace_matches_reference(capsys, config3_list):
    words, _ = config3_list
    for argv in (["keyspace", str(words), "-a", "wordlist", "--rules",
                  "best64"],
                 ["keyspace", str(words), "-a", "wordlist"],
                 ["keyspace", str(words), "-a", "wordlist", "--rules",
                  "toggle", "--max-len", "8"]):
        want = _run(ref_main, argv, capsys)
        assert _run(port_main, argv, capsys) == want
    assert want[0] == 0 and int(want[1]) > 0
    assert _run(port_main, ["keyspace", str(words), "-a", "wordlist",
                            "--rules", "best64"], capsys) == (0, "12800\n")


def test_config3_device_cuda_without_card_fails(tmp_path, capsys,
                                                monkeypatch, config3_list):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words, planted = config3_list
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(hashlib.sha256(planted[0]).hexdigest() + "\n")
    rc = port_main(["crack", "--engine", "sha256", "-a", "wordlist",
                    str(words), str(hashfile), "--rules", "best64",
                    "--no-potfile"])
    captured = capsys.readouterr()
    assert rc == 2 and captured.out == ""
    assert "--device cuda needs an NVIDIA card" in captured.err
