"""Slice N end to end on the CPU: ``crack -a wordlist --device torch-cpu``
(the rules kernel's plain versions: its new cores, its salted and
Kerberos tails) against the reference CLI's ``--device cpu`` on the same
word list, rules and hashlist -- targets planted at the first, the last
and a seeded (word, rule) index, and one no candidate reaches: the same
found set and potfile, for every name the slice takes; and a dense-hit
window at ``--hit-cap 1``, which the worker relaunches with a buffer of
its count, or, past ``relaunch_cap``, whose overflowing targets it
rescans (and only those), to the reference's found set.
"""

import numpy as np
import pytest

from dprf_tpu.cli import main as ref_main
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.cpu.krb5 import der, encrypt
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.rules.parser import parse_rule
from dprf_tpu_torch.runtime import worker as worker_mod

pytestmark = pytest.mark.smoke

WORDS = [b"alpha", b"Bravo", b"charlie", b"d3lta", b"echo", b"f0xtrot"]
#: a rejecting rule ("<6") among them
RULES = [":", "c", "u $1", "<6 r", "$! $!", "T0"]
#: the slice's 27 names: each with its targets' salt (None: unsalted)
NAMES = {
    "md5-ps": b"NaCl", "md5-sp": b"pepper", "sha1-ps": b"\x00\x01",
    "sha1-sp": b"", "sha256-ps": b"s" * 32, "sha256-sp": b"abc",
    "postgres": b"admin", "postgres-md5": b"svc", "ldap-smd5": b"\xfe\xff",
    "ldap-ssha": b"salt", "ssha": b"ssha", "oracle11": b"0123456789",
    "oracle-11g": b"ABCDEFGHIJ", "mssql2000": b"\x01\x02\x03\x04",
    "mssql2005": b"\x0a\x0b\x0c\x0d", "md5(md5)": None, "sha1(sha1)": None,
    "md5(sha1)": None, "sha1(md5)": None, "sha256(md5)": None,
    "sha256(sha1)": None, "mysql41": None, "krb5tgs": None,
    "krb5asrep": None, "sha224": None, "mysql323": None, "mysql-old": None}


def line(name: str, plain: bytes, salt, seed: int) -> str:
    """A target line of ``name`` in its own format for ``plain``."""
    import base64
    if name.startswith("krb5"):
        asrep = name == "krb5asrep"
        rng = np.random.default_rng(seed)
        body = der(0x79 if asrep else 0x63, der(0x30, bytes(rng.integers(
            0, 256, 50 + seed, dtype=np.uint8))))
        chk, edata = encrypt(plain, 8 if asrep else 2,
                             bytes(rng.integers(0, 256, 8, dtype=np.uint8))
                             + body)
        if asrep:
            return f"$krb5asrep$23$u@R:{chk.hex()}${edata.hex()}"
        return f"$krb5tgs$23$*u$R$s*${chk.hex()}${edata.hex()}"
    oracle = get_engine(name)
    d = oracle.hash_batch([plain], None if salt is None
                          else {"salt": salt})[0]
    if salt is None:
        return "*" + d.hex().upper() if name == "mysql41" else d.hex()
    if name.startswith("mssql"):
        case = d.hex() if name == "mssql2000" else ""
        return f"0x0100{salt.hex()}{case}{d.hex()}".upper()
    if name.startswith("postgres"):
        return f"md5{d.hex()}:{salt.decode()}"
    if name.startswith("ldap-s") or name == "ssha":
        tag = "SMD5" if name == "ldap-smd5" else "SSHA"
        return "{" + tag + "}" + base64.b64encode(d + salt).decode()
    if name.startswith("oracle"):
        return f"S:{d.hex().upper()}{salt.hex().upper()}"
    return f"{d.hex()}:$HEX[{salt.hex()}]"


def hashlist(tmp_path, name: str, seed: int):
    """(lines, the word file, the rule file): targets planted at the
    first, the last and a seeded (word, rule) index of the job, and one
    no candidate reaches."""
    max_len = get_engine(name).max_candidate_len
    gen = WordlistRulesGenerator(WORDS, [parse_rule(r) for r in RULES],
                                 max_len)
    rng = np.random.default_rng(seed)
    idx = [0, gen.keyspace - 1]
    while len({gen.candidate(i) for i in idx} - {None}) < 3:
        idx.append(int(rng.integers(1, gen.keyspace - 1)))
    plants = list(dict.fromkeys(c for c in map(gen.candidate, idx)
                                if c is not None))[:3]
    salt = NAMES[name]
    lines = []
    for k, plain in enumerate(plants + [b"~~~~"]):
        s = None if salt is None else \
            salt[:-1] + bytes([salt[-1] ^ k]) if salt else salt
        lines.append(line(name, plain, s, k))
    words = tmp_path / "words.txt"
    words.write_bytes(b"\n".join(WORDS) + b"\n")
    rules = tmp_path / "rules.rule"
    rules.write_text("\n".join(RULES) + "\n")
    return lines, str(words), str(rules)


def crack(main, tmp_path, capsys, name, words, rules, lines, device, tag,
          extra=()):
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    pot = tmp_path / f"{tag}.pot"
    rc = main(["crack", "-a", "wordlist", words, str(hashfile), "--rules",
               rules, "--engine", name, "--device", device, "--potfile",
               str(pot), "--batch", "256", "-q", *extra])
    out = sorted(ln for ln in capsys.readouterr().out.splitlines() if ln)
    return rc, out, sorted(pot.read_text().splitlines())


@pytest.mark.parametrize("name", sorted(NAMES))
def test_cli_matches_the_reference(tmp_path, capsys, name):
    lines, words, rules = hashlist(tmp_path, name, len(name))
    want = crack(ref_main, tmp_path, capsys, name, words, rules, lines,
                 "cpu", "ref")
    got = crack(port_main, tmp_path, capsys, name, words, rules, lines,
                "torch-cpu", "port")
    assert got == want
    assert want[0] == 0 and len(want[1]) == 3


def dense_crack(tmp_path, capsys, monkeypatch, name) -> tuple:
    """One word window holds every plant, some candidates at several
    (word, rule) lanes (":", "c" and "T0" agree on a capitalised word),
    and --hit-cap 1 holds one hit a target, so the window overflows: the
    reference's and the port's runs (asserted equal, every plant found),
    the port's workers and the job targets of each oracle rescan."""
    rescans, workers = [], []
    rescan = worker_mod.GroupedSweepWorker._rescan
    init = worker_mod.GroupedWordlistWorker.__init__

    def spy(self, tis, bstart, unit):
        rescans.append(tuple(tis))
        return rescan(self, tis, bstart, unit)

    def spy_init(self, *args, **kw):
        init(self, *args, **kw)
        workers.append(self)

    monkeypatch.setattr(worker_mod.GroupedSweepWorker, "_rescan", spy)
    monkeypatch.setattr(worker_mod.GroupedWordlistWorker, "__init__",
                        spy_init)
    lines, words, rules = hashlist(tmp_path, name, 3)
    lines[-1] = line(name, b"Bravo", NAMES[name], 9)   # at rules 0 and 1
    extra = ("--hit-cap", "1")
    want = crack(ref_main, tmp_path, capsys, name, words, rules, lines,
                 "cpu", "ref", extra)
    got = crack(port_main, tmp_path, capsys, name, words, rules, lines,
                "torch-cpu", "port", extra)
    assert got == want and len(want[1]) == 4
    return workers, rescans


@pytest.mark.parametrize("name", ["md5-ps", "krb5tgs"])
def test_dense_hits_relaunch_on_the_card(tmp_path, capsys, monkeypatch,
                                         name):
    """The overflowing (group, window) runs once more into buffers of
    its count, and nothing goes to the oracle rescan."""
    workers, rescans = dense_crack(tmp_path, capsys, monkeypatch, name)
    assert [(w.relaunches, w.rescans) for w in workers] == [(1, 0)]
    assert rescans == []


@pytest.mark.parametrize("name", ["md5-ps", "krb5tgs"])
def test_dense_hits_rescan_the_overflowing_targets(tmp_path, capsys,
                                                   monkeypatch, name):
    """Past ``relaunch_cap`` (0 here) the overflowing window is not
    relaunched: the worker rescans with the oracle only the targets whose
    own count its recorded hits miss -- some of the group, not all -- and
    finds the reference's set."""
    monkeypatch.setattr(worker_mod.GroupedWordlistWorker, "relaunch_cap", 0)
    workers, rescans = dense_crack(tmp_path, capsys, monkeypatch, name)
    assert [(w.relaunches, w.rescans) for w in workers] == [(0, 1)]
    assert len(rescans) == 1 and 0 < len(rescans[0]) < 4
