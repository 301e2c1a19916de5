"""Slice O end to end on the CPU: ``crack -a wordlist --device torch-cpu``
(the rules kernel's plain versions: its wide cores, sha512's salted
tails) against the reference CLI's ``--device cpu`` on the same word
list, rules and hashlist, for every name the slice takes: targets planted
at the first (word, rule) index, the last, a seeded one and a word of the
name's max_len kept as it is (for the sha3/keccak names of rate - 1
bytes, the pad byte and 0x80 in one byte), and one no candidate reaches:
the same found set and potfile.  The reference's XLA wordlist workers are
held against the port in test_torch_slice_o_jax*.py.
"""

import base64

import numpy as np
import pytest

from dprf_tpu.cli import main as ref_main
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.rules.parser import parse_rule

pytestmark = pytest.mark.smoke

#: a few words, and one at each max_len of the slice's names (53
#: mssql2012's, 55 sha3-256's, 71 sha3-512's, 79 the sha512 salts', 103,
#: 111, 135, 143), longer ones skipped where a name's limit is lower
WORDS = [b"alpha", b"Bravo", b"charlie", b"d3lta"] + [
    bytes(97 + (i * 7 + n) % 26 for i in range(n))
    for n in (53, 55, 71, 79, 103, 111, 135, 143)]
#: a rejecting rule ("<6") among them, and rules that grow a word past
#: max_len ("$! $!")
RULES = [":", "c", "u $1", "<6 r", "$! $!", "T0"]
#: the slice's 23 names: each with its targets' salt (None: unsalted)
NAMES = {"sha512": None, "sha-512": None, "sha384": None, "sha-384": None,
         "sha512-ps": b"NaCl", "sha512-sp": b"p" * 32,
         "ldap-ssha512": b"salt", "ssha512": b"\x00\x01\x02\x03\x04",
         "mssql2012": b"\x01\x02\x03\x04", "mssql2014": b"\xaa\xbb\xcc\xdd",
         **{n: None for n in (
             "sha3", "sha3-224", "sha3-256", "sha3-384", "sha3-512",
             "keccak-224", "keccak-256", "keccak-384", "keccak-512",
             "keccak224", "keccak256", "keccak384", "keccak512")}}


def line(name: str, plain: bytes, salt) -> str:
    """A target line of ``name`` in its own format for ``plain``."""
    d = get_engine(name).hash_batch([plain], None if salt is None
                                    else {"salt": salt})[0]
    if salt is None:
        return d.hex()
    if name.startswith("mssql"):
        return f"0x0200{salt.hex()}{d.hex()}".upper()
    if name in ("ldap-ssha512", "ssha512"):
        return "{SSHA512}" + base64.b64encode(d + salt).decode()
    return f"{d.hex()}:$HEX[{salt.hex()}]"


def hashlist(tmp_path, name: str, seed: int, n_plants: int = 4):
    """(lines, the word file, the rule file): ``n_plants`` targets planted
    -- the first and the last (word, rule) index, the word of max_len
    under ":", a seeded index -- and, for more than one, one no candidate
    reaches.  A salted list's targets differ in their salt's last byte."""
    max_len = get_engine(name).max_candidate_len
    kept = [w for w in WORDS if len(w) <= max_len]    # the CLI skips others
    gen = WordlistRulesGenerator(kept, [parse_rule(r) for r in RULES],
                                 max_len)
    longest = next(i for i, w in enumerate(kept) if len(w) == max_len)
    rng = np.random.default_rng(seed)
    idx = [0, gen.keyspace - 1, gen.index_of(longest, 0)]
    while len({gen.candidate(i) for i in idx} - {None}) < 4:
        idx.append(int(rng.integers(1, gen.keyspace - 1)))
    plants = list(dict.fromkeys(c for c in map(gen.candidate, idx)
                                if c is not None))
    plants = plants[:n_plants] if n_plants > 1 else plants[2:3]
    salt = NAMES[name]
    lines = []
    misses = [b"~~~~"] if n_plants > 1 else []
    for k, plain in enumerate(plants + misses):
        s = None if salt is None else \
            salt[:-1] + bytes([salt[-1] ^ k]) if salt else salt
        lines.append(line(name, plain, s))
    words = tmp_path / "words.txt"
    words.write_bytes(b"\n".join(WORDS) + b"\n")
    rules = tmp_path / "rules.rule"
    rules.write_text("\n".join(RULES) + "\n")
    return lines, str(words), str(rules)


def crack(main, tmp_path, capsys, name, words, rules, lines, device, tag):
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    pot = tmp_path / f"{tag}.pot"
    rc = main(["crack", "-a", "wordlist", words, str(hashfile), "--rules",
               rules, "--engine", name, "--device", device, "--potfile",
               str(pot), "--batch", "256", "-q"])
    out = sorted(ln for ln in capsys.readouterr().out.splitlines() if ln)
    return rc, out, sorted(pot.read_text().splitlines())


def same_as_the_reference(tmp_path, capsys, name, device, n_plants=4):
    """``name``'s wordlist job on the port's torch-cpu and the reference's
    ``device``: the same found set and potfile, every plant found."""
    lines, words, rules = hashlist(tmp_path, name, len(name), n_plants)
    want = crack(ref_main, tmp_path, capsys, name, words, rules, lines,
                 device, "ref")
    got = crack(port_main, tmp_path, capsys, name, words, rules, lines,
                "torch-cpu", "port")
    assert got == want
    assert want[0] == 0 and len(want[1]) == n_plants


@pytest.mark.parametrize("name", sorted(NAMES))
def test_cli_matches_the_reference(tmp_path, capsys, name):
    same_as_the_reference(tmp_path, capsys, name, "cpu")
