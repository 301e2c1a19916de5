"""Slice L end to end: for each of its 13 names, ``python -m
dprf_tpu_torch crack --device torch-cpu`` against the reference CLI's
``--device cpu`` on the same hashlist (targets planted at the first, the
last and a seeded index of a 3-position mask, and one no candidate
reaches): the same found set and the same potfile.
"""

import base64

import numpy as np
import pytest

from dprf_tpu.cli import main as ref_main
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.mask import MaskGenerator

pytestmark = pytest.mark.smoke

MASK = "?l?d?l"

#: each name of the slice, and the salt of its targets' lines
NAMES = {"sha224": None, "ldap-sha": None, "ldap-md5": None,
         "mysql323": None, "mysql-old": None, "sha512-ps": b"s:a\x00lt",
         "sha512-sp": b"NaCl", "ldap-ssha512": b"\x00\x01\x02\x03\x04",
         "ssha512": b"pepper", "mssql2000": b"\x01\x02\xfe\xff",
         "mssql2005": b"\x0a\x0b\x0c\x0d", "mssql2012": b"abcd",
         "mssql2014": b"\xff\x00\xff\x00"}


def line(name: str, digest: bytes, salt) -> str:
    """A target line of ``name`` in its own format."""
    if name in ("ldap-sha", "ldap-md5"):
        return "{" + name[5:].upper() + "}" + base64.b64encode(digest).decode()
    if name in ("ldap-ssha512", "ssha512"):
        return "{SSHA512}" + base64.b64encode(digest + salt).decode()
    if name.startswith("mssql"):
        tag = "0200" if name in ("mssql2012", "mssql2014") else "0100"
        case = digest.hex() if name == "mssql2000" else ""
        return f"0x{tag}{salt.hex()}{case}{digest.hex()}".upper()
    if salt is not None:
        return f"{digest.hex()}:$HEX[{salt.hex()}]"
    return digest.hex()


def hashlist(name: str, mask: str, seed: int) -> list:
    """Lines of targets planted at the first, the last and a seeded index
    of ``mask``, and one candidate outside it."""
    gen = MaskGenerator(mask)
    oracle = get_engine(name)
    rnd = int(np.random.default_rng(seed).integers(1, gen.keyspace - 1))
    salt = NAMES[name]
    lines = []
    for k, plain in enumerate([gen.candidate(0), gen.candidate(rnd),
                               gen.candidate(gen.keyspace - 1), b"~~~~"]):
        s = None if salt is None else salt[:-1] + bytes([salt[-1] ^ k])
        params = None if s is None else {"salt": s}
        lines.append(line(name, oracle.hash_batch([plain], params)[0], s))
    return lines


def crack(main, tmp_path, capsys, name, mask, lines, device, tag,
          extra=()):
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    pot = tmp_path / f"{tag}.pot"
    rc = main(["crack", mask, str(hashfile), "--engine", name, "--device",
               device, "--potfile", str(pot), "--batch", "2048", "-q",
               *extra])
    out = sorted(ln for ln in capsys.readouterr().out.splitlines() if ln)
    return rc, out, sorted(pot.read_text().splitlines())


@pytest.mark.parametrize("name", sorted(NAMES))
def test_cli_matches_the_reference(tmp_path, capsys, name):
    lines = hashlist(name, MASK, len(name))
    want = crack(ref_main, tmp_path, capsys, name, MASK, lines, "cpu", "ref")
    got = crack(port_main, tmp_path, capsys, name, MASK, lines, "torch-cpu",
                "port")
    assert got == want
    assert want[0] == 0 and len(want[1]) == 3


def test_mssql2000_lowercase_plant_under_all_printables(tmp_path, capsys):
    """mssql2000 under ?a?a: a target planted lowercase is found, with
    the same plaintext as the reference reports."""
    lines = hashlist("mssql2000", "?a?a", 7)
    want = crack(ref_main, tmp_path, capsys, "mssql2000", "?a?a", lines,
                 "cpu", "ref")
    got = crack(port_main, tmp_path, capsys, "mssql2000", "?a?a", lines,
                "torch-cpu", "port")
    assert got == want and len(want[1]) == 3
